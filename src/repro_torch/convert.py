"""Carry state across from the JAX reference.

The reference's objects arrive as numpy arrays (a mapping of field name
to array, or any object with those attributes -- e.g. a reference
dataclass after ``np.asarray`` on each leaf); this module builds the
port's dataclasses from them and turns the port's results back into
numpy for a field-by-field diff.  It imports neither JAX nor the
reference package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import engine
from .core.gridlet import GridletBatch
from .core.resource import Fleet

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.int32): torch.int32,
           np.dtype(np.uint32): torch.int64,     # PRNG key words
           np.dtype(np.bool_): torch.bool}


def _get(src, name):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def _tensor(x, device):
    a = np.asarray(x)
    b = a.astype(np.int64) if a.dtype == np.uint32 else a.copy()
    return torch.as_tensor(b, dtype=_DTYPES[a.dtype], device=device)


def _build(cls, src, device):
    return cls(**{f.name: None if _get(src, f.name) is None
                  else _tensor(_get(src, f.name), device)
                  for f in dataclasses.fields(cls)})


def gridlets(src, device="cpu") -> GridletBatch:
    """A ``GridletBatch`` from the reference's gridlet fields."""
    return _build(GridletBatch, src, device)


def fleet(src, device="cpu") -> Fleet:
    """A ``Fleet`` from the reference's fleet fields."""
    return _build(Fleet, src, device)


def params(src, device="cpu") -> engine.SimParams:
    """``SimParams`` from the reference's params fields: the link rates,
    trunk vectors, failure and auction keys, fault-trace rows,
    reservation windows and pricing knobs included.  Lane-stacked
    params (every leaf with a leading [L], as ``jax.vmap(_scenario_point)``
    or ``examples/table1_strategies.lane_params`` make them) give the
    port's lane params, which ``engine.run_sweep_lanes`` takes as they
    are: both packages then run the same lanes."""
    return _build(engine.SimParams, src, device)


def to_numpy(obj):
    """A port result (dataclass, tuple or tensor) as nested dicts /
    tuples of numpy arrays."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj):
        return {f.name: to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple):
        return tuple(to_numpy(x) for x in obj)
    return obj
