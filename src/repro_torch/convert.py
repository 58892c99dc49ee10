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
           np.dtype(np.bool_): torch.bool}


def _get(src, name):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def _tensor(x, device):
    a = np.asarray(x)
    return torch.as_tensor(a.copy(), dtype=_DTYPES[a.dtype], device=device)


def _build(cls, src, device):
    return cls(**{f.name: _tensor(_get(src, f.name), device)
                  for f in dataclasses.fields(cls)})


def gridlets(src, device="cpu") -> GridletBatch:
    """A ``GridletBatch`` from the reference's gridlet fields."""
    return _build(GridletBatch, src, device)


def fleet(src, device="cpu") -> Fleet:
    """A ``Fleet`` from the reference's fleet fields."""
    return _build(Fleet, src, device)


def params(src, device="cpu") -> engine.SimParams:
    """``SimParams`` from the reference's params fields.  Raises
    ``NotImplementedError`` where the reference switches on a source
    this slice does not run (reservations, trunks, fault traces,
    failures, dynamic pricing, plan-ahead)."""
    for name in ("trunk_of", "fault_time"):
        if _get(src, name) is not None:
            raise NotImplementedError(f"{name} is not ported yet")
    if np.asarray(_get(src, "resv_res")).shape[0]:
        raise NotImplementedError("reservations are not ported yet")
    p = _build(engine.SimParams, src, device)
    engine._check_params(p)
    return p


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
