"""Shared enums / constants (port of ``repro.core.types``).

The codes are the reference's own, so statuses and trace kinds compare
bit for bit.  The dataclasses of the port are plain ``dataclasses``:
``replace`` is ``dataclasses.replace``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

# Gridlet lifecycle status.
CREATED = 0
IN_TRANSIT = 1
QUEUED = 2
RUNNING = 3
RETURNING = 4
DONE = 5
FAILED = 6

# Resource allocation policy.
TIME_SHARED = 0
SPACE_SHARED = 1

# Space-shared queue discipline.
FCFS = 0
SJF = 1

# Broker optimisation strategy (paper section 4.2.2).
OPT_COST = 0
OPT_TIME = 1
OPT_COST_TIME = 2
OPT_NONE = 3

INF = float("inf")


def replace(obj: Any, **kw: Any) -> Any:
    return dataclasses.replace(obj, **kw)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``cuda`` (the default of every
    entry point) raises where no card is present: the port never falls
    back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda is not "
                           "available; pass device='cpu' to run the plain "
                           "PyTorch path")
    return dev


def to_device(obj, device):
    """Move every tensor field of a dataclass to ``device``."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})
