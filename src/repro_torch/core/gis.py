"""Grid Information Service (``gridsim.GridInformationService``; port of
``repro.core.gis``).

Resources register at start-up; brokers query the registered,
available resources and their characteristics (the REGISTER_RESOURCE /
RESOURCE_LIST / RESOURCE_DYNAMICS tags of paper Fig 14).  The registry
is a boolean availability mask over the fleet table: querying is a
masked read, and a resource joining or leaving flips its entry.
"""
from __future__ import annotations

import dataclasses

import torch

from .calendar import effective_mips


@dataclasses.dataclass(frozen=True)
class GIS:
    registered: torch.Tensor  # bool[R]


def init(fleet) -> GIS:
    """Every fleet resource registers itself at start-up (paper 3.4)."""
    return GIS(registered=torch.ones((fleet.r,), dtype=torch.bool,
                                     device=fleet.num_pe.device))


def register(gis: GIS, idx) -> GIS:
    reg = gis.registered.clone()
    reg[idx] = True
    return GIS(registered=reg)


def deregister(gis: GIS, idx) -> GIS:
    """Resource failure or administrative removal."""
    reg = gis.registered.clone()
    reg[idx] = False
    return GIS(registered=reg)


def resource_list(gis: GIS) -> torch.Tensor:
    """RESOURCE_LIST: the availability mask the broker iterates over."""
    return gis.registered


def dynamics(gis: GIS, fleet, t):
    """RESOURCE_DYNAMICS: advertised aggregate rate and price per
    resource; an unregistered resource advertises zero capacity."""
    t = torch.as_tensor(t, dtype=torch.float32, device=fleet.num_pe.device)
    rate = effective_mips(fleet, t) * fleet.num_pe.to(torch.float32)
    rate = torch.where(gis.registered, rate, 0.0)
    return rate, fleet.cost_per_sec
