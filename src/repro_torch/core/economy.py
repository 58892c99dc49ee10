"""Deadline/budget determination (paper 4.2.3): the static half of
``repro.core.economy``.

    Deadline = T_MIN + D_FACTOR * (T_MAX - T_MIN)        (Eq 1)
    Budget   = C_MIN + B_FACTOR * (C_MAX - C_MIN)        (Eq 2)

The dynamic pricing models (``commodity_reprice``, ``auction_round``)
are not ported yet; the engine refuses a non-static pricing model.
"""
from __future__ import annotations

import torch

PRICE_STATIC = 0
PRICE_COMMODITY = 1
PRICE_AUCTION = 2

_PRICING_NAMES = {"static": PRICE_STATIC, "commodity": PRICE_COMMODITY,
                  "auction": PRICE_AUCTION}


def as_pricing_model(model) -> int:
    """Normalise a pricing knob ("commodity", "auction", "static", an
    int code, or None) to a PRICE_* int."""
    if model is None:
        return PRICE_STATIC
    if isinstance(model, str):
        return _PRICING_NAMES[model]
    return int(model)


def _f32(x, like):
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def t_min(fleet, total_mi, registered=None):
    rate = fleet.peak_rate()
    if registered is not None:
        rate = torch.where(registered, rate, 0.0)
    return _f32(total_mi, rate) / torch.clamp_min(rate.sum(), 1e-30)


def t_max(fleet, total_mi, registered=None):
    mips = fleet.mips_per_pe
    if registered is not None:
        mips = torch.where(registered, mips, float("inf"))
    return _f32(total_mi, mips) / torch.clamp_min(mips.min(), 1e-30)


def c_min(fleet, total_mi, registered=None):
    cpm = fleet.cost_per_mi()
    if registered is not None:
        cpm = torch.where(registered, cpm, float("inf"))
    return _f32(total_mi, cpm) * cpm.min()


def c_max(fleet, total_mi, registered=None):
    cpm = fleet.cost_per_mi()
    if registered is not None:
        cpm = torch.where(registered, cpm, -float("inf"))
    return _f32(total_mi, cpm) * cpm.max()


def deadline_from_factor(fleet, total_mi, d_factor, registered=None):
    lo = t_min(fleet, total_mi, registered)
    hi = t_max(fleet, total_mi, registered)
    return lo + d_factor * (hi - lo)


def budget_from_factor(fleet, total_mi, b_factor, registered=None):
    lo = c_min(fleet, total_mi, registered)
    hi = c_max(fleet, total_mi, registered)
    return lo + b_factor * (hi - lo)
