"""``gridsim.ResourceCalendar`` -- local (non-grid) load by local time
(port of ``repro.core.calendar``).

``jnp.mod``/``%`` are floor-mods, so this module uses
``torch.remainder`` (never ``torch.fmod``).  The engine evaluates these
functions inside its compiled loop, where XLA turns ``/ 24.0`` into a
multiply by the reciprocal; :func:`numerics.div_const` does the same.
"""
from __future__ import annotations

import torch

from .numerics import div_const

HOURS_PER_UNIT = 1.0
SATURDAY = 5  # day index with epoch t=0 == Monday 00:00 local at UTC+0
SUNDAY = 6
_WEEK = 7 * 24.0
_SAT = float(SATURDAY) * 24.0


def local_day_and_hour(t, time_zone):
    """Day-of-week index [0..6] and hour-of-day at the resource's zone."""
    local_hours = t * HOURS_PER_UNIT + time_zone
    day = torch.remainder(
        torch.floor(div_const(local_hours, 24.0)).to(torch.int32), 7)
    hour = torch.remainder(local_hours, 24.0)
    return day, hour


def load(fleet, t) -> torch.Tensor:
    """Background load factor per resource at simulation time ``t``."""
    day, _ = local_day_and_hour(t, fleet.time_zone)
    weekend = (day == SATURDAY) | (day == SUNDAY)
    l = fleet.base_load + torch.where(weekend, fleet.weekend_load, 0.0)
    return torch.clamp(l, 0.0, 0.95)


def effective_mips(fleet, t) -> torch.Tensor:
    """Per-PE MIPS actually available to grid jobs at time ``t``."""
    return fleet.mips_per_pe * (1.0 - load(fleet, t))


def next_boundary(fleet, t) -> torch.Tensor:
    """Earliest load-calendar step strictly after ``t``, per resource:
    f32[R], +inf where ``weekend_load`` is zero (see the reference)."""
    t = torch.as_tensor(t, dtype=torch.float32,
                        device=fleet.time_zone.device)
    local = t * HOURS_PER_UNIT + fleet.time_zone
    w = torch.remainder(local, _WEEK)                  # [R] hours into week
    dh = torch.where(w < _SAT, _SAT - w, _WEEK - w)    # to next step
    dh2 = torch.where(w < _SAT, _WEEK - w, _WEEK + _SAT - w)
    t_b = t + dh
    t_b = torch.where(t_b > t, t_b, t + dh2)
    return torch.where(fleet.weekend_load != 0.0, t_b, float("inf"))
