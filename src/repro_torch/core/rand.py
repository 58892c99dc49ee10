"""``gridsim.GridSimRandom`` on ``torch.Generator`` (port of
``repro.core.rand``).

``real(d, f_L, f_M)`` maps a predicted value ``d`` to a random value in
``[(1-f_L)*d, (1+f_M)*d]`` via ``d * (1 - f_L + (f_L + f_M) * rd)``,
``rd ~ U[0, 1)``.  The draws come from a seeded ``torch.Generator``, so
runs repeat exactly, but they are not the reference's threefry bits:
parity tests hand reference-drawn arrays to the port instead.
"""
from __future__ import annotations

import torch

FACTORS = {
    "exec": (0.0, 0.10),       # paper section 5.2: 0..10% positive side
    "net_io": (0.05, 0.05),
    "none": (0.0, 0.0),
}


def real(gen: torch.Generator, d, f_low, f_more):
    """Vectorised GridSimRandom.real; ``d`` may be any shaped tensor."""
    d = torch.as_tensor(d, dtype=torch.float32)
    rd = torch.rand(d.shape, generator=gen, dtype=torch.float32,
                    device=gen.device).to(d.device)
    return d * (1.0 - f_low + (f_low + f_more) * rd)


def real_named(gen: torch.Generator, d, situation: str = "exec"):
    f_low, f_more = FACTORS[situation]
    return real(gen, d, f_low, f_more)


def exponential(gen: torch.Generator, mean):
    """One exponential holding time per element of ``mean``; +inf where
    the mean is not positive (the stream is off)."""
    mean = torch.as_tensor(mean, dtype=torch.float32)
    e = torch.empty(mean.shape, dtype=torch.float32,
                    device=gen.device).exponential_(generator=gen)
    return torch.where(mean > 0.0, mean * e.to(mean.device), float("inf"))
