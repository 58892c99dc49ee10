"""Entity communication model, analytic half (port of
``repro.core.network``): transfer delay is the closed-form term
bytes / baud_rate (+ fixed latency).  The fair-share link subsystem is
not ported yet; the engine refuses ``net_cap != 0``.
"""
from __future__ import annotations

import torch

LATENCY = 0.0   # fixed per-message latency in time units
BIG = 3.0e38    # finite "never arrives" horizon (matches kernels BIG)


def transfer_delay(nbytes, baud_rate):
    """Delay to move ``nbytes`` over a link of ``baud_rate`` bytes/unit:
    0 for empty payloads or infinite links, BIG for dead links."""
    baud = torch.as_tensor(baud_rate, dtype=torch.float32)
    nbytes = torch.as_tensor(nbytes, dtype=torch.float32,
                             device=baud.device)
    safe = torch.clamp_min(baud, 1e-30)
    d = torch.clamp_max(nbytes / safe, BIG)     # overflow -> BIG, not inf
    d = torch.where(torch.isinf(baud) | (nbytes <= 0.0), 0.0, d)
    return d + LATENCY


def submit_delay(gridlets, fleet, resource_idx):
    """User -> resource staging delay for each gridlet (input files)."""
    return transfer_delay(gridlets.in_bytes, fleet.baud_rate[resource_idx])


def return_delay(gridlets, fleet, resource_idx):
    """Resource -> user result delay for each gridlet (output files)."""
    return transfer_delay(gridlets.out_bytes, fleet.baud_rate[resource_idx])
