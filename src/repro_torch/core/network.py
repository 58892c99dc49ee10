"""Entity communication model (port of ``repro.core.network``).

Two tiers, as in the reference:

* **Analytic links:** transfer delay is the closed-form term
  bytes / baud_rate (+ fixed latency), folded into the gridlet's event
  timestamps at dispatch and completion.
* **Fair-share links** (the engine's ``net_cap > 0``): each resource's
  link splits its baud rate equally over its concurrent transfers plus
  ``bg`` phantom background flows, through the ``[R_pad, T]``
  transfer-slot table and the link scan
  (``kernels.event_scan.link_scan_tabled_*``).  A shared trunk caps the
  rate of every transfer behind it at the trunk's own fair share
  (:func:`trunk_rate_cap`).

Only transfers that can contend occupy a link slot (:func:`link_tabled`);
zero-byte payloads and infinite links keep the analytic delay, which
is exactly 0.0 for them.
"""
from __future__ import annotations

import torch

LATENCY = 0.0   # fixed per-message latency in time units
BIG = 3.0e38    # finite "never arrives" horizon (matches kernels BIG)
# The reference's compiled comparisons read subnormal f32 inputs as
# zero, so "positive" is "at least the smallest normal f32".
TINY = float(torch.finfo(torch.float32).tiny)


def _f32(x, device=None):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def transfer_delay(nbytes, baud_rate):
    """Delay to move ``nbytes`` over a link of ``baud_rate`` bytes/unit:
    0 for empty payloads or infinite links, BIG for dead links."""
    baud = _f32(baud_rate)
    nbytes = _f32(nbytes, baud.device)
    safe = torch.clamp_min(baud, 1e-30)
    d = torch.clamp_max(nbytes / safe, BIG)     # overflow -> BIG, not inf
    d = torch.where(torch.isinf(baud) | (nbytes <= 0.0), 0.0, d)
    return d + LATENCY


def fastest_drain(nbytes, baud_rate, bg_flows):
    """Lower bound on the time a tabled transfer with ``nbytes`` left
    needs to drain: its rate never exceeds ``baud / (1 + bg)``, however
    the link's membership changes.  Same clamps as
    :func:`transfer_delay`."""
    baud = _f32(baud_rate)
    nbytes = _f32(nbytes, baud.device)
    bg = _f32(bg_flows, baud.device)
    safe = torch.clamp_min(baud, 1e-30)
    d = torch.clamp_max(nbytes * (1.0 + bg) / safe, BIG)
    return torch.where(torch.isinf(baud) | (nbytes <= 0.0), 0.0, d)


def link_tabled(nbytes, baud_rate):
    """True where a transfer contends for link bandwidth: a positive
    payload over a link of positive capacity below BIG (the link
    kernel's live-row mask; subnormals count as zero)."""
    baud = _f32(baud_rate)
    nbytes = _f32(nbytes, baud.device)
    return (nbytes >= TINY) & (baud >= TINY) & (baud < BIG)


# ----------------------------------------------------------------------
# Shared trunks: each resource keeps its private link (one table row);
# a trunk groups rows that also share an upstream segment.  Every
# resource sits behind at most one trunk, so the incidence is stored as
# trunk_of i32[R] (-1 = private only) plus per-trunk vectors gathered
# out to per-resource form.
# ----------------------------------------------------------------------

def trunk_topology(trunk_of, n_resources, trunk_baud=None, trunk_bg=None,
                   device="cpu"):
    """Validate a trunk topology.  ``trunk_of`` holds dense trunk ids
    0..n_trunks-1 or -1; ``trunk_baud`` (default BIG: never binds) and
    ``trunk_bg`` (default 0) are scalars or per-trunk vectors.  Returns
    ``(trunk_of i32[R], trunk_baud f32[R], trunk_bg f32[R])``."""
    trunk_of = torch.as_tensor(trunk_of, dtype=torch.int32, device=device)
    if tuple(trunk_of.shape) != (n_resources,):
        raise ValueError(f"trunk_of must have shape ({n_resources},), "
                         f"got {tuple(trunk_of.shape)}")
    top = int(trunk_of.max())
    n_trunks = top + 1 if top >= 0 else 0
    if int(trunk_of.min()) < -1:
        raise ValueError("trunk ids must be >= -1")
    width = (max(n_trunks, 1),)
    baud_t = _f32(BIG if trunk_baud is None else trunk_baud,
                  device).broadcast_to(width)
    bg_t = _f32(0.0 if trunk_bg is None else trunk_bg,
                device).broadcast_to(width)
    idx = torch.clamp(trunk_of.to(torch.int64), 0, max(n_trunks - 1, 0))
    private = trunk_of < 0
    return (trunk_of, torch.where(private, BIG, baud_t[idx]),
            torch.where(private, 0.0, bg_t[idx]))


def trunk_incidence(trunk_of, n_resources):
    """bool[R, R]: resources i and j share a trunk (the diagonal is True
    only for trunked rows)."""
    same = trunk_of[:, None] == trunk_of[None, :]
    return same & (trunk_of >= 0)[:, None]


def trunk_rate_cap(occupancy, trunk_of, trunk_baud, trunk_bg):
    """Per-row rate cap from trunk membership: a trunk with M transfers
    across its rows and ``bg`` phantom flows grants each at most
    ``trunk_baud / max(M + bg, 1)``; private rows get BIG.  M is a sum
    of integer-valued floats below 2**24, exact in any order."""
    occ = _f32(occupancy)
    inc = trunk_incidence(trunk_of, occ.shape[0])
    m_trunk = torch.where(inc, occ[None, :], 0.0).sum(dim=1)
    cap = trunk_baud / torch.clamp_min(m_trunk + trunk_bg, 1.0)
    return torch.where(trunk_of >= 0, cap, BIG)


def submit_delay(gridlets, fleet, resource_idx):
    """User -> resource staging delay for each gridlet (input files)."""
    return transfer_delay(gridlets.in_bytes, fleet.baud_rate[resource_idx])


def return_delay(gridlets, fleet, resource_idx):
    """Resource -> user result delay for each gridlet (output files)."""
    return transfer_delay(gridlets.out_bytes, fleet.baud_rate[resource_idx])
