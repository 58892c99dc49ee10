"""Public kernel entry points, routed by device (port of
``repro.kernels.ops``; same signatures as its ``event_scan``,
``link_scan`` and ``event_frontier``).

A tensor on the CPU goes to the plain PyTorch version; a tensor on the
card goes to the CUDA kernel, which raises if it cannot be built or
launched.  Nothing falls back.  ``block_r``, ``block_l`` and
``interpret`` are the reference's Pallas knobs, accepted so calls port
unchanged; the CUDA kernels have no row blocking and no interpret mode.
"""
from __future__ import annotations

from . import event_scan as _event


def _on_card(x) -> bool:
    return x.device.type == "cuda"


def event_scan(remaining, mips_eff, num_pe, tie=None, policy=None,
               pe_blocked=None, row_ok=None, rank=None, *, block_r=8,
               interpret=None, with_rank=False):
    """GridSim Fig 8 share allocation + completion forecast.  Returns
    (rate [R, J], t_min [R], argmin_col [R], occupancy [R]);
    ``with_rank=True`` appends the per-row (remaining, tie) rank table.
    ``rank`` injects a precomputed rank table (no sort)."""
    fn = _event.event_scan_cuda if _on_card(remaining) \
        else _event.event_scan_ref
    return fn(remaining, mips_eff, num_pe, tie=tie, policy=policy,
              pe_blocked=pe_blocked, row_ok=row_ok, with_rank=with_rank,
              rank=rank)


def link_scan(remaining, baud, bg=None, tie=None, cap=None, *,
              block_l=8, interpret=None):
    """Fair-share link transfer forecast over the [L, T] transfer-slot
    table; ``cap`` [L] is the optional trunk rate ceiling.  Returns
    (rate [L, T], t_min [L], argmin_col [L], occupancy [L])."""
    fn = _event.link_scan_cuda if _on_card(remaining) \
        else _event.link_scan_ref
    return fn(remaining, baud, bg=bg, tie=tie, cap=cap)


def event_frontier(cand, sizes, cuts=None, *, interpret=None):
    """Fused superstep event frontier over the concatenated per-source
    candidates.  Returns (t_star, fired bool[S], counts i32[S], t_safe,
    per_source_min f32[S])."""
    fn = _event.event_frontier_cuda if _on_card(cand) \
        else _event.event_frontier_ref
    return fn(cand, tuple(sizes), cuts=cuts)
