"""Public kernel entry points, routed by device (port of
``repro.kernels.ops``; same signatures as its ``flash_attention``,
``ssd_scan``, ``event_scan``, ``event_scan_slab``, ``link_scan`` and
``event_frontier``).

A tensor on the CPU goes to the plain PyTorch version; a tensor on the
card goes to the CUDA kernel, which raises if it cannot be built or
launched.  Nothing falls back.  ``block_q``, ``block_kv``, ``block_h``,
``block_r``, ``block_l`` and ``interpret`` are the reference's Pallas
knobs, accepted so calls port unchanged; the CUDA kernels choose their
own tiles and have no interpret mode.
"""
from __future__ import annotations

from . import event_scan as _event
from . import flash_attention as _flash
from . import ssd_scan as _ssd


def _on_card(x) -> bool:
    return x.device.type == "cuda"


def flash_attention(q, k, v, *, causal=True, window=0, cap=0.0,
                    block_q=512, block_kv=1024, interpret=None):
    """q: [B, Hq, Sq, d]; k, v: [B, Hkv, Skv, d] -> [B, Hq, Sq, d]."""
    fn = _flash.flash_attention_cuda if _on_card(q) \
        else _flash.flash_attention_ref
    return fn(q, k, v, causal=causal, window=window, cap=cap)


def ssd_scan(x, dt, a, b_mat, c_mat, *, chunk=256, block_h=8,
             interpret=None):
    """Mamba-2 SSD over chunks: x [B, S, H, P], dt [B, S, H], a [H],
    b/c [B, S, N] -> y [B, S, H, P]."""
    fn = _ssd.ssd_scan_cuda if _on_card(x) else _ssd.ssd_scan_ref
    return fn(x, dt, a, b_mat, c_mat, chunk=chunk)


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


def event_scan_slab(remaining, mips_eff, num_pe, k=8, tie=None,
                    policy=None, pe_blocked=None, row_ok=None, live=None,
                    *, block_r=8, interpret=None, assoc=True):
    """Next-k completion forecast per resource row.  Returns (t_wave
    [R, k] f32, time from now of each row's w-th completion, BIG-padded;
    col_wave [R, k] i32, J-padded).  ``live`` False (a scalar, kept on
    the device) masks every row off; ``assoc`` picks the wave-matrix
    product over the sequential recurrence.  On the CPU the product runs
    in ``jax.lax.associative_scan``'s order, as the reference's CPU
    route does; the kernel runs the Pallas body's balanced tree.  Any
    ``k >= 1`` on both routes."""
    fn = _event.event_scan_slab_cuda if _on_card(remaining) \
        else _event.event_scan_slab_ref
    return fn(remaining, mips_eff, num_pe, k, tie=tie, policy=policy,
              pe_blocked=pe_blocked, row_ok=row_ok, live=live, assoc=assoc)


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
