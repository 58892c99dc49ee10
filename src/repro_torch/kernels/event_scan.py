"""The GridSim inner loop on Hopper: Fig 8 PE-share allocation plus the
earliest-completion forecast (``event_scan``), and the fused event
frontier (``event_frontier``).  Port of ``repro.kernels.event_scan``.

Per resource row of the ``[R, J]`` job-slot table:

  rank_j  = position of (remaining_j, tie_j, j) in the row's lexsort
  P_eff   = num_pe - pe_blocked
  k       = g // P_eff,  extra = g % P_eff,  msc = (P_eff - extra) * k
  rate_j  = eff_mips / (k + [rank_j >= msc])   (space-shared: a whole PE)
  t_j     = remaining_j / rate_j
  t_min   = min_j t_j;  argmin = earliest column, ties by the tie key
  occ     = number of occupied job slots

Each function has two implementations with identical arithmetic:

* the CUDA kernel (``csrc/event_scan.cu``), launched for tensors on the
  card -- :func:`event_scan_cuda`, :func:`event_frontier_cuda`;
* the plain PyTorch version beside it -- :func:`event_scan_ref`,
  :func:`event_frontier_ref` -- used for tensors on the CPU and as the
  card-side yardstick the kernels are held against.

``kernels.ops`` routes by device.  ``LAUNCHES`` counts kernel launches
and ``PLAIN_CALLS`` plain-version calls, so a run can show which path
it took.
"""
from __future__ import annotations

import ctypes
import functools

import torch

BIG = 3.0e38
INF = float("inf")

LAUNCHES = {"event_scan": 0, "event_frontier": 0}
PLAIN_CALLS = {"event_scan": 0, "event_frontier": 0}


def reset_counts():
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


# ----------------------------------------------------------------------
# Plain PyTorch versions (and the helpers the engine calls directly)
# ----------------------------------------------------------------------

def _row_masks(rem, npe, pol, blk, ok):
    """Shared masking prologue: reservation windows shrink the PE pool
    of time-shared rows; a down row, or a fully reserved time-shared
    row, is dead.  Returns (npe_e [R,1] f32, valid [R,J] bool, g [R,1]
    f32 job count)."""
    npe_e = torch.clamp_min(npe - blk, 0.0)
    dead = (ok < 0.5) | ((pol < 0.5) & (npe_e < 0.5))
    valid = (rem > 0.0) & (rem < BIG) & ~dead
    g = valid.sum(dim=1, keepdim=True).to(torch.float32)
    return npe_e, valid, g


def _lexsort_rank(rem, tie, valid):
    """Within-row (remaining, tie) rank: the inverse of the row's stable
    lexsort permutation, built from two stable sorts (tie key first,
    then remaining).  Returns (rank [R,J] f32, key, tkey) with invalid
    slots keyed BIG."""
    key = torch.where(valid, rem, BIG)
    tkey = torch.where(valid, tie, BIG)
    o1 = torch.sort(tkey, dim=-1, stable=True).indices
    o2 = torch.sort(torch.gather(key, -1, o1), dim=-1, stable=True).indices
    order = torch.gather(o1, -1, o2)
    pos = torch.arange(rem.shape[-1], device=rem.device).expand_as(order)
    rank = torch.empty_like(order).scatter_(-1, order, pos)
    return rank.to(torch.float32), key, tkey


def _fig8_rates(rem, rank, valid, g, mips, npe_e, pol):
    """Fig 8 share divisor -> per-slot rate."""
    m = torch.clamp_min(npe_e, 1.0)
    k = torch.floor(g / m)                          # [R,1] min jobs per PE
    extra = g - k * m
    msc = (npe_e - extra) * k                       # max-share count
    divisor = k + (rank >= msc).to(torch.float32)
    divisor = torch.where(g <= npe_e, 1.0, divisor)  # everyone a full PE
    divisor = torch.where(pol > 0.5, 1.0, divisor)   # space-shared rows
    return torch.where(valid, mips / torch.clamp_min(divisor, 1.0), 0.0)


def _default_inputs(remaining, tie, policy, pe_blocked, row_ok):
    r, j = remaining.shape
    dev = remaining.device

    def vec(x, fill):
        if x is None:
            return torch.full((r,), fill, dtype=torch.float32, device=dev)
        return x.to(torch.float32).reshape(r)

    if tie is None:
        tie = torch.arange(j, dtype=torch.float32,
                           device=dev).expand(r, j)
    return (remaining.to(torch.float32), tie.to(torch.float32),
            vec(policy, 0.0), vec(pe_blocked, 0.0), vec(row_ok, 1.0))


def event_scan_ref(remaining, mips_eff, num_pe, tie=None, policy=None,
                   pe_blocked=None, row_ok=None, *, with_rank=False,
                   rank=None):
    """Plain PyTorch event scan (the semantics of the reference's
    ``event_scan_xla``).  ``rank`` injects a precomputed rank table and
    skips the sort; ``with_rank`` appends the rank to the outputs.
    Returns (rate [R,J], t_min [R], argmin_col [R] i32, occupancy [R]
    i32[, rank [R,J]]); argmin_col is J for empty or dead rows."""
    PLAIN_CALLS["event_scan"] += 1
    r, j = remaining.shape
    remaining, tie, policy, pe_blocked, row_ok = _default_inputs(
        remaining, tie, policy, pe_blocked, row_ok)
    mips = mips_eff.to(torch.float32)[:, None]
    npe = num_pe.to(torch.float32)[:, None]
    pol = policy[:, None]
    npe_e, valid, g = _row_masks(remaining, npe, pol, pe_blocked[:, None],
                                 row_ok[:, None])
    if rank is None:
        rank, _, tkey = _lexsort_rank(remaining, tie, valid)
    else:
        rank = rank.to(torch.float32)
        tkey = torch.where(valid, tie, BIG)
    rate = _fig8_rates(remaining, rank, valid, g, mips, npe_e, pol)

    t = torch.where(valid, remaining / torch.clamp_min(rate, 1e-30), BIG)
    tmin = t.min(dim=1, keepdim=True).values
    at_min = (t <= tmin) & valid
    cand = torch.where(at_min, tkey, BIG)
    tie_min = cand.min(dim=1, keepdim=True).values
    col = torch.arange(j, dtype=torch.int32, device=remaining.device)
    amin = torch.where(at_min & (cand <= tie_min), col, j).min(dim=1).values
    res = (rate, tmin[:, 0], amin, valid.sum(dim=1).to(torch.int32))
    if with_rank:
        res = res + (rank,)
    return res


def _frontier_finish(mins, counts, safe):
    n_src = mins.shape[0]
    if n_src == 0:
        inf = torch.tensor(INF, device=mins.device)
        return inf, mins > 0, counts, inf, mins
    t_star = mins.min()
    fired = torch.isfinite(mins) & (mins <= t_star)
    return t_star, fired, counts, safe.min(), mins


def _segment_ids(sizes, device):
    return torch.repeat_interleave(
        torch.arange(len(sizes), device=device),
        torch.as_tensor(sizes, dtype=torch.int64, device=device))


def event_frontier_ref(cand, sizes, cuts=None):
    """Plain PyTorch event frontier over per-source candidate instants.

    cand: f32[C], the concatenation of every source's candidates (+inf
    where nothing is pending); sizes: the static per-source segment
    lengths; cuts: bool[C] marking horizon-cutting candidates (default
    all).  Returns (t_star, fired bool[S], counts i32[S], t_safe,
    per_source_min f32[S])."""
    PLAIN_CALLS["event_frontier"] += 1
    n_src = len(sizes)
    c = cand.shape[0]
    if sum(sizes) != c:
        raise ValueError("segment layout out of sync with candidates")
    dev = cand.device
    cand = cand.to(torch.float32)
    seg = _segment_ids(sizes, dev)
    inf = torch.full((n_src,), INF, dtype=torch.float32, device=dev)
    mins = inf.scatter_reduce(0, seg, cand, "amin")
    t_star = mins.min() if n_src else torch.tensor(INF, device=dev)
    due = (cand <= t_star) & (cand < INF)
    counts = torch.zeros(n_src, dtype=torch.int32, device=dev).index_add_(
        0, seg, due.to(torch.int32))
    cut = cand if cuts is None else torch.where(
        cuts.to(torch.float32) > 0.5, cand, INF)
    safe = inf.scatter_reduce(0, seg, cut, "amin")
    return _frontier_finish(mins, counts, safe)


# ----------------------------------------------------------------------
# CUDA kernels (csrc/event_scan.cu), built at first use
# ----------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    from . import _build
    lib = _build.library()
    if not getattr(lib, "_repro_torch_bound", False):
        lib.event_scan_launch.argtypes = [_P] * 13 + [_I, _I, _P]
        lib.event_scan_launch.restype = _I
        lib.event_frontier_launch.argtypes = [_P, _P, _P, _I,
                                              _P, _P, _P, _P]
        lib.event_frontier_launch.restype = _I
        lib._repro_torch_bound = True
    return lib


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _check(t, name, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def event_scan_cuda(remaining, mips_eff, num_pe, tie=None, policy=None,
                    pe_blocked=None, row_ok=None, *, with_rank=False,
                    rank=None):
    """:func:`event_scan_ref` as one CUDA kernel launch (same
    arguments, same outputs, bitwise).  A non-None ``rank`` selects the
    injected-rank form, which is returned as the rank output."""
    if remaining.device.type != "cuda":
        raise ValueError("event_scan_cuda takes CUDA tensors")
    r, j = remaining.shape
    dev = remaining.device
    remaining, tie, policy, pe_blocked, row_ok = (
        x.contiguous() for x in _default_inputs(remaining, tie, policy,
                                                pe_blocked, row_ok))
    mips = mips_eff.to(torch.float32).contiguous()
    npe = num_pe.to(torch.float32).contiguous()
    f32 = torch.float32
    _check(remaining, "remaining", (r, j), f32, dev)
    _check(tie, "tie", (r, j), f32, dev)
    for name, v in (("mips_eff", mips), ("num_pe", npe),
                    ("policy", policy), ("pe_blocked", pe_blocked),
                    ("row_ok", row_ok)):
        _check(v, name, (r,), f32, dev)
    if rank is not None:
        rank = rank.to(f32).contiguous()
        _check(rank, "rank", (r, j), f32, dev)
    rate = torch.empty((r, j), dtype=f32, device=dev)
    tmin = torch.empty((r,), dtype=f32, device=dev)
    amin = torch.empty((r,), dtype=torch.int32, device=dev)
    occ = torch.empty((r,), dtype=torch.int32, device=dev)
    rank_out = (torch.empty((r, j), dtype=f32, device=dev)
                if with_rank and rank is None else None)
    if r:
        err = _lib().event_scan_launch(
            _ptr(remaining), _ptr(tie), _ptr(mips), _ptr(npe),
            _ptr(policy), _ptr(pe_blocked), _ptr(row_ok), _ptr(rank),
            _ptr(rate), _ptr(tmin), _ptr(amin), _ptr(occ), _ptr(rank_out),
            r, j, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        _raise_on(err, "event_scan")
        LAUNCHES["event_scan"] += 1
    res = (rate, tmin, amin, occ)
    if with_rank:
        res = res + (rank if rank is not None else rank_out,)
    return res


@functools.lru_cache(maxsize=64)
def _segment_offsets(sizes, device):
    """Device int32 [S+1] segment offsets for a static layout (the
    engine asks for the same few layouts on every superstep)."""
    acc = [0]
    for n in sizes:
        acc.append(acc[-1] + n)
    return torch.tensor(acc, dtype=torch.int32, device=device)


def event_frontier_cuda(cand, sizes, cuts=None):
    """:func:`event_frontier_ref` as one CUDA kernel launch (one block;
    ``_frontier_finish`` stays in torch)."""
    if cand.device.type != "cuda":
        raise ValueError("event_frontier_cuda takes CUDA tensors")
    n_src = len(sizes)
    c = cand.shape[0]
    if sum(sizes) != c:
        raise ValueError("segment layout out of sync with candidates")
    dev = cand.device
    cand = cand.to(torch.float32).contiguous()
    _check(cand, "cand", (c,), torch.float32, dev)
    if cuts is not None:
        cuts = cuts.to(torch.float32).contiguous()
        _check(cuts, "cuts", (c,), torch.float32, dev)
    off = _segment_offsets(tuple(sizes), dev)
    mins = torch.empty((n_src,), dtype=torch.float32, device=dev)
    counts = torch.empty((n_src,), dtype=torch.int32, device=dev)
    safe = torch.empty((n_src,), dtype=torch.float32, device=dev)
    if n_src:
        err = _lib().event_frontier_launch(
            _ptr(cand), _ptr(cuts), _ptr(off), n_src, _ptr(mins),
            _ptr(counts), _ptr(safe),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        _raise_on(err, "event_frontier")
        LAUNCHES["event_frontier"] += 1
    return _frontier_finish(mins, counts, safe)
