"""The GridSim inner loop on Hopper: Fig 8 PE-share allocation plus the
earliest-completion forecast (``event_scan``), its k-wave slab
(``event_scan_slab``), its fair-share link twin (``link_scan``) and the
fused event frontier (``event_frontier``).  Port of
``repro.kernels.event_scan``.

Per resource row of the ``[R, J]`` job-slot table:

  rank_j  = position of (remaining_j, tie_j, j) in the row's lexsort
  P_eff   = num_pe - pe_blocked
  k       = g // P_eff,  extra = g % P_eff,  msc = (P_eff - extra) * k
  rate_j  = eff_mips / (k + [rank_j >= msc])   (space-shared: a whole PE)
  t_j     = remaining_j / rate_j
  t_min   = min_j t_j;  argmin = earliest column, ties by the tie key
  occ     = number of occupied job slots

then, from the same rank, the row's next k completions under
uninterrupted Fig 8 dynamics (``event_scan_slab``): wave w completes the
rank-w job at the share of rank 0 among g - w jobs, and advances the
survivors at theirs;

and per link row of the ``[L, T]`` transfer-slot table:

  m       = number of live transfers (rem in (0, BIG), baud in (0, BIG))
  rate_j  = min(baud / max(m + bg, 1), cap)    (cap: the trunk share)
  t_j     = rem_j / rate_j;  t_min, argmin and occupancy as above

Each function has two implementations with identical arithmetic:

* the CUDA kernel (``csrc/event_scan.cu``), launched for tensors on the
  card -- :func:`event_scan_cuda`, :func:`event_scan_slab_cuda`,
  :func:`link_scan_cuda`, :func:`event_frontier_cuda`;
* the plain PyTorch version beside it -- :func:`event_scan_ref`,
  :func:`event_scan_slab_ref`, :func:`link_scan_ref`,
  :func:`event_frontier_ref` -- used for tensors on the CPU and as the
  card-side yardstick the kernels are held against.

The sweep engine (``engine.run_sweep_lanes``) runs the lane forms of
the checked scan and the frontier (:func:`event_scan_checked_lanes_cuda`
/ :func:`event_scan_checked_lanes_ref`, :func:`event_frontier_lanes_cuda`
/ :func:`event_frontier_lanes_ref`): one launch over every scenario
lane, each lane's outputs bitwise the one-lane form's.

The engine's scan is ``event_scan``'s checked form
(:func:`event_scan_checked_cuda` / :func:`event_scan_checked_ref`): the
table gathered from the slot map, the carried rank checked, and the
carried or a fresh rank chosen for every row at once, all on the
device, as the reference's ``_checked_scan(select_free=True)`` does.
The engine's link scan is ``link_scan``'s engine form
(:func:`link_scan_tabled_cuda` / :func:`link_scan_tabled_ref`): the tie
key from the transfer-slot map and, with shared trunks, each trunk's
occupancy and rate cap, all in the kernel, as the reference engine's
``_link_scan`` builds them around its kernel.
On the engine's path the kernels write into a :class:`Scratch` of
reused outputs and take the engine's tensors without casts or checks.

``kernels.ops`` routes by device.  ``LAUNCHES`` counts kernel launches
and ``PLAIN_CALLS`` plain-version calls (``kernels._launch``, shared by
every kernel module), so a run can show which path it took.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..core import network, numerics
from ._launch import LAUNCHES, PLAIN_CALLS, reset_counts  # noqa: F401
from ._launch import check as _check
from ._launch import lib as _lib
from ._launch import ptr as _ptr
from ._launch import raise_on as _raise_on
from ._launch import stream as _stream

BIG = 3.0e38
INF = float("inf")
# The reference's compiled link scan compares subnormal inputs as zero:
# a positive remaining or baud is one of at least the smallest normal.
TINY = float(torch.finfo(torch.float32).tiny)



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


def _gather_table(row_gridlet, remaining):
    """The [R, J] job-slot table from the slot map (gridlet index, -1 =
    empty) as the reference's ``_table_inputs`` gathers it: an occupied
    slot holds its gridlet's remaining, clamped to 1e-30 (0 marks an
    empty slot), and the gridlet index as its tie key; an empty slot
    holds 0 and 2^30."""
    occupied = row_gridlet >= 0
    gid = torch.clamp(row_gridlet.to(torch.int64), 0, remaining.shape[0] - 1)
    rem = torch.where(occupied, torch.clamp_min(remaining[gid], 1e-30), 0.0)
    tie = torch.where(occupied, row_gridlet, 2 ** 30).to(torch.float32)
    return rem, tie


def _partition_ok(rem, tie, valid, rank, npe_e, g, pol):
    """True iff the carried rank still yields the exact Fig 8 rate
    assignment the fresh lexsort rank would (the reference engine's
    ``_partition_ok``): :func:`_partition_rows` holds in every row."""
    return _partition_rows(rem, tie, valid, rank, npe_e, g, pol).all()


def _partition_rows(rem, tie, valid, rank, npe_e, g, pol):
    """bool [R, 1]: the row never consults its rank, or its carried
    MaxShare side's lexicographic max lies strictly below its MinShare
    side's min."""
    m = torch.clamp_min(npe_e, 1.0)
    k = torch.floor(g / m)
    extra = g - k * m
    msc = (npe_e - extra) * k
    left = valid & (rank < msc)
    right = valid & (rank >= msc)
    rem_lo = torch.where(left, rem, -BIG).max(dim=1, keepdim=True).values
    rem_hi = torch.where(right, rem, BIG).min(dim=1, keepdim=True).values
    tie_lo = torch.where(left & (rem == rem_lo), tie, -BIG).max(
        dim=1, keepdim=True).values
    tie_hi = torch.where(right & (rem == rem_hi), tie, BIG).min(
        dim=1, keepdim=True).values
    row_ok = (rem_lo < rem_hi) | ((rem_lo == rem_hi) & (tie_lo < tie_hi))
    rank_free = (pol > 0.5) | (g <= npe_e)
    return rank_free | row_ok


def event_scan_checked_ref(row_gridlet, remaining, mips_eff, num_pe,
                           policy, pe_blocked, row_ok, rank_carry, slab_ok,
                           n_reseeds):
    """Plain PyTorch checked scan: the reference engine's
    ``_checked_scan(select_free=True)`` from the slot map.

    row_gridlet i32[R, J] (-1 = empty slot), remaining f32[N]; the
    per-row f32[R] mips_eff, num_pe, policy, pe_blocked, row_ok; the
    carried rank f32[R, J] and its flag slab_ok (bool[]).  The table is
    gathered (:func:`_gather_table`), the carry kept if ``slab_ok`` and
    :func:`_partition_ok` hold, else every row takes the fresh lexsort
    rank; ``n_reseeds`` (i32[], updated in place) counts the fresh ones.
    Returns :func:`event_scan_ref`'s outputs with the rank used (one
    plain ``event_scan`` call)."""
    rem, tie = _gather_table(row_gridlet, remaining)
    pol = policy[:, None]
    npe_e, valid, g = _row_masks(rem, num_pe[:, None], pol,
                                 pe_blocked[:, None], row_ok[:, None])
    use = slab_ok & _partition_ok(rem, tie, valid, rank_carry, npe_e, g, pol)
    fresh = _lexsort_rank(rem, tie, valid)[0]
    n_reseeds.add_((~use).to(torch.int32))
    return event_scan_ref(rem, mips_eff, num_pe, tie=tie, policy=policy,
                          pe_blocked=pe_blocked, row_ok=row_ok,
                          rank=torch.where(use, rank_carry, fresh),
                          with_rank=True)


def event_scan_checked_lanes_ref(row_gridlet, remaining, mips_eff, num_pe,
                                 policy, pe_blocked, row_ok, rank_carry,
                                 slab_ok, *, reseed=True):
    """Plain PyTorch checked scan over scenario lanes: row_gridlet
    i32[L, R, J], remaining f32[L, N], the per-row f32[L, R] inputs,
    rank_carry f32[L, R, J] and slab_ok bool[L].  Each lane's carry is
    kept if its flag and every one of its rows' checks hold
    (``use``); else, with ``reseed``, all its rows take the fresh
    lexsort rank, and without it they scan with the carry all the same
    (the sweep engine's micro-steps, which decline on a stale carry).
    The rows are independent, so they run as one [L * R, J] table:
    every lane's outputs are :func:`event_scan_checked_ref`'s bitwise.
    Returns (rate [L, R, J], t_min, argmin, occupancy [L, R], rank
    [L, R, J]) and use bool[L]."""
    PLAIN_CALLS["event_scan_lanes"] += 1
    n_lanes, r, j = row_gridlet.shape
    occupied = row_gridlet >= 0
    gid = torch.clamp(row_gridlet.to(torch.int64), 0, remaining.shape[1] - 1)
    slot_rem = torch.gather(remaining, 1, gid.reshape(n_lanes, -1)).reshape(
        n_lanes, r, j)
    rem = torch.where(occupied, torch.clamp_min(slot_rem, 1e-30),
                      0.0).reshape(-1, j)
    tie = torch.where(occupied, row_gridlet, 2 ** 30).to(
        torch.float32).reshape(-1, j)
    mips, npe, pol, blk, ok = (x.reshape(-1) for x in (
        mips_eff, num_pe, policy, pe_blocked, row_ok))
    carry = rank_carry.reshape(-1, j)
    npe_e, valid, g = _row_masks(rem, npe[:, None], pol[:, None],
                                 blk[:, None], ok[:, None])
    rows_ok = _partition_rows(rem, tie, valid, carry, npe_e, g,
                              pol[:, None]).reshape(n_lanes, r)
    use = slab_ok & rows_ok.all(dim=1)
    rank = carry
    if reseed:
        fresh = _lexsort_rank(rem, tie, valid)[0]
        rank = torch.where(use.repeat_interleave(r)[:, None], carry, fresh)
    out = event_scan_ref(rem, mips, npe, tie=tie, policy=pol, pe_blocked=blk,
                         row_ok=ok, rank=rank, with_rank=True)
    return tuple(x.reshape((n_lanes, r) + x.shape[1:]) for x in out), use


def _live_rows(row_ok, live):
    """The scalar ``live`` gate folded into the row mask on the device:
    ``live`` False masks every row off (no host read)."""
    if live is None:
        return row_ok
    live = torch.as_tensor(live, device=row_ok.device).to(torch.bool)
    return torch.where(live, row_ok, 0.0)


def _slab_waves(rem, rank, valid, g, mips, npe_e, pol, col, k):
    """The sequential k-wave recurrence (the reference's ``_slab_waves``):
    wave w is the Fig 8 share over the survivors, with job count and
    ranks shifted by the w departed heads; the rank-w job completes it.
    Returns (t_wave f32[R, k] from now, BIG-padded; col_wave i32[R, k],
    J-padded)."""
    r, j = rem.shape
    t_acc = torch.zeros((r, 1), dtype=torch.float32, device=rem.device)
    ts, cols = [], []
    for w in range(k):
        active = valid & (rank >= w)
        rate = _fig8_rates(rem, rank - w, active, g - w, mips, npe_e, pol)
        head = valid & (rank == w)
        has = head.any(dim=1, keepdim=True)
        # one head per row: the sum is that head's quotient, exactly
        dt = torch.where(head, rem / torch.clamp_min(rate, 1e-30),
                         0.0).sum(dim=1, keepdim=True)
        t_acc = t_acc + torch.where(has, dt, 0.0)
        ts.append(torch.where(has, t_acc, BIG))
        cols.append(torch.where(
            has, torch.where(head, col, 0).sum(dim=1, keepdim=True),
            j).to(torch.int32))
        # XLA:CPU contracts rem - rate * dt into one FMA
        adv = torch.clamp_min(numerics.fma(-rate, dt, rem), 0.0)
        rem = torch.where(head, 0.0, torch.where(active, adv, rem))
    return torch.cat(ts, dim=1), torch.cat(cols, dim=1)


def _slab_assoc_inputs(rem, rank, valid, g, mips, npe_e, pol, col, k):
    """Rank-indexed slab inputs: the wave-rate table A f32[R, k, k]
    (A[:, w, p] = wave-w rate of the rank-p job), the heads' remaining
    srem f32[R, k] and columns scol i32[R, k], and has bool[R, k]
    (rank p exists iff p < g)."""
    dev = rem.device
    ar = torch.arange(k, dtype=torch.float32, device=dev)
    w_i, p_i = ar[None, :, None], ar[None, None, :]
    g3 = g[:, :, None]
    act = (p_i >= w_i) & (p_i < g3)
    a_mat = _fig8_rates(p_i, p_i - w_i, act, g3 - w_i, mips[:, :, None],
                        npe_e[:, :, None], pol[:, :, None])
    has = ar[None, :] < g
    heads = [valid & (rank == p) for p in range(k)]
    srem = torch.cat([torch.where(h, rem, 0.0).sum(dim=1, keepdim=True)
                      for h in heads], dim=1)
    scol = torch.cat([torch.where(h, col, 0).sum(dim=1, keepdim=True)
                      for h in heads], dim=1)
    return a_mat, srem, scol, has


def _wave_matrices(a_mat, srem, k):
    """The k homogeneous (k+1)x(k+1) wave matrices [R, k+1, k+1]: the
    identity but for row p, which holds (-A[v, p] / d for v < p, 0,
    srem_p / d) with d = max(A[p, p], 1e-30), clipped to +-BIG so a
    zero-rate head cannot poison the product with 0 * inf."""
    r = a_mat.shape[0]
    eye = torch.eye(k + 1, dtype=torch.float32, device=a_mat.device)
    v_i = torch.arange(k, dtype=torch.float32, device=a_mat.device)[None]
    mats = []
    for p in range(k):
        d = torch.clamp_min(a_mat[:, p, p], 1e-30)[:, None]
        coeff = torch.where(v_i < p, -a_mat[:, :, p] / d, 0.0)
        rowvals = torch.clamp(torch.cat([coeff, srem[:, p:p + 1] / d],
                                        dim=1), -BIG, BIG)
        m = eye.expand(r, k + 1, k + 1).clone()
        m[:, p, :] = rowvals
        mats.append(m)
    return mats


def _compose_waves(a, b):
    """``b`` after ``a``: the product ``b @ a`` as XLA:CPU compiles the
    reference's broadcast-multiply-sum -- per entry, an FMA chain over
    the inner index in order, from +0."""
    acc = torch.zeros_like(a)
    for jj in range(a.shape[-1]):
        acc = numerics.fma(b[..., :, jj, None], a[..., jj, None, :], acc)
    return acc


def _scan_last(mats):
    """The last prefix of ``jax.lax.associative_scan`` over ``mats``,
    composed in that function's order: pairs (0,1), (2,3), ... recurse;
    an odd tail is composed onto the prefix before it."""
    if len(mats) == 1:
        return mats[0]
    if len(mats) % 2:
        return _compose_waves(_scan_last(mats[:-1]), mats[-1])
    return _scan_last([_compose_waves(mats[i], mats[i + 1])
                       for i in range(0, len(mats), 2)])


def _tree_product(mats):
    """The balanced static product tree of the reference's Pallas slab
    body: pairs composed level by level, an odd level padded with the
    identity."""
    eye = torch.eye(mats[0].shape[-1], dtype=torch.float32,
                    device=mats[0].device)
    while len(mats) > 1:
        if len(mats) % 2:
            mats = mats + [eye.expand_as(mats[0])]
        mats = [_compose_waves(mats[i], mats[i + 1])
                for i in range(0, len(mats), 2)]
    return mats[0]


def _slab_waves_assoc(rem, rank, valid, g, mips, npe_e, pol, col, k,
                      *, tree=False):
    """The same slab through the associative wave-matrix product: the
    composite's last column is the dt vector.  ``tree`` picks the
    Pallas body's balanced tree (and the CUDA kernel's) instead of
    ``jax.lax.associative_scan``'s order."""
    j = rem.shape[1]
    a_mat, srem, scol, has = _slab_assoc_inputs(
        rem, rank, valid, g, mips, npe_e, pol, col, k)
    mats = _wave_matrices(a_mat, srem, k)
    comp = _tree_product(mats) if tree else _scan_last(mats)
    dt = torch.clamp_min(torch.where(has, comp[:, :k, k], 0.0), 0.0)
    t_wave = torch.where(has, numerics.cumsum_rows(dt), BIG)
    col_wave = torch.where(has, scol, j).to(torch.int32)
    return t_wave, col_wave


def event_scan_slab_ref(remaining, mips_eff, num_pe, k, tie=None,
                        policy=None, pe_blocked=None, row_ok=None,
                        live=None, *, assoc=True, tree=False):
    """Plain PyTorch slab forecast (the reference's
    ``event_scan_slab_xla``): each row's next ``k`` completions under
    uninterrupted Fig 8 dynamics, from one rank pass.  Returns (t_wave
    f32[R, k], time from now of the w-th completion, BIG-padded;
    col_wave i32[R, k], J-padded).  ``assoc`` picks the wave-matrix
    product over the sequential recurrence, ``tree`` its balanced-tree
    order (the kernel's) over ``associative_scan``'s; ``live`` False
    masks every row off.  Wave 0 is ``event_scan``'s (t_min, argmin)."""
    PLAIN_CALLS["event_scan_slab"] += 1
    if k < 1:
        raise ValueError("the slab needs k >= 1")
    r, j = remaining.shape
    remaining, tie, policy, pe_blocked, row_ok = _default_inputs(
        remaining, tie, policy, pe_blocked, row_ok)
    row_ok = _live_rows(row_ok, live)
    mips = mips_eff.to(torch.float32)[:, None]
    npe = num_pe.to(torch.float32)[:, None]
    pol = policy[:, None]
    npe_e, valid, g = _row_masks(remaining, npe, pol, pe_blocked[:, None],
                                 row_ok[:, None])
    rank, _, _ = _lexsort_rank(remaining, tie, valid)
    col = torch.arange(j, dtype=torch.int32,
                       device=remaining.device).expand(r, j)
    if assoc:
        return _slab_waves_assoc(remaining, rank, valid, g, mips, npe_e,
                                 pol, col, k, tree=tree)
    return _slab_waves(remaining, rank, valid, g, mips, npe_e, pol, col, k)


def _link_inputs(remaining, baud, bg, tie, cap):
    """Defaults and dtypes of the link scan: tie = column index, bg = 0,
    cap = None (no trunk).  Row vectors come back as [L]."""
    l, t_n = remaining.shape
    dev = remaining.device
    if tie is None:
        tie = torch.arange(t_n, dtype=torch.float32,
                           device=dev).expand(l, t_n)
    if bg is None:
        bg = torch.zeros((l,), dtype=torch.float32, device=dev)
    f32 = torch.float32
    return (remaining.to(f32), baud.to(f32).reshape(l),
            bg.to(f32).reshape(l), tie.to(f32),
            None if cap is None else cap.to(f32).reshape(l))


def link_scan_ref(remaining, baud, bg=None, tie=None, cap=None):
    """Plain PyTorch fair-share link scan (the semantics of the
    reference's ``_link_math`` / ``link_scan_xla`` as compiled).  A row
    whose baud is not in (0, BIG) is dead; a slot holds a transfer when
    its remaining is in (0, BIG); subnormals count as zero.  Returns
    (rate [L,T], t_min [L], argmin_col [L] i32, occupancy [L] i32);
    argmin_col is T for empty or dead rows."""
    PLAIN_CALLS["link_scan"] += 1
    l, t_n = remaining.shape
    rem, baud, bg, tie, cap = _link_inputs(remaining, baud, bg, tie, cap)
    baud, bg = baud[:, None], bg[:, None]
    live = (baud >= TINY) & (baud < BIG)
    valid = (rem >= TINY) & (rem < BIG) & live
    m = valid.sum(dim=1, keepdim=True).to(torch.float32)
    rate = torch.where(valid, baud / torch.clamp_min(m + bg, 1.0), 0.0)
    if cap is not None:
        rate = torch.where(valid, torch.minimum(rate, cap[:, None]), 0.0)
    t = torch.where(valid, rem / torch.clamp_min(rate, 1e-30), BIG)
    tmin = t.min(dim=1, keepdim=True).values
    tkey = torch.where(valid, tie, BIG)
    at_min = (t <= tmin) & valid
    cand = torch.where(at_min, tkey, BIG)
    tie_min = cand.min(dim=1, keepdim=True).values
    col = torch.arange(t_n, dtype=torch.int32, device=rem.device)
    amin = torch.where(at_min & (cand <= tie_min), col, t_n).min(
        dim=1).values
    return rate, tmin[:, 0], amin, m[:, 0].to(torch.int32)


class LinkRows(NamedTuple):
    """The per-row inputs of the engine's link scan, [L] each: the link
    baud and background flows (f32) and, with shared trunks (else None),
    the row's trunk id (i32, -1 = private) and its trunk's baud and
    background flows (f32), as ``network.trunk_topology`` gives them."""
    baud: torch.Tensor
    bg: torch.Tensor
    trunk_of: torch.Tensor | None = None
    trunk_baud: torch.Tensor | None = None
    trunk_bg: torch.Tensor | None = None


def link_scan_tabled_ref(link_gridlet, link_rem, rows):
    """Plain PyTorch engine link scan: what the reference engine's
    ``_link_scan`` computes around its kernel.  link_gridlet i32[L, T]
    (gridlet index, -1 = free slot) gives the tie key (the gridlet
    index, 2^30 on a free slot); link_rem f32[L, T] the remaining bytes;
    ``rows`` a :class:`LinkRows`.  With trunks, each row's occupancy is
    counted as the scan counts m and ``network.trunk_rate_cap`` caps
    its rate.  Returns :func:`link_scan_ref`'s outputs (one plain
    ``link_scan`` call)."""
    tie = torch.where(link_gridlet >= 0, link_gridlet, 2 ** 30).to(
        torch.float32)
    cap = None
    if rows.trunk_of is not None:
        live = (rows.baud >= TINY) & (rows.baud < BIG)
        valid = (link_rem >= TINY) & (link_rem < BIG) & live[:, None]
        occ = valid.to(torch.float32).sum(dim=1)
        cap = network.trunk_rate_cap(occ, rows.trunk_of, rows.trunk_baud,
                                     rows.trunk_bg)
    return link_scan_ref(link_rem, rows.baud, bg=rows.bg, tie=tie, cap=cap)


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


def event_frontier_lanes_ref(cand, sizes, cuts=None):
    """Plain PyTorch event frontier over scenario lanes: cand f32[L, C],
    each row laid out as ``sizes`` says, cuts bool[L, C] (default all).
    Every lane's outputs are :func:`event_frontier_ref`'s bitwise (a
    minimum and a count are exact in any order).  Returns (t_star [L],
    fired bool[L, S], counts i32[L, S], t_safe [L], per_source_min f32
    [L, S])."""
    PLAIN_CALLS["event_frontier_lanes"] += 1
    n_lanes, c = cand.shape
    n_src = len(sizes)
    if sum(sizes) != c:
        raise ValueError("segment layout out of sync with candidates")
    dev = cand.device
    cand = cand.to(torch.float32)
    seg = _segment_ids(sizes, dev).expand(n_lanes, c)
    inf = torch.full((n_lanes, n_src), INF, dtype=torch.float32, device=dev)
    mins = inf.scatter_reduce(1, seg, cand, "amin")
    if n_src == 0:
        t_inf = torch.full((n_lanes,), INF, device=dev)
        return t_inf, mins > 0, mins.to(torch.int32), t_inf, mins
    t_star = mins.min(dim=1).values
    due = (cand <= t_star[:, None]) & (cand < INF)
    counts = torch.zeros((n_lanes, n_src), dtype=torch.int32,
                         device=dev).scatter_add(1, seg, due.to(torch.int32))
    cut = cand if cuts is None else torch.where(
        cuts.to(torch.float32) > 0.5, cand, INF)
    safe = inf.scatter_reduce(1, seg, cut, "amin")
    fired = torch.isfinite(mins) & (mins <= t_star[:, None])
    return t_star, fired, counts, safe.min(dim=1).values, mins


# ----------------------------------------------------------------------
# CUDA kernels (csrc/event_scan.cu), built at first use
# ----------------------------------------------------------------------

class Scratch:
    """The kernel outputs one engine run reuses.  Each layout has two
    sets, handed out in turn: a call's outputs stay intact through the
    next call of that layout and are rewritten by the one after.  The
    engine reads every result of a scan, a link scan or a frontier
    before the call after next (a scan's rank is at most the next scan's
    carry; a link scan's rates and forecasts are read only in the
    superstep that made them; a horizon's t_safe lives until the next
    committing frontier), so it never holds a result that a call
    rewrites.  A set is its tensors and their data pointers."""

    def __init__(self):
        self._rings = {}

    def take(self, key, make):
        ring = self._rings.get(key)
        if ring is None:
            ring = self._rings[key] = [None, None, 0]
        i = ring[2]
        ring[2] = 1 - i
        if ring[i] is None:
            outs = make()
            ring[i] = (outs, tuple(t.data_ptr() for t in outs))
        return ring[i]


def _scan_outputs(r, j, dev):
    """(rate, t_min, argmin, occupancy, rank, row flags) of a checked
    scan."""
    f32, i32 = torch.float32, torch.int32
    return (torch.empty((r, j), dtype=f32, device=dev),
            torch.empty((r,), dtype=f32, device=dev),
            torch.empty((r,), dtype=i32, device=dev),
            torch.empty((r,), dtype=i32, device=dev),
            torch.empty((r, j), dtype=f32, device=dev),
            torch.empty((r,), dtype=i32, device=dev))


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
            r, j, _stream(dev))
        _raise_on(err, "event_scan")
        LAUNCHES["event_scan"] += 1
    res = (rate, tmin, amin, occ)
    if with_rank:
        res = res + (rank if rank is not None else rank_out,)
    return res


def event_scan_checked_cuda(row_gridlet, remaining, mips_eff, num_pe,
                            policy, pe_blocked, row_ok, rank_carry, slab_ok,
                            n_reseeds, *, scratch=None):
    """:func:`event_scan_checked_ref` as one launcher call: two kernels
    (the per-row check, then the scan, which reads the check's flags),
    no host read; the same outputs bitwise and the same count added to
    ``n_reseeds``, on the device.  With ``scratch`` (an engine run's
    :class:`Scratch`) the inputs are taken as the engine makes them,
    unchecked, and the outputs are the scratch's; without it every
    input is checked and the outputs are new."""
    if remaining.device.type != "cuda":
        raise ValueError("event_scan_checked_cuda takes CUDA tensors")
    r, j = row_gridlet.shape
    dev = remaining.device
    if scratch is None:
        f32 = torch.float32
        _check(row_gridlet, "row_gridlet", (r, j), torch.int32, dev)
        _check(remaining, "remaining", (remaining.shape[0],), f32, dev)
        for name, v in (("mips_eff", mips_eff), ("num_pe", num_pe),
                        ("policy", policy), ("pe_blocked", pe_blocked),
                        ("row_ok", row_ok)):
            _check(v, name, (r,), f32, dev)
        _check(rank_carry, "rank_carry", (r, j), f32, dev)
        _check(slab_ok, "slab_ok", (), torch.bool, dev)
        _check(n_reseeds, "n_reseeds", (), torch.int32, dev)
        outs = _scan_outputs(r, j, dev)
        out_ptrs = tuple(t.data_ptr() for t in outs)
    else:
        outs, out_ptrs = scratch.take(("event_scan", r, j),
                                      lambda: _scan_outputs(r, j, dev))
    if r:
        rate, tmin, amin, occ, rank, flags = out_ptrs
        err = _lib().event_scan_checked_launch(
            row_gridlet.data_ptr(), remaining.data_ptr(), remaining.shape[0],
            mips_eff.data_ptr(), num_pe.data_ptr(), policy.data_ptr(),
            pe_blocked.data_ptr(), row_ok.data_ptr(), rank_carry.data_ptr(),
            slab_ok.data_ptr(), flags, n_reseeds.data_ptr(), rate, tmin,
            amin, occ, rank, r, j, _stream(dev))
        _raise_on(err, "event_scan")
        LAUNCHES["event_scan"] += 1
    return outs[:5]


def _scan_lane_outputs(n_lanes, r, j, dev):
    """(rate, t_min, argmin, occupancy, rank, row flags, use) of a checked
    scan over lanes."""
    f32, i32 = torch.float32, torch.int32
    return (torch.empty((n_lanes, r, j), dtype=f32, device=dev),
            torch.empty((n_lanes, r), dtype=f32, device=dev),
            torch.empty((n_lanes, r), dtype=i32, device=dev),
            torch.empty((n_lanes, r), dtype=i32, device=dev),
            torch.empty((n_lanes, r, j), dtype=f32, device=dev),
            torch.empty((n_lanes, r), dtype=i32, device=dev),
            torch.empty((n_lanes,), dtype=torch.bool, device=dev))


def event_scan_checked_lanes_cuda(row_gridlet, remaining, mips_eff, num_pe,
                                  policy, pe_blocked, row_ok, rank_carry,
                                  slab_ok, *, reseed=True, scratch=None):
    """:func:`event_scan_checked_lanes_ref` as one launcher call: the
    checked form's two kernels on an (R, L) grid, each lane deciding its
    own carry; the same outputs bitwise, no host read.  With ``scratch``
    (a sweep run's :class:`Scratch`) the inputs are taken as the engine
    makes them, unchecked, and the outputs are the scratch's; without
    it every input is checked and the outputs are new."""
    if remaining.device.type != "cuda":
        raise ValueError("event_scan_checked_lanes_cuda takes CUDA tensors")
    n_lanes, r, j = row_gridlet.shape
    dev = remaining.device
    if scratch is None:
        f32 = torch.float32
        _check(row_gridlet, "row_gridlet", (n_lanes, r, j), torch.int32, dev)
        _check(remaining, "remaining", (n_lanes, remaining.shape[-1]), f32,
               dev)
        for name, v in (("mips_eff", mips_eff), ("num_pe", num_pe),
                        ("policy", policy), ("pe_blocked", pe_blocked),
                        ("row_ok", row_ok)):
            _check(v, name, (n_lanes, r), f32, dev)
        _check(rank_carry, "rank_carry", (n_lanes, r, j), f32, dev)
        _check(slab_ok, "slab_ok", (n_lanes,), torch.bool, dev)
        outs = _scan_lane_outputs(n_lanes, r, j, dev)
        out_ptrs = tuple(t.data_ptr() for t in outs)
    else:
        outs, out_ptrs = scratch.take(
            ("event_scan_lanes", n_lanes, r, j),
            lambda: _scan_lane_outputs(n_lanes, r, j, dev))
    if n_lanes and r:
        rate, tmin, amin, occ, rank, flags, use = out_ptrs
        err = _lib().event_scan_checked_lanes_launch(
            row_gridlet.data_ptr(), remaining.data_ptr(), remaining.shape[-1],
            mips_eff.data_ptr(), num_pe.data_ptr(), policy.data_ptr(),
            pe_blocked.data_ptr(), row_ok.data_ptr(), rank_carry.data_ptr(),
            slab_ok.data_ptr(), flags, use, int(bool(reseed)), rate, tmin,
            amin, occ, rank, n_lanes, r, j, _stream(dev))
        _raise_on(err, "event_scan_lanes")
        LAUNCHES["event_scan_lanes"] += 1
    return outs[:5], outs[6]


@functools.lru_cache(maxsize=None)
def event_scan_slab_max_k(j):
    """The largest ``k`` whose associative slab keeps its k + ceil(k/2)
    (k+1)x(k+1) wave matrices in the card's shared memory beside the
    row of width ``j`` (32 at J = 640; the launcher's own count), 0
    where none does.  :func:`event_scan_slab_cuda` stages a larger k's
    matrices in a global workspace."""
    out = _lib().event_scan_slab_max_k(j)
    if out < 0:
        _raise_on(-out, "event_scan_slab")
    return out


def event_scan_slab_cuda(remaining, mips_eff, num_pe, k, tie=None,
                         policy=None, pe_blocked=None, row_ok=None,
                         live=None, *, assoc=True):
    """:func:`event_scan_slab_ref` as one CUDA kernel launch (same
    arguments and outputs, bitwise; the associative form composes in
    the balanced tree, as ``event_scan_slab_ref(tree=True)`` does), for
    every ``k >= 1``: the associative form above
    :func:`event_scan_slab_max_k` keeps its wave matrices in a
    [R, k + ceil(k/2), k+1, k+1] f32 workspace.  A row too wide for
    shared memory is refused at launch (``RuntimeError``)."""
    if remaining.device.type != "cuda":
        raise ValueError("event_scan_slab_cuda takes CUDA tensors")
    if k < 1:
        raise ValueError("the slab needs k >= 1")
    r, j = remaining.shape
    dev = remaining.device
    remaining, tie, policy, pe_blocked, row_ok = _default_inputs(
        remaining, tie, policy, pe_blocked, row_ok)
    row_ok = _live_rows(row_ok, live)
    remaining, tie, policy, pe_blocked, row_ok = (
        x.contiguous() for x in (remaining, tie, policy, pe_blocked, row_ok))
    mips = mips_eff.to(torch.float32).contiguous()
    npe = num_pe.to(torch.float32).contiguous()
    f32 = torch.float32
    _check(remaining, "remaining", (r, j), f32, dev)
    _check(tie, "tie", (r, j), f32, dev)
    for name, v in (("mips_eff", mips), ("num_pe", npe),
                    ("policy", policy), ("pe_blocked", pe_blocked),
                    ("row_ok", row_ok)):
        _check(v, name, (r,), f32, dev)
    t_wave = torch.empty((r, k), dtype=f32, device=dev)
    col_wave = torch.empty((r, k), dtype=torch.int32, device=dev)
    if r:
        work = None
        if assoc and k > event_scan_slab_max_k(j):
            work = torch.empty((r, k + (k + 1) // 2, k + 1, k + 1),
                               dtype=f32, device=dev)
        err = _lib().event_scan_slab_launch(
            _ptr(remaining), _ptr(tie), _ptr(mips), _ptr(npe), _ptr(policy),
            _ptr(pe_blocked), _ptr(row_ok), _ptr(t_wave), _ptr(col_wave),
            _ptr(work), r, j, k, int(bool(assoc)), _stream(dev))
        _raise_on(err, "event_scan_slab")
        LAUNCHES["event_scan_slab"] += 1
    return t_wave, col_wave


def _link_outputs(l, t_n, dev):
    """(rate, t_min, argmin, occupancy) of a link scan."""
    f32, i32 = torch.float32, torch.int32
    return (torch.empty((l, t_n), dtype=f32, device=dev),
            torch.empty((l,), dtype=f32, device=dev),
            torch.empty((l,), dtype=i32, device=dev),
            torch.empty((l,), dtype=i32, device=dev))


def link_scan_cuda(remaining, baud, bg=None, tie=None, cap=None):
    """:func:`link_scan_ref` as one CUDA kernel launch (same arguments,
    same outputs, bitwise).  ``cap`` None launches the kernel with a
    null cap pointer: the private-link form."""
    if remaining.device.type != "cuda":
        raise ValueError("link_scan_cuda takes CUDA tensors")
    l, t_n = remaining.shape
    dev = remaining.device
    rem, baud, bg, tie, cap = (
        None if x is None else x.contiguous()
        for x in _link_inputs(remaining, baud, bg, tie, cap))
    f32 = torch.float32
    _check(rem, "remaining", (l, t_n), f32, dev)
    _check(tie, "tie", (l, t_n), f32, dev)
    for name, v in (("baud", baud), ("bg", bg), ("cap", cap)):
        if v is not None:
            _check(v, name, (l,), f32, dev)
    outs = _link_outputs(l, t_n, dev)
    if l:
        err = _lib().link_scan_launch(
            _ptr(rem), _ptr(tie), None, _ptr(baud), _ptr(bg), _ptr(cap),
            None, None, None, *(_ptr(t) for t in outs), l, t_n,
            _stream(dev))
        _raise_on(err, "link_scan")
        LAUNCHES["link_scan"] += 1
    return outs


def link_scan_tabled_cuda(link_gridlet, link_rem, rows, *, scratch=None):
    """:func:`link_scan_tabled_ref` as one kernel launch: the tie key
    read from the slot map and, with trunks, every trunk's occupancy and
    cap computed in the kernel (no host read); the same outputs bitwise.
    With ``scratch`` (an engine run's :class:`Scratch`) the inputs are
    taken as the engine makes them, unchecked, and the outputs are the
    scratch's; without it every input is checked and the outputs are
    new."""
    if link_rem.device.type != "cuda":
        raise ValueError("link_scan_tabled_cuda takes CUDA tensors")
    l, t_n = link_rem.shape
    dev = link_rem.device
    if scratch is None:
        f32 = torch.float32
        _check(link_gridlet, "link_gridlet", (l, t_n), torch.int32, dev)
        _check(link_rem, "link_rem", (l, t_n), f32, dev)
        for name, v, dtype in zip(LinkRows._fields, rows,
                                  (f32, f32, torch.int32, f32, f32)):
            if v is not None:
                _check(v, name, (l,), dtype, dev)
        outs = _link_outputs(l, t_n, dev)
        out_ptrs = tuple(t.data_ptr() for t in outs)
    else:
        outs, out_ptrs = scratch.take(("link_scan", l, t_n),
                                      lambda: _link_outputs(l, t_n, dev))
    if l:
        trunks = ((None,) * 3 if rows.trunk_of is None else
                  (rows.trunk_of.data_ptr(), rows.trunk_baud.data_ptr(),
                   rows.trunk_bg.data_ptr()))
        err = _lib().link_scan_launch(
            link_rem.data_ptr(), None, link_gridlet.data_ptr(),
            rows.baud.data_ptr(), rows.bg.data_ptr(), None, *trunks,
            *out_ptrs, l, t_n, _stream(dev))
        _raise_on(err, "link_scan")
        LAUNCHES["link_scan"] += 1
    return outs


@functools.lru_cache(maxsize=64)
def _segment_offsets(sizes, device):
    """Device int32 [S+1] segment offsets for a static layout (the
    engine asks for the same few layouts on every superstep)."""
    acc = [0]
    for n in sizes:
        acc.append(acc[-1] + n)
    return torch.tensor(acc, dtype=torch.int32, device=device)


def _frontier_outputs(n_src, dev):
    """(t_star, fired, counts, t_safe, per-source min) of a frontier."""
    f32 = torch.float32
    return (torch.empty((), dtype=f32, device=dev),
            torch.empty((n_src,), dtype=torch.bool, device=dev),
            torch.empty((n_src,), dtype=torch.int32, device=dev),
            torch.empty((), dtype=f32, device=dev),
            torch.empty((n_src,), dtype=f32, device=dev))


def _frontier_lane_outputs(n_lanes, n_src, dev):
    """(t_star, fired, counts, t_safe, per-source min) of a frontier over
    lanes."""
    f32 = torch.float32
    return (torch.empty((n_lanes,), dtype=f32, device=dev),
            torch.empty((n_lanes, n_src), dtype=torch.bool, device=dev),
            torch.empty((n_lanes, n_src), dtype=torch.int32, device=dev),
            torch.empty((n_lanes,), dtype=f32, device=dev),
            torch.empty((n_lanes, n_src), dtype=f32, device=dev))


def event_frontier_lanes_cuda(cand, sizes, cuts=None, *, scratch=None):
    """:func:`event_frontier_lanes_ref` as one CUDA kernel launch, one
    block a lane.  With ``scratch`` (a sweep run's :class:`Scratch`; the
    engine's candidates are f32 and contiguous) the candidates are taken
    unchecked and the outputs are the scratch's; without it the inputs
    are cast and checked and the outputs are new."""
    if cand.device.type != "cuda":
        raise ValueError("event_frontier_lanes_cuda takes CUDA tensors")
    n_lanes, c = cand.shape
    n_src = len(sizes)
    dev = cand.device
    if scratch is None:
        if sum(sizes) != c:
            raise ValueError("segment layout out of sync with candidates")
        cand = cand.to(torch.float32).contiguous()
        _check(cand, "cand", (n_lanes, c), torch.float32, dev)
        if cuts is not None:
            cuts = cuts.to(torch.float32).contiguous()
            _check(cuts, "cuts", (n_lanes, c), torch.float32, dev)
        outs = _frontier_lane_outputs(n_lanes, n_src, dev)
        out_ptrs = tuple(t.data_ptr() for t in outs)
    else:
        outs, out_ptrs = scratch.take(
            ("event_frontier_lanes", n_lanes, n_src),
            lambda: _frontier_lane_outputs(n_lanes, n_src, dev))
    if n_lanes:
        off = _segment_offsets(tuple(sizes), dev)
        err = _lib().event_frontier_lanes_launch(
            cand.data_ptr(), None if cuts is None else cuts.data_ptr(),
            off.data_ptr(), n_src, c, n_lanes, *out_ptrs, _stream(dev))
        _raise_on(err, "event_frontier_lanes")
        LAUNCHES["event_frontier_lanes"] += 1
    return outs


def event_frontier_cuda(cand, sizes, cuts=None, *, scratch=None):
    """:func:`event_frontier_ref` as one CUDA kernel launch, which writes
    all five outputs.  With ``scratch`` (an engine run's
    :class:`Scratch`; the engine's candidates are f32, contiguous and
    laid out as ``sizes`` says) the candidates are taken unchecked and
    the outputs are the scratch's; without it the inputs are cast and
    checked and the outputs are new."""
    if cand.device.type != "cuda":
        raise ValueError("event_frontier_cuda takes CUDA tensors")
    n_src = len(sizes)
    c = cand.shape[0]
    dev = cand.device
    if scratch is None:
        if sum(sizes) != c:
            raise ValueError("segment layout out of sync with candidates")
        cand = cand.to(torch.float32).contiguous()
        _check(cand, "cand", (c,), torch.float32, dev)
        if cuts is not None:
            cuts = cuts.to(torch.float32).contiguous()
            _check(cuts, "cuts", (c,), torch.float32, dev)
        outs = _frontier_outputs(n_src, dev)
        out_ptrs = tuple(t.data_ptr() for t in outs)
    else:
        outs, out_ptrs = scratch.take(("event_frontier", n_src),
                                      lambda: _frontier_outputs(n_src, dev))
    off = _segment_offsets(tuple(sizes), dev)
    err = _lib().event_frontier_launch(
        cand.data_ptr(), None if cuts is None else cuts.data_ptr(),
        off.data_ptr(), n_src, c, *out_ptrs, _stream(dev))
    _raise_on(err, "event_frontier")
    LAUNCHES["event_frontier"] += 1
    return outs
