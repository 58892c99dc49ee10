"""Segmented (grouped) array utilities (port of ``repro.core.segments``).

Flat per-element arrays over one table of ``N`` elements in
``n_groups`` segments; ordering inside a segment is (order_key, index).
The lexsort is two stable sorts: by ``order_key`` (ties keep index
order), then by segment.  The f32 prefix sum adds in the reference's
compiled order (:func:`numerics.cumsum`).
"""
from __future__ import annotations

import torch

from . import numerics

BIG = 2 ** 30


def _group_order(gk, order_key):
    o1 = torch.sort(order_key, stable=True).indices
    o2 = torch.sort(gk[o1], stable=True).indices
    return o1[o2]


def group_rank(group_key, member_mask, order_key, n_groups):
    """Rank of each member within its group, ordered by (order_key,
    index); non-members get BIG.  Returns (rank i32[N], counts
    i32[n_groups])."""
    n = group_key.shape[0]
    dev = group_key.device
    idx = torch.arange(n, device=dev)
    gk = torch.where(member_mask, group_key.to(torch.int64), n_groups)
    order = _group_order(gk, order_key)
    sorted_g = gk[order]
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = sorted_g[1:] != sorted_g[:-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), 0).values
    rank_sorted = idx - seg_start
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[order] = rank_sorted
    rank = torch.where(member_mask, rank, BIG).to(torch.int32)
    counts = torch.bincount(gk, minlength=n_groups + 1)[:n_groups]
    return rank, counts.to(torch.int32)


def group_prefix_sum(group_key, member_mask, order_key, values, n_groups):
    """Exclusive prefix sum of ``values`` within each group in
    (order_key, index) order.  Non-members get 0.  values must be >= 0.
    Same arithmetic as the reference: one global running sum, rebased at
    each segment start."""
    n = group_key.shape[0]
    dev = group_key.device
    gk = torch.where(member_mask, group_key.to(torch.int64), n_groups)
    v = torch.where(member_mask, values.to(torch.float32), 0.0)
    order = _group_order(gk, order_key)
    sv = v[order]
    sg = gk[order]
    cs = numerics.cumsum(sv)                  # inclusive, global
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = sg[1:] != sg[:-1]
    base = torch.cummax(torch.where(is_start, cs - sv, -float("inf")),
                        0).values
    excl_sorted = cs - sv - base              # exclusive within segment
    out = torch.empty(n, dtype=torch.float32, device=dev)
    out[order] = excl_sorted
    return torch.where(member_mask, out, 0.0)


def segment_count(mask, seg, n_seg: int):
    """Integer ``segment_sum`` of a bool mask, i32[n_seg] (exact in any
    order); ids outside ``[0, n_seg)`` are dropped."""
    seg = seg.to(torch.int64)
    keep = mask & (seg >= 0) & (seg < n_seg)
    return torch.zeros(n_seg + 1, dtype=torch.int32,
                       device=seg.device).index_add_(
        0, torch.where(keep, seg, n_seg), keep.to(torch.int32))[:n_seg]


def segment_min(values, seg, n_seg: int):
    """``jax.ops.segment_min`` of f32 ``values`` (+inf for empty
    segments; a minimum is exact in any order)."""
    out = torch.full((n_seg,), float("inf"), dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce(0, seg.to(torch.int64), values, "amin")
