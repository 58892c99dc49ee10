"""The float semantics of the reference's compiled program, in PyTorch.

The JAX reference runs its engine as one XLA:CPU program, and three of
XLA's choices decide its low bits.  The port reproduces each one
exactly, on the CPU and on the card alike, because the parity bar for
times and spend is bitwise:

* **Contraction.**  Inside a fused loop XLA:CPU turns ``c + a * b``
  into one fused multiply-add (one rounding).  :func:`fma` is that
  operation, correctly rounded, built from float64 arithmetic (the
  product of two f32 values is exact in f64; a TwoSum error term breaks
  the one case where rounding twice could differ: an f64 sum landing
  exactly on an f32 midpoint).
* **Division by a constant.**  Under ``jit`` XLA rewrites ``x / c`` as
  ``x * (1 / c)`` for a literal ``c``.  :func:`div_const` does the same.
  Eager JAX code keeps the true division (PyTorch's ``/`` by a tensor).
* **Cumulative sums.**  XLA:CPU lowers ``cumsum`` through a two-level
  scan over tiles of 16 (:func:`cumsum`); ``segment_sum`` adds in index
  order, and ``x + segment_sum(...)`` becomes one scatter-add into ``x``
  (:func:`segment_sum`).  ``torch.cumsum`` and ``index_add_``
  use other orders (the card's ``index_add_`` even changes its order
  from run to run through atomics), so neither is used on float data.

Division by a Python number is avoided everywhere on the card: PyTorch's
CUDA ``true_divide`` by a CPU scalar multiplies by the reciprocal.
"""
from __future__ import annotations

import torch

_TILE = 16        # XLA:CPU's cumulative-reduction tile


def fma(a, b, c):
    """Correctly rounded f32 ``a * b + c`` (tensors broadcast; a Python
    number enters as its f32 rounding, like a JAX weak-typed scalar)."""
    dev = next(x.device for x in (a, b, c) if isinstance(x, torch.Tensor))
    a64, b64, c64 = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                     .to(torch.float64) for x in (a, b, c))
    p = a64 * b64                                  # exact
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)                # exact: p + c - s
    r = s.to(torch.float32)
    r64 = r.to(torch.float64)
    d = s - r64                                    # exact
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    dn = torch.nextafter(r, torch.full_like(r, -float("inf")))
    other = torch.where(d > 0, up, dn)
    midpoint = (d != 0) & (other.to(torch.float64) - s == d)
    toward_other = (e != 0) & ((e > 0) == (d > 0))
    fixed = torch.where(midpoint & toward_other, other, r)
    return torch.where(torch.isfinite(s), fixed, r)


def div_const(x, c: float):
    """``x / c`` for a literal ``c`` as XLA compiles it under jit."""
    inv = torch.tensor(1.0 / c, dtype=torch.float32).item()
    return x * inv


def _seq_scan_cols(t):
    """Inclusive left-to-right running sum along dim 1, one add at a
    time (f32)."""
    out = torch.empty_like(t)
    acc = torch.zeros_like(t[:, 0])
    for j in range(t.shape[1]):
        acc = acc + t[:, j]
        out[:, j] = acc
    return out


def cumsum(x):
    """XLA:CPU's f32 ``cumsum`` of a 1-D tensor, bit for bit: tiles of
    16 summed left to right, tile totals scanned recursively the same
    way, then each tile's running sums offset by the total before it."""
    n = x.shape[0]
    if n <= _TILE:
        return _seq_scan_cols(x.reshape(1, n)).reshape(n)
    nt = -(-n // _TILE)
    xp = torch.zeros(nt * _TILE, dtype=x.dtype, device=x.device)
    xp[:n] = x
    within = _seq_scan_cols(xp.reshape(nt, _TILE))
    pref = cumsum(within[:, -1].contiguous())
    out = torch.cat([within[:1], within[1:] + pref[:-1, None]])
    return out.reshape(-1)[:n]


def segment_sum(values, seg, n_seg: int, width: int, init=None):
    """``jax.ops.segment_sum`` of f32 ``values``: each segment's members
    added in index order, starting from +0.0 -- or from ``init`` [n_seg]
    for ``init + segment_sum(...)``, which XLA folds into one scatter-add
    into ``init``.  ``width`` is a static bound on the members of any
    segment; ids outside ``[0, n_seg)`` are dropped.  One add per
    position, vectorised over segments."""
    n = values.shape[0]
    seg = seg.to(torch.int64)
    seg = torch.where((seg >= 0) & (seg < n_seg), seg,
                      torch.full_like(seg, n_seg))
    order = torch.sort(seg, stable=True).indices
    sseg = seg[order]
    counts = torch.bincount(sseg, minlength=n_seg + 1)
    start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=values.device) - start[sseg]
    table = torch.zeros((n_seg + 1) * width + 1, dtype=values.dtype,
                        device=values.device)
    flat = torch.where((sseg < n_seg) & (pos < width), sseg * width + pos,
                       torch.full_like(pos, (n_seg + 1) * width))
    table[flat] = values[order]
    table = table[:n_seg * width].reshape(n_seg, width)
    acc = torch.zeros(n_seg, dtype=values.dtype, device=values.device) \
        if init is None else init
    for p in range(width):
        acc = acc + table[:, p]
    return acc
