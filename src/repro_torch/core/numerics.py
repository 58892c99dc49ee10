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
* **Full sums.**  XLA:CPU rewrites a reduction over more than 32
  elements into windows of 32 (zero padding split evenly at both ends)
  summed in order, then reduces the window sums the same way
  (:func:`ordered_sum`).

Every function here is written out of place (no write into a fresh
tensor, no ``bincount``, ``scatter_add`` where ``index_add``'s batching
rule would loop), so ``torch.func.vmap`` batches each op over the sweep
engine's scenario lanes in one call, one lane's adds never meeting
another's.

* **Transcendentals.**  XLA:CPU expands ``log1p`` into f32 arithmetic
  of its own (:func:`log1p`, with the fused multiply-adds its machine
  code has), and its ``exp2`` misses ``2**k`` by a few ulp for some
  integer ``k`` (:data:`EXP2_BITS`), so neither ``torch.log1p`` nor
  ``torch.exp2`` stands in for them.

Division by a Python number is avoided everywhere on the card: PyTorch's
CUDA ``true_divide`` by a CPU scalar multiplies by the reciprocal.
"""
from __future__ import annotations

import struct

import torch

_TILE = 16        # XLA:CPU's cumulative-reduction tile
_WINDOW = 32      # XLA:CPU's tree-reduction window


def _f32(bits: int) -> float:
    return struct.unpack("<f", struct.pack("<I", bits))[0]


# XLA:CPU's f32 exp2(k) for k = 0..30 (tests/data/port_ref_rand.json):
# 2**k exactly except k in {13, 15, 17, 19, 21, 23, 25, 26, 27, 29, 30},
# which miss by 4 to 15 ulp.
EXP2_BITS = (
    0x3F800000, 0x40000000, 0x40800000, 0x41000000, 0x41800000,
    0x42000000, 0x42800000, 0x43000000, 0x43800000, 0x44000000,
    0x44800000, 0x45000000, 0x45800000, 0x46000004, 0x46800000,
    0x46FFFFF8, 0x47800000, 0x48000004, 0x48800000, 0x48FFFFF9,
    0x49800000, 0x4A000004, 0x4A800000, 0x4AFFFFF9, 0x4B800000,
    0x4C000004, 0x4C800008, 0x4CFFFFF9, 0x4D800000, 0x4E000004,
    0x4E7FFFF1)


def exp2_table(k):
    """XLA:CPU's ``exp2`` of the integer-valued exponents ``k`` (int,
    clamped to the table's 0..30) as f32."""
    table = torch.tensor([_f32(b) for b in EXP2_BITS], dtype=torch.float32,
                         device=k.device)
    return table[torch.clamp(k.to(torch.int64), 0, len(EXP2_BITS) - 1)]


# log1p(x) for |x| < sqrt(2) - 1: x - x^2/2 + x^3 * P(x) / Q(x) (Cephes),
# both polynomials by Horner from the leading coefficient.
_LOG1P_SMALL = _f32(0x3ED413CD)            # 0.41421357
_LOG1P_Q = tuple(_f32(b) for b in (
    0x3F800000, 0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3,
    0x43586D8A, 0x42707982))
_LOG1P_P = tuple(_f32(b) for b in (
    0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C, 0x4273CC76,
    0x426473AD, 0x41A05101))
# log(y) = e * ln2 + log(m), m in [sqrt(1/2), sqrt(2)): three interleaved
# Horner chains in m - 1, ln2 split in a high and a low part.
_LOG_SQRTHF = _f32(0x3F3504F3)
_LOG_P = tuple(tuple(_f32(b) for b in chain) for chain in (
    (0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A),
    (0xBDFE5D4F, 0x3E11E9BF, 0xBE2AAE50),
    (0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA)))
_LN2_LO = _f32(0xB95E8083)
_LN2_HI = _f32(0x3F318000)


def _log(y):
    """XLA:CPU's f32 ``log`` of positive finite ``y``."""
    bits = torch.clamp_min(y, _f32(0x00800000)).view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    low = m < _LOG_SQRTHF
    e = torch.where(low, e - 1.0, e)
    x = (m + -1.0) + torch.where(low, m, 0.0)
    z = x * x
    x3 = z * x
    p = []
    for c0, c1, c2 in _LOG_P:
        p.append(fma(x, fma(x, c0, c1), c2))
    y1 = fma(x3, p[0], p[1])
    y1 = fma(x3, y1, p[2])
    y1 = fma(x3, y1, e * _LN2_LO)
    r = fma(-0.5, z, x) + y1
    return fma(e, _LN2_HI, r)


def log1p(x):
    """``jnp.log1p`` of f32 ``x`` > -1 as XLA:CPU compiles it: a rational
    function for |x| < sqrt(2) - 1, else ``log(1 + x)``; the fused
    multiply-adds are the ones its machine code has."""
    x2 = x * x
    q = torch.full_like(x, _LOG1P_Q[0])
    for c in _LOG1P_Q[1:]:
        q = fma(q, x, c)
    p = torch.full_like(x, _LOG1P_P[0])
    for c in _LOG1P_P[1:]:
        p = fma(p, x, c)
    small = fma(x2, -0.5, x2 * x * (p / q)) + x
    return torch.where(x.abs() < _LOG1P_SMALL, small, _log(1.0 + x))


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


def cumsum_rows(x):
    """XLA:CPU's f32 ``cumsum`` along dim 1 of a 2-D tensor, bit for
    bit: tiles of 16 summed left to right, tile totals scanned
    recursively the same way, then each tile's running sums offset by
    the total before it."""
    r, n = x.shape
    if n <= _TILE:
        return _seq_scan_cols(x)
    nt = -(-n // _TILE)
    xp = torch.cat([x, x.new_zeros((r, nt * _TILE - n))], dim=1)
    within = _seq_scan_cols(xp.reshape(r * nt, _TILE)).reshape(r, nt, _TILE)
    pref = cumsum_rows(within[:, :, -1].contiguous())
    out = torch.cat([within[:, :1], within[:, 1:] + pref[:, :-1, None]],
                    dim=1)
    return out.reshape(r, -1)[:, :n]


def cumsum(x):
    """XLA:CPU's f32 ``cumsum`` of a 1-D tensor (:func:`cumsum_rows`)."""
    return cumsum_rows(x.reshape(1, -1))[0]


def ordered_sum_rows(x):
    """XLA:CPU's f32 ``jnp.sum(x, axis=1)`` of a 2-D tensor, bit for bit:
    while a row holds more than 32 values, pad it with zeros to a
    multiple of 32 (half the padding in front, the odd one at the back)
    and sum each window of 32 left to right; the last <= 32 values are
    summed left to right."""
    r = x.shape[0]
    while x.shape[1] > _WINDOW:
        n = x.shape[1]
        pad = -(-n // _WINDOW) * _WINDOW - n
        x = torch.cat([x.new_zeros((r, pad // 2)), x,
                       x.new_zeros((r, pad - pad // 2))], dim=1)
        x = _seq_scan_cols(x.reshape(-1, _WINDOW))[:, -1].reshape(r, -1)
    if not x.shape[1]:
        return x.new_zeros((r,))
    return _seq_scan_cols(x)[:, -1].contiguous()


def ordered_sum(x):
    """XLA:CPU's f32 ``jnp.sum`` of a 1-D tensor (:func:`ordered_sum_rows`
    of one row)."""
    return ordered_sum_rows(x.reshape(1, -1))[0]


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
    counts = torch.zeros(n_seg + 1, dtype=torch.int64,
                         device=seg.device).scatter_add(
        0, sseg, torch.ones_like(sseg))
    start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=values.device) - start[sseg]
    flat = torch.where((sseg < n_seg) & (pos < width), sseg * width + pos,
                       torch.full_like(pos, (n_seg + 1) * width))
    table = torch.zeros((n_seg + 1) * width + 1, dtype=values.dtype,
                        device=values.device).index_put(
        (flat,), values[order])
    table = table[:n_seg * width].reshape(n_seg, width)
    acc = torch.zeros(n_seg, dtype=values.dtype, device=values.device) \
        if init is None else init
    for p in range(width):
        acc = acc + table[:, p]
    return acc
