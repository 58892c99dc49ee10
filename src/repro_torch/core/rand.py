"""``gridsim.GridSimRandom`` on a PyTorch threefry2x32 (port of
``repro.core.rand``), bit for bit the reference's ``jax.random``.

``real(d, f_L, f_M)`` maps a predicted value ``d`` to a random value in
``[(1-f_L)*d, (1+f_M)*d]`` via ``d * (1 - f_L + (f_L + f_M) * rd)``,
``rd ~ U[0, 1)``; ``exponential`` draws the MTBF/MTTR holding times.

A key is an int64 tensor ``[2]`` holding two uint32 words (a batch of
keys is ``[n, 2]``), as ``jax.random.PRNGKey`` lays them out; every
word stays in ``[0, 2**32)``: sums and shifts are masked with
``& 0xFFFFFFFF`` (PyTorch's ``uint32`` has too few CUDA operations to
count on).  The hash is ``jax._src.prng.threefry_2x32`` (20 rounds,
key schedule with the 0x1BD11BDA parity word); ``split`` and
``random_bits`` follow both of jax's counter layouts, picked by the
``partitionable`` argument: ``True`` is jax 0.9.0's default
(``jax_threefry_partitionable``), ``False`` the layout older goldens
were drawn with.  ``uniform`` keeps the top 23 bits as the mantissa of a
float in [1, 2) less 1, and ``exponential`` is ``-log1p(-u)`` with
XLA:CPU's own ``log1p`` (:func:`numerics.log1p`).
"""
from __future__ import annotations

import torch

from . import numerics

FACTORS = {
    "exec": (0.0, 0.10),       # paper section 5.2: 0..10% positive side
    "net_io": (0.05, 0.05),
    "none": (0.0, 0.0),
}

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32-bit
    words (an int32 seed, as jax takes a Python int with 64-bit types
    off, has a zero high word)."""
    seed = int(seed)
    hi = 0 if -2 ** 31 <= seed < 2 ** 31 else (seed >> 32) & MASK
    return torch.tensor([hi, seed & MASK], dtype=torch.int64, device=device)


def _rotl(v, r: int):
    return ((v << r) & MASK) | (v >> (32 - r))


def threefry2x32(key, x0, x1):
    """The threefry2x32 hash of the counter pairs ``(x0, x1)`` (int64
    tensors of one shape) under ``key`` (int64 ``[2]``)."""
    k0, k1 = key[0], key[1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def _iota(n: int, device):
    return torch.arange(n, dtype=torch.int64, device=device)


def _hash_flat(key, counts):
    """``threefry_2x32(key, counts)`` of the original layout: the flat
    counter vector split in halves (zero-padded to an even length)."""
    n = counts.shape[0]
    if n % 2:
        counts = torch.cat([counts, counts.new_zeros(1)])
    half = counts.shape[0] // 2
    o0, o1 = threefry2x32(key, counts[:half], counts[half:])
    return torch.cat([o0, o1])[:n]


def split(key, num: int = 2, partitionable: bool = True):
    """``jax.random.split(key, num)``: int64 ``[num, 2]``."""
    dev = key.device
    if partitionable:
        b0, b1 = threefry2x32(key, torch.zeros(num, dtype=torch.int64,
                                               device=dev), _iota(num, dev))
        return torch.stack([b0, b1], dim=1)
    return _hash_flat(key, _iota(2 * num, dev)).reshape(num, 2)


def random_bits(key, shape, partitionable: bool = True):
    """``jax.random.bits(key, shape)`` (32-bit words) as int64."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    dev = key.device
    if partitionable:
        b0, b1 = threefry2x32(key, torch.zeros(n, dtype=torch.int64,
                                               device=dev), _iota(n, dev))
        bits = b0 ^ b1
    else:
        bits = _hash_flat(key, _iota(n, dev))
    return bits.reshape(shape)


def uniform(key, shape, partitionable: bool = True, minval=None,
            maxval=None):
    """``jax.random.uniform(key, shape, float32)`` in [0, 1): the top 23
    random bits as the mantissa of a float in [1, 2), less one.  With
    ``minval``/``maxval`` (f32 scalars or tensors broadcasting to
    ``shape``) it is ``max(minval, u * (maxval - minval) + minval)``,
    the multiply-add fused into one rounding as XLA:CPU compiles it."""
    bits = random_bits(key, shape, partitionable)
    one = (bits >> 9) | 0x3F800000
    u = one.to(torch.int32).view(torch.float32) - 1.0
    if minval is None and maxval is None:
        return u
    lo = torch.as_tensor(0.0 if minval is None else minval,
                         dtype=torch.float32, device=u.device)
    hi = torch.as_tensor(1.0 if maxval is None else maxval,
                         dtype=torch.float32, device=u.device)
    return torch.maximum(lo, numerics.fma(u, hi - lo, lo))


def real(key, d, f_low, f_more, partitionable: bool = True):
    """Vectorised GridSimRandom.real; ``d`` may be any shaped tensor."""
    d = torch.as_tensor(d, dtype=torch.float32)
    rd = uniform(key.to(d.device), d.shape, partitionable)
    return d * (1.0 - f_low + (f_low + f_more) * rd)


def real_named(key, d, situation: str = "exec",
               partitionable: bool = True):
    f_low, f_more = FACTORS[situation]
    return real(key, d, f_low, f_more, partitionable)


def exponential(key, mean, partitionable: bool = True):
    """One exponential holding time per element of ``mean``: ``mean *
    -log1p(-u)``; +inf where the mean is not positive (the stream is
    off)."""
    mean = torch.as_tensor(mean, dtype=torch.float32)
    u = uniform(key.to(mean.device), mean.shape, partitionable)
    draw = mean * -numerics.log1p(-u)
    return torch.where(mean > 0.0, draw, float("inf"))
