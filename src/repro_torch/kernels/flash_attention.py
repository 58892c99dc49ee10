"""Forward attention with GQA, causal and sliding-window masks and tanh
soft-capping on Hopper.  Port of ``repro.kernels.flash_attention``.

q [B, Hq, Sq, d], k/v [B, Hkv, Skv, d] -> o [B, Hq, Sq, d]; query head
h reads kv head h // (Hq / Hkv).  Positions count from 0 for queries and
keys alike: causal keeps kv <= q, a window w keeps kv > q - w, and a cap
c maps each score s to tanh(s / c) * c.

Two implementations: the CUDA kernel (``csrc/flash_attention.cu``, an
online softmax over key tiles, launched by :func:`flash_attention_cuda`
for tensors on the card; both products run on Hopper's tensor cores: in
bf16 on ``wgmma``, in f32 as three TF32 products each on ``mma.sync``,
big.big + big.small + small.big of operands split as big = TF32(x),
small = TF32(x - big), within ~1e-6 of f32) and the plain PyTorch version
:func:`flash_attention_ref` (the materialised masked softmax in f32 of
the reference's oracle, for tensors on the CPU and as the kernel's
yardstick).  They agree to rounding: in f32 within the reference's own
kernel-vs-oracle tolerance (2e-5), in bf16 within 2e-2 of each query
row's largest |o| (the kernel rounds p to bf16 before PV).
"""
from __future__ import annotations

import torch

from ._launch import LAUNCHES, PLAIN_CALLS
from ._launch import check as _check
from ._launch import lib as _lib
from ._launch import ptr as _ptr
from ._launch import raise_on as _raise_on
from ._launch import stream as _stream

DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 128, 256)


def _mask(sq, skv, causal, window, device):
    qp = torch.arange(sq, device=device)[:, None]
    kp = torch.arange(skv, device=device)[None, :]
    keep = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        keep &= kp <= qp
    if window:
        keep &= kp > qp - window
    return keep


def flash_attention_ref(q, k, v, *, causal=True, window=0, cap=0.0):
    """Plain PyTorch attention: per (batch, head), the [Sq, Skv] scores
    in f32, capped, masked to -inf, softmax, times v in f32; the result
    in q's type.  One score matrix is alive at a time."""
    PLAIN_CALLS["flash_attention"] += 1
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    f32 = torch.float32
    keep = _mask(sq, skv, causal, window, q.device)
    out = torch.empty_like(q)
    for bi in range(b):
        for h in range(hq):
            s = (q[bi, h].to(f32) @ k[bi, h // g].to(f32).T) * d ** -0.5
            if cap:
                s = torch.tanh(s / cap) * cap
            p = torch.softmax(s.masked_fill(~keep, -torch.inf), dim=-1)
            out[bi, h] = (p @ v[bi, h // g].to(f32)).to(q.dtype)
    return out


def flash_attention_cuda(q, k, v, *, causal=True, window=0, cap=0.0):
    """:func:`flash_attention_ref` as one CUDA kernel launch: one block
    per flattened query head and 128-row query tile (in f32 at d = 256,
    64-row)."""
    if q.device.type != "cuda":
        raise ValueError("flash_attention_cuda takes CUDA tensors")
    if q.dtype not in DTYPES:
        raise ValueError(f"q has dtype {q.dtype}; the kernel takes "
                         f"float32 or bfloat16")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of {HEAD_DIMS}")
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not share {hkv} kv heads")
    dev = q.device
    # the kernels stage rows with 16-byte copies
    q, k, v = (t.contiguous() if t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in (q, k, v))
    _check(k, "k", (b, hkv, skv, d), q.dtype, dev)
    _check(v, "v", (b, hkv, skv, d), q.dtype, dev)
    out = torch.empty_like(q)
    if q.numel() and skv:
        err = _lib().flash_attention_launch(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out), b * hq, hq // hkv, sq,
            skv, d, int(bool(causal)), int(window),
            int(q.dtype == torch.bfloat16), d ** -0.5, float(cap),
            _stream(dev))
        _raise_on(err, "flash_attention")
        LAUNCHES["flash_attention"] += 1
    return out
