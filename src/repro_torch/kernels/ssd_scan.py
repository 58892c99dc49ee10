"""The Mamba-2 SSD chunk scan (arXiv:2405.21060) on Hopper.  Port of
``repro.kernels.ssd_scan``.

x [B, S, H, P], dt [B, S, H] (> 0), a [H] (< 0), B/C [B, S, N] -> y like
x.  Per chunk of Q steps, in f32 (x cast inside, as the reference's
kernel body does):

  cum    = running sum of dt * a over the chunk          [Q, H]
  y      = ((C B^T) * exp(cum_q - cum_k) * dt_k, causal) @ x
           + exp(cum_q) * (C @ state^T)
  state  = state * exp(cum_end) + ((exp(cum_end - cum) * dt) x)^T B

with the [H, P, N] state carried from chunk to chunk.

Two implementations: the CUDA kernel (``csrc/ssd_scan.cu``, launched by
:func:`ssd_scan_cuda` for tensors on the card) and the plain PyTorch
version :func:`ssd_scan_ref` (for tensors on the CPU, and the yardstick
the kernel is held against).  They agree to rounding: the reference's
own kernel-vs-oracle tolerance (5e-4 in f32, 5e-2 in bf16) applies.
"""
from __future__ import annotations

import ctypes

import torch

from ._launch import LAUNCHES, PLAIN_CALLS
from ._launch import check as _check
from ._launch import lib as _lib
from ._launch import ptr as _ptr
from ._launch import raise_on as _raise_on
from ._launch import stream as _stream

DTYPES = (torch.float32, torch.bfloat16)


def _chunk(s, chunk):
    chunk = min(chunk, s)
    if chunk < 1 or s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {chunk}: pad upstream")
    return chunk


def ssd_scan_ref(x, dt, a, b_mat, c_mat, *, chunk=256):
    """Plain PyTorch SSD chunk scan, the arithmetic of the reference's
    Pallas body chunk by chunk (``cum`` as a lower-triangular matmul)."""
    PLAIN_CALLS["ssd_scan"] += 1
    bs, s, h, p = x.shape
    n = b_mat.shape[-1]
    q = _chunk(s, chunk)
    f32 = torch.float32
    dev = x.device
    xf, dtf = x.to(f32), dt.to(f32)
    af, bf, cf = a.to(f32), b_mat.to(f32), c_mat.to(f32)
    lt = torch.tril(torch.ones((q, q), dtype=f32, device=dev))
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dev))
    state = torch.zeros((bs, h, p, n), dtype=f32, device=dev)
    ys = []
    for c0 in range(0, s, q):
        xc, dtc = xf[:, c0:c0 + q], dtf[:, c0:c0 + q]     # [B,Q,H,P], [B,Q,H]
        bm, cm = bf[:, c0:c0 + q], cf[:, c0:c0 + q]       # [B,Q,N]
        cum = torch.einsum("qk,bkh->bqh", lt, dtc * af)
        seg_end = cum[:, -1]                              # [B,H]
        cb = torch.einsum("bqn,bkn->bqk", cm, bm)
        dec = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])
        dec = torch.where(causal[None, :, :, None], dec, 0.0)
        w = cb[..., None] * dec * dtc[:, None, :, :]      # [B,Q,K,H]
        y_intra = torch.einsum("bqkh,bkhp->bqhp", w, xc)
        cs = torch.einsum("bqn,bhpn->bqhp", cm, state)
        y = y_intra + cs * torch.exp(cum)[..., None]
        ys.append(y.to(x.dtype))
        wk = torch.exp(seg_end[:, None, :] - cum) * dtc   # [B,Q,H]
        s_c = torch.einsum("bkhp,bkn->bhpn", xc * wk[..., None], bm)
        state = state * torch.exp(seg_end)[:, :, None, None] + s_c
    return torch.cat(ys, dim=1)


def ssd_scan_cuda(x, dt, a, b_mat, c_mat, *, chunk=256):
    """:func:`ssd_scan_ref` on the card: three kernels in one launcher
    call (the chunks' states, the states passed from chunk to chunk, the
    output; ``csrc/ssd_scan.cu``), with their f32 scratch allocated
    here.  Refused (RuntimeError) beyond chunk 256, P 64, N 128."""
    if x.device.type != "cuda":
        raise ValueError("ssd_scan_cuda takes CUDA tensors")
    if x.dtype not in DTYPES:
        raise ValueError(f"x has dtype {x.dtype}; the kernel takes "
                         f"float32 or bfloat16")
    bs, s, h, p = x.shape
    n = b_mat.shape[-1]
    q = _chunk(s, chunk)
    dev = x.device
    f32 = torch.float32
    x = x.contiguous()
    dt, a, b_mat, c_mat = (t.to(f32).contiguous()
                           for t in (dt, a, b_mat, c_mat))
    _check(dt, "dt", (bs, s, h), f32, dev)
    _check(a, "a", (h,), f32, dev)
    _check(b_mat, "b_mat", (bs, s, n), f32, dev)
    _check(c_mat, "c_mat", (bs, s, n), f32, dev)
    y = torch.empty_like(x)
    if x.numel():
        # each chunk's state increment, then (in place) its incoming state;
        # the running sums of dt * a, [B, S / Q, Q, H]
        states = torch.empty((bs, s // q, h, p, n), dtype=f32, device=dev)
        cum = torch.empty((bs, s, h), dtype=f32, device=dev)
        err = _lib().ssd_scan_launch(
            _ptr(x), _ptr(dt), _ptr(a), _ptr(b_mat), _ptr(c_mat), _ptr(y),
            _ptr(states), _ptr(cum), bs, s, h, p, n, q,
            int(x.dtype == torch.bfloat16), _stream(dev))
        _raise_on(err, "ssd_scan")
        LAUNCHES["ssd_scan"] += 1
    return y


def launch_blocks(bs, s, h, p, n, *, chunk=256):
    """The blocks each of the kernel's three passes launches at these
    widths: (states, pass, output).  Needs the built library."""
    out = (ctypes.c_int * 3)()
    _raise_on(_lib().ssd_scan_blocks(bs, s, h, p, n, _chunk(s, chunk), out),
              "ssd_scan")
    return tuple(out)
