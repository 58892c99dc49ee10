"""What every kernel module shares: the launch and plain-call counters,
and the ctypes binding of the one CUDA library ``_build`` makes.

``LAUNCHES`` counts kernel launches and ``PLAIN_CALLS`` plain-version
calls, one key per kernel, so a run can show which path it took; one
``reset_counts()`` zeroes both.
"""
from __future__ import annotations

import ctypes

import torch

KERNELS = ("event_scan", "event_frontier", "link_scan", "event_scan_slab",
           "ssd_scan", "flash_attention", "event_scan_lanes",
           "event_frontier_lanes")
LAUNCHES = {k: 0 for k in KERNELS}
PLAIN_CALLS = {k: 0 for k in KERNELS}


def reset_counts():
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# launcher -> ctypes argument types (every launcher returns its
# cudaError_t as an int; the last argument is the stream, but for
# ssd_scan_blocks, which takes the array it writes the block counts to,
# and event_scan_slab_max_k, which returns a count)
_SIGNATURES = {
    "event_scan_launch": [P] * 13 + [I, I, P],
    "event_scan_checked_launch": [P, P, I] + [P] * 14 + [I, I, P],
    "event_scan_checked_lanes_launch": [P, P, I] + [P] * 9 + [I] +
    [P] * 5 + [I, I, I, P],
    "event_frontier_launch": [P, P, P, I, I] + [P] * 6,
    "event_frontier_lanes_launch": [P, P, P, I, I, I] + [P] * 6,
    "link_scan_launch": [P] * 13 + [I, I, P],
    "event_scan_slab_launch": [P] * 10 + [I, I, I, I, P],
    "event_scan_slab_max_k": [I],
    "ssd_scan_launch": [P] * 8 + [I] * 7 + [P],
    "ssd_scan_blocks": [I] * 6 + [P],
    "flash_attention_launch": [P] * 4 + [I] * 8 + [F, F, P],
}


def lib():
    """The loaded kernel library (built at first use), its launchers
    bound."""
    from . import _build
    out = _build.library()
    if not getattr(out, "_repro_torch_bound", False):
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(out, name)
            fn.argtypes = argtypes
            fn.restype = I
        out._repro_torch_bound = True
    return out


def ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def check(t, name, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
