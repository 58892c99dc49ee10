"""The port's kernel module (repro_torch.kernels) against the JAX
reference: the plain PyTorch versions of ``event_scan`` and
``event_frontier`` must equal the Pallas kernels (interpret mode) and
the XLA paths bit for bit.  The CUDA kernels themselves run only on a
card: tests/test_torch_gpu.py and chip_smoke.py."""
import gc

import jax
import numpy as np
import pytest
import torch

from repro.kernels import event_scan as jax_event
from repro.kernels import ops as jax_ops
from repro_torch.kernels import _build
from repro_torch.kernels import event_scan as ek
from repro_torch.kernels import ops

# The tensors here are tiny: intra-op threads would only contend with
# the other test workers.
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _release_xla_executables():
    """Each XLA:CPU executable keeps memory maps of its own until JAX's
    caches drop it, and a process may hold only vm.max_map_count maps
    (65530 by default).  The JAX package's own tests compile enough to
    come near that in one test worker, so the executables compiled
    before this module and by it are freed on the way in and out."""
    jax.clear_caches()
    gc.collect()
    yield
    jax.clear_caches()
    gc.collect()


def _scan_case(r, j, seed):
    """Job-slot tables with empty slots, duplicated remaining values
    (ties settled by the tie key), time- and space-shared rows,
    reservation-blocked PEs and down rows."""
    rng = np.random.RandomState(seed)
    rem = rng.uniform(0.5, 500.0, (r, j)).astype(np.float32)
    rem[rng.rand(r, j) < 0.2] = 0.0
    dup = rng.rand(r, j) < 0.15
    rem = np.where(dup, np.roll(rem, 1, axis=1), rem).astype(np.float32)
    tie = np.stack([rng.permutation(j) for _ in range(r)]).astype(
        np.float32)
    tie = np.where(rem > 0, tie, np.float32(2 ** 30)).astype(np.float32)
    mips = rng.randint(100, 600, r).astype(np.float32)
    npe = rng.randint(1, 17, r).astype(np.float32)
    pol = (rng.rand(r) < 0.3).astype(np.float32)
    blk = np.where(rng.rand(r) < 0.3, rng.randint(0, 4, r), 0).astype(
        np.float32)
    ok = (rng.rand(r) > 0.15).astype(np.float32)
    return rem, tie, mips, npe, pol, blk, ok


def _bits(x):
    a = np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_bitwise(port, ref, names, valid=None):
    for name, p, q in zip(names, port, ref):
        p = p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
        q = np.asarray(q)
        if name == "rank" and valid is not None:
            p, q = p[valid], q[valid]
        np.testing.assert_array_equal(_bits(p), _bits(q), err_msg=name)


NAMES = ("rate", "t_min", "argmin", "occ", "rank")


def _check_fresh(j):
    rem, tie, mips, npe, pol, blk, ok = _scan_case(8, j, seed=j)
    kw = dict(tie=tie, policy=pol, pe_blocked=blk, row_ok=ok,
              with_rank=True)
    t = [torch.from_numpy(x) for x in (rem, tie, mips, npe, pol, blk, ok)]
    port = ops.event_scan(t[0], t[2], t[3], tie=t[1], policy=t[4],
                          pe_blocked=t[5], row_ok=t[6], with_rank=True)
    pallas = jax_ops.event_scan(rem, mips, npe, interpret=True, **kw)
    xla = jax_event.event_scan_xla(rem, mips, npe, **kw)
    npe_e = np.maximum(npe - blk, 0.0)
    dead = (ok < 0.5) | ((pol < 0.5) & (npe_e < 0.5))
    valid = (rem > 0) & (rem < ek.BIG) & ~dead[:, None]
    # ranks of invalid slots are unused and differ between the Pallas
    # rank algorithms; the XLA lexsort gives the same inverse permutation
    _assert_bitwise(port, pallas, NAMES, valid=valid)
    _assert_bitwise(port, xla, NAMES)


def _check_injected(j):
    rem, tie, mips, npe, pol, blk, ok = _scan_case(8, j, seed=100 + j)
    rng = np.random.RandomState(j)
    # any rank table: the injected form trusts it, both sides alike
    rank = np.stack([rng.permutation(j) for _ in range(8)]).astype(
        np.float32)
    kw = dict(tie=tie, policy=pol, pe_blocked=blk, row_ok=ok)
    ref = jax_ops.event_scan(rem, mips, npe, rank=rank, with_rank=True,
                             **kw)
    t = [torch.from_numpy(x) for x in (rem, tie, mips, npe, pol, blk, ok)]
    port = ops.event_scan(t[0], t[2], t[3], tie=t[1], policy=t[4],
                          pe_blocked=t[5], row_ok=t[6],
                          rank=torch.from_numpy(rank), with_rank=True)
    _assert_bitwise(port, ref, NAMES)


def _check_defaults_and_empty_rows():
    rem = np.zeros((8, 7), np.float32)
    rem[2, :3] = [3.0, 1.0, 2.0]
    mips = np.full(8, 10.0, np.float32)
    npe = np.full(8, 2.0, np.float32)
    ref = jax_event.event_scan_xla(rem, mips, npe)
    port = ops.event_scan(torch.from_numpy(rem), torch.from_numpy(mips),
                          torch.from_numpy(npe))
    _assert_bitwise(port, ref, NAMES[:4])
    assert int(port[2][0]) == 7
    assert float(port[1][0]) == float(np.float32(ek.BIG))


def test_event_scan_plain_matches_pallas_and_xla():
    """Fresh rank against the Pallas kernel and the XLA path, injected
    rank against the reference router, at J in {5, 130, 600}; then the
    default inputs and empty rows."""
    for j in (5, 130, 600):
        _check_fresh(j)
        _check_injected(j)
    _check_defaults_and_empty_rows()


def _frontier_case(sizes, seed):
    rng = np.random.RandomState(seed)
    c = sum(sizes)
    cand = (np.floor(rng.uniform(0, 20, c)) + 5.0).astype(np.float32)
    cand[rng.rand(c) < 0.5] = np.inf
    cuts = rng.rand(c) < 0.6
    return cand, cuts


FRONTIER_LAYOUTS = (
    (16, 11, 11, 1, 0, 1, 1, 0, 30, 30, 11, 1),   # the engine's layout
    (16, 0, 0, 0, 0, 0, 0, 0, 30, 0, 11, 1),      # a horizon layout
    (3, 200, 1, 0, 57),
)


def test_event_frontier_plain_matches_pallas_and_xla():
    names = ("t_star", "fired", "counts", "t_safe", "mins")
    for sizes in FRONTIER_LAYOUTS:
        cand, cuts = _frontier_case(sizes, seed=len(sizes))
        for use_cuts in (None, cuts):
            jc = None if use_cuts is None else use_cuts.astype(np.float32)
            pallas = jax_ops.event_frontier(cand, sizes, jc, interpret=True)
            xla = jax_event.event_frontier_xla(cand, sizes, cuts=jc)
            port = ops.event_frontier(
                torch.from_numpy(cand), sizes,
                None if use_cuts is None else torch.from_numpy(use_cuts))
            _assert_bitwise(port, pallas, names)
            _assert_bitwise(port, xla, names)


def test_cpu_tensors_route_to_plain_versions():
    rem, tie, mips, npe, pol, blk, ok = _scan_case(8, 9, seed=1)
    ek.reset_counts()
    ops.event_scan(torch.from_numpy(rem), torch.from_numpy(mips),
                   torch.from_numpy(npe), tie=torch.from_numpy(tie))
    ops.event_frontier(torch.ones(4), (1, 3))
    assert ek.PLAIN_CALLS == {"event_scan": 1, "event_frontier": 1}
    assert ek.LAUNCHES == {"event_scan": 0, "event_frontier": 0}
    # the kernels' own wrappers take no CPU tensor
    with pytest.raises(ValueError):
        ek.event_scan_cuda(torch.ones(8, 4), torch.ones(8), torch.ones(8))
    with pytest.raises(ValueError):
        ek.event_frontier_cuda(torch.ones(4), (1, 3))


def test_failed_build_and_launch_raise(monkeypatch):
    """A launcher's non-zero cudaError_t surfaces as an exception; without
    nvcc the build raises instead of falling back."""
    ek._raise_on(0, "event_scan")
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        ek._raise_on(1, "event_scan")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(_build, "library_path",
                        lambda: _build.BUILD_DIR / "never-built.so")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
