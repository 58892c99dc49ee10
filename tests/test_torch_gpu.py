"""The port's CUDA kernels on a card: each against its plain PyTorch
version (bitwise, but for ssd_scan and flash_attention, held at the
reference's kernel-vs-oracle tolerances), the threefry draws on the card
equal to the CPU's, and small experiments (analytic links, contended
links behind a trunk, failure streams and a fault trace, reservation
windows, pricing and the plan-ahead broker, a deadline x budget sweep
and strategy lanes through the lane-batched engine) on the card equal
to the same experiments on the CPU.  Marked ``gpu``; where ``torch.cuda`` is not
available every test skips.  Run on a card with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import math

import pytest
import torch

from repro_torch.core import (gridlet, rand, reservation, resource,
                              simulation, types)
from repro_torch.kernels import event_scan as ek
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as sk

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # the plain versions' f32 products stay in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _bits_equal(a, b):
    a, b = a.cpu().contiguous(), b.cpu().contiguous()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _scan_case(r, j, seed, dev):
    g = torch.Generator().manual_seed(seed)
    rem = torch.rand((r, j), generator=g) * 500.0
    rem[torch.rand((r, j), generator=g) < 0.2] = 0.0
    rem = torch.where(torch.rand((r, j), generator=g) < 0.1,
                      rem.roll(1, dims=1), rem)
    tie = torch.stack([torch.randperm(j, generator=g) for _ in range(r)]
                      ).to(torch.float32)
    mips = torch.randint(100, 600, (r,), generator=g).to(torch.float32)
    npe = torch.randint(1, 17, (r,), generator=g).to(torch.float32)
    pol = (torch.rand(r, generator=g) < 0.3).to(torch.float32)
    blk = torch.randint(0, 3, (r,), generator=g).to(torch.float32)
    ok = (torch.rand(r, generator=g) > 0.1).to(torch.float32)
    return [x.to(dev) for x in (rem, tie, mips, npe, pol, blk, ok)]


def _check_event_scan(r, j, cuda, ties=False):
    """Fresh and injected rank; with ``ties``, remaining values on a grid
    of 50 (many equal, ranked by the tie key), row 0 all invalid and row
    1 dead."""
    rem, tie, mips, npe, pol, blk, ok = _scan_case(r, j, r * j, cuda)
    if ties:
        rem = torch.floor(rem / 50.0) * 50.0
        rem[0] = 0.0
        ok[1] = 0.0
    kw = dict(tie=tie, policy=pol, pe_blocked=blk, row_ok=ok,
              with_rank=True)
    want = ek.event_scan_ref(rem, mips, npe, **kw)
    got = ek.event_scan_cuda(rem, mips, npe, **kw)
    assert all(_bits_equal(a, b) for a, b in zip(want, got))
    rank = want[4]
    want = ek.event_scan_ref(rem, mips, npe, rank=rank, **kw)
    got = ek.event_scan_cuda(rem, mips, npe, rank=rank, **kw)
    assert all(_bits_equal(a, b) for a, b in zip(want, got))


def _checked_case(r, j, seed, dev):
    """The checked scan's inputs (r >= 4): a slot map over 2 r j
    gridlets, remaining on a 10 MI grid (many equal; zeros clamped by
    the gather), time-shared rows of 1-4 PEs, row 1 space-shared, row 2
    dead, row 3 empty; carries "kept" (each row's MaxShare side
    reversed: the same partition) and "one row" (row 0's boundary pair
    swapped: only row 0 fails)."""
    g = torch.Generator().manual_seed(seed)
    n = 2 * r * j
    ids = torch.randperm(n, generator=g)[:r * j].reshape(r, j)
    rg = torch.where(torch.rand((r, j), generator=g) < 0.7, ids,
                     -1).to(torch.int32)
    rg[3] = -1
    occ0 = torch.nonzero(rg[0] >= 0)[:, 0]
    if len(occ0) % 3 == 0:
        rg[0, occ0[0]] = -1
    remaining = torch.floor(torch.rand(n, generator=g) * 20.0) * 10.0
    mips = torch.randint(100, 600, (r,), generator=g).to(torch.float32)
    npe = torch.randint(1, 5, (r,), generator=g).to(torch.float32)
    npe[0] = 3.0
    pol, ok = torch.zeros(r), torch.ones(r)
    pol[1], ok[2] = 1.0, 0.0
    args = [x.to(dev) for x in (rg, remaining, mips, npe, pol,
                                torch.zeros(r), ok)]
    fresh = ek.event_scan_checked_ref(
        *args, torch.zeros((r, j), device=dev),
        torch.tensor(False, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev))[4]
    rem, _ = ek._gather_table(args[0], args[1])
    npe_e, valid, gj = ek._row_masks(rem, args[3][:, None], args[4][:, None],
                                     args[5][:, None], args[6][:, None])
    m = torch.clamp_min(npe_e, 1.0)
    k = torch.floor(gj / m)
    msc = (npe_e - (gj - k * m)) * k
    kept = torch.where(valid & (fresh < msc),
                       torch.minimum(msc, gj) - 1.0 - fresh, fresh)
    ms = float(msc[0, 0])
    assert 0 < ms < float(gj[0, 0])
    one = kept.clone()
    one[0] = torch.where(valid[0] & (fresh[0] == ms - 1), ms,
                         torch.where(valid[0] & (fresh[0] == ms), ms - 1,
                                     fresh[0]))
    return args, {"kept": kept, "one row": one}


def _check_checked_scan(r, j, cuda):
    """The checked form with the carry kept, with its flag off, and with
    a carry that fails in one row only (every row reseeds): outputs and
    reseed count bitwise to the plain version, also through the
    engine's reused outputs (both sets of a Scratch)."""
    args, carries = _checked_case(r, j, r + j, cuda)
    scratch = ek.Scratch()
    for carry, flag, reseeds in (("kept", True, 0), ("kept", False, 1),
                                 ("one row", True, 1)):
        flag = torch.tensor(flag, device=cuda)
        counts = [torch.zeros((), dtype=torch.int32, device=cuda)
                  for _ in range(3)]
        want = ek.event_scan_checked_ref(*args, carries[carry], flag,
                                         counts[0])
        got = ek.event_scan_checked_cuda(*args, carries[carry], flag,
                                         counts[1])
        assert all(_bits_equal(a, b) for a, b in zip(want, got))
        assert _bits_equal(want[4], carries[carry]) == (reseeds == 0)
        for _ in range(2):
            got = ek.event_scan_checked_cuda(*args, carries[carry], flag,
                                             counts[2], scratch=scratch)
            assert all(_bits_equal(a, b) for a, b in zip(want, got))
        assert [int(c) for c in counts] == [reseeds, reseeds, 2 * reseeds]


def _check_refused_launch(cuda):
    """A row too wide for shared memory, or an SSD chunk too long (the
    kernel takes chunks up to 256), is refused at launch, and the
    wrapper raises instead of returning unwritten outputs."""
    rem = torch.ones((2, 30000), device=cuda)
    one = torch.ones(2, device=cuda)
    with pytest.raises(RuntimeError, match="event_scan"):
        ek.event_scan_cuda(rem, one, one)
    with pytest.raises(RuntimeError, match="event_scan"):
        ek.event_scan_checked_cuda(
            torch.zeros((2, 30000), dtype=torch.int32, device=cuda), one,
            one, one, one, one, one, rem, torch.tensor(True, device=cuda),
            torch.zeros((), dtype=torch.int32, device=cuda))
    with pytest.raises(RuntimeError, match="event_scan_slab"):
        ek.event_scan_slab_cuda(rem, one, one, 4)
    s, n = 2048, 128
    with pytest.raises(RuntimeError, match="ssd_scan"):
        sk.ssd_scan_cuda(torch.ones((1, s, 1, 64), device=cuda),
                         torch.ones((1, s, 1), device=cuda),
                         -torch.ones(1, device=cuda),
                         torch.ones((1, s, n), device=cuda),
                         torch.ones((1, s, n), device=cuda), chunk=s)


def _check_slab(r, j, cuda, ks=(1, 4, 8), forms=(True, False)):
    """The given forms (associative True, sequential False), with and
    without the live gate, on the random table and on one of
    whole-number remaining values (many equal, ranked by the tie key)."""
    rem, tie, mips, npe, pol, blk, ok = _scan_case(r, j, r + j, cuda)
    kw = dict(tie=tie, policy=pol, pe_blocked=blk, row_ok=ok)
    for table in (rem, torch.floor(rem / 100.0)):
        for k in ks:
            for assoc in forms:
                for live in (None, torch.tensor(False, device=cuda)):
                    want = ek.event_scan_slab_ref(table, mips, npe, k,
                                                  live=live, assoc=assoc,
                                                  tree=True, **kw)
                    got = ek.event_scan_slab_cuda(table, mips, npe, k,
                                                  live=live, assoc=assoc,
                                                  **kw)
                    assert all(_bits_equal(a, b) for a, b in zip(want, got))


def _close(got, want, tol):
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(),
                               rtol=tol, atol=tol)


def _check_ssd(b, s, h, p, n, chunk, dtype, cuda, draws="test"):
    """dt and a drawn as tests/test_kernels.py draws them, or ("mamba2")
    as Mamba-2 initialises them: dt log-uniform in [1e-3, 1e-1], A =
    -U[1, 16], so slow heads carry keys far below the diagonal and the
    state across chunks."""
    g = torch.Generator().manual_seed(s + h)
    x = torch.randn((b, s, h, p), generator=g).to(dtype)
    if draws == "test":
        dt = torch.nn.functional.softplus(torch.randn((b, s, h),
                                                      generator=g))
        a = -torch.exp(torch.randn(h, generator=g) * 0.3)
    else:
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt = torch.exp(torch.rand((b, s, h), generator=g) * (hi - lo) + lo)
        a = -(1.0 + 15.0 * torch.rand(h, generator=g))
    bm, cm = torch.randn((2, b, s, n), generator=g)
    args = [t.to(cuda) for t in (x, dt, a, bm, cm)]
    tol = 5e-2 if dtype == torch.bfloat16 else 5e-4
    _close(sk.ssd_scan_cuda(*args, chunk=chunk),
           sk.ssd_scan_ref(*args, chunk=chunk), tol)


def _check_flash(b, hq, hkv, s, d, causal, window, cap, dtype, cuda,
                 skv=None):
    """``s`` query rows against ``skv`` keys (default ``s``)."""
    g = torch.Generator().manual_seed(s + d)
    q = torch.randn((b, hq, s, d), generator=g).to(dtype).to(cuda)
    k, v = (torch.randn((b, hkv, skv or s, d), generator=g).to(dtype).to(
        cuda) for _ in range(2))
    kw = dict(causal=causal, window=window, cap=cap)
    got = fk.flash_attention_cuda(q, k, v, **kw)
    want = fk.flash_attention_ref(q, k, v, **kw)
    if dtype == torch.float32:
        _close(got, want, 2e-5)
        return
    # bf16: each query row's largest error within 2e-2 of its largest |o|
    # (an absolute 2e-2 is the size of a long row's output)
    got, want = got.float().cpu(), want.float().cpu()
    rel = (got - want).abs().amax(-1) / want.abs().amax(-1).clamp_min(1e-30)
    assert rel.max() <= 2e-2, (f"row-relative error {float(rel.max()):.4g}"
                               f" > 2e-2 at {got.shape}, {kw}")


def _check_flash_unaligned(dtype, cuda):
    """Inputs that start off a 16-byte boundary (views into one buffer)
    give the result of their aligned copies."""
    g = torch.Generator().manual_seed(7)
    buf = torch.randn(3 * 2 * 64 * 32 + 1, generator=g).to(dtype)
    q, k, v = buf.to(cuda)[1:].view(3, 1, 2, 64, 32).unbind(0)
    assert q.data_ptr() % 16
    assert torch.equal(fk.flash_attention_cuda(q, k, v),
                       fk.flash_attention_cuda(q.clone(), k.clone(),
                                               v.clone()))


def _check_event_frontier(sizes, cuda):
    g = torch.Generator().manual_seed(sum(sizes))
    c = sum(sizes)
    cand = torch.floor(torch.rand(c, generator=g) * 30.0)
    cand[torch.rand(c, generator=g) < 0.5] = float("inf")
    cuts = (torch.rand(c, generator=g) < 0.5).to(cuda)
    cand = cand.to(cuda)
    for use in (None, cuts):
        want = ek.event_frontier_ref(cand, sizes, use)
        got = ek.event_frontier_cuda(cand, sizes, use)
        assert all(_bits_equal(a, b) for a, b in zip(want, got))
    # the engine's call: unchecked candidates, reused outputs
    scratch = ek.Scratch()
    want = ek.event_frontier_ref(cand, sizes)
    for _ in range(3):
        got = ek.event_frontier_cuda(cand, sizes, scratch=scratch)
        assert all(_bits_equal(a, b) for a, b in zip(want, got))


def _link_case(l, t, seed, dev):
    """Free slots, exact forecast ties (integer payloads), an empty row,
    dead rows (baud 0, BIG, inf, subnormal), fractional background
    flows and a cap that binds on some rows."""
    g = torch.Generator().manual_seed(seed)
    rem = torch.randint(1, 5, (l, t), generator=g).to(torch.float32) * 1024
    rem[torch.rand((l, t), generator=g) < 0.4] = 0.0
    rem[1] = 0.0
    baud = torch.rand(l, generator=g) * 1e4 + 100.0
    baud[2], baud[3], baud[4], baud[5] = 0.0, 3.0e38, float("inf"), 1e-40
    bg = torch.tensor([0.0, 0.5, 1.0, 2.5])[torch.randint(
        0, 4, (l,), generator=g)]
    tie = torch.stack([torch.randperm(t, generator=g) for _ in range(l)]
                      ).to(torch.float32)
    cap = torch.where(torch.rand(l, generator=g) < 0.5,
                      torch.rand(l, generator=g) * 2e3 + 10.0,
                      torch.tensor(3.0e38))
    return [x.to(dev) for x in (rem, baud, bg, tie, cap)]


def _check_link_scan(l, t, cuda):
    """The public forms, also with tie keys that tie at t_min in every
    way the two-stage argmin tells apart (-0 and +0, BIG, above BIG,
    +-inf); then the engine form (tie key from a slot map, trunk caps
    computed in the kernel: rows in two trunks, private rows, the dead
    rows of ``_link_case`` inside trunks) with and without trunks, fresh
    outputs and twice through one Scratch (both output sets)."""
    rem, baud, bg, tie, cap = _link_case(l, t, l * t, cuda)
    g = torch.Generator().manual_seed(l + t)
    keys = torch.tensor([0.0, -0.0, 1.0, 3.0e38, 3.2e38, float("inf"),
                         -float("inf"), 2.0 ** 30])
    odd = keys[torch.randint(0, len(keys), (l, t), generator=g)].to(cuda)
    for c in (None, cap):
        for ties in (tie, odd):
            want = ek.link_scan_ref(rem, baud, bg=bg, tie=ties, cap=c)
            got = ek.link_scan_cuda(rem, baud, bg=bg, tie=ties, cap=c)
            assert all(_bits_equal(a, b) for a, b in zip(want, got))
    ids = torch.randperm(2 * l * t, generator=g)[:l * t].reshape(l, t)
    lg = torch.where(rem.cpu() > 0, ids, -1).to(torch.int32).to(cuda)
    trunk_of = torch.tensor([i % 3 - 1 for i in range(l)], dtype=torch.int32)
    trunk_of[0] = 0
    trunk_baud = torch.where(trunk_of == 0, 3e3, 5e4)
    trunk_bg = torch.where(trunk_of == 0, 1.0, 0.5)
    trunks = tuple(x.to(cuda) for x in (trunk_of, trunk_baud, trunk_bg))
    scratch = ek.Scratch()
    for topology in ((), trunks):
        rows = ek.LinkRows(baud, bg, *topology)
        want = ek.link_scan_tabled_ref(lg, rem, rows)
        got = [ek.link_scan_tabled_cuda(lg, rem, rows)]
        got += [ek.link_scan_tabled_cuda(lg, rem, rows, scratch=scratch)
                for _ in range(2)]
        assert got[1][0].data_ptr() != got[2][0].data_ptr()
        for out in got:
            assert all(_bits_equal(a, b) for a, b in zip(want, out))


def _check_card_tensors_never_reach_the_plain_versions(cuda):
    rem, tie, mips, npe, pol, blk, ok = _scan_case(8, 40, 0, cuda)
    ek.reset_counts()
    ops.event_scan(rem, mips, npe, tie=tie, policy=pol)
    ops.event_frontier(torch.ones(4, device=cuda), (1, 3))
    ops.link_scan(rem, mips)
    ops.event_scan_slab(rem, mips, npe, 4, tie=tie, policy=pol)
    x = torch.ones((1, 32, 2, 16), device=cuda)
    ops.ssd_scan(x, torch.ones((1, 32, 2), device=cuda),
                 -torch.ones(2, device=cuda),
                 torch.ones((1, 32, 8), device=cuda),
                 torch.ones((1, 32, 8), device=cuda), chunk=16)
    q = torch.ones((1, 2, 40, 32), device=cuda)
    ops.flash_attention(q, q, q)
    assert ek.PLAIN_CALLS == dict.fromkeys(ek.PLAIN_CALLS, 0)
    assert ek.LAUNCHES == dict.fromkeys(ek.LAUNCHES, 1) | dict.fromkeys(
        ("event_scan_lanes", "event_frontier_lanes"), 0)


def test_kernels_match_plain_on_the_card(cuda):
    """Every kernel against its plain version (event_scan in its fresh
    and injected-rank forms, also on tie-heavy tables, and in its
    checked form with the carry kept, its flag off and failing in one
    row; the one-launch frontier; link_scan with and without the trunk
    cap, and its engine form with and without trunks; the slab in both
    forms with and without the live gate, also at k at and past the
    associative form's shared-memory limit and past J -- all bitwise;
    ssd_scan and f32 flash_attention at the reference's tolerances, bf16
    flash_attention per query row), refused launches, and the router
    sending card tensors only to the kernels."""
    for r, j in ((8, 1), (16, 32), (16, 640), (8, 2000), (3, 3000)):
        _check_event_scan(r, j, cuda)
    for r, j in ((16, 32), (16, 640), (16, 2000)):
        _check_event_scan(r, j, cuda, ties=True)
    for r, j in ((16, 32), (16, 640), (16, 2000), (8, 640)):
        _check_checked_scan(r, j, cuda)
    _check_refused_launch(cuda)
    for sizes in ((16, 11, 11, 1, 0, 1, 1, 0, 2000, 2000, 11, 1),
                  (0, 5, 0), (1,), (700, 3), ()):
        _check_event_frontier(sizes, cuda)
    for l, t in ((8, 1), (16, 32), (16, 640), (8, 2000), (6, 3000)):
        _check_link_scan(l, t, cuda)
    for r, j in ((8, 1), (8, 12), (16, 640), (3, 2000), (16, 500)):
        _check_slab(r, j, cuda)
    # every k the reference takes: both forms at the associative form's
    # shared-memory limit (its largest shared layout), the associative
    # form past it (wave matrices in a workspace), the sequential form
    # past its old cap of 256 and up to J
    limit = ek.event_scan_slab_max_k(640)
    assert 1 <= limit < 33
    _check_slab(16, 640, cuda, ks=(limit,))
    _check_slab(16, 640, cuda, ks=(33, 64), forms=(True,))
    _check_slab(16, 640, cuda, ks=(257, 640), forms=(False,))
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((1, 32, 4, 8, 16, 8), (2, 64, 8, 16, 32, 16),
                      (1, 512, 2, 64, 128, 256), (1, 100, 3, 24, 40, 50)):
            _check_ssd(*shape, dtype, cuda)
        # Mamba-2's draws: two chunks at mamba2-130m's widths; B 2 with
        # H 5 (not a multiple of either pass's head group), ragged P, N
        # and a chunk of 100 (a full key tile below a partial one); P 6
        # and N 10, whose rows are not whole 16-byte chunks (staged
        # without cp.async)
        for shape in ((2, 512, 24, 64, 128, 256), (2, 300, 5, 24, 40, 100),
                      (1, 64, 3, 6, 10, 32)):
            _check_ssd(*shape, dtype, cuda, draws="mamba2")
        for shape in ((1, 2, 2, 64, 16, True, 0, 0.0),
                      (2, 4, 1, 128, 32, True, 32, 0.0),
                      (1, 8, 8, 256, 64, True, 0, 50.0),
                      (1, 2, 2, 64, 16, False, 0, 0.0),
                      (2, 6, 2, 96, 16, True, 16, 30.0),
                      (1, 4, 1, 200, 256, True, 64, 0.0),
                      (1, 2, 1, 130, 128, False, 0, 0.0),
                      # across the bf16 kernel's 128-row / 128-key tiles
                      # (64-key at d 256): ragged S, qwen2's g = 7, d 256
                      # with a window or a cap and no causal mask, d 16
                      # and 32 bidirectional
                      (1, 2, 1, 1000, 64, True, 0, 0.0),
                      (1, 2, 2, 200, 32, False, 0, 0.0),
                      (1, 28, 4, 256, 128, True, 0, 0.0),
                      (1, 2, 1, 300, 256, False, 64, 0.0),
                      (1, 2, 2, 256, 256, False, 0, 30.0),
                      (1, 3, 1, 1000, 16, False, 0, 0.0)):
            _check_flash(*shape, dtype, cuda)
        _check_flash_unaligned(dtype, cuda)
    # f32 at every head dim: Sq != Skv both ways and lengths off every
    # tile (the f32 kernel's 128 / 64 query rows, 64 / 32 keys), causal
    # with and without a window, bidirectional with a cap, GQA g = 2
    for d in fk.HEAD_DIMS:
        for sq, skv, causal, window, cap in ((77, 200, True, 0, 0.0),
                                             (77, 200, True, 48, 0.0),
                                             (200, 77, False, 0, 30.0),
                                             (200, 200, True, 0, 50.0)):
            _check_flash(1, 4, 2, sq, d, causal, window, cap,
                         torch.float32, cuda, skv=skv)
    _check_card_tensors_never_reach_the_plain_versions(cuda)


def _same_runs(runs):
    for name in ("n_done", "spent", "term_time", "per_resource_done"):
        assert _bits_equal(getattr(runs[0], name), getattr(runs[1], name))
    for name in ("status", "resource", "finish", "returned", "cost"):
        assert _bits_equal(getattr(runs[0].gridlets, name),
                           getattr(runs[1].gridlets, name))
    for a, b in zip(runs[0].trace, runs[1].trace):
        assert _bits_equal(a, b)
    for name in ("n_steps", "n_spec", "n_events", "n_failed",
                 "n_resubmits"):
        assert int(getattr(runs[0], name)) == int(getattr(runs[1], name))
    assert _bits_equal(runs[0].downtime, runs[1].downtime)
    assert _bits_equal(runs[0].gridlets.retry_at, runs[1].gridlets.retry_at)


def test_experiment_on_the_card_equals_cpu(cuda):
    """The broker experiment on analytic links, then on contended links
    with a trunk cap (the link kernel on the card, its plain version on
    the CPU)."""
    k_farm, k_net = rand.split(rand.PRNGKey(5))
    farm = gridlet.task_farm(k_farm, n_jobs=12, n_users=3)
    fleet = resource.wwg_fleet()
    _same_runs([simulation.run_experiment(farm, fleet, 600.0, 2500.0,
                                          n_users=3, device=d)
                for d in ("cpu", cuda)])
    net = gridlet.task_farm(k_net, n_jobs=12, n_users=3, in_bytes=2e5,
                            out_bytes=1e5)
    scenario = simulation.Scenario(baud_rate=28_000.0, bg_flows=1.0,
                                   trunk_of=[0] * 5 + [-1] * 6,
                                   trunk_baud=56_000.0)
    ek.reset_counts()
    runs = [simulation.run_experiment(net, fleet, 2000.0, 22000.0,
                                      n_users=3, scenario=scenario,
                                      net_cap=None, device=d)
            for d in ("cpu", cuda)]
    _same_runs(runs)
    assert ek.LAUNCHES["link_scan"] > 0


def test_economy_on_the_card_equals_cpu(cuda):
    """Reservation and maintenance windows on R8 (reactive and plan-ahead
    broker), commodity and auction pricing: the card's runs equal the
    CPU's."""
    farm = gridlet.task_farm(rand.PRNGKey(3), n_jobs=25, n_users=4)
    fleet = resource.wwg_fleet()
    windows = reservation.maintenance(fleet.num_pe, [(8, 100.0, 200.0)]) + \
        [(8, 1, 300.0, 500.0)]
    for scenario in (
            simulation.Scenario(reservations=windows),
            simulation.Scenario(reservations=windows, plan_ahead=True,
                                policy=types.OPT_COST_TIME),
            simulation.Scenario(pricing_model="commodity",
                                market_period=60.0),
            simulation.Scenario(pricing_model="auction",
                                auction_period=60.0, seed=5)):
        _same_runs([simulation.run_experiment(farm, fleet, 2000.0, 22000.0,
                                              n_users=4, scenario=scenario,
                                              device=d)
                    for d in ("cpu", cuda)])


def test_threefry_and_dynamic_resources_on_the_card_equal_cpu(cuda):
    """split, uniform and exponential draws on the card against the CPU's
    in both layouts, then MTBF/MTTR strikes and a trunk-wide fault trace
    with retries: the card's runs equal the CPU's."""
    for part in (True, False):
        for seed in (0, 1, 7):
            key = rand.PRNGKey(seed)
            for fn in (lambda k: rand.split(k, 3, part),
                       lambda k: rand.uniform(k, (4097,), part),
                       lambda k: rand.exponential(k, torch.full(
                           (4097,), 25.0, device=k.device), part)):
                assert _bits_equal(fn(key), fn(key.to(cuda)))
    farm = gridlet.task_farm(rand.PRNGKey(3), n_jobs=25, n_users=4)
    fleet = resource.wwg_fleet()
    for scenario in (
            simulation.Scenario(mtbf=100.0, mttr=25.0, seed=1),
            simulation.Scenario(trunk_of=[-1] * 8 + [0, 0, -1],
                                fault_trace=[(300.0, 11, 0),
                                             (400.0, 11, 1)],
                                retry_limit=8, backoff_base=1.0,
                                blacklist_cooldown=5.0)):
        runs = [simulation.run_experiment(farm, fleet, 2000.0, 22000.0,
                                          n_users=4, scenario=scenario,
                                          device=d)
                for d in ("cpu", cuda)]
        _same_runs(runs)
        assert int(runs[0].n_failed) > 0


def _check_lane_kernels(cuda):
    """The lane forms against their plain versions: the checked scan over
    three lanes (the carry kept, its flag off, a carry failing in one
    row) with and without the reseed, also through a Scratch twice; the
    frontier over three lanes with and without cuts, and through a
    Scratch."""
    cases = [_checked_case(16, 32, seed, cuda) for seed in (1, 2, 3)]
    args = [torch.stack(x) for x in zip(*(a for a, _ in cases))]
    rank = torch.stack([c[k] for (_, c), k in zip(cases, ("kept", "kept",
                                                          "one row"))])
    flag = torch.tensor([True, False, True], device=cuda)
    scratch = ek.Scratch()
    for reseed in (True, False):
        want, use = ek.event_scan_checked_lanes_ref(*args, rank, flag,
                                                    reseed=reseed)
        assert use.tolist() == [True, False, False]
        for sc in (None, scratch, scratch):
            got, got_use = ek.event_scan_checked_lanes_cuda(
                *args, rank, flag, reseed=reseed, scratch=sc)
            assert all(_bits_equal(a, b) for a, b in zip(want, got))
            assert _bits_equal(use, got_use)
    sizes = (16, 11, 11, 1, 0, 1, 1, 0, 200, 200, 11, 1)
    g = torch.Generator().manual_seed(7)
    cand = torch.floor(torch.rand((3, sum(sizes)), generator=g) * 30.0)
    cand[torch.rand(cand.shape, generator=g) < 0.5] = float("inf")
    cand = cand.to(cuda)
    cuts = (torch.rand(cand.shape, generator=g) < 0.5).to(cuda)
    for use in (None, cuts):
        want = ek.event_frontier_lanes_ref(cand, sizes, use)
        got = ek.event_frontier_lanes_cuda(cand, sizes, use)
        assert all(_bits_equal(a, b) for a, b in zip(want, got))
    want = ek.event_frontier_lanes_ref(cand, sizes)
    for _ in range(3):
        got = ek.event_frontier_lanes_cuda(cand, sizes, scratch=scratch)
        assert all(_bits_equal(a, b) for a, b in zip(want, got))


def test_sweep_on_the_card_equals_cpu(cuda):
    """The lane kernels against their plain versions, then a 2 x 2
    deadline x budget sweep (coarse polls) and the four strategy lanes
    through the lane-batched engine: the card's lanes equal the CPU's,
    "how" counters included, and the card launched both lane kernels."""
    _check_lane_kernels(cuda)
    farm = gridlet.task_farm(rand.PRNGKey(5), n_jobs=8, n_users=3)
    fleet = resource.wwg_fleet()
    coarse = simulation.Scenario(sched_min_period=10.0, sched_frac=0.05)
    runs = []
    for d in ("cpu", cuda):
        ek.reset_counts()
        runs.append(simulation.sweep(farm, fleet, [700.0, 1400.0],
                                     [6000.0, 14000.0], n_users=3,
                                     scenario=coarse, device=d))
    assert ek.LAUNCHES["event_scan_lanes"] > 0
    assert ek.LAUNCHES["event_frontier_lanes"] > 0
    assert ek.PLAIN_CALLS == dict.fromkeys(ek.PLAIN_CALLS, 0)
    for name in ("n_done", "spent", "term_time", "per_resource_done",
                 "n_steps", "n_spec", "n_reseeds", "n_scans", "n_events"):
        assert _bits_equal(getattr(runs[0], name), getattr(runs[1], name))
    for name in ("status", "resource", "finish", "returned", "cost"):
        assert _bits_equal(getattr(runs[0].gridlets, name),
                           getattr(runs[1].gridlets, name))
    for a, b in zip(runs[0].trace, runs[1].trace):
        assert _bits_equal(a, b)
    from repro_torch.core import engine
    farm = gridlet.task_farm(rand.PRNGKey(9), n_jobs=12, base_mi=50_000.0)
    params = engine._stack([simulation._scenario_params(
        fleet, 1200.0, 30_000.0, types.OPT_COST, 1,
        simulation.Scenario(policy=opt)) for opt in range(4)])
    lanes = [engine.run_sweep_lanes(farm, fleet, params, 1, 2048, device=d)
             for d in ("cpu", cuda)]
    for name in ("spent", "term_time", "n_events", "n_steps", "n_spec",
                 "n_reseeds", "n_scans"):
        assert _bits_equal(getattr(lanes[0], name), getattr(lanes[1], name))
    for a, b in zip(lanes[0].trace, lanes[1].trace):
        assert _bits_equal(a, b)
