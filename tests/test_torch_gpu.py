"""The port's CUDA kernels on a card: each against its plain PyTorch
version, bitwise, and a small experiment on the card equal to the same
experiment on the CPU.  Marked ``gpu``; where ``torch.cuda`` is not
available every test skips.  Run on a card with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.core import gridlet, resource, simulation
from repro_torch.kernels import event_scan as ek
from repro_torch.kernels import ops

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
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


def _check_event_scan(r, j, cuda):
    rem, tie, mips, npe, pol, blk, ok = _scan_case(r, j, r * j, cuda)
    kw = dict(tie=tie, policy=pol, pe_blocked=blk, row_ok=ok,
              with_rank=True)
    want = ek.event_scan_ref(rem, mips, npe, **kw)
    got = ek.event_scan_cuda(rem, mips, npe, **kw)
    assert all(_bits_equal(a, b) for a, b in zip(want, got))
    rank = want[4]
    want = ek.event_scan_ref(rem, mips, npe, rank=rank, **kw)
    got = ek.event_scan_cuda(rem, mips, npe, rank=rank, **kw)
    assert all(_bits_equal(a, b) for a, b in zip(want, got))


def _check_refused_launch(cuda):
    """A row too wide for shared memory is refused at launch, and the
    wrapper raises instead of returning unwritten outputs."""
    rem = torch.ones((2, 30000), device=cuda)
    with pytest.raises(RuntimeError, match="event_scan"):
        ek.event_scan_cuda(rem, torch.ones(2, device=cuda),
                           torch.ones(2, device=cuda))


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


def _check_card_tensors_never_reach_the_plain_versions(cuda):
    rem, tie, mips, npe, pol, blk, ok = _scan_case(8, 40, 0, cuda)
    ek.reset_counts()
    ops.event_scan(rem, mips, npe, tie=tie, policy=pol)
    ops.event_frontier(torch.ones(4, device=cuda), (1, 3))
    assert ek.PLAIN_CALLS == {"event_scan": 0, "event_frontier": 0}
    assert ek.LAUNCHES == {"event_scan": 1, "event_frontier": 1}


def test_kernels_match_plain_on_the_card(cuda):
    """Both kernels bitwise against their plain versions (event_scan in
    its fresh and injected-rank forms), a refused launch, and the router
    sending card tensors only to the kernels."""
    for r, j in ((8, 1), (16, 32), (16, 640), (8, 2000), (3, 3000)):
        _check_event_scan(r, j, cuda)
    _check_refused_launch(cuda)
    for sizes in ((16, 11, 11, 1, 0, 1, 1, 0, 2000, 2000, 11, 1),
                  (0, 5, 0), (1,), (700, 3)):
        _check_event_frontier(sizes, cuda)
    _check_card_tensors_never_reach_the_plain_versions(cuda)


def test_experiment_on_the_card_equals_cpu(cuda):
    gen = torch.Generator().manual_seed(5)
    farm = gridlet.task_farm(gen, n_jobs=12, n_users=3)
    fleet = resource.wwg_fleet()
    runs = [simulation.run_experiment(farm, fleet, 600.0, 2500.0,
                                      n_users=3, device=d)
            for d in ("cpu", cuda)]
    for name in ("n_done", "spent", "term_time", "per_resource_done"):
        assert _bits_equal(getattr(runs[0], name), getattr(runs[1], name))
    for name in ("status", "resource", "finish", "cost"):
        assert _bits_equal(getattr(runs[0].gridlets, name),
                           getattr(runs[1].gridlets, name))
    for a, b in zip(runs[0].trace, runs[1].trace):
        assert _bits_equal(a, b)
