"""The port's kernel module (repro_torch.kernels) against the JAX
reference: the plain PyTorch versions of ``event_scan``,
``event_scan_slab``, ``link_scan`` and ``event_frontier`` must equal the
Pallas kernels (interpret mode) and the XLA paths bit for bit (the
sweep engine's lane forms of the checked scan and the frontier equal
their one-lane forms per lane and ``jax.vmap`` of the reference's); those of
``ssd_scan`` and ``flash_attention`` must agree with the Pallas kernels
and the reference's oracles within the reference's own kernel-vs-oracle
tolerances.  The CUDA kernels themselves run only on a card:
tests/test_torch_gpu.py and chip_smoke.py."""
import gc
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jax_engine
from repro.core import network as jax_network
from repro.kernels import event_scan as jax_event
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.core import engine as torch_engine
from repro_torch.kernels import _build
from repro_torch.kernels import event_scan as ek
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as sk

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


def _checked_case(r, j, seed):
    """The engine's checked scan inputs (r >= 4): a slot map over 2 r j
    gridlets (-1 = empty), remaining on a 10 MI grid (many equal; zeros,
    which the gather clamps to 1e-30), time-shared rows of 1-4 PEs, row
    1 space-shared, row 2 down, row 3 empty, row 0 with 3 PEs and both
    share sides; two carried ranks from the reference's own fresh rank:
    "kept" (each row's MaxShare side reversed, the same partition) and
    "one row" (row 0's boundary pair swapped, so only row 0 fails)."""
    rng = np.random.RandomState(seed)
    n = 2 * r * j
    ids = rng.permutation(n)[:r * j].reshape(r, j)
    rg = np.where(rng.rand(r, j) < 0.7, ids, -1).astype(np.int32)
    rg[3] = -1
    occ0 = np.flatnonzero(rg[0] >= 0)
    if len(occ0) % 3 == 0:
        rg[0, occ0[0]] = -1
    remaining = (np.floor(rng.rand(n) * 20.0) * 10.0).astype(np.float32)
    mips = rng.randint(100, 600, r).astype(np.float32)
    npe = rng.randint(1, 5, r).astype(np.float32)
    npe[0] = 3.0
    pol, blk, ok = (np.zeros(r, np.float32), np.zeros(r, np.float32),
                    np.ones(r, np.float32))
    pol[1], ok[2] = 1.0, 0.0
    rem, tie = _jax_table(rg, remaining)
    npe_e, valid, g = (np.asarray(x) for x in jax_event._row_masks(
        rem, npe[:, None], pol[:, None], blk[:, None], ok[:, None]))
    fresh = np.asarray(jax_event._lexsort_rank(rem, tie, valid)[0])
    m = np.maximum(npe_e, 1.0)
    k = np.floor(g / m)
    msc = (npe_e - (g - k * m)) * k
    kept = np.where(valid & (fresh < msc), np.minimum(msc, g) - 1.0 - fresh,
                    fresh).astype(np.float32)
    ms = msc[0, 0]
    assert 0 < ms < g[0, 0]
    one = kept.copy()
    one[0] = np.where(valid[0] & (fresh[0] == ms - 1), ms,
                      np.where(valid[0] & (fresh[0] == ms), ms - 1, fresh[0]))
    return (rg, remaining, mips, npe, pol, blk, ok), {"kept": kept,
                                                      "one row": one}


def _jax_table(rg, remaining):
    """The reference engine's ``_table_inputs`` gather of the table."""
    occupied = rg >= 0
    gid = jnp.clip(rg, 0, remaining.shape[0] - 1)
    rem = jnp.where(occupied, jnp.maximum(remaining[gid], 1e-30), 0.0)
    return rem, jnp.where(occupied, rg, 2 ** 30).astype(jnp.float32)


def _check_checked(r, j):
    """``event_scan_checked_ref`` against the reference's
    ``_checked_scan(select_free=True)`` composed from its parts: the
    gather, ``_row_masks``, the engine's ``_partition_ok``, then
    ``event_scan_xla`` on ``where(use, carry, fresh lexsort)``; the
    carry kept, its flag off, and a carry failing in one row only."""
    (rg, remaining, mips, npe, pol, blk, ok), carries = _checked_case(
        r, j, seed=j)
    rem, tie = _jax_table(rg, remaining)
    npe_e, valid, g = jax_event._row_masks(rem, npe[:, None], pol[:, None],
                                           blk[:, None], ok[:, None])
    fresh = jax_event._lexsort_rank(rem, tie, valid)[0]
    args = [torch.from_numpy(x) for x in (rg, remaining, mips, npe, pol,
                                          blk, ok)]
    for carry, flag, reseeds in (("kept", True, 0), ("kept", False, 1),
                                 ("one row", True, 1)):
        rank = carries[carry]
        use = flag & jax_engine._partition_ok(rem, tie, valid, rank, npe_e,
                                              g, pol[:, None])
        want = jax_event.event_scan_xla(
            rem, mips, npe, tie=tie, policy=pol, pe_blocked=blk, row_ok=ok,
            rank=jnp.where(use, rank, fresh), with_rank=True)
        count = torch.zeros((), dtype=torch.int32)
        port = ek.event_scan_checked_ref(*args, torch.from_numpy(rank),
                                         torch.tensor(flag), count)
        _assert_bitwise(port, want, NAMES)
        assert int(count) == int(~use) == reseeds
        # the carry is used exactly when it passes
        assert np.array_equal(port[4].numpy(), rank) == (reseeds == 0)


def test_event_scan_plain_matches_pallas_and_xla():
    """Fresh rank against the Pallas kernel and the XLA path, injected
    rank against the reference router, at J in {5, 130, 600}; the
    default inputs and empty rows; the engine's checked form against
    the reference's select-free composition at J = 130; and the
    frontier over the engine's layout against Pallas and XLA."""
    for j in (5, 130, 600):
        _check_fresh(j)
        _check_injected(j)
    _check_defaults_and_empty_rows()
    _check_checked(8, 130)
    _check_frontier(FRONTIER_LAYOUTS[0])
    jax.clear_caches()


def _link_case(l, t, seed):
    """Transfer-slot tables with free slots, exact forecast ties
    (integer payloads on odd seeds), empty rows, dead rows (baud 0, at
    BIG and infinite), fractional background flows, and a trunk cap
    that binds on some rows and is BIG on others."""
    rng = np.random.RandomState(seed)
    rem = rng.exponential(1e5, (l, t)).astype(np.float32)
    rem[rng.rand(l, t) < 0.4] = 0.0
    if seed % 2:
        rem = np.where(rem > 0, (rng.randint(1, 4, (l, t)) * 1024.0),
                       0.0).astype(np.float32)
    rem[1] = 0.0                                  # an empty row
    baud = rng.uniform(100.0, 1e4, l).astype(np.float32)
    baud[2], baud[3], baud[4] = 0.0, 3.0e38, np.inf   # dead rows
    bg = rng.choice([0.0, 0.5, 1.0, 2.5], l).astype(np.float32)
    tie = np.stack([rng.permutation(t) for _ in range(l)]).astype(
        np.float32)
    tie = np.where(rem > 0, tie, np.float32(2 ** 30)).astype(np.float32)
    cap = np.where(rng.rand(l) < 0.5, rng.uniform(10.0, 2e3, l),
                   3.0e38).astype(np.float32)
    return rem, baud, bg, tie, cap


def _check_link_scan_tabled(rem, baud, bg, seed):
    """The engine form's plain version (tie key from a slot map; with
    trunks, each trunk's occupancy and cap) against the reference: the
    JAX engine's own ``_link_scan``, and its composition spelled out --
    ``network.trunk_rate_cap`` over the live-row occupancy, then
    ``link_scan_xla``.  The last two rows are the engine's padding (no
    transfer); the trunk topology has a live private row (0), dead rows
    inside trunks (2-4, from ``_link_case``) and an empty one (1)."""
    l, t = rem.shape
    n = l - 2
    rem = rem.copy()
    rem[n:] = 0.0
    rng = np.random.RandomState(seed)
    ids = rng.permutation(2 * l * t)[:l * t].reshape(l, t)
    lg = np.where(rem > 0, ids, -1).astype(np.int32)
    trunk_of = np.array([-1, 0, 0, 1, 1, 0] + [i % 3 - 1 for i in
                                               range(6, n)], np.int32)
    trunks = [np.asarray(x) for x in jax_network.trunk_topology(
        trunk_of, n, trunk_baud=[3e3, 5e4], trunk_bg=[1.0, 0.5])]
    pad = [(0, 2)]
    for topology in (None, trunks):
        # the reference engine's wrapper, on its own state and params
        params = types.SimpleNamespace(
            link_baud=baud[:n], bg_flows=bg[:n],
            **dict(zip(("trunk_of", "trunk_baud", "trunk_bg"),
                       topology or (None,) * 3)))
        want = jax_engine._link_scan(
            types.SimpleNamespace(link_gridlet=jnp.asarray(lg),
                                  link_rem=jnp.asarray(rem)),
            params, n, l)
        # the same, composed by hand
        baud_p = np.pad(baud[:n], (0, 2), constant_values=1.0)
        bg_p = np.pad(bg[:n], (0, 2))
        cap = None
        if topology is not None:
            live = (baud_p > 0.0) & (baud_p < 3.0e38)
            valid = (rem > 0.0) & (rem < 3.0e38) & live[:, None]
            cap = jax_network.trunk_rate_cap(
                jnp.sum(jnp.asarray(valid, jnp.float32), axis=1),
                np.pad(topology[0], pad, constant_values=-1),
                np.pad(topology[1], pad, constant_values=1.0),
                np.pad(topology[2], pad))
        tie = np.where(lg >= 0, lg, 2 ** 30).astype(np.float32)
        spelled = jax_event.link_scan_xla(rem, baud_p, bg=bg_p, tie=tie,
                                          cap=cap)
        # the port: the engine's padded rows, then the plain engine form
        state = types.SimpleNamespace(
            t=torch.zeros(()), link_gridlet=torch.from_numpy(lg),
            link_rem=torch.from_numpy(rem),
            host=torch_engine.HostCounts(
                n_reseeds=torch.zeros((), dtype=torch.int32)))
        tparams = types.SimpleNamespace(
            **{k: None if v is None else torch.from_numpy(np.array(v))
               for k, v in vars(params).items()})
        rows = torch_engine._link_rows(state, tparams, n, l)
        port = ek.link_scan_tabled_ref(state.link_gridlet, state.link_rem,
                                       rows)
        names = ("rate", "t_min", "argmin", "occ")
        _assert_bitwise(port, want, names)
        _assert_bitwise(port, spelled, names)
        _assert_bitwise(torch_engine._link_scan(state, tparams, n, l), want,
                        names)
        if topology is not None:     # the trunk cap binds somewhere
            private = ek.link_scan_tabled_ref(
                state.link_gridlet, state.link_rem, rows._replace(
                    trunk_of=None, trunk_baud=None, trunk_bg=None))
            assert not torch.equal(port[0], private[0])


def test_link_scan_plain_matches_pallas_and_xla():
    """``link_scan_ref`` against the reference router (jitted XLA), the
    eager ``link_scan_xla`` and the Pallas kernel in interpret mode,
    with and without the trunk cap, at T in {5, 12, 130}, and the engine
    form's plain version (``link_scan_tabled_ref``) against the
    reference engine's link scan, with and without trunks; then the
    default tie and background inputs."""
    names = ("rate", "t_min", "argmin", "occ")
    for l, t, seed in ((8, 5, 0), (8, 12, 1), (16, 130, 3)):
        rem, baud, bg, tie, cap = _link_case(l, t, seed)
        _check_link_scan_tabled(rem, baud, bg, seed)
        for c in (None, cap):
            port = ops.link_scan(
                torch.from_numpy(rem), torch.from_numpy(baud),
                bg=torch.from_numpy(bg), tie=torch.from_numpy(tie),
                cap=None if c is None else torch.from_numpy(c))
            kw = dict(bg=bg, tie=tie, cap=c)
            _assert_bitwise(port, jax_ops.link_scan(rem, baud, **kw), names)
            _assert_bitwise(port, jax_event.link_scan_xla(rem, baud, **kw),
                            names)
            _assert_bitwise(port, jax_ops.link_scan(rem, baud,
                                                    interpret=True, **kw),
                            names)
            # an empty or dead row answers T; live rows share exactly
            assert int(port[2][1]) == t and int(port[3][2]) == 0
    rem, baud, _, _, _ = _link_case(8, 9, 5)
    _assert_bitwise(ops.link_scan(torch.from_numpy(rem),
                                  torch.from_numpy(baud)),
                    jax_event.link_scan_xla(rem, baud), names)
    # Compiled, the reference reads subnormal payloads and links as
    # zero (eager JAX keeps them): a subnormal slot is empty, a
    # subnormal link dead.
    rem[0, 0], baud[5] = 1e-40, 1e-40
    _assert_bitwise(ops.link_scan(torch.from_numpy(rem),
                                  torch.from_numpy(baud)),
                    jax_ops.link_scan(rem, baud), names)
    jax.clear_caches()


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


def _check_frontier(sizes):
    names = ("t_star", "fired", "counts", "t_safe", "mins")
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


def test_event_frontier_plain_matches_pallas_and_xla():
    for sizes in FRONTIER_LAYOUTS:
        _check_frontier(sizes)


def test_lane_forms_match_per_lane_and_jax_vmap():
    """The sweep engine's lane forms: ``event_scan_checked_lanes_ref``
    over 4 lanes (the carry kept, its flag off, a carry failing in one
    row, kept again), with and without the reseed, against the one-lane
    ``event_scan_checked_ref`` of each lane and against ``jax.vmap`` of
    the reference's select-free composition (``_partition_ok``, the
    lexsort, ``event_scan_xla``); ``event_frontier_lanes_ref`` over 3
    lanes of every layout against ``event_frontier_ref`` per lane and
    ``jax.vmap`` of the reference's ``ops.event_frontier`` (XLA path);
    every output bitwise."""
    r, j = 8, 33
    lanes = [_checked_case(r, j, seed) for seed in (1, 2, 3, 4)]
    choice = (("kept", True), ("kept", False), ("one row", True),
              ("kept", True))
    ins = [np.stack(x) for x in zip(*(case for case, _ in lanes))]
    rank = np.stack([c[k] for (_, c), (k, _) in zip(lanes, choice)])
    flag = np.array([f for _, f in choice])
    rg, remaining, mips, npe, pol, blk, ok = ins

    def jax_lane(rg, remaining, mips, npe, pol, blk, ok, rank, flag,
                 reseed):
        rem, tie = _jax_table(rg, remaining)
        npe_e, valid, g = jax_event._row_masks(
            rem, npe[:, None], pol[:, None], blk[:, None], ok[:, None])
        use = flag & jax_engine._partition_ok(rem, tie, valid, rank, npe_e,
                                              g, pol[:, None])
        fresh = jax_event._lexsort_rank(rem, tie, valid)[0]
        out = jax_event.event_scan_xla(
            rem, mips, npe, tie=tie, policy=pol, pe_blocked=blk, row_ok=ok,
            rank=jnp.where(use, rank, fresh) if reseed else rank,
            with_rank=True)
        return out, use

    args = [torch.from_numpy(x) for x in ins]
    for reseed in (True, False):
        port, use = ek.event_scan_checked_lanes_ref(
            *args, torch.from_numpy(rank), torch.from_numpy(flag),
            reseed=reseed)
        want, want_use = jax.vmap(
            lambda *a: jax_lane(*a, reseed))(*ins, rank, flag)
        _assert_bitwise(port, want, NAMES)
        assert use.tolist() == np.asarray(want_use).tolist() == \
            [True, False, False, True]
        for lane in range(4):
            count = torch.zeros((), dtype=torch.int32)
            one = ek.event_scan_checked_ref(
                *(a[lane] for a in args), torch.from_numpy(rank[lane]),
                torch.tensor(flag[lane]), count)
            if reseed or use[lane]:
                _assert_bitwise([x[lane] for x in port], one, NAMES)
            assert int(count) == int(~use[lane])

    names = ("t_star", "fired", "counts", "t_safe", "mins")
    for sizes in FRONTIER_LAYOUTS:
        cases = [_frontier_case(sizes, seed) for seed in (5, 6, 7)]
        cand = np.stack([c for c, _ in cases])
        cuts = np.stack([k for _, k in cases])
        for use_cuts in (None, cuts):
            tc = None if use_cuts is None else torch.from_numpy(use_cuts)
            port = ek.event_frontier_lanes_ref(torch.from_numpy(cand), sizes,
                                               tc)
            jc = None if use_cuts is None else use_cuts.astype(np.float32)
            want = jax.vmap(lambda c, k: jax_ops.event_frontier(
                c, sizes, k, interpret=None), in_axes=(0, None if jc is None
                                                        else 0))(cand, jc)
            _assert_bitwise(port, want, names)
            for lane in range(3):
                one = ek.event_frontier_ref(
                    torch.from_numpy(cand[lane]), sizes,
                    None if tc is None else tc[lane])
                _assert_bitwise([x[lane] for x in port], one, names)
    jax.clear_caches()


def _slab_case(r, j, seed):
    """The reference's slab case: empty slots, integer remaining values
    on odd seeds (ties within and across rows), a permuted tie key,
    mixed policies, blocked PEs and down rows."""
    rng = np.random.RandomState(seed)
    rem = rng.exponential(50.0, (r, j)).astype(np.float32)
    rem[rng.rand(r, j) < 0.3] = 0.0
    if seed % 2:
        rem = np.where(rem > 0, rng.randint(1, 5, (r, j)), 0.0).astype(
            np.float32)
    mips = rng.uniform(1.0, 500.0, (r,)).astype(np.float32)
    npe = rng.randint(1, 9, (r,)).astype(np.int32)
    kw = dict(tie=rng.permutation(r * j).reshape(r, j).astype(np.float32),
              policy=rng.randint(0, 2, (r,)).astype(np.int32),
              pe_blocked=rng.randint(0, 4, (r,)).astype(np.float32),
              row_ok=(rng.rand(r) < 0.8).astype(np.float32))
    return rem, mips, npe, kw


def test_event_scan_slab_plain_matches_pallas_and_xla():
    """``event_scan_slab_ref`` bit for bit against the reference router's
    XLA path (``associative_scan`` order) and the Pallas kernel in
    interpret mode (``tree=True``), sequential and associative, with
    the live gate open, shut and absent, at k in {1, 4, 6}; wave 0
    against the port's own ``event_scan``."""
    names = ("t_wave", "col_wave")
    for (r, j), seed in (((8, 12), 1), ((16, 40), 3), ((16, 40), 4)):
        rem, mips, npe, kw = _slab_case(r, j, seed)
        t = {a: torch.from_numpy(v) for a, v in kw.items()}
        args = [torch.from_numpy(x) for x in (rem, mips, npe)]
        for k in (1, 4, 6):
            lives = (None, True, False) if k == 4 else (None,)
            for assoc in (True, False):
                for live in lives:
                    jl = None if live is None else np.bool_(live)
                    tl = None if live is None else torch.tensor(live)
                    xla = jax_ops.event_scan_slab(rem, mips, npe, k, **kw,
                                                  live=jl, assoc=assoc)
                    pallas = jax_ops.event_scan_slab(
                        rem, mips, npe, k, **kw, live=jl, assoc=assoc,
                        interpret=True)
                    port = ops.event_scan_slab(*args, k, **t, live=tl,
                                               assoc=assoc)
                    tree = ek.event_scan_slab_ref(*args, k, **t, live=tl,
                                                  assoc=assoc, tree=True)
                    _assert_bitwise(port, xla, names)
                    _assert_bitwise(tree, pallas, names)
                    if live is False:
                        assert (port[1] == j).all()
        _, tmin, amin, _ = ops.event_scan(*args, **t)
        for assoc in (True, False):
            t_w, col_w = ops.event_scan_slab(*args, 3, **t, assoc=assoc)
            _assert_bitwise((t_w[:, 0], col_w[:, 0]), (tmin, amin), names)
    jax.clear_caches()


def test_ssd_scan_plain_matches_pallas_and_oracle():
    """``ssd_scan_ref`` against the Pallas kernel (interpret mode) and
    the token-by-token oracle, in f32 and bf16, at the reference's
    tolerances (5e-4, 5e-2)."""
    for b, s, h, p, n, chunk, block_h in ((2, 64, 8, 16, 32, 16, 4),
                                          (2, 48, 2, 8, 8, 16, 2)):
        rng = np.random.RandomState(s + h)
        x = rng.standard_normal((b, s, h, p)).astype(np.float32)
        dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(
            np.float32)
        a = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
        bm, cm = rng.standard_normal((2, b, s, n)).astype(np.float32)
        for jd, td, tol in ((jnp.float32, torch.float32, 5e-4),
                            (jnp.bfloat16, torch.bfloat16, 5e-2)):
            jx = jnp.asarray(x, jd)
            want = [jax_ops.ssd_scan(jx, dt, a, bm, cm, chunk=chunk,
                                     block_h=block_h, interpret=True),
                    jax_ref.ssd_ref(jx, dt, a, bm, cm)]
            got = ops.ssd_scan(torch.from_numpy(x).to(td),
                               *map(torch.from_numpy, (dt, a, bm, cm)),
                               chunk=chunk, block_h=block_h)
            assert got.dtype == td
            for w in want:
                np.testing.assert_allclose(
                    got.float().numpy(), np.asarray(w, np.float32),
                    rtol=tol, atol=tol)
    jax.clear_caches()


def test_flash_attention_plain_matches_pallas_and_oracle():
    """``flash_attention_ref`` against the Pallas kernel (interpret
    mode) and the reference's oracle with GQA and a window, a soft-cap,
    and without the causal mask, in f32 and bf16, at the reference's
    tolerances (2e-5, 2e-2)."""
    for b, hq, hkv, s, d, causal, window, cap in (
            (2, 4, 1, 128, 32, True, 32, 0.0),
            (1, 8, 8, 256, 64, True, 0, 50.0),
            (1, 2, 2, 64, 16, False, 0, 0.0)):
        rng = np.random.RandomState(s + d)
        q = rng.standard_normal((b, hq, s, d)).astype(np.float32)
        k, v = rng.standard_normal((2, b, hkv, s, d)).astype(np.float32)
        kw = dict(causal=causal, window=window, cap=cap)
        for jd, td, tol in ((jnp.float32, torch.float32, 2e-5),
                            (jnp.bfloat16, torch.bfloat16, 2e-2)):
            jq, jk, jv = (jnp.asarray(x, jd) for x in (q, k, v))
            want = [jax_ops.flash_attention(jq, jk, jv, block_q=32,
                                            block_kv=32, interpret=True,
                                            **kw),
                    jax_ref.flash_attention_ref(jq, jk, jv, **kw)]
            got = ops.flash_attention(
                *(torch.from_numpy(x).to(td) for x in (q, k, v)),
                block_q=32, block_kv=32, **kw)
            assert got.dtype == td
            for w in want:
                np.testing.assert_allclose(
                    got.float().numpy(), np.asarray(w, np.float32),
                    rtol=tol, atol=tol)
    jax.clear_caches()


def _tf32(x):
    """cvt.rna.tf32.f32: the float nearest x with 10 mantissa bits, ties
    away from zero (half an ulp added to the magnitude, the 13 low bits
    cut)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _matmul_3xtf32(a, b, apart, terms=3):
    """f32 a @ b as the f32 flash kernel's tensor-core products: each
    operand split as big = TF32(x), small = TF32(x - big); big.big plus
    (small.big + big.small), each product exact and summed in f64, then
    rounded to f32 once (``apart``: big.big and the small terms rounded
    apart and added in f32, as the kernel's S; else together, as its
    P V).  ``terms=1`` keeps big.big alone: one TF32 product."""
    f64 = np.float64
    ab, bb = _tf32(a), _tf32(b)
    big = ab.astype(f64) @ bb.astype(f64)
    if terms == 1:
        return big.astype(np.float32)
    small = (_tf32(a - ab).astype(f64) @ bb.astype(f64) +
             ab.astype(f64) @ _tf32(b - bb).astype(f64))
    if apart:
        return big.astype(np.float32) + small.astype(np.float32)
    return (big + small).astype(np.float32)


def _flash_3xtf32(q, k, v, causal, window, cap, terms=3):
    """The f32 flash kernel's arithmetic in numpy: an online softmax in
    f32 over the kernel's key tiles (64 keys, 32 from d = 128 up), both
    products as :func:`_matmul_3xtf32`."""
    f32 = np.float32
    _, hq, sq, d = q.shape
    block_k = 32 if d > 64 else 64
    hkv, skv = k.shape[1], k.shape[2]
    neg_inf, scale = f32(-2.0 ** 30), f32(d ** -0.5)
    qpos = np.arange(sq)[:, None]
    out = np.empty_like(q)
    for bi in range(q.shape[0]):
        for h in range(hq):
            kh, vh = k[bi, h // (hq // hkv)], v[bi, h // (hq // hkv)]
            m = np.full(sq, neg_inf, f32)
            l = np.zeros(sq, f32)
            acc = np.zeros((sq, d), f32)
            for lo in range(0, skv, block_k):
                kt, vt = kh[lo:lo + block_k], vh[lo:lo + block_k]
                s = _matmul_3xtf32(q[bi, h], kt.T, True, terms) * scale
                if cap:
                    s = np.tanh(s / f32(cap)) * f32(cap)
                kpos = np.arange(lo, lo + len(kt))[None, :]
                keep = np.ones(s.shape, bool)
                if causal:
                    keep &= kpos <= qpos
                if window:
                    keep &= kpos > qpos - window
                s = np.where(keep, s, neg_inf)
                m_new = np.maximum(m, s.max(-1))
                p = np.exp(s - m_new[:, None])
                alpha = np.exp(m - m_new)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[:, None] + _matmul_3xtf32(p, vt, False,
                                                             terms)
                m = m_new
            out[bi, h] = acc / np.maximum(l, f32(1e-30))[:, None]
    return out


@pytest.mark.parametrize("d", (16, 128, 256))
def test_flash_attention_3xtf32_emulation_holds_the_tolerance(d):
    """The f32 kernel's precision, before any card time: its arithmetic
    emulated in numpy (3xTF32 products with cvt.rna's rounding inside
    an online softmax over the kernel's key tiles) against
    ``flash_attention_ref`` and the Pallas kernel (interpret mode, whose
    blocks must divide the length) at the reference's 2e-5, causal, with
    a cap, and with a window and GQA, over a length that is not a whole
    number of the kernel's tiles; one TF32 product instead must miss
    it."""
    b, hq, hkv, s, tol = 1, 4, 2, 150, 2e-5
    rng = np.random.RandomState(d)
    q = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    k, v = rng.standard_normal((2, b, hkv, s, d)).astype(np.float32)
    for causal, window, cap in ((True, 0, 0.0), (True, 0, 50.0),
                                (True, 48, 0.0)):
        kw = dict(causal=causal, window=window, cap=cap)
        got = _flash_3xtf32(q, k, v, **kw)
        want = [fk.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                       **kw).numpy(),
                np.asarray(jax_ops.flash_attention(
                    *map(jnp.asarray, (q, k, v)), block_q=30, block_kv=30,
                    interpret=True, **kw))]
        for w in want:
            np.testing.assert_allclose(got, w, rtol=tol, atol=tol)
        one = _flash_3xtf32(q, k, v, terms=1, **kw)
        assert not np.allclose(one, want[0], rtol=tol, atol=tol)
    jax.clear_caches()


def test_cpu_tensors_route_to_plain_versions():
    rem, tie, mips, npe, pol, blk, ok = _scan_case(8, 9, seed=1)
    ek.reset_counts()
    ops.event_scan(torch.from_numpy(rem), torch.from_numpy(mips),
                   torch.from_numpy(npe), tie=torch.from_numpy(tie))
    ops.event_frontier(torch.ones(4), (1, 3))
    ops.link_scan(torch.from_numpy(rem), torch.from_numpy(mips))
    ops.event_scan_slab(torch.from_numpy(rem), torch.from_numpy(mips),
                        torch.from_numpy(npe), 2)
    x = torch.ones((1, 8, 2, 4))
    ops.ssd_scan(x, torch.ones((1, 8, 2)), -torch.ones(2),
                 torch.ones((1, 8, 3)), torch.ones((1, 8, 3)), chunk=4)
    q = torch.ones((1, 2, 8, 16))
    ops.flash_attention(q, q, q)
    assert ek.PLAIN_CALLS == dict.fromkeys(
        ("event_scan", "event_frontier", "link_scan", "event_scan_slab",
         "ssd_scan", "flash_attention"), 1) | dict.fromkeys(
        ("event_scan_lanes", "event_frontier_lanes"), 0)
    assert ek.LAUNCHES == dict.fromkeys(ek.PLAIN_CALLS, 0)
    # one pair of counters, shared by every kernel module
    assert sk.LAUNCHES is ek.LAUNCHES and fk.PLAIN_CALLS is ek.PLAIN_CALLS
    # the kernels' own wrappers take no CPU tensor
    with pytest.raises(ValueError):
        ek.event_scan_cuda(torch.ones(8, 4), torch.ones(8), torch.ones(8))
    with pytest.raises(ValueError):
        ek.event_frontier_cuda(torch.ones(4), (1, 3))
    with pytest.raises(ValueError):
        ek.event_scan_checked_cuda(
            torch.zeros((8, 4), dtype=torch.int32), *[torch.ones(8)] * 6,
            torch.zeros((8, 4)), torch.tensor(True),
            torch.zeros((), dtype=torch.int32))
    with pytest.raises(ValueError):
        ek.event_scan_checked_lanes_cuda(
            torch.zeros((2, 8, 4), dtype=torch.int32), torch.ones(2, 9),
            *[torch.ones(2, 8)] * 5, torch.zeros((2, 8, 4)),
            torch.ones(2, dtype=torch.bool))
    with pytest.raises(ValueError):
        ek.event_frontier_lanes_cuda(torch.ones(2, 4), (1, 3))
    with pytest.raises(ValueError):
        ek.link_scan_cuda(torch.ones(8, 4), torch.ones(8))
    with pytest.raises(ValueError):
        ek.link_scan_tabled_cuda(torch.zeros((8, 4), dtype=torch.int32),
                                 torch.ones(8, 4),
                                 ek.LinkRows(torch.ones(8), torch.zeros(8)))
    with pytest.raises(ValueError):
        ek.event_scan_slab_cuda(torch.ones(8, 4), torch.ones(8),
                                torch.ones(8), 2)
    with pytest.raises(ValueError):
        sk.ssd_scan_cuda(x, torch.ones((1, 8, 2)), -torch.ones(2),
                         torch.ones((1, 8, 3)), torch.ones((1, 8, 3)))
    with pytest.raises(ValueError):
        fk.flash_attention_cuda(q, q, q)


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
