"""The port's leaf modules against the JAX reference: fleet tables,
calendar, economy (the pricing rounds too), network delays, segmented
ranks and sums, the reference-order float helpers, the threefry PRNG and
XLA:CPU's log1p and exp2, reservation tables and the booking calendar,
the GIS, the gridlet table and the event queue.  Inputs are numpy
arrays made from a seed; floats compare bit for bit."""
import dataclasses
import gc
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import calendar as jcal
from repro.core import des as jdes
from repro.core import economy as jecon
from repro.core import gis as jgis
from repro.core import gridlet as jgrid
from repro.core import network as jnet
from repro.core import rand as jrand
from repro.core import reservation as jresv
from repro.core import resource as jres
from repro.core import segments as jseg
from repro.core import types as jtypes
from repro_torch import convert
from repro_torch.core import (calendar, des, economy, gis, gridlet,
                              network, numerics, rand, reservation,
                              resource, segments, types)

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


def _bits(x):
    a = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _eq(port, ref, msg=""):
    np.testing.assert_array_equal(_bits(port), _bits(ref), err_msg=msg)


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _check_codes():
    for name in ("CREATED", "IN_TRANSIT", "QUEUED", "RUNNING", "RETURNING",
                 "DONE", "FAILED", "TIME_SHARED", "SPACE_SHARED", "FCFS",
                 "SJF", "OPT_COST", "OPT_TIME", "OPT_COST_TIME",
                 "OPT_NONE"):
        assert getattr(types, name) == getattr(jtypes, name), name
    assert des.PRIORITY_ORDER == jdes.PRIORITY_ORDER
    for name in dir(jdes):
        if name.startswith("K_"):
            assert getattr(des, name) == getattr(jdes, name), name


FLEETS = (
    lambda m: m.wwg_fleet(),
    lambda m: m.table1_resource(jtypes.TIME_SHARED),
    lambda m: m.table1_resource(jtypes.SPACE_SHARED),
    lambda m: m.make_fleet([3, 5], [100.0, 250.0], [1.5, 2.0],
                           jtypes.SPACE_SHARED, time_zone=[2.0, -5.0]),
)


def test_codes_and_fleet_tables_match_reference():
    _check_codes()
    for make in FLEETS:
        ref, port = make(jres), make(resource)
        for name, arr in _leaves(ref).items():
            _eq(getattr(port, name), arr, name)
        _eq(port.cost_per_mi(), ref.cost_per_mi())
        _eq(port.peak_rate(), ref.peak_rate())
        assert port.max_pe == ref.max_pe and port.r == ref.r


def _weekend_fleets():
    kw = dict(time_zone=[10.0, 9.0, 1.0, -6.0, 0.0],
              base_load=[0.0, 0.1, 0.2, 0.0, 0.5],
              weekend_load=[0.3, 0.0, 0.5, 0.9, 0.2])
    args = ([4, 2, 16, 8, 1], [515.0, 377.0, 410.0, 380.0, 100.0],
            [8.0, 4.0, 5.0, 3.0, 1.0], jtypes.TIME_SHARED)
    return jres.make_fleet(*args, **kw), resource.make_fleet(*args, **kw)


def test_calendar_over_a_week_of_instants():
    """The engine evaluates the calendar inside its compiled loop, so the
    reference is the jitted function (XLA multiplies by 1/24 there)."""
    jf, tf = _weekend_fleets()
    t = np.concatenate([np.arange(0.0, 2 * 168.0, 0.37),
                        np.arange(0.0, 2 * 168.0, 24.0) - 1e-3,
                        [23.999998, 24.0, 120.0, 168.0, 191.0]])
    eff = jax.jit(jcal.effective_mips)
    nb = jax.jit(jcal.next_boundary)
    day = jax.jit(jcal.local_day_and_hour)
    for x in t.astype(np.float32):
        tt = torch.tensor(x)
        _eq(calendar.effective_mips(tf, tt), eff(jf, x), f"t={x}")
        _eq(calendar.next_boundary(tf, tt), nb(jf, x), f"t={x}")
        for p, r in zip(calendar.local_day_and_hour(tt, tf.time_zone),
                        day(x, jf.time_zone)):
            _eq(p, r, f"t={x}")


def _check_quickstart_header():
    """examples/quickstart.py's header line, from the reference's farm
    drawn in the PRNG layout that line was recorded with."""
    with jax.threefry_partitionable(False):
        farm = jgrid.task_farm(jax.random.PRNGKey(7), n_jobs=200)
    total = float(farm.length_mi.sum())
    fleet = resource.wwg_fleet()
    header = tuple(round(float(f(fleet, total))) for f in (
        economy.t_min, economy.t_max, economy.c_min, economy.c_max))
    assert header == (76, 5555, 5511, 32530)
    jfleet = jres.wwg_fleet()
    for name in ("t_min", "t_max", "c_min", "c_max"):
        _eq(getattr(economy, name)(fleet, total),
            getattr(jecon, name)(jfleet, total), name)


def _check_factors():
    jfleet, fleet = jres.wwg_fleet(), resource.wwg_fleet()
    reg = np.array([True] * 5 + [False] * 6)
    for total in (2094095.5, 12345.678):
        for d, b in ((0.0, 0.0), (0.3, 0.7), (1.0, 1.0), (-0.2, 1.5)):
            _eq(economy.deadline_from_factor(fleet, total, d),
                jecon.deadline_from_factor(jfleet, total, d))
            _eq(economy.budget_from_factor(fleet, total, b),
                jecon.budget_from_factor(jfleet, total, b))
            _eq(economy.deadline_from_factor(fleet, total, d,
                                             torch.from_numpy(reg)),
                jecon.deadline_from_factor(jfleet, total, d, reg))
    for m in (None, "static", "commodity", "auction", 2):
        assert economy.as_pricing_model(m) == jecon.as_pricing_model(m)


def _check_transfer_delay_edge_cases():
    nbytes = np.array([0.0, 1.0, 2e5, 3e38, -5.0, 1e6], np.float32)
    baud = np.array([28000.0, np.inf, 0.0, 1e-40, 9600.0, 3e-39],
                    np.float32)
    _eq(network.transfer_delay(torch.from_numpy(nbytes),
                               torch.from_numpy(baud)),
        jnet.transfer_delay(nbytes, baud))
    length = np.full(6, 10.0, np.float32)
    jg = jgrid.make_batch(length, in_bytes=nbytes, out_bytes=nbytes[::-1])
    g = gridlet.make_batch(torch.from_numpy(length),
                           in_bytes=torch.from_numpy(nbytes),
                           out_bytes=torch.from_numpy(nbytes[::-1].copy()))
    jf = jres.make_fleet([1] * 6, 1.0, 1.0, 0, baud_rate=baud)
    f = resource.make_fleet([1] * 6, 1.0, 1.0, 0,
                            baud_rate=torch.from_numpy(baud))
    idx = np.array([5, 4, 3, 2, 1, 0])
    t_idx = torch.from_numpy(idx)
    _eq(network.submit_delay(g, f, t_idx), jnet.submit_delay(jg, jf, idx))
    _eq(network.return_delay(g, f, t_idx), jnet.return_delay(jg, jf, idx))


def _check_fair_share_leaves():
    """``fastest_drain``, ``link_tabled`` and the trunk helpers against
    the jitted reference (the engine runs them inside its compiled
    loop), on payloads and links at every clamp: empty, negative,
    huge, dead (0, denormal), BIG and infinite baud."""
    rng = np.random.RandomState(7)
    nbytes = np.concatenate([
        np.array([0.0, -3.0, 1.0, 2e5, 3e38, 1e30], np.float32),
        rng.exponential(1e5, 30).astype(np.float32)])
    baud = np.concatenate([
        np.array([28000.0, 0.0, 1e-40, 3.0e38, np.inf, 9600.0],
                 np.float32),
        rng.uniform(100.0, 1e5, 30).astype(np.float32)])
    bg = rng.choice([0.0, 0.5, 1.0, 2.5, 7.0], 36).astype(np.float32)
    t = [torch.from_numpy(x) for x in (nbytes, baud, bg)]
    _eq(network.fastest_drain(*t), jax.jit(jnet.fastest_drain)(
        nbytes, baud, bg), "fastest_drain")
    _eq(network.link_tabled(t[0], t[1]),
        jax.jit(jnet.link_tabled)(nbytes, baud), "link_tabled")
    trunk_of = [0, 0, 1, -1, 1, 2, -1, 0, 2, -1, 1]
    for tb, tg in ((None, None), (56000.0, 0.0),
                   ([5e4, 1e3, 7e4], [0.0, 1.5, 0.25])):
        port = network.trunk_topology(trunk_of, 11, tb, tg)
        ref = jnet.trunk_topology(trunk_of, 11, tb, tg)
        for p, r in zip(port, ref):
            _eq(p, r, "trunk_topology")
        _eq(network.trunk_incidence(port[0], 11),
            jnet.trunk_incidence(ref[0], 11), "trunk_incidence")
        occ = rng.randint(0, 40, 11).astype(np.float32)
        _eq(network.trunk_rate_cap(torch.from_numpy(occ), *port),
            jax.jit(jnet.trunk_rate_cap)(occ, *ref), "trunk_rate_cap")
    with pytest.raises(ValueError):
        network.trunk_topology([0, 1], 3)
    with pytest.raises(ValueError):
        network.trunk_topology([0, -2, 1], 3)


def _check_segments():
    rng = np.random.RandomState(0)
    for n, groups in ((1, 1), (40, 3), (300, 25), (2048, 8)):
        key = rng.randint(0, groups, n).astype(np.int32)
        member = rng.rand(n) < 0.7
        order = np.floor(rng.uniform(0, 10, n)).astype(np.float32)  # ties
        values = rng.uniform(0, 1e4, n).astype(np.float32)
        t = [torch.from_numpy(x) for x in (key, member, order, values)]
        for p, r in zip(segments.group_rank(t[0], t[1], t[2], groups),
                        jseg.group_rank(key, member, order, groups)):
            _eq(p, r)
        _eq(segments.group_prefix_sum(t[0], t[1], t[2], t[3], groups),
            jax.jit(jseg.group_prefix_sum, static_argnums=4)(
                key, member, order, values, groups))


def _check_ordered_sum():
    """``jnp.sum`` of f32 ``[N]`` (XLA:CPU's window-32 tree) against
    numerics.ordered_sum, signed values over 14 binades so every order
    difference shows."""
    rng = np.random.RandomState(8)
    for n in (0, 1, 31, 32, 33, 100, 129, 1055, 2000, 20000, 70000):
        x = (np.exp(rng.uniform(0, 14, n)) *
             rng.choice([-1.0, 1.0], n)).astype(np.float32)
        _eq(numerics.ordered_sum(torch.from_numpy(x)), jnp.sum(x), f"n={n}")


def _check_cumsum():
    for n in (1, 15, 16, 17, 200, 2048, 20000):
        x = np.random.RandomState(n).uniform(0, 1e4, n).astype(np.float32)
        _eq(numerics.cumsum(torch.from_numpy(x)), jax.jit(jnp.cumsum)(x),
            f"n={n}")


def _check_segment_sum_and_scatter_add_fold():
    rng = np.random.RandomState(1)
    n, u = 300, 7
    v = rng.uniform(0, 1e4, n).astype(np.float32)
    v[rng.rand(n) < 0.3] = 0.0
    seg = rng.randint(0, u, n).astype(np.int32)
    init = rng.uniform(0, 1e5, u).astype(np.float32)
    width = int(np.bincount(seg).max())
    _eq(numerics.segment_sum(torch.from_numpy(v), torch.from_numpy(seg),
                             u, width),
        jax.jit(lambda v, s: jax.ops.segment_sum(v, s, num_segments=u))(
            v, seg))
    _eq(numerics.segment_sum(torch.from_numpy(v), torch.from_numpy(seg),
                             u, width, init=torch.from_numpy(init)),
        jax.jit(lambda i, v, s: i + jax.ops.segment_sum(
            v, s, num_segments=u))(init, v, seg))


def _check_fma():
    """XLA:CPU contracts ``c - a * b`` in a fused loop; the port's fma is
    that single rounding, including near-cancelling inputs."""
    rng = np.random.RandomState(2)
    a = rng.uniform(0, 500, 200000).astype(np.float32)
    b = rng.uniform(0, 30, 200000).astype(np.float32)
    c = (a.astype(np.float64) * b * (1 + rng.uniform(-1e-6, 1e-6,
                                                     200000))
         ).astype(np.float32)
    c[::2] = rng.uniform(0, 1e4, 100000).astype(np.float32)
    ref = jax.jit(lambda a, b, c: c - a * b)(a, b, c)
    port = numerics.fma(-torch.from_numpy(a), torch.from_numpy(b),
                        torch.from_numpy(c))
    _eq(port, ref)


def _check_min_affordable_cost():
    from repro.core import broker as jbroker
    from repro_torch.core import broker
    rng = np.random.RandomState(4)
    length = rng.uniform(9000, 11000, 40).astype(np.float32)
    user = np.repeat(np.arange(4), 10).astype(np.int32)
    status = rng.choice([jtypes.CREATED, jtypes.RUNNING, jtypes.DONE,
                         jtypes.FAILED], 40).astype(np.int32)
    status[30:] = jtypes.DONE                 # user 3: nothing to buy
    jg = jtypes.replace(jgrid.make_batch(length, user=user), status=status)
    g = types.replace(gridlet.make_batch(torch.from_numpy(length),
                                         user=torch.from_numpy(user)),
                      status=torch.from_numpy(status))
    _eq(broker.min_affordable_cost(g, resource.wwg_fleet(), 4),
        jbroker.min_affordable_cost(jg, jres.wwg_fleet(), 4))


def _check_gridlet_batch():
    length = np.array([10.0, 8.5, 9.5, 12.25], np.float32)
    user = np.array([0, 0, 1, 1], np.int32)
    ref = jgrid.make_batch(length, in_bytes=5.0, user=user)
    port = gridlet.make_batch(torch.from_numpy(length), in_bytes=5.0,
                              user=torch.from_numpy(user))
    for name, arr in _leaves(ref).items():
        _eq(getattr(port, name), arr, name)
    back = convert.gridlets(_leaves(ref))
    for name, arr in _leaves(ref).items():
        _eq(getattr(back, name), arr, name)


def _check_task_farm_and_real_draws():
    """``task_farm`` and ``real`` on a key, bitwise the reference's in
    both threefry layouts (the gate: task_farm(PRNGKey(3), 100, 20))."""
    for part in (True, False):
        with jax.threefry_partitionable(part):
            ref = jgrid.task_farm(jax.random.PRNGKey(3), n_jobs=100,
                                  n_users=20)
            d = np.linspace(1.0, 1e4, 1000).astype(np.float32)
            real = {s: jrand.real_named(jax.random.PRNGKey(1), d, s)
                    for s in ("exec", "net_io", "none")}
        farm = gridlet.task_farm(rand.PRNGKey(3), n_jobs=100, n_users=20,
                                 partitionable=part)
        for name, arr in _leaves(ref).items():
            _eq(getattr(farm, name), arr, f"{part} {name}")
        for situation, want in real.items():
            _eq(rand.real_named(rand.PRNGKey(1), torch.from_numpy(d),
                                situation, partitionable=part), want,
                f"{part} real {situation}")
    assert bool((farm.length_mi >= 10_000.0).all())
    assert bool((farm.length_mi < 11_000.0).all())
    e = rand.exponential(rand.PRNGKey(0), torch.tensor([0.0, 5.0, -1.0]))
    assert torch.isinf(e[0]) and torch.isfinite(e[1]) and torch.isinf(e[2])


def _check_event_queue():
    rq, pq = jdes.make_queue(3), des.make_queue(3)
    for time_ in (5.0, 2.0, 2.0, 9.0):       # the last one overflows
        rq = jdes.schedule(rq, time_, 1, 2, 3)
        pq = des.schedule(pq, time_, 1, 2, 3)
    assert int(pq.overflow) == int(rq.overflow) == 1
    _eq(des.peek_time(pq), jdes.peek_time(rq))
    for _ in range(4):
        rq, rev = jdes.pop_next(rq)
        pq, pev = des.pop_next(pq)
        for p, r in zip(pev, rev):
            _eq(p, r)
    pq = des.cancel(des.schedule(pq, 1.0, 0, 0, 7), lambda q: q.tag == 7)
    assert int(des.size(pq)) == 0


def _check_event_source_contract():
    """FnSource's candidate, horizon and masked-apply hooks, on a toy
    state (the masked apply is bitwise apply when fired, identity when
    not)."""
    @dataclasses.dataclass(frozen=True)
    class Toy:
        t: torch.Tensor
        x: torch.Tensor

    state = Toy(t=torch.tensor(1.0), x=torch.tensor([3.0, float("inf")]))
    bump = des.FnSource(7, "toy", lambda s: s.x,
                        lambda s, now: types.replace(s, x=s.x + now))
    safe = types.replace(bump, horizon_fn=des.no_interference)
    assert float(bump.next_time(state)) == 3.0
    assert bump.horizon_candidates(state).shape == (2,)
    assert safe.horizon_candidates(state).shape == (0,)
    assert float(bump.horizon(state, float("inf"))) == 3.0
    fired = bump.masked_apply(state, torch.tensor(2.0), torch.tensor(True))
    kept = bump.masked_apply(state, torch.tensor(np.nan),
                             torch.tensor(False))
    assert torch.equal(fired.x, bump.apply(state, torch.tensor(2.0)).x)
    assert torch.equal(kept.x, state.x) and torch.equal(kept.t, state.t)


def test_economy_and_network_match_reference():
    """quickstart's header, the D-/B-factors, the network delays on edge
    inputs, the fair-share and trunk leaves, and the broker's
    min-affordable cost."""
    _check_quickstart_header()
    _check_factors()
    _check_transfer_delay_edge_cases()
    _check_fair_share_leaves()
    _check_min_affordable_cost()


def test_segments_and_float_order_match_xla():
    """Segmented ranks and sums, and the reference-order float helpers
    (cumsum's tile order at sizes around 16, the full sum's window-32
    tree, the ordered segment_sum and its scatter-add fold, the fused
    multiply-add)."""
    _check_segments()
    _check_cumsum()
    _check_ordered_sum()
    _check_segment_sum_and_scatter_add_fold()
    _check_fma()


REF_RAND = os.path.join(os.path.dirname(__file__), "data",
                        "port_ref_rand.json")
SEEDS = (0, 1, 3, 7, 42, 2 ** 31 - 1, -1, 123456789)


def _check_threefry_layout(part):
    """PRNGKey, split, bits, uniform and the jitted exponential of the
    current jax layout against the port's ``part`` layout."""
    for seed in SEEDS:
        key, pkey = jax.random.PRNGKey(seed), rand.PRNGKey(seed)
        _eq(pkey, np.asarray(key).astype(np.int64), f"key {seed}")
        for num in (2, 3, 5):
            _eq(rand.split(pkey, num, part),
                np.asarray(jax.random.split(key, num)).astype(np.int64),
                f"split {seed} {num}")
        for n in (1, 2, 11, 4096):
            _eq(rand.random_bits(pkey, (n,), part),
                np.asarray(jax.random.bits(key, (n,), jnp.uint32)).astype(
                    np.int64), f"bits {seed} {n}")
            _eq(rand.uniform(pkey, (n,), part),
                jax.random.uniform(key, (n,)), f"uniform {seed} {n}")
            mean = np.linspace(-1.0, 500.0, n).astype(np.float32)
            _eq(rand.exponential(pkey, torch.from_numpy(mean), part),
                jax.jit(jrand.exponential)(key, mean),
                f"exponential {seed} {n}")


def test_threefry_matches_jax_random_in_both_layouts():
    """The torch threefry2x32 against ``jax.random`` bit for bit, in the
    partitionable layout (jax 0.9.0's default) and the original one,
    and against the committed draws chip_smoke.py checks on the card."""
    _check_threefry_layout(True)
    with jax.threefry_partitionable(False):
        _check_threefry_layout(False)
    with open(REF_RAND) as f:
        ref = json.load(f)
    for flag, seeds in ref["partitionable"].items():
        part = flag == "True"
        for seed, r in seeds.items():
            key = rand.PRNGKey(int(seed))
            _eq(key, np.asarray(r["key"]), f"{flag} {seed} key")
            k = key
            for pair in r["chain"]:
                k, sub = rand.split(k, partitionable=part)
                _eq(torch.cat([k, sub]), np.asarray(pair), f"{seed} chain")
            _eq(rand.split(key, 3, part).reshape(-1), np.asarray(r["split3"]),
                f"{flag} {seed} split3")
            n = len(r["bits"])
            _eq(rand.random_bits(key, (n,), part), np.asarray(r["bits"]),
                f"{flag} {seed} bits")
            for name, got in (
                    ("uniform", rand.uniform(key, (n,), part)),
                    ("exponential", rand.exponential(key, torch.ones(n),
                                                     part))):
                _eq(got, np.asarray(r[name], np.uint32).view(np.float32),
                    f"{flag} {seed} {name}")


def test_exponential_log1p_and_exp2_are_xla_cpus():
    """``rand.exponential``'s ``-log1p(-u)`` on every one of the 2**23
    f32 uniforms against jitted JAX, bit for bit (``torch.log1p`` misses
    by an ulp on many of them), with the SHA-256 the card checks; and the
    backoff's exp2 table against jitted ``jnp.exp2`` on 0..30."""
    mant = np.arange(2 ** 23, dtype=np.uint32) | np.uint32(0x3F800000)
    u = mant.view(np.float32) - np.float32(1.0)
    want = np.asarray(jax.jit(lambda u: -jnp.log1p(-u))(u))
    got = torch.cat([-numerics.log1p(-c) for c in
                     torch.from_numpy(u).split(1 << 20)]).numpy()
    _eq(got, want, "exponential(1) over every uniform")
    with open(REF_RAND) as f:
        ref = json.load(f)
    assert hashlib.sha256(got.tobytes()).hexdigest() == ref["log1p_sha256"]
    exp2 = np.asarray(jax.jit(jnp.exp2)(np.arange(31, dtype=np.float32)))
    _eq(np.asarray(numerics.EXP2_BITS, np.uint32), exp2.view(np.uint32),
        "EXP2_BITS")
    _eq(np.asarray(ref["exp2"], np.uint32), exp2.view(np.uint32), "json")
    _eq(numerics.exp2_table(torch.arange(31)), exp2, "exp2_table")


def test_gridlets_and_event_queue_match_reference():
    _check_gridlet_batch()
    _check_task_farm_and_real_draws()
    _check_event_queue()
    _check_event_source_contract()


# ----------------------------------------------------------------------
# The grid economy's leaves: pricing rounds, reservation tables, the GIS
# ----------------------------------------------------------------------

def _check_commodity_reprice():
    """Jitted ``commodity_reprice`` on demands at 0, at 1, far above the
    cap and random, with a gain whose ``1 + gain * (d - 1)`` rounds twice
    unless fused (0.3) and the engine's default (0.25)."""
    rng = np.random.RandomState(0)
    n = 512
    base = rng.uniform(1e-4, 3.0, n).astype(np.float32)
    price = (base * rng.uniform(0.5, 2.0, n)).astype(np.float32)
    demand = np.concatenate([np.zeros(16), np.ones(16), np.full(16, 1e4),
                             rng.uniform(0.0, 40.0, n - 48)]).astype(
        np.float32)
    ref_fn = jax.jit(jecon.commodity_reprice)
    for gain, floor, cap in ((0.25, 0.5, 2.0), (0.3, 0.45, 1.7)):
        want = ref_fn(price, base, demand, np.float32(gain),
                      np.float32(floor), np.float32(cap))
        t = [torch.from_numpy(x) for x in (price, base, demand)]
        got = economy.commodity_reprice(*t, torch.tensor(gain),
                                        torch.tensor(floor),
                                        torch.tensor(cap))
        _eq(got, want, f"commodity gain {gain}")
    # the draws tell the fused form from two roundings
    plain = torch.clamp(t[0] * (1.0 + gain * (t[2] - 1.0)), t[1] * floor,
                        t[1] * cap)
    assert not np.array_equal(_bits(plain), _bits(want))


def _check_auction_round():
    """Jitted ``auction_round`` (``jax.random.uniform`` with ``minval`` /
    ``maxval``: ``max(lo, u * (hi - lo) + lo)``, the multiply-add fused)
    over a few hundred keys, and ``rand.uniform``'s bounded form alone."""
    base = np.random.RandomState(1).uniform(1e-4, 3.0, 11).astype(np.float32)
    ref_fn = jax.jit(jecon.auction_round)
    for floor, cap in ((0.5, 2.0), (0.3, 1.7)):
        got = [economy.auction_round(rand.PRNGKey(s), torch.from_numpy(base),
                                     torch.tensor(floor), torch.tensor(cap))
               for s in range(300)]
        want = [ref_fn(jax.random.PRNGKey(s), base, np.float32(floor),
                       np.float32(cap)) for s in range(300)]
        _eq(torch.stack(got), np.stack(want), f"auction {floor} {cap}")
    # the keys tell the fused form from two roundings
    plain = [torch.from_numpy(base) * torch.clamp_min(
        rand.uniform(rand.PRNGKey(s), (11,)) * (cap - floor) + floor, floor)
        for s in range(300)]
    assert not np.array_equal(_bits(torch.stack(plain)), _bits(np.stack(want)))
    key = jax.random.PRNGKey(9)
    want = jax.jit(lambda k: jax.random.uniform(
        k, (4096,), minval=np.float32(-0.7), maxval=np.float32(3.1)))(key)
    _eq(rand.uniform(rand.PRNGKey(9), (4096,), minval=-0.7, maxval=3.1),
        want, "uniform minval/maxval")


def _check_prices_stay_clamped():
    """Twin of test_economy_invariants'
    test_repriced_costs_stay_positive_finite_and_clamped on the port."""
    rng = np.random.RandomState(0)
    base = torch.tensor([0.004, 0.01, 2.5])
    floor, cap, gain = 0.5, 2.0, 0.25
    lo, hi = (base * floor).numpy(), (base * cap).numpy()
    price = base
    for _ in range(200):
        demand = torch.from_numpy(rng.uniform(0.0, 8.0, 3).astype(np.float32))
        price = economy.commodity_reprice(price, base, demand,
                                          torch.tensor(gain),
                                          torch.tensor(floor),
                                          torch.tensor(cap))
        p = price.numpy()
        assert np.all(np.isfinite(p)) and np.all(p > 0.0)
        assert np.all(p >= lo) and np.all(p <= hi)
    for s in range(20):
        p = economy.auction_round(rand.PRNGKey(s), base, torch.tensor(floor),
                                  torch.tensor(cap)).numpy()
        assert np.all(np.isfinite(p)) and np.all(p > 0.0)
        assert np.all(p >= lo) and np.all(p <= hi)


def test_pricing_rounds_match_jitted_reference():
    """The MARKET and AUCTION arithmetic bitwise against the jitted
    reference, and prices inside the clamp box."""
    _check_commodity_reprice()
    _check_auction_round()
    _check_prices_stay_clamped()


def _windows(k, seed, n_res=11):
    """K random windows: some touching end to start, some overlapping,
    boundaries on a grid of 10 so that instants land on them."""
    rng = np.random.RandomState(seed)
    res = rng.randint(0, n_res, k).astype(np.int32)
    pes = rng.randint(1, 5, k).astype(np.int32)
    start = (rng.randint(0, 30, k) * 10.0).astype(np.float32)
    end = (start + rng.randint(1, 12, k) * 10.0).astype(np.float32)
    if k > 2:                        # a window that touches the first one
        res[1], start[1] = res[0], end[0]
        end[1] = start[1] + 10.0
    return res, pes, start, end


def _check_window_tables():
    """``active_pes``, ``boundary_candidates`` and ``next_boundary``
    against the jitted reference for K = 0, 1 and 12, at instants on and
    between boundaries; ``as_tables`` / ``empty_tables`` / ``maintenance``
    give the reference's tables."""
    for k, seed in ((0, 0), (1, 1), (12, 2), (12, 3)):
        tab = _windows(k, seed)
        ptab = tuple(torch.from_numpy(x) for x in tab)
        ts = np.unique(np.concatenate([tab[2], tab[3], [0.0, 5.0, 1e4],
                                       tab[2] + 5.0])).astype(np.float32)
        for t in ts:
            t = np.float32(t)
            _eq(reservation.active_pes(*ptab, torch.tensor(t), 11),
                jax.jit(jresv.active_pes, static_argnums=5)(*tab, t, 11),
                f"active_pes K={k} t={t}")
            _eq(reservation.boundary_candidates(ptab[2], ptab[3],
                                                torch.tensor(t)),
                jax.jit(jresv.boundary_candidates)(tab[2], tab[3], t),
                f"boundary_candidates K={k} t={t}")
            _eq(reservation.next_boundary(ptab[2], ptab[3], torch.tensor(t)),
                jax.jit(jresv.next_boundary)(tab[2], tab[3], t),
                f"next_boundary K={k} t={t}")
    num_pe = np.array(jres.wwg_fleet().num_pe)
    windows = [(8, 100.0, 200.0), (4, 600.0, 700.5)]
    assert reservation.maintenance(torch.from_numpy(num_pe), windows) == \
        jresv.maintenance(num_pe, windows)
    bookings = jresv.maintenance(num_pe, windows) + [(7, 8, 0.0, 1e3)]
    for got, want in zip(reservation.as_tables(bookings),
                         jresv.as_tables(bookings)):
        assert got.dtype == convert._DTYPES[np.asarray(want).dtype]
        _eq(got, want, "as_tables")
    for got, want in zip(reservation.empty_tables(), jresv.empty_tables()):
        assert got.shape == (0,) and \
            got.dtype == convert._DTYPES[np.asarray(want).dtype]


def _check_booking_calendar():
    """The reference's booking, conflict and validation cases
    (tests/test_core_units.py, tests/test_network.py) on the port's
    ``ReservationBook``, and its exported tables equal to the
    reference's for the same bookings."""
    book = reservation.ReservationBook([2, 4])
    r1 = book.book(0, 1, 0.0, 10.0)
    book.book(0, 1, 0.0, 10.0)
    with pytest.raises(ValueError):
        book.book(0, 1, 5.0, 15.0)       # both PEs held on [5, 10)
    book.book(0, 2, 10.0, 20.0)          # back to back is fine
    assert book.reserved_pes(0, 5.0) == 2
    assert book.reserved_pes(0, 15.0) == 2
    book.cancel(r1)
    assert book.reserved_pes(0, 5.0) == 1
    assert book.load_factor(1, 0.0) == 0.0
    assert book.peak_usage(0, 0.0, 20.0) == 2
    book = reservation.ReservationBook([2])
    for bad in ((0, 0, 0.0, 1.0), (0, 1, 5.0, 5.0), (1, 1, 0.0, 1.0)):
        with pytest.raises(ValueError):
            book.book(*bad)
    book = reservation.ReservationBook([4, 2])
    book.book(0, 2, 10.0, 20.0)
    with pytest.raises(ValueError):
        book.book_maintenance(0, 15.0, 25.0)   # 2 PEs already held
    res = book.book_maintenance(1, 0.0, 5.0)
    assert res.pes == 2 and book.reserved_pes(1, 2.0) == 2
    jbook = jresv.ReservationBook([4, 2])
    book = reservation.ReservationBook([4, 2])
    for b in (jbook, book):
        b.book(1, 1, 30.0, 40.0)
        b.book(0, 3, 5.0, 9.0)
        b.book_maintenance(1, 0.0, 5.0)
    for got, want in zip(book.as_tables(), jbook.as_tables()):
        _eq(got, want, "book as_tables")


def test_reservation_tables_and_booking_match_reference():
    _check_window_tables()
    _check_booking_calendar()


def test_gis_register_deregister_on_the_port():
    """Twin of tests/test_core_units.py::test_gis_register_deregister,
    with the advertised rates held against the reference's."""
    fleet = resource.wwg_fleet()
    g = gis.init(fleet)
    assert bool(gis.resource_list(g).all())
    g = gis.deregister(g, 3)
    rate, cost = gis.dynamics(g, fleet, 0.0)
    assert float(rate[3]) == 0.0
    assert float(rate[0]) > 0.0
    jfleet = jres.wwg_fleet()
    jg = jgis.deregister(jgis.init(jfleet), 3)
    for t in (0.0, 130.0):
        for got, want in zip(gis.dynamics(g, fleet, t),
                             jgis.dynamics(jg, jfleet, t)):
            _eq(got, want, f"dynamics t={t}")
    g = gis.register(g, 3)
    rate, _ = gis.dynamics(g, fleet, 0.0)
    assert float(rate[3]) > 0.0
    _eq(gis.resource_list(g), jgis.resource_list(jgis.register(jg, 3)),
        "resource_list")
