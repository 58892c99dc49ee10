"""The port's leaf modules against the JAX reference: fleet tables,
calendar, economy, network delays, segmented ranks and sums, the
reference-order float helpers, the gridlet table and the event queue.
Inputs are numpy arrays made from a seed; floats compare bit for bit."""
import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import calendar as jcal
from repro.core import des as jdes
from repro.core import economy as jecon
from repro.core import gridlet as jgrid
from repro.core import network as jnet
from repro.core import resource as jres
from repro.core import segments as jseg
from repro.core import types as jtypes
from repro_torch import convert
from repro_torch.core import (calendar, des, economy, gridlet, network,
                              numerics, rand, resource, segments, types)

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
    gen = torch.Generator().manual_seed(3)
    farm = gridlet.task_farm(gen, n_jobs=50, n_users=4)
    assert farm.n == 200
    assert torch.equal(farm.user, torch.arange(4, dtype=torch.int32)
                       .repeat_interleave(50))
    assert bool((farm.length_mi >= 10_000.0).all())
    assert bool((farm.length_mi < 11_000.0).all())
    again = gridlet.task_farm(torch.Generator().manual_seed(3), 50, 4)
    assert torch.equal(farm.length_mi, again.length_mi)
    e = rand.exponential(torch.Generator().manual_seed(0),
                         torch.tensor([0.0, 5.0, -1.0]))
    assert torch.isinf(e[0]) and torch.isfinite(e[1]) and torch.isinf(e[2])
    d = torch.full((1000,), 100.0)
    x = rand.real_named(torch.Generator().manual_seed(1), d, "net_io")
    assert bool((x >= 95.0).all()) and bool((x <= 105.0).all())
    assert torch.equal(rand.real_named(torch.Generator(), d, "none"), d)


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
    inputs and the broker's min-affordable cost."""
    _check_quickstart_header()
    _check_factors()
    _check_transfer_delay_edge_cases()
    _check_min_affordable_cost()


def test_segments_and_float_order_match_xla():
    """Segmented ranks and sums, and the reference-order float helpers
    (cumsum's tile order at sizes around 16, the ordered segment_sum and
    its scatter-add fold, the fused multiply-add)."""
    _check_segments()
    _check_cumsum()
    _check_segment_sum_and_scatter_add_fold()
    _check_fma()


def test_gridlets_and_event_queue_match_reference():
    _check_gridlet_batch()
    _check_task_farm_and_real_draws()
    _check_event_queue()
    _check_event_source_contract()
