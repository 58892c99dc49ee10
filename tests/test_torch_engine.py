"""The port's slices end to end against the JAX reference: the Table 1
trace through ``run_direct``, live ``run_experiment`` runs of the
economic broker under every optimisation mode at batch 1 and 8, the
committed 1u_200j, contended-network, dynamic-resource, grid-economy
and sweep references replayed on the CPU (the sweep through the
lane-batched engine, every lane's "how" counters included), the failure, recovery, trace and
failing-arrival applies and the broker's measurement and policy keys on
hand-built states, the reference tests' reservation figures, the
quickstart's and failure_recovery's figures, and batch 8 equal to
batch 1.  Every integer, status, trace and float field is compared bit
for bit."""
import contextlib
import dataclasses
import gc
import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import broker as jbroker
from repro.core import des as jdes
from repro.core import engine as jeng
from repro.core import gridlet as jgrid
from repro.core import reservation as jresv
from repro.core import resource as jres
from repro.core import simulation as jsim
from repro.core import types as jtypes
from repro_torch import convert
from repro_torch.core import (broker, calendar, des, engine, gridlet, rand,
                              reservation, resource, simulation, types)

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


REF = os.path.join(os.path.dirname(__file__), "data", "port_ref_main.json")
REF_NET = os.path.join(os.path.dirname(__file__), "data",
                       "port_ref_net.json")
REF_FAIL = os.path.join(os.path.dirname(__file__), "data",
                        "port_ref_fail.json")
REF_ECON = os.path.join(os.path.dirname(__file__), "data",
                        "port_ref_econ.json")
REF_SWEEP = os.path.join(os.path.dirname(__file__), "data",
                         "port_ref_sweep.json")
GRIDLET_FIELDS = ("status", "resource", "assigned", "remaining", "t_event",
                  "start", "finish", "returned", "cost", "n_retries")
COUNTERS = ("n_events", "n_steps", "n_spec", "n_reseeds", "n_scans",
            "overflow", "n_failed", "n_resubmits")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits(x):
    a = _np(x)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _eq(port, ref, msg):
    np.testing.assert_array_equal(_bits(port), _bits(ref), err_msg=msg)


def _leaves(obj):
    """Every field as numpy (``np.asarray`` on each leaf; None stays)."""
    return {f.name: None if getattr(obj, f.name) is None
            else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _assert_same_run(port, ref, counters=COUNTERS):
    """Every result field of a port run against a reference run (both
    SimResult-like: gridlets, spent, term_time, trace, counters)."""
    for name in GRIDLET_FIELDS:
        _eq(getattr(port.gridlets, name), getattr(ref.gridlets, name),
            f"gridlets.{name}")
    for name in ("spent", "term_time", "downtime"):
        _eq(getattr(port, name), getattr(ref, name), name)
    for p, r, name in zip(port.trace, ref.trace, ("t", "kind", "who")):
        _eq(p, r, f"trace_{name}")
    for name in counters:
        assert int(getattr(port, name)) == int(getattr(ref, name)), name


# ----------------------------------------------------------------------
# Table 1 (paper Figs 9 and 12): run_direct under both policies
# ----------------------------------------------------------------------

def test_table1_run_direct_matches_reference():
    length = np.array([10.0, 8.5, 9.5], np.float32)
    arrivals = np.array([0.0, 4.0, 7.0], np.float32)
    for policy, finish in ((jtypes.TIME_SHARED, [10.0, 14.0, 18.0]),
                           (jtypes.SPACE_SHARED, [10.0, 12.5, 19.5])):
        ref = jeng.run_direct(jgrid.make_batch(length),
                              jres.table1_resource(policy), 0, arrivals,
                              max_events=64)
        port = engine.run_direct(
            gridlet.make_batch(torch.from_numpy(length)),
            resource.table1_resource(policy), 0, torch.from_numpy(arrivals),
            max_events=64, device="cpu")
        _assert_same_run(port, ref)
        np.testing.assert_array_equal(_np(port.gridlets.finish), finish)


def test_flat_rates_match_reference():
    """``engine._rates``, the flat-layout Fig 8 oracle, on equal-remaining
    ties (the FIFO tie-break decides MaxShare)."""
    for case in ((0, 7, 2, jtypes.TIME_SHARED),
                 (1, 24, 6, jtypes.TIME_SHARED),
                 (2, 5, 1, jtypes.SPACE_SHARED)):
        _check_flat_rates(*case)


def _check_flat_rates(seed, n_jobs, num_pe, policy):
    rem = np.random.RandomState(seed).randint(1, 6, n_jobs).astype(
        np.float32)
    running = np.full(n_jobs, jtypes.RUNNING, np.int32)
    on_zero = np.zeros(n_jobs, np.int32)
    jfleet = jres.make_fleet([num_pe], 3.0, 1.0, policy)
    jg = jtypes.replace(jgrid.make_batch(np.full(n_jobs, 100.0, np.float32)),
                        status=running, resource=on_zero, remaining=rem)
    ref = jeng._rates(jeng.init_state(jg, jfleet, 1), jfleet, 1)
    fleet = resource.make_fleet([num_pe], 3.0, 1.0, policy)
    g = types.replace(gridlet.make_batch(torch.full((n_jobs,), 100.0)),
                      status=torch.from_numpy(running),
                      resource=torch.from_numpy(on_zero),
                      remaining=torch.from_numpy(rem))
    _eq(engine._rates(engine.init_state(g, fleet, 1), fleet, 1), ref,
        "rates")


# ----------------------------------------------------------------------
# Live run_experiment: WWG, 3 users x 10 jobs, every optimisation mode
# ----------------------------------------------------------------------

N_USERS, N_JOBS, DEADLINE = 3, 10, 500.0
CASES = [(jtypes.OPT_COST, 1200.0), (jtypes.OPT_TIME, 2500.0),
         (jtypes.OPT_COST_TIME, 1500.0), (jtypes.OPT_NONE, 4000.0)]


def _ref_experiment(g, fleet, opt, budget, batch):
    """``jsim.run_experiment`` spelled out so the engine trace is kept."""
    params = jsim._scenario_params(fleet, DEADLINE, budget, opt, N_USERS,
                                   None)
    max_events = jsim._max_events(g.n, N_USERS, DEADLINE * 2.0 + 100.0,
                                  1.0)
    res = jeng.run(g, fleet, params, N_USERS, max_events,
                   max_jobs=jsim.safe_max_jobs(g, params, fleet),
                   batch=batch)
    return res, jsim.summarize(res, params, N_USERS, fleet.r, max_events)


@pytest.fixture(scope="module")
def live():
    """The reference farm and fleet, and its runs computed on demand and
    shared by the tests below (deadline and sizes are common to every
    case, so each batch value compiles once per process)."""
    g = jgrid.task_farm(jax.random.PRNGKey(11), n_jobs=N_JOBS,
                        n_users=N_USERS)
    fleet = jres.wwg_fleet()
    runs = {}

    def ref(opt, budget, batch):
        key = (opt, budget, batch)
        if key not in runs:
            runs[key] = _ref_experiment(g, fleet, opt, budget, batch)
        return runs[key]

    return convert.gridlets(_leaves(g)), convert.fleet(_leaves(fleet)), \
        ref


def _port_experiment(live, opt, budget, batch):
    g, fleet, _ = live
    return simulation.run_experiment(g, fleet, DEADLINE, budget, opt=opt,
                                     n_users=N_USERS, batch=batch,
                                     device="cpu")


def test_run_experiment_matches_reference(live):
    """Every optimisation mode at batch 1 and batch 8."""
    for batch in (1, 8):
        for opt, budget in CASES:
            ref_run, ref = live[2](opt, budget, batch)
            port = _port_experiment(live, opt, budget, batch)
            _assert_same_run(port, ref_run)
            for name in ("n_done", "spent", "term_time", "time_utilization",
                         "budget_utilization", "per_resource_done",
                         "truncated"):
                _eq(getattr(port, name), getattr(ref, name),
                    f"opt={opt} batch={batch} {name}")
            assert int(port.n_done.sum()) > 0


def test_batch8_equals_batch1(live):
    for opt, budget in CASES[:2]:
        one = _port_experiment(live, opt, budget, 1)
        eight = _port_experiment(live, opt, budget, 8)
        _assert_same_run(eight, one, counters=("n_events", "overflow"))
        assert int(eight.n_steps) + int(eight.n_spec) == int(one.n_steps)
        assert int(eight.n_steps) < int(one.n_steps)


# ----------------------------------------------------------------------
# The committed reference (tests/data/gen_port_ref.py), replayed
# ----------------------------------------------------------------------

def _f32(bits):
    return np.asarray(bits, np.uint32).view(np.float32)


def test_committed_1u_200j_reference_replays_on_cpu():
    with open(REF) as f:
        c = json.load(f)["cells"]["1u_200j"]
    fl = c["fleet"]
    fleet = resource.make_fleet(
        fl["num_pe"], torch.from_numpy(_f32(fl["mips_per_pe"])),
        torch.from_numpy(_f32(fl["cost_per_sec"])), fl["policy"],
        time_zone=torch.from_numpy(_f32(fl["time_zone"])),
        baud_rate=torch.from_numpy(_f32(fl["baud_rate"])))
    g = gridlet.make_batch(torch.from_numpy(_f32(c["length_mi"])))
    res = simulation.run_experiment(g, fleet, c["deadline"], c["budget"],
                                    opt=c["opt"], n_users=c["n_users"],
                                    batch=c["batch"], device="cpu")
    r = c["result"]
    out = convert.to_numpy(res)          # the result as numpy, field-wise
    for name in ("n_done", "spent", "term_time", "per_resource_done"):
        _eq(out[name].reshape(-1), _f32(r[name]), name)
    for got, name in zip(out["trace"], ("trace_t", "trace_kind",
                                        "trace_who")):
        want = _f32(r[name]) if name == "trace_t" else np.asarray(
            r[name], np.int32)
        _eq(got, want, name)
    for name in ("status", "resource"):
        _eq(out["gridlets"][name], np.asarray(r[name], np.int32), name)
    for name in ("start", "finish", "returned", "cost"):
        _eq(out["gridlets"][name], _f32(r[name]), name)
    for name in ("n_events", "n_steps", "n_spec", "n_reseeds", "n_scans",
                 "overflow"):
        assert int(out[name]) == r[name], name
    assert bool(res.truncated) == r["truncated"]


def test_run_experiment_factors_within_the_sum_order_drift(live):
    """D-/B-factors go through ``length_mi.sum()``, which the port adds
    in XLA:CPU's own order (``numerics.ordered_sum``): the deadline, the
    budget and the run are bitwise the reference's (no drift left; the
    name is the one this test had when it allowed 2 ULP)."""
    g, fleet, _ = live
    jg = jgrid.task_farm(jax.random.PRNGKey(11), n_jobs=N_JOBS,
                         n_users=N_USERS)
    ref, (jd, jb) = jsim.run_experiment_factors(jg, jres.wwg_fleet(), 0.4,
                                                0.6, n_users=N_USERS)
    res, (d, b) = simulation.run_experiment_factors(
        g, fleet, 0.4, 0.6, n_users=N_USERS, device="cpu")
    _eq(d, np.float32(jd), "deadline")
    _eq(b, np.float32(jb), "budget")
    for name in ("n_done", "spent", "term_time", "per_resource_done"):
        _eq(getattr(res, name), getattr(ref, name), name)
    for name in ("status", "finish", "cost"):
        _eq(getattr(res.gridlets, name), getattr(ref.gridlets, name), name)
    assert int(res.n_done.sum()) > 0 and int(res.overflow) == 0
    _check_params_carry_across()


def _check_params_carry_across():
    jfleet = jres.wwg_fleet()
    ref = jsim._scenario_params(jfleet, 700.0, 9000.0, jtypes.OPT_TIME, 4,
                                jsim.Scenario(sched_frac=0.05))
    fleet = convert.fleet(_leaves(jfleet))
    port = simulation._scenario_params(fleet, 700.0, 9000.0,
                                       jtypes.OPT_TIME, 4,
                                       simulation.Scenario(sched_frac=0.05))
    carried = convert.params(_leaves(ref))
    for f in dataclasses.fields(engine.SimParams):
        _eq(getattr(carried, f.name), getattr(ref, f.name), f.name)
        _eq(getattr(port, f.name), getattr(ref, f.name), f.name)
    # the link rates and the trunk vectors carry across too
    knobs = dict(baud_rate=28_000.0, bg_flows=0.5,
                 trunk_of=[0] * 5 + [-1] * 4 + [1] * 2,
                 trunk_baud=[56_000.0, 9_000.0], trunk_bg=[0.0, 1.5])
    ref = jsim._scenario_params(jfleet, 700.0, 9000.0, 0, 4,
                                jsim.Scenario(**knobs))
    port = simulation._scenario_params(fleet, 700.0, 9000.0, 0, 4,
                                       simulation.Scenario(**knobs))
    carried = convert.params(_leaves(ref))
    for name in ("link_baud", "bg_flows", "trunk_of", "trunk_baud",
                 "trunk_bg"):
        _eq(getattr(carried, name), getattr(ref, name), name)
        _eq(getattr(port, name), getattr(ref, name), name)
    # the failure streams' key and the fault trace (rows out of time
    # order: both sort them stably) with the retry knobs
    knobs = dict(mtbf=[100.0] * 5 + [0.0] * 6, mttr=25.0, seed=5,
                 trunk_of=[-1] * 8 + [0, 0, -1],
                 fault_trace=[(400.0, 11, 1), (300.0, 3, 0),
                              (300.0, 11, 0)],
                 retry_limit=8, backoff_base=0.5, blacklist_cooldown=5.0)
    ref = jsim._scenario_params(jfleet, 700.0, 9000.0, 0, 4,
                                jsim.Scenario(**knobs))
    port = simulation._scenario_params(fleet, 700.0, 9000.0, 0, 4,
                                       simulation.Scenario(**knobs))
    carried = convert.params(_leaves(ref))
    for f in dataclasses.fields(engine.SimParams):
        _eq(getattr(carried, f.name), getattr(ref, f.name), f.name)
        _eq(getattr(port, f.name), getattr(ref, f.name), f.name)
    # reservation windows (a book, tuples, maintenance), commodity and
    # auction pricing with their knobs and seeds, plan-ahead
    book = reservation.ReservationBook([int(p) for p in fleet.num_pe])
    jbook = jresv.ReservationBook([int(p) for p in fleet.num_pe])
    for b in (book, jbook):
        b.book(3, 1, 40.0, 90.0)
        b.book_maintenance(8, 10.0, 20.5)
    windows = [(7, 8, 0.0, 1000.0)] + reservation.maintenance(
        fleet.num_pe, [(8, 200.0, 400.0)])
    for jknobs, knobs in (
            (dict(reservations=jbook), dict(reservations=book)),
            (dict(reservations=windows, pricing_model="commodity",
                  market_period=60.0, market_gain=0.3), None),
            (dict(pricing_model="auction", auction_period=15.0, seed=5,
                  auction_seed=99, plan_ahead=True), None),
            (dict(pricing_model="auction", seed=5), None)):
        ref = jsim._scenario_params(jfleet, 700.0, 9000.0, 0, 4,
                                    jsim.Scenario(**jknobs))
        port = simulation._scenario_params(
            fleet, 700.0, 9000.0, 0, 4, simulation.Scenario(**(
                knobs or jknobs)))
        carried = convert.params(_leaves(ref))
        for f in dataclasses.fields(engine.SimParams):
            _eq(getattr(carried, f.name), getattr(ref, f.name), f.name)
            _eq(getattr(port, f.name), getattr(ref, f.name), f.name)


# ----------------------------------------------------------------------
# The contended network (tests/data/gen_port_ref.py), replayed, and the
# network identities of tests/test_network.py on the port alone
# ----------------------------------------------------------------------

def _check_net_cell(c, res):
    r = c["result"]
    out = convert.to_numpy(res)
    for name in ("n_done", "spent", "term_time", "per_resource_done"):
        _eq(out[name].reshape(-1), _f32(r[name]), name)
    for got, name in zip(out["trace"], ("trace_t", "trace_kind",
                                        "trace_who")):
        want = _f32(r[name]) if name == "trace_t" else np.asarray(
            r[name], np.int32)
        _eq(got, want, name)
    for name in ("status", "resource"):
        _eq(out["gridlets"][name], np.asarray(r[name], np.int32), name)
    for name in ("start", "finish", "returned", "cost"):
        _eq(out["gridlets"][name], _f32(r[name]), name)
    for name in ("n_events", "n_steps", "n_spec", "n_reseeds", "n_scans",
                 "overflow"):
        assert int(out[name]) == r[name], name
    assert bool(res.truncated) == r["truncated"]


def _replay_cell(c, net_cap, batch=None):
    """``run_experiment`` on a recorded scenario cell (payloads where the
    cell has them) on the CPU."""
    fl = c["fleet"]
    fleet = resource.make_fleet(
        fl["num_pe"], torch.from_numpy(_f32(fl["mips_per_pe"])),
        torch.from_numpy(_f32(fl["cost_per_sec"])), fl["policy"],
        time_zone=torch.from_numpy(_f32(fl["time_zone"])),
        baud_rate=torch.from_numpy(_f32(fl["baud_rate"])))
    u, nj = c["n_users"], c["n_jobs_per_user"]
    payload = {k: torch.from_numpy(_f32(c[k]))
               for k in ("in_bytes", "out_bytes") if k in c}
    g = gridlet.make_batch(
        torch.from_numpy(_f32(c["length_mi"])),
        user=torch.arange(u, dtype=torch.int32).repeat_interleave(nj),
        **payload)
    return simulation.run_experiment(
        g, fleet, c["deadline"], c["budget"], opt=c["opt"], n_users=u,
        batch=c["batch"] if batch is None else batch,
        scenario=simulation.Scenario(**c["scenario"]), net_cap=net_cap,
        device="cpu"), g, fleet


def _replay_net_cell(c):
    res, g, fleet = _replay_cell(c, None)
    u = c["n_users"]
    _check_net_cell(c, res)
    assert c["net_cap"] == simulation.safe_net_cap(
        g, engine.default_params(c["deadline"], c["budget"], c["opt"], u,
                                 fleet.r), fleet, u)


def _replay_direct_net(c):
    fleet = resource.table1_resource(c["policy"])
    g = gridlet.make_batch(torch.from_numpy(_f32(c["length_mi"])),
                           in_bytes=torch.from_numpy(_f32(c["in_bytes"])),
                           out_bytes=torch.from_numpy(_f32(c["out_bytes"])))
    res = engine.run_direct(g, fleet, c["resource"],
                            torch.from_numpy(_f32(c["dispatch_time"])),
                            c["max_events"], batch=c["batch"],
                            net_cap=c["net_cap"], baud_rate=c["baud_rate"],
                            bg_flows=c["bg_flows"], device="cpu")
    r = c["result"]
    for name in ("spent", "term_time"):
        _eq(getattr(res, name), _f32(r[name]), name)
    for got, name in zip(res.trace, ("trace_t", "trace_kind", "trace_who")):
        want = _f32(r[name]) if name == "trace_t" else np.asarray(
            r[name], np.int32)
        _eq(got, want, name)
    _eq(res.gridlets.status, np.asarray(r["status"], np.int32), "status")
    for name in ("start", "finish", "returned"):
        _eq(getattr(res.gridlets, name), _f32(r[name]), name)
    for name in ("n_events", "n_steps", "n_spec", "n_reseeds", "n_scans",
                 "overflow"):
        assert int(getattr(res, name)) == r[name], name


def _grid_fields(res):
    return [getattr(res.gridlets, f) for f in ("status", "resource",
                                               "start", "finish",
                                               "returned", "cost")]


def _check_infinite_links_equal_analytic():
    """Infinite links table nothing: net mode equals the analytic run
    superstep for superstep, trace included."""
    g = gridlet.make_batch(torch.tensor([10.0, 8.5, 9.5]), in_bytes=5e4,
                           out_bytes=2e4)
    fleet = resource.table1_resource(types.TIME_SHARED)    # baud = inf
    runs = [engine.run_direct(g, fleet, 0, torch.tensor([0.0, 4.0, 7.0]),
                              64, net_cap=cap, device="cpu")
            for cap in (0, 3)]
    for a, b in zip(runs[0].trace, runs[1].trace):
        _eq(b, a, "trace")
    for a, b in zip(_grid_fields(runs[0]), _grid_fields(runs[1])):
        _eq(b, a, "gridlets")
    assert int(runs[0].n_steps) == int(runs[1].n_steps)
    assert int(runs[0].n_events) == int(runs[1].n_events)


def _check_zero_bytes_equal_analytic():
    """Zero-byte payloads cannot contend: the WWG broker run with the
    subsystem on is bitwise the analytic run, counters included."""
    farm = gridlet.task_farm(rand.PRNGKey(5), n_jobs=10, n_users=3)
    fleet = resource.wwg_fleet()
    runs = [simulation.run_experiment(farm, fleet, 600.0, 2500.0,
                                      n_users=3, net_cap=cap, device="cpu")
            for cap in (0, None)]
    for name in ("n_done", "spent", "term_time", "n_events", "n_steps",
                 "n_spec", "n_reseeds", "overflow"):
        _eq(getattr(runs[1], name), getattr(runs[0], name), name)
    for a, b in zip(_grid_fields(runs[0]), _grid_fields(runs[1])):
        _eq(b, a, "gridlets")


def _check_contended_batch8_equals_batch1():
    """Contended links (some payloads zero, so tabled and instant
    transfers coexist) give bitwise the same run at batch 8 as at
    batch 1, and the slabs do fold supersteps."""
    rng = np.random.RandomState(4)
    fleet = resource.make_fleet([2, 2], [1.0, 1.0], [1.0, 2.0],
                                types.TIME_SHARED, baud_rate=64.0)
    n = 10
    in_b = np.where(rng.rand(n) < 0.3, 0.0,
                    rng.randint(1, 9, n) * 32.0).astype(np.float32)
    out_b = np.where(rng.rand(n) < 0.3, 0.0,
                     rng.randint(1, 5, n) * 16.0).astype(np.float32)
    g = gridlet.make_batch(torch.full((n,), 25.0),
                           in_bytes=torch.from_numpy(in_b),
                           out_bytes=torch.from_numpy(out_b))
    one, eight = (simulation.run_experiment(
        g, fleet, 1000.0, 50000.0, n_users=1, net_cap=None, batch=b,
        scenario=simulation.Scenario(bg_flows=0.5), device="cpu")
        for b in (1, 8))
    _assert_same_run(eight, one, counters=("n_events", "overflow"))
    assert int(eight.n_steps) + int(eight.n_spec) == int(one.n_steps)
    assert int(eight.n_spec) > 0 and int(one.overflow) == 0


def test_committed_net_reference_replays_on_cpu():
    """4u_25j_net, 4u_25j_trunknet and direct_net replayed bitwise, then
    the network identities: infinite links and zero-byte payloads equal
    the analytic run, and batch 8 equals batch 1 on contended links."""
    with open(REF_NET) as f:
        cells = json.load(f)["cells"]
    _replay_net_cell(cells["4u_25j_net"])
    _replay_net_cell(cells["4u_25j_trunknet"])
    _replay_direct_net(cells["direct_net"])
    _check_infinite_links_equal_analytic()
    _check_zero_bytes_equal_analytic()
    _check_contended_batch8_equals_batch1()


# ----------------------------------------------------------------------
# Dynamic resources: strikes, the fault trace, failing arrivals, retries
# ----------------------------------------------------------------------

STATE_SKIP = ("g", "host", "width")      # port-only (or nested) fields


def _hand_state(n=40, seed=0, knobs=None, net_cap=0):
    """A mid-run state on the WWG fleet, the same in both packages:
    gridlets of 4 users in every status, RUNNING ones holding job slots,
    some resources down, the failure clocks and retry counts set
    (``net_cap``: an empty transfer table of that width)."""
    rng = np.random.RandomState(seed)
    jfleet = jres.wwg_fleet()
    r = jfleet.r
    knobs = {**dict(mtbf=60.0, mttr=[0.0, 25.0] * 5 + [25.0], seed=seed,
                    trunk_of=[0] * 3 + [-1] * 5 + [1, 1, -1],
                    backoff_base=0.37), **(knobs or {})}
    params = jsim._scenario_params(jfleet, 900.0, 50000.0, jtypes.OPT_COST,
                                   4, jsim.Scenario(**knobs))
    length = rng.uniform(5e3, 2e4, n).astype(np.float32)
    user = np.sort(rng.randint(0, 4, n)).astype(np.int32)
    jg = jgrid.make_batch(length, user=user)
    status = rng.choice([jtypes.CREATED, jtypes.IN_TRANSIT, jtypes.QUEUED,
                         jtypes.RUNNING, jtypes.RETURNING, jtypes.DONE,
                         jtypes.FAILED], n).astype(np.int32)
    res_of = rng.randint(0, r, n).astype(np.int32)
    slot = np.full(n, -1, np.int32)
    for k in range(r):
        mine = np.nonzero((status == jtypes.RUNNING) & (res_of == k))[0]
        slot[mine] = np.arange(mine.size, dtype=np.int32)
    t_now = np.float32(250.0)
    jg = jtypes.replace(
        jg, status=status, resource=res_of, assigned=res_of,
        remaining=(length * rng.uniform(0.1, 1.0, n)).astype(np.float32),
        t_event=np.where(status == jtypes.IN_TRANSIT,
                         rng.choice([200.0, 250.0, 300.0], n),
                         np.inf).astype(np.float32),
        cost=rng.uniform(0, 300, n).astype(np.float32),
        n_retries=rng.randint(0, 40, n).astype(np.int32),
        retry_at=rng.uniform(0, 240, n).astype(np.float32))
    st = jeng.init_state(jg, jfleet, 4, params=params, net_cap=net_cap)
    rg = np.full(np.asarray(st.row_gridlet).shape, -1, np.int32)
    on = slot >= 0
    rg[res_of[on], slot[on]] = np.nonzero(on)[0]
    up = rng.rand(r) < 0.6
    st = jtypes.replace(
        st, t=t_now, slot=slot, row_gridlet=rg, res_up=up,
        spent=rng.uniform(100, 2000, 4).astype(np.float32),
        first_dispatch=rng.uniform(0, 200, (4, r)).astype(np.float32),
        next_fail=np.where(up, rng.choice([150.0, 250.0, np.inf], r),
                           np.inf).astype(np.float32),
        next_recover=np.where(~up, rng.choice([200.0, 250.0, 400.0], r),
                              np.inf).astype(np.float32),
        fail_since=np.where(up, np.inf,
                            rng.uniform(0, 200, r)).astype(np.float32),
        downtime=rng.uniform(0, 50, r).astype(np.float32),
        recovered_at=np.where(rng.rand(r) < 0.5, -np.inf, 100.0).astype(
            np.float32))
    fleet = convert.fleet(_leaves(jfleet))
    port_params = convert.params(_leaves(params))
    port = engine.init_state(convert.gridlets(_leaves(jg)), fleet, 4,
                             params=port_params, net_cap=net_cap)
    port = types.replace(port, g=convert.gridlets(_leaves(st.g)), **{
        f.name: torch.from_numpy(np.array(getattr(st, f.name)).astype(
            np.int64 if f.name in ("rng_key", "auction_key") else
            np.asarray(getattr(st, f.name)).dtype))
        for f in dataclasses.fields(engine.SimState)
        if f.name not in STATE_SKIP})
    port.host.maybe_down = True
    return (st, jfleet, params), (port, fleet, port_params)


def _assert_same_state(port, ref, msg):
    for f in dataclasses.fields(engine.SimState):
        if f.name not in STATE_SKIP:
            _eq(getattr(port, f.name), getattr(ref, f.name),
                f"{msg}: {f.name}")
    for f in dataclasses.fields(gridlet.GridletBatch):
        _eq(getattr(port.g, f.name), getattr(ref.g, f.name),
            f"{msg}: g.{f.name}")


def test_fail_gridlets_backoff_matches_reference():
    """``_fail_gridlets`` against the reference's jitted function: retry
    counts 1..40 (XLA:CPU's exp2 up to 2**30, clamped past it), backoff
    unit 1.0 and 0.37 (the fused multiply-add), the refund summed in
    index order within each user."""
    for base in (1.0, 0.37):
        (st, _, params), (port, _, pparams) = _hand_state(
            knobs=dict(backoff_base=base))
        st = jtypes.replace(st, g=jtypes.replace(
            st.g, n_retries=np.arange(40, dtype=np.int32)))
        port = types.replace(port, g=types.replace(
            port.g, n_retries=torch.arange(40, dtype=torch.int32)))
        victims = np.random.RandomState(1).rand(40) < 0.8
        victims[:2] = True
        now = np.float32(250.0)
        ref = jax.jit(jeng._fail_gridlets, static_argnums=2)(
            st, victims, 4, now, params)
        got = engine._fail_gridlets(port, torch.from_numpy(victims), 4,
                                    torch.tensor(now), pparams)
        _assert_same_state(got, ref, f"base {base}")


def test_strike_and_trace_applies_match_reference():
    """``_apply_failures`` / ``_apply_recoveries`` (one split and draw
    each), ``_trace_masks`` / ``_apply_trace`` (trunk targets, a down
    and an up of one resource at one instant) and the arrival at a down
    resource, on hand-built states, against the reference's jitted
    functions."""
    for seed in (0, 1, 2):
        (st, jfleet, params), (port, fleet, pparams) = _hand_state(
            seed=seed, knobs=dict(fault_trace=[
                (250.0, 11, 0), (250.0, 2, 1), (250.0, 12, 0),
                (250.0, 12, 1), (260.0, 5, 0)]))
        now = np.float32(250.0)
        tnow = torch.tensor(now)
        r = jfleet.r
        due_r = np.asarray(st.next_fail) <= now
        ref = jax.jit(jeng._apply_failures, static_argnums=(5, 6, 7))(
            st, jfleet, params, due_r, now, 4, r, 16)
        got = engine._apply_failures(port, fleet, pparams,
                                     torch.from_numpy(due_r), tnow, 4, r, 16)
        _assert_same_state(got, ref, f"{seed} failures")
        due_r = np.asarray(st.next_recover) <= now
        ref = jax.jit(jeng._apply_recoveries)(st, params, due_r, now)
        got = engine._apply_recoveries(port, pparams,
                                       torch.from_numpy(due_r), tnow)
        _assert_same_state(got, ref, f"{seed} recoveries")
        due = np.asarray(params.fault_time) <= now
        masks = jeng._trace_masks(params, due, r)
        pmasks = engine._trace_masks(pparams, torch.from_numpy(due), r)
        for p, m in zip(pmasks, masks):
            _eq(p, m, f"{seed} trace masks")
        ref = jax.jit(jeng._apply_trace, static_argnums=(7, 8, 9))(
            st, jfleet, params, due, *masks, now, 4, r, 16)
        got = engine._apply_trace(port, fleet, pparams,
                                  torch.from_numpy(due), *pmasks, tnow, 4,
                                  r, 16)
        _assert_same_state(got, ref, f"{seed} trace")
        free_pe = np.random.RandomState(seed).randint(0, 3, r).astype(
            np.int32)
        arr_pre = np.asarray(st.g.t_event) < now
        ref = jax.jit(jeng._apply_arrivals, static_argnums=(6, 7))(
            st, jfleet, params, free_pe, arr_pre, now, 4, r)
        got = engine._apply_arrivals(port, fleet, pparams,
                                     torch.from_numpy(free_pe),
                                     torch.from_numpy(arr_pre), tnow, 4, r)
        _assert_same_state(got[0], ref[0], f"{seed} arrivals")
        assert int(got[0].n_failed) > int(port.n_failed), seed
        for p, m in zip(got[1:], ref[1:]):
            _eq(p, m, f"{seed} arrival masks")


def _check_fail_cell(c, res):
    """Every recorded field of a dynamic-resource cell."""
    _check_net_cell(c, res)
    r = c["result"]
    out = convert.to_numpy(res)
    for name in ("n_failed", "n_resubmits"):
        assert int(out[name]) == r[name], name
    _eq(out["downtime"], _f32(r["downtime"]), "downtime")
    _eq(out["gridlets"]["n_retries"], np.asarray(r["n_retries"], np.int32),
        "n_retries")
    _eq(out["gridlets"]["retry_at"], _f32(r["retry_at"]), "retry_at")
    assert r["n_failed"] > 0


@pytest.mark.parametrize("name", ["4u_25j_fail", "4u_25j_trunk",
                                  "4u_25j_net_fail"])
def test_committed_fail_reference_replays_on_cpu(name):
    """The MTBF/MTTR streams (on analytic links and on contended ones)
    and the trunk-wide fault trace with retry limit, backoff and
    cooldown, replayed bitwise from tests/data/port_ref_fail.json."""
    with open(REF_FAIL) as f:
        c = json.load(f)["cells"][name]
    _check_fail_cell(c, _replay_cell(c, c["net_cap"])[0])


def test_fail_batch8_equals_batch1():
    """Strikes inside the speculation horizon fire in the micro-steps:
    batch 8 gives the batch 1 run bit for bit, and folds supersteps."""
    with open(REF_FAIL) as f:
        c = json.load(f)["cells"]["4u_25j_fail"]
    one = _replay_cell(c, 0, batch=1)[0]
    eight = _replay_cell(c, 0, batch=8)[0]
    _assert_same_run(eight, one, counters=("n_events", "overflow",
                                           "n_failed", "n_resubmits"))
    _eq(eight.gridlets.retry_at, one.gridlets.retry_at, "retry_at")
    assert int(eight.n_steps) + int(eight.n_spec) == int(one.n_steps)
    assert int(eight.n_spec) > 0 and int(one.n_failed) > 0


def test_quickstart_twin_on_the_port():
    """examples/quickstart.py's figures from the port alone: the farm
    drawn by the port's threefry in the original layout, the run on the
    CPU."""
    farm = gridlet.task_farm(rand.PRNGKey(7), n_jobs=200,
                             partitionable=False)
    fleet = resource.wwg_fleet()
    res = simulation.run_experiment(farm, fleet, 600.0, 12000.0,
                                    opt=types.OPT_COST, device="cpu")
    per = res.per_resource_done[0]
    cheapest = int(torch.argmin(fleet.cost_per_mi()))
    assert (int(res.n_done[0]), round(float(res.spent[0])),
            round(float(res.term_time[0])), cheapest, int(per[cheapest])) \
        == (182, 11993, 548, 8, 38)
    assert int(res.overflow) == 0 and not bool(res.truncated)
    assert int(res.n_spec) > 0


# ----------------------------------------------------------------------
# The grid economy: reservations, maintenance, pricing, plan-ahead
# ----------------------------------------------------------------------

# Three windows on R8 (one straddling t = 250, one past the deadlines,
# one ending at t) and one each on R3 and R5.
WINDOWS = [(8, 1, 200.0, 300.0), (8, 1, 260.0, 420.0), (8, 2, 850.0, 1200.0),
           (3, 1, 100.0, 700.0), (5, 2, 950.0, 990.0), (8, 1, 249.5, 250.0)]
# Per hand state (seed), one deadline a user (f32 bits) at which the
# plan-ahead capacity est_jobs * window - blocked_jobs lies within an ulp
# of an integer: there its floor tells one rounding (the reference's,
# fused) from two; the caps are those of the reference.
CRAFTED = {0: (0x442B4F02, 0x4522DB7A, 0x44CF0205, 0x43F7B7CF),
           1: (0x44F9432C, 0x45089A9A, 0x44F7D1D8, 0x44C71B58),
           2: (0x44B2D681, 0x44B1EBDA, 0x44E39483, 0x43F84987)}


def _measure_state(seed, plan, started=True):
    """A hand state with the windows, a transfer table holding queued
    bytes on every link and, unless ``started``, no measured rate yet."""
    knobs = dict(reservations=WINDOWS, plan_ahead=plan,
                 policy=jtypes.OPT_COST_TIME, baud_rate=28_000.0,
                 bg_flows=0.5)
    (st, jfleet, params), (port, fleet, pparams) = _hand_state(
        seed=seed, knobs=knobs, net_cap=40)
    rng = np.random.RandomState(seed)
    lr = np.where(rng.rand(16, 40) < 0.4, rng.uniform(1e3, 2e5, (16, 40)),
                  0.0).astype(np.float32)
    kw = dict(link_rem=lr)
    if not started:
        kw["first_dispatch"] = np.full((4, jfleet.r), np.inf, np.float32)
    st = jtypes.replace(st, **kw)
    port = types.replace(port, **{k: torch.from_numpy(v)
                                  for k, v in kw.items()})
    return (st, jfleet, params), (port, fleet, pparams)


def test_broker_measure_and_policy_keys_match_reference(monkeypatch):
    """``broker._measure`` (reactive and plan-ahead: windows straddling
    t and past the deadline, queued link bytes) and ``_policy_keys``
    (near-tie costs, both cost-time keys) against the reference's jitted
    functions, bitwise on every field; the windows' PE-time contraction
    against jitted ``einsum``; the plan-ahead capacity at deadlines where
    its fused multiply-add decides the floor."""
    measure = jax.jit(jbroker._measure, static_argnums=3)

    def same(got, ref, msg):
        assert set(got) == set(ref)
        for k in ref:
            _eq(got[k], ref[k], f"{msg}: {k}")

    for seed in (0, 1, 2):
        for plan in (False, True):
            (st, jfleet, params), (port, fleet, pparams) = _measure_state(
                seed, plan)
            same(broker._measure(port, fleet, pparams, 4),
                 measure(st, jfleet, params, 4), f"{seed} plan {plan}")
        (st, jfleet, params), (port, fleet, pparams) = _measure_state(
            seed, True, started=False)
        dl = np.asarray(CRAFTED[seed], np.uint32).view(np.float32)
        ref = measure(st, jfleet, jtypes.replace(params, deadline=dl), 4)
        got = broker._measure(port, fleet, types.replace(
            pparams, deadline=torch.from_numpy(dl)), 4)
        same(got, ref, f"{seed} crafted deadlines")
        # ... where two roundings give every user another cap
        eff = calendar.effective_mips(fleet, port.t)
        left = torch.clamp_min(torch.from_numpy(dl) - port.t, 0.0)
        with monkeypatch.context() as m:
            m.setattr(broker.numerics, "fma", lambda a, b, c: a * b + c)
            twice = broker._plan_capacity(port, types.replace(
                pparams, deadline=torch.from_numpy(dl)), eff, got["avg_mi"],
                got["est_jobs"], left, jfleet.r)
        assert bool((twice != got["cap_jobs"]).any(dim=1).all())
    # the windows' PE-time sum: lanes of four and the tail, as the dot
    einsum = jax.jit(lambda x, oh: jax.numpy.einsum("uk,rk->ur", x, oh))
    for u, k in ((4, 3), (4, 6), (20, 7), (2, 12), (4, 43)):
        rng = np.random.RandomState(k)
        x = (rng.uniform(0, 1, (u, k)) *
             10 ** rng.uniform(-3, 4, (u, k))).astype(np.float32)
        res = rng.randint(0, 3, k).astype(np.int32)
        oh = (res[None, :] == np.arange(11)[:, None]).astype(np.float32)
        _eq(broker._window_pe_time(torch.from_numpy(x),
                                   torch.from_numpy(res), 11),
            einsum(x, oh), f"window PE-time U={u} K={k}")
    keys = jax.jit(jbroker._policy_keys, static_argnums=4)
    for seed in range(40):
        rng = np.random.RandomState(seed)
        cost = rng.choice([0.004, 0.0041, 0.01, 2.5], 11).astype(np.float32)
        cost[rng.rand(11) < 0.3] = np.nextafter(cost[0], np.float32(1))
        est = rng.uniform(0, 3, (4, 11)).astype(np.float32)
        est[:, rng.rand(11) < 0.2] = 0.0
        opt = rng.randint(0, 4, 4).astype(np.int32)
        r = np.arange(11, dtype=np.float32)[None, :]
        for plan in (False, True):
            _eq(broker._policy_keys(torch.from_numpy(opt),
                                    torch.from_numpy(cost)[None, :],
                                    torch.from_numpy(est),
                                    torch.from_numpy(r), plan),
                keys(opt, cost[None, :], est, r, plan),
                f"keys {seed} plan {plan}")


def _direct(lengths, num_pe, policy, resv, batch=engine.DEFAULT_BATCH,
            net_cap=0):
    fleet = resource.make_fleet([num_pe], 1.0, 1.0, policy,
                                baud_rate=float("inf"))
    return engine.run_direct(gridlet.make_batch(torch.tensor(lengths)),
                             fleet, 0, 0.0, 64, reservations=resv,
                             batch=batch, net_cap=net_cap, device="cpu")


def _kinds(res, kind):
    tt, k, _ = (_np(x) for x in res.trace)
    return tt[k == kind].tolist()


def test_run_direct_reservation_figures_on_the_port():
    """The figures of the reference's own reservation tests
    (tests/test_superstep.py, tests/test_network.py) on the port: held
    PEs admit half the arrivals, shares shrink, a boundary cuts the
    speculation (batch 8 traces as batch 1), maintenance on space- and
    time-shared rows; one of them with a transfer table too."""
    ss, ts = jtypes.SPACE_SHARED, jtypes.TIME_SHARED
    for net_cap in (0, 4):
        r = _direct([20.0] * 4, 4, ss, [(0, 2, 0.0, 12.0)], net_cap=net_cap)
        assert sorted(_np(r.gridlets.finish).tolist()) == [20, 20, 32, 32]
        assert 12.0 in _kinds(r, jdes.K_RESERVATION)
        assert int(r.overflow) == 0
    r0 = _direct([20.0] * 4, 4, ss, None)
    assert _np(r0.gridlets.finish).tolist() == [20.0] * 4
    r = _direct([10.0, 10.0], 2, ts, [(0, 1, 0.0, 100.0)])
    assert _np(r.gridlets.finish).tolist() == [20.0, 20.0]
    resv = [(0, 1, 40.0, 45.0)]
    free = _direct([10.0, 20.0, 30.0], 1, ts, None)
    assert int(free.n_steps) == 1
    r1 = _direct([10.0, 20.0, 30.0], 1, ts, resv, batch=1)
    rk = _direct([10.0, 20.0, 30.0], 1, ts, resv)
    assert _np(rk.gridlets.finish).tolist() == [30.0, 55.0, 65.0]
    for a, b, name in zip(r1.trace, rk.trace, "tkw"):
        _eq(a, b, f"trace {name}")
    assert int(r1.n_steps) == int(rk.n_steps) + int(rk.n_spec)
    assert int(rk.n_steps) >= 3
    maint = reservation.maintenance([2], [(0, 0.0, 5.0)])
    r = _direct([10.0, 10.0], 2, ss, maint)
    assert _np(r.gridlets.finish).tolist() == [15.0, 15.0]
    assert _kinds(r, jdes.K_RESERVATION) == [5.0]
    r = _direct([10.0], 1, ts, reservation.maintenance([1], [(0, 4.0, 6.0)]))
    assert _np(r.gridlets.finish).tolist() == [12.0]


ECON_SMALL = ("4u_25j_resv", "4u_25j_plan", "4u_25j_commodity",
              "4u_25j_auction")


@pytest.mark.parametrize("name", ECON_SMALL)
def test_committed_econ_reference_replays_on_cpu(name):
    """Reservations and maintenance windows on R8, the plan-ahead broker,
    commodity and auction pricing, replayed bitwise from
    tests/data/port_ref_econ.json."""
    with open(REF_ECON) as f:
        c = json.load(f)["cells"][name]
    res = _replay_cell(c, 0)[0]
    _check_net_cell(c, res)
    kinds = _np(res.trace[1]).tolist()
    want = {"resv": jdes.K_RESERVATION, "plan": jdes.K_RESERVATION,
            "commodity": jdes.K_MARKET, "auction": jdes.K_AUCTION}
    assert want[name.split("_")[-1]] in kinds


def test_econ_batch8_equals_batch1():
    """Window boundaries and auction rounds cut the speculation horizon:
    batch 8 gives the batch 1 run bit for bit, and folds supersteps."""
    with open(REF_ECON) as f:
        cells = json.load(f)["cells"]
    for name in ("4u_25j_resv", "4u_25j_auction"):
        one = _replay_cell(cells[name], 0, batch=1)[0]
        eight = _replay_cell(cells[name], 0, batch=8)[0]
        _assert_same_run(eight, one, counters=("n_events", "overflow"))
        assert int(eight.n_steps) + int(eight.n_spec) == int(one.n_steps)
        assert int(eight.n_spec) > 0


def _invariants_run(sc, seed=0):
    """tests/test_economy_invariants.py's ``_run`` on the port."""
    fleet = resource.make_fleet([2, 4], [300.0, 500.0], [2.0, 5.0],
                                [jtypes.TIME_SHARED, jtypes.SPACE_SHARED])
    g = gridlet.task_farm(rand.PRNGKey(seed), n_jobs=8, n_users=2)
    params = simulation._scenario_params(fleet, 500.0, 20_000.0,
                                         jtypes.OPT_COST, 2, sc)
    res = engine.run(g, fleet, params, 2, 4096, batch=1, device="cpu")
    assert int(res.n_steps) + int(res.n_spec) < 4096
    return res


def test_pricing_twins_on_the_port():
    """Twins of test_economy_invariants' auction determinism and engine
    clamp tests: the same seed replays bitwise, another auction seed
    moves the dispatch costs, and the MARKET and AUCTION sources keep
    the posted price inside [floor, cap] x base over many rounds."""
    sc = simulation.Scenario(pricing_model="auction", auction_period=20.0,
                             seed=4)
    a, b = _invariants_run(sc), _invariants_run(sc)
    assert (_np(a.trace[1]) == jdes.K_AUCTION).sum() >= 1
    for f in ("spent", "term_time", "n_events"):
        _eq(getattr(a, f), getattr(b, f), f)
    for x, y, name in zip(a.trace, b.trace, "tkw"):
        _eq(x, y, f"trace {name}")
    c = _invariants_run(sc._replace(auction_seed=99))
    assert not np.array_equal(_np(a.gridlets.cost), _np(c.gridlets.cost))
    fleet = resource.make_fleet([2, 4], [300.0, 500.0], [2.0, 5.0],
                                [jtypes.TIME_SHARED, jtypes.SPACE_SHARED])
    g = gridlet.task_farm(rand.PRNGKey(1), n_jobs=6, n_users=2)
    for model, kind in (("commodity", des.K_MARKET),
                        ("auction", des.K_AUCTION)):
        params = simulation._scenario_params(
            fleet, 500.0, 20_000.0, jtypes.OPT_COST, 2,
            simulation.Scenario(pricing_model=model, market_period=10.0,
                                auction_period=10.0, seed=2))
        state = engine.init_state(g, fleet, 2, params=params)
        src = {s.kind: s for s in engine._make_sources(fleet, params, 2,
                                                       {})}[kind]
        base = fleet.cost_per_mi()
        lo, hi = base * params.price_floor, base * params.price_cap
        now = 10.0
        for _ in range(50):
            state = src.apply(state, torch.tensor(now))
            p = state.price
            assert bool(torch.isfinite(p).all()) and bool((p > 0).all())
            assert bool((p >= lo).all()) and bool((p <= hi).all())
            now += 10.0
        assert float(state.next_market if kind == des.K_MARKET
                     else state.next_auction) == now


def test_failure_recovery_maintenance_twin_on_the_port():
    """examples/failure_recovery.py's maintenance run on the port: R2
    held over [100, 160) on the example's 3-resource fleet fails
    nothing, resubmits nothing, finishes all 40 gridlets and spends more
    than the run without the window."""
    fleet = resource.make_fleet(
        num_pe=[4, 2, 2], mips_per_pe=[500.0, 400.0, 380.0],
        cost_per_sec=[8.0, 4.0, 2.0], policy=jtypes.TIME_SHARED,
        baud_rate=float("inf"))
    farm = gridlet.task_farm(rand.PRNGKey(7), n_jobs=40, base_mi=10_000.0)
    kw = dict(deadline=600.0, budget=12000.0, opt=jtypes.OPT_COST,
              device="cpu")
    baseline = simulation.run_experiment(farm, fleet, **kw)
    maint = simulation.run_experiment(
        farm, fleet, scenario=simulation.Scenario(
            reservations=reservation.maintenance(fleet.num_pe,
                                                 [(2, 100.0, 160.0)])),
        **kw)
    assert int(maint.n_failed) == 0 and int(maint.n_resubmits) == 0
    assert int(maint.n_done[0]) == 40
    assert float(maint.spent[0]) > float(baseline.spent[0])
    assert jdes.K_RESERVATION in _np(maint.trace[1]).tolist()


# ----------------------------------------------------------------------
# What the port refuses
# ----------------------------------------------------------------------

def _tiny():
    return gridlet.make_batch(torch.full((4,), 100.0)), resource.wwg_fleet()


UNPORTED_SETTINGS = (
    dict(telemetry=16),
)
# the sweep engine's settings still to port (ROADMAP A7b)
UNPORTED_SWEEP = (
    dict(scenario=simulation.Scenario(mtbf=100.0)),
    dict(scenario=simulation.Scenario(fault_trace=[(10.0, 0, 0)])),
    dict(scenario=simulation.Scenario(reservations=[(7, 4, 0.0, 50.0)])),
    dict(scenario=simulation.Scenario(pricing_model="commodity")),
    dict(scenario=simulation.Scenario(pricing_model="auction")),
    dict(scenario=simulation.Scenario(plan_ahead=True)),
    dict(net_cap=None),
    dict(net_cap=4),
)


def test_unported_settings_and_entry_points_raise():
    g, fleet = _tiny()
    for kw in UNPORTED_SETTINGS:
        with pytest.raises(NotImplementedError):
            simulation.run_experiment(g, fleet, 100.0, 100.0, device="cpu",
                                      **kw)
    for kw in UNPORTED_SWEEP:
        with pytest.raises(NotImplementedError):
            simulation.sweep(g, fleet, [100.0], [100.0], device="cpu", **kw)
        with pytest.raises(NotImplementedError):
            simulation.sweep_sharded(g, fleet, [100.0], [100.0],
                                     devices=["cpu"], **kw)
    params = engine._stack([simulation._scenario_params(
        fleet, 100.0, 100.0, 0, 1, None)])
    with pytest.raises(NotImplementedError):
        engine.run_sweep_lanes(g, fleet, params, 1, 64, telemetry=16,
                               device="cpu")


def test_cuda_by_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    g, fleet = _tiny()
    with pytest.raises(RuntimeError, match="cuda"):
        simulation.run_experiment(g, fleet, 100.0, 100.0)
    with pytest.raises(RuntimeError, match="cuda"):
        engine.run_direct(g, fleet, 0, 0.0, 16)
    with pytest.raises(RuntimeError, match="cuda"):
        types.resolve_device("cuda")
    assert types.INF == float("inf")


# ----------------------------------------------------------------------
# The sweep engine (lane-batched) against tests/data/port_ref_sweep.json
# ----------------------------------------------------------------------

SWEEP_CPU = ("sweep_1u_40j_3x3", "sweep_3u_8j_2x2", "strategies_1u_40j")
SWEEP_HOW = ("n_events", "n_steps", "n_spec", "n_reseeds", "n_scans",
             "overflow")


def _sweep_inputs(c):
    """A sweep record's gridlets and fleet."""
    fl = c["fleet"]
    fleet = resource.make_fleet(
        fl["num_pe"], torch.from_numpy(_f32(fl["mips_per_pe"])),
        torch.from_numpy(_f32(fl["cost_per_sec"])), fl["policy"],
        time_zone=torch.from_numpy(_f32(fl["time_zone"])),
        baud_rate=torch.from_numpy(_f32(fl["baud_rate"])))
    u, nj = c["n_users"], c["n_jobs_per_user"]
    g = gridlet.make_batch(
        torch.from_numpy(_f32(c["length_mi"])),
        user=torch.arange(u, dtype=torch.int32).repeat_interleave(nj))
    return g, fleet


def _check_sweep_lane(lane, want, how=True):
    """One lane of a port result (ExperimentResult) against its record:
    every "what" field bitwise, and the "how" counters."""
    out = convert.to_numpy(lane)
    for name in ("n_done", "spent", "term_time", "per_resource_done"):
        _eq(out[name].reshape(-1), _f32(want[name]), name)
    for got, name in zip(out["trace"], ("trace_t", "trace_kind",
                                        "trace_who")):
        _eq(got, _f32(want[name]) if name == "trace_t" else
            np.asarray(want[name], np.int32), name)
    for name in ("status", "resource"):
        _eq(out["gridlets"][name], np.asarray(want[name], np.int32), name)
    for name in ("start", "finish", "returned", "cost"):
        _eq(out["gridlets"][name], _f32(want[name]), name)
    for name in SWEEP_HOW if how else ("n_events", "overflow"):
        assert int(out[name]) == want[name], name
    assert bool(out["truncated"]) == want["truncated"]


def _flat_lanes(out):
    """A [D, B] grid result as one lane axis (deadline-major)."""
    return engine._tree_map(lambda x: x.reshape((-1,) + x.shape[2:]), out)


def _jax_lane_params(c, fleet):
    """The strategy lanes' params as the reference stacks them
    (``examples/table1_strategies.lane_params``), carried across with
    ``convert.params``."""
    import jax.numpy as jnp
    jfleet = jres.wwg_fleet()
    ps = [jsim._scenario_params(jfleet, c["deadline"], c["budget"],
                                jtypes.OPT_COST, c["n_users"],
                                jsim.Scenario(policy=opt))
          for opt in c["policies"]]
    lanes = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *ps)
    return convert.params(_leaves(lanes))


def _table1_rows():
    """The rows of the table in examples/table1_strategies.py's header."""
    import re
    path = os.path.join(os.path.dirname(__file__), os.pardir, "examples",
                        "table1_strategies.py")
    with open(path) as f:
        return dict(re.findall(
            r"^ +(cost|time|cost-time|none) +(done .*)$", f.read(), re.M))


@contextlib.contextmanager
def _vmap_fallbacks_fail():
    """vmap's per-lane fallback (an op without a batching rule) warns,
    and the warning is an error."""
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            yield
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)


@pytest.mark.parametrize("name", SWEEP_CPU)
def test_committed_sweep_reference_replays_on_cpu(name):
    """The CPU cells of tests/data/port_ref_sweep.json: the grids through
    ``simulation.sweep`` and the strategy lanes through
    ``engine.run_sweep_lanes`` (on the reference's own lane params,
    carried across by ``convert.params``), with vmap's fallback an
    error.  Every lane bitwise, its "how" counters equal; two lanes of
    the 3 x 3 grid (the tightest and the loosest) equal the port's own
    ``run_experiment``; the strategy rows are the table in
    examples/table1_strategies.py's header."""
    with open(REF_SWEEP) as f:
        c = json.load(f)["cells"][name]
    g, fleet = _sweep_inputs(c)
    with _vmap_fallbacks_fail():
        if c["kind"] == "grid":
            out = _flat_lanes(simulation.sweep(
                g, fleet, _f32(c["deadlines"]), _f32(c["budgets"]),
                opt=c["opt"], n_users=c["n_users"],
                scenario=simulation.Scenario(**c["scenario"]),
                device="cpu"))
        else:
            params = _jax_lane_params(c, fleet)
            mine = engine._stack([simulation._scenario_params(
                fleet, c["deadline"], c["budget"], types.OPT_COST,
                c["n_users"], simulation.Scenario(policy=opt))
                for opt in c["policies"]])
            for f in dataclasses.fields(params):
                a, b = getattr(params, f.name), getattr(mine, f.name)
                assert (a is None) == (b is None), f.name
                if a is not None:
                    _eq(a, b, f"lane params {f.name}")
            res = engine.run_sweep_lanes(g, fleet, params, c["n_users"],
                                         c["max_events"], c["max_jobs"],
                                         batch=c["batch"], device="cpu")
            out = simulation.summarize(res, params, c["n_users"],
                                             fleet.r, c["max_events"])
    assert out.spent.shape[0] == len(c["lanes"])
    for i, want in enumerate(c["lanes"]):
        _check_sweep_lane(engine._lane(out, i), want)
    if name == "sweep_1u_40j_3x3":
        for i in (0, len(c["lanes"]) - 1):
            d = _f32(c["deadlines"])[i // 3]
            b = _f32(c["budgets"])[i % 3]
            one = simulation.run_experiment(g, fleet, float(d), float(b),
                                            opt=c["opt"], device="cpu")
            _check_sweep_lane(one, c["lanes"][i], how=False)
    if c["kind"] == "lanes":
        rows = _table1_rows()
        assert len(rows) == 4
        for i, strategy in enumerate(c["names"]):
            lane = engine._lane(out, i)
            done = int((lane.gridlets.status == types.DONE).sum())
            assert rows[strategy] == (
                f"done {done}/{g.n}  t={float(lane.term_time[0]):7.1f}  "
                f"spent {float(lane.spent[0]):5.0f}"), strategy


class _CountOps(TorchDispatchMode):
    """Counts the operations dispatched (one launch each on the card)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types=(), args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_sweep_entry_points_on_the_port(monkeypatch):
    """``sweep_sharded`` over two CPU devices on the 3 x 3 grid (9 lanes
    padded to 10), and ``sweep(select_free=False)`` (each point through
    ``run_inner``) on the 2 x 2 grid, give every lane's "what" fields as
    recorded; ``run_sweep`` and ``run_inner`` give ``run``'s on one lane;
    and lanes do not multiply work on the host: four copies of a lane
    dispatch exactly the operations and host reads of two copies."""
    with open(REF_SWEEP) as f:
        cells = json.load(f)["cells"]
    c = cells["sweep_1u_40j_3x3"]
    g, fleet = _sweep_inputs(c)
    out = _flat_lanes(simulation.sweep_sharded(
        g, fleet, _f32(c["deadlines"]), _f32(c["budgets"]), opt=c["opt"],
        devices=["cpu", "cpu"]))
    for i, want in enumerate(c["lanes"]):
        _check_sweep_lane(engine._lane(out, i), want)

    c = cells["sweep_3u_8j_2x2"]
    g, fleet = _sweep_inputs(c)
    u = c["n_users"]
    scenario = simulation.Scenario(**c["scenario"])
    out = _flat_lanes(simulation.sweep(
        g, fleet, _f32(c["deadlines"]), _f32(c["budgets"]), opt=c["opt"],
        n_users=u, scenario=scenario, select_free=False, device="cpu"))
    for i, want in enumerate(c["lanes"]):
        _check_sweep_lane(engine._lane(out, i), want, how=False)

    params = simulation._scenario_params(fleet, 1400.0, 6000.0, c["opt"], u,
                                         scenario)
    args = (g, fleet, params, u, c["max_events"], c["max_jobs"])
    ref = engine.run(*args, device="cpu")
    _assert_same_run(engine.run_sweep(*args, device="cpu"), ref,
                     counters=("n_events", "overflow"))
    _assert_same_run(engine.run_inner(*args, device="cpu"), ref,
                     counters=("n_events", "overflow"))

    counts = []
    step = engine._step_sweep_lanes

    def counted(*a, **kw):
        with _CountOps() as m:
            out = step(*a, **kw)
        counts[-1].n += m.n
        return out

    monkeypatch.setattr(engine, "_step_sweep_lanes", counted)
    for n_lanes in (2, 4):
        counts.append(_CountOps())
        res = engine.run_sweep_lanes(*args[:2], engine._stack(
            [params] * n_lanes), u, 40, c["max_jobs"], device="cpu")
        counts[-1].syncs = res.host_syncs
    assert counts[0].n == counts[1].n and counts[0].n > 0
    assert counts[0].syncs == counts[1].syncs
