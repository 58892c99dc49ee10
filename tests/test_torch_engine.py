"""The port's slice end to end against the JAX reference: the Table 1
trace through ``run_direct``, live ``run_experiment`` runs of the
economic broker under every optimisation mode at batch 1 and 8, the
committed 1u_200j reference replayed on the CPU, and batch 8 equal to
batch 1.  Every integer, status, trace and float field is compared bit
for bit."""
import dataclasses
import gc
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import gridlet as jgrid
from repro.core import resource as jres
from repro.core import simulation as jsim
from repro.core import types as jtypes
from repro_torch import convert
from repro_torch.core import engine, gridlet, resource, simulation, types

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


REF =os.path.join(os.path.dirname(__file__), "data", "port_ref_main.json")
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
    """D-/B-factors go through ``length_mi.sum()``, which XLA:CPU adds in
    its own vectorised order and torch in another: the total, hence the
    deadline and budget, may differ by up to 2 ULP (ROADMAP C).  Given
    the same deadline and budget the runs are bitwise equal (above)."""
    g, fleet, _ = live
    jg = jgrid.task_farm(jax.random.PRNGKey(11), n_jobs=N_JOBS,
                         n_users=N_USERS)
    _, (jd, jb) = jsim.run_experiment_factors(jg, jres.wwg_fleet(), 0.4,
                                              0.6, n_users=N_USERS)
    res, (d, b) = simulation.run_experiment_factors(
        g, fleet, 0.4, 0.6, n_users=N_USERS, device="cpu")
    for port, ref in ((d, jd), (b, jb)):
        ulp = abs(int(_bits(port)) - int(_bits(np.float32(ref))))
        assert ulp <= 2, ulp
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
    with pytest.raises(NotImplementedError):
        convert.params(_leaves(jsim._scenario_params(
            jfleet, 700.0, 9000.0, 0, 4, jsim.Scenario(mtbf=100.0))))


# ----------------------------------------------------------------------
# What this slice refuses
# ----------------------------------------------------------------------

def _tiny():
    return gridlet.make_batch(torch.full((4,), 100.0)), resource.wwg_fleet()


UNPORTED_SETTINGS = (
    dict(scenario=simulation.Scenario(mtbf=500.0)),
    dict(scenario=simulation.Scenario(reservations=[(0, 1, 0.0, 5.0)])),
    dict(scenario=simulation.Scenario(pricing_model="auction")),
    dict(scenario=simulation.Scenario(plan_ahead=True)),
    dict(scenario=simulation.Scenario(trunk_of=[0] * 11)),
    dict(scenario=simulation.Scenario(fault_trace=[(1.0, 0, 0)])),
    dict(net_cap=None), dict(net_cap=8), dict(telemetry=16),
)


def test_unported_settings_and_entry_points_raise():
    g, fleet = _tiny()
    for kw in UNPORTED_SETTINGS:
        with pytest.raises(NotImplementedError):
            simulation.run_experiment(g, fleet, 100.0, 100.0, device="cpu",
                                      **kw)
    for fn in (simulation.sweep, simulation.sweep_sharded,
               engine.run_inner, engine.run_sweep, engine.run_sweep_lanes):
        with pytest.raises(NotImplementedError):
            fn(g, fleet)
    with pytest.raises(NotImplementedError):
        engine.run_direct(g, fleet, 0, 0.0, 16, net_cap=4, device="cpu")


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
