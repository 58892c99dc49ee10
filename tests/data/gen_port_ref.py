"""Regenerate the reference results the PyTorch port is held against:
tests/data/port_ref_main.json (the main path),
tests/data/port_ref_net.json (the contended network),
tests/data/port_ref_fail.json (failures, fault traces, retries),
tests/data/port_ref_rand.json (the PRNG and XLA:CPU's transcendentals),
tests/data/port_ref_econ.json (reservations, pricing, plan-ahead) and
tests/data/port_ref_sweep.json (the lane-batched sweep engine).

Run from the repo root with the JAX reference on the CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/data/gen_port_ref.py [main|net|fail|rand|econ|sweep]

(no argument writes all six).  port_ref_main.json holds four cells of
``benchmarks/engine_bench.py``: 1u_200j, 20u_100j and 200u_10j on the
WWG fleet, 4u_512j on the deep 2 x 80-PE fleet; gridlets from
``task_farm(PRNGKey(3))``, cost optimisation, the engine's default
batch.  port_ref_net.json holds the ``engine_20u_100j_net`` row
(200 KB in, 100 KB out per gridlet, 28,000 B/s links with one
background flow, the transfer table auto-sized), the same with the
first five resources behind one 56,000 B/s trunk (``_trunknet``), both
again at 4 users x 25 jobs, and ``direct_net``: ``run_direct`` with
payloads and staggered dispatch instants on the Table 1 resource.
port_ref_fail.json holds the dynamic-resource rows of the same bench:
``engine_20u_100j_fail`` (MTBF 500, MTTR 25, seed 1) and
``engine_20u_100j_trunk`` (R0-R4 on one trunk, the trace cutting it at
t=500 and restoring it at 600, retry limit 8, backoff 1, cooldown 5),
and for the CPU replay 4 users x 25 jobs with MTBF 100 (``4u_25j_fail``),
with the trace on a trunk that holds R8 (``4u_25j_trunk``) and with MTBF
100 over the 4u_25j_net links (``4u_25j_net_fail``); each records the
failure counters, the downtime and every gridlet's retry state too, and
must fail at least one gridlet.  port_ref_rand.json holds PRNGKey /
split chains and 4096-word bits, uniform and exponential draws for a
few seeds in both threefry layouts, XLA:CPU's exp2 on 0..30 and the
SHA-256 of its ``-log1p(-u)`` over all 2**23 f32 uniforms.
port_ref_econ.json holds the grid economy on analytic links: at 20 users
x 100 jobs R7 with 8 of its 16 PEs booked over [0, 1000) and maintenance
on R8 over [200, 400) and R4 over [600, 700) (``_resv``), the same
windows under cost-time optimisation with the plan-ahead broker
(``_plan``), commodity pricing (period 60, gain 0.25, ``_commodity``) and
auction pricing (period 60, seed 5, ``_auction``); and the four at 4
users x 25 jobs, whose work all lands on R8, so their windows hold R8
(maintenance over [100, 200) and one PE over [300, 500)).  Each window
cell must move ``term_time`` or ``spent`` against the same cell without
windows, each pricing cell must write MARKET or AUCTION rows into its
trace, and ``20u_100j_plan`` must differ from the same knobs without
plan-ahead.
port_ref_sweep.json holds ``simulation.sweep`` (the lane-batched engine,
``engine.run_sweep_lanes``, deadline-major lanes) and lane stacks of
``Scenario(policy=)``: three small cells in full for the CPU replay
(``sweep_1u_40j_3x3``, ``sweep_3u_8j_2x2`` under coarse polls, and
``strategies_1u_40j``, the four policy lanes of
``examples/table1_strategies.py``, its gridlets drawn in the threefry
layout its header's table was made in, ``partitionable=False``), and
three for the card, whose
per-gridlet fields are stored as the SHA-256 of each lane's bytes:
``sweep_1u_200j_8x18`` (the paper's Figs 21-24 grid), ``sweep_20u_25j_2x2``
(``engine_bench._sweep_bench``'s grid, coarse polls) and
``strategies_20u_25j`` (``engine_bench._strategy_sweep``'s four policy
lanes).  Every lane records its "how" counters too.
Every float (inputs and results) is stored as its uint32 bit pattern,
so the comparison is bitwise and needs no JAX.
"""
import hashlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import (des, engine, gridlet, rand, reservation, resource,
                        simulation, types)

HERE = os.path.dirname(__file__)
OUT = os.path.join(HERE, "port_ref_main.json")
OUT_NET = os.path.join(HERE, "port_ref_net.json")
OUT_FAIL = os.path.join(HERE, "port_ref_fail.json")
OUT_RAND = os.path.join(HERE, "port_ref_rand.json")
OUT_ECON = os.path.join(HERE, "port_ref_econ.json")
OUT_SWEEP = os.path.join(HERE, "port_ref_sweep.json")

CELLS = (
    # name, n_users, n_jobs_per_user, fleet, deadline, budget
    ("1u_200j", 1, 200, "wwg", 2000.0, 22000.0),
    ("20u_100j", 20, 100, "wwg", 2000.0, 22000.0),
    ("4u_512j", 4, 512, "deep_2x80pe", 2000.0, 500000.0),
    ("200u_10j", 200, 10, "wwg", 2000.0, 22000.0),
)


def _fleet(name):
    if name == "wwg":
        return resource.wwg_fleet()
    return resource.make_fleet([80, 80], [100.0, 120.0], [1.0, 2.0],
                               types.TIME_SHARED)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32).ravel().tolist()


def _ints(x):
    return np.asarray(x).astype(np.int64).ravel().tolist()


def _result(r, res):
    """The summarized result and the engine's trace, every field the
    port is held to."""
    tt, kind, who = (np.asarray(x) for x in res.trace)
    out = r.gridlets
    return {
        "n_done": _bits(r.n_done),
        "spent": _bits(r.spent),
        "term_time": _bits(r.term_time),
        "per_resource_done": _bits(r.per_resource_done),
        "n_events": int(r.n_events), "n_steps": int(r.n_steps),
        "n_spec": int(r.n_spec), "n_reseeds": int(r.n_reseeds),
        "n_scans": int(r.n_scans), "overflow": int(r.overflow),
        "truncated": bool(r.truncated),
        "trace_t": _bits(tt), "trace_kind": _ints(kind),
        "trace_who": _ints(who),
        "status": _ints(out.status),
        "resource": _ints(out.resource),
        "start": _bits(out.start),
        "finish": _bits(out.finish),
        "returned": _bits(out.returned),
        "cost": _bits(out.cost),
    }


def _fleet_fields(fleet, fleet_name):
    return {
        "name": fleet_name,
        "num_pe": _ints(fleet.num_pe),
        "mips_per_pe": _bits(fleet.mips_per_pe),
        "cost_per_sec": _bits(fleet.cost_per_sec),
        "policy": _ints(fleet.policy),
        "time_zone": _bits(fleet.time_zone),
        "baud_rate": _bits(fleet.baud_rate),
    }


def cell(name, n_users, n_jobs, fleet_name, deadline, budget):
    """``simulation.run_experiment`` spelled out (the same params, event
    budget, job-slot width and batch) so the engine's trace is kept."""
    fleet = _fleet(fleet_name)
    g = gridlet.task_farm(jax.random.PRNGKey(3), n_jobs=n_jobs,
                          n_users=n_users)
    params = simulation._scenario_params(fleet, deadline, budget,
                                         types.OPT_COST, n_users, None)
    max_events = simulation._max_events(g.n, n_users,
                                        deadline * 2.0 + 100.0, 1.0)
    res = engine.run(g, fleet, params, n_users, max_events,
                     max_jobs=simulation.safe_max_jobs(g, params, fleet))
    r = simulation.summarize(res, params, n_users, fleet.r, max_events)
    return {
        "n_users": n_users, "n_jobs_per_user": n_jobs,
        "deadline": deadline, "budget": budget, "opt": types.OPT_COST,
        "batch": engine.DEFAULT_BATCH,
        "fleet": _fleet_fields(fleet, fleet_name),
        "length_mi": _bits(g.length_mi),
        "result": _result(r, res),
    }


# The engine_20u_100j_net row of benchmarks/engine_bench.py, its trunk
# variant (the engine_20u_100j_trunk topology without the fault trace
# and retry knobs), and both at 4 users x 25 jobs for the CPU replay.
NET = dict(baud_rate=28_000.0, bg_flows=1.0)
TRUNK = dict(NET, trunk_of=[0] * 5 + [-1] * 6, trunk_baud=56_000.0,
             trunk_bg=0.0)
IN_BYTES, OUT_BYTES = 200_000.0, 100_000.0
NET_CELLS = (
    # name, n_users, n_jobs_per_user, scenario knobs
    ("20u_100j_net", 20, 100, NET),
    ("20u_100j_trunknet", 20, 100, TRUNK),
    ("4u_25j_net", 4, 25, NET),
    ("4u_25j_trunknet", 4, 25, TRUNK),
)


def scenario_cell(name, n_users, n_jobs, knobs, net=True, deadline=2000.0,
                  budget=22000.0):
    """``run_experiment(..., scenario=Scenario(**knobs))`` spelled out on
    the WWG fleet: the cell's record and the engine's result.  ``net``:
    payloads on every gridlet and the auto-sized transfer table
    (``net_cap=None``); else the default analytic links, no payloads."""
    fleet = resource.wwg_fleet()
    payload = dict(in_bytes=IN_BYTES, out_bytes=OUT_BYTES) if net else {}
    g = gridlet.task_farm(jax.random.PRNGKey(3), n_jobs=n_jobs,
                          n_users=n_users, **payload)
    scenario = simulation.Scenario(**knobs)
    params = simulation._scenario_params(fleet, deadline, budget,
                                         types.OPT_COST, n_users, scenario)
    net_cap = simulation.safe_net_cap(g, params, fleet, n_users) if net \
        else 0
    max_events = simulation._max_events(g.n, n_users,
                                        deadline * 2.0 + 100.0, 1.0)
    res = engine.run(g, fleet, params, n_users, max_events,
                     max_jobs=simulation.safe_max_jobs(g, params, fleet),
                     net_cap=net_cap)
    r = simulation.summarize(res, params, n_users, fleet.r, max_events)
    return {
        "n_users": n_users, "n_jobs_per_user": n_jobs,
        "deadline": deadline, "budget": budget, "opt": types.OPT_COST,
        "batch": engine.DEFAULT_BATCH, "net_cap": net_cap,
        "scenario": knobs,
        "fleet": _fleet_fields(fleet, "wwg"),
        "length_mi": _bits(g.length_mi),
        **({"in_bytes": _bits(g.in_bytes), "out_bytes": _bits(g.out_bytes)}
           if net else {}),
        "result": _result(r, res),
    }, res


# The dynamic-resource rows of benchmarks/engine_bench.py and their CPU
# sizes.  At 4 users x 25 jobs all the work lands on R8, so the small
# trace cell puts R8 on the cut trunk, and the small failure cells take
# MTBF 100 (MTBF 500 fails nothing there).
FAIL = dict(mtbf=500.0, mttr=25.0, seed=1)
SMALL_FAIL = dict(mtbf=100.0, mttr=25.0, seed=1)
RETRY = dict(retry_limit=8, backoff_base=1.0, blacklist_cooldown=5.0)
FAIL_CELLS = (
    # name, n_users, n_jobs_per_user, scenario knobs, payloads and links
    ("20u_100j_fail", 20, 100, FAIL, False),
    ("20u_100j_trunk", 20, 100, dict(
        trunk_of=[0] * 5 + [-1] * 6,
        fault_trace=[(500.0, 11, 0), (600.0, 11, 1)], **RETRY), False),
    ("4u_25j_fail", 4, 25, SMALL_FAIL, False),
    ("4u_25j_trunk", 4, 25, dict(
        trunk_of=[-1] * 8 + [0, 0, -1],
        fault_trace=[(300.0, 11, 0), (400.0, 11, 1)], **RETRY), False),
    ("4u_25j_net_fail", 4, 25, dict(NET, **SMALL_FAIL), True),
)


def fail_cell(name, n_users, n_jobs, knobs, net):
    """A scenario cell with the failure counters, the downtime and every
    gridlet's retry state recorded too; it must fail a gridlet."""
    out, res = scenario_cell(name, n_users, n_jobs, knobs, net)
    out["result"].update(
        n_failed=int(res.n_failed), n_resubmits=int(res.n_resubmits),
        downtime=_bits(res.downtime),
        n_retries=_ints(res.gridlets.n_retries),
        retry_at=_bits(res.gridlets.retry_at))
    assert int(res.n_failed) > 0, f"{name} fails no gridlet"
    assert float(np.asarray(res.downtime).max()) > 0.0, name
    return out


# The grid economy (reservations, maintenance, pricing, plan-ahead) on
# analytic links.  At 4 users x 25 jobs all the work lands on R8, so the
# small cells' windows hold R8.
_NUM_PE = [int(p) for p in np.asarray(resource.wwg_fleet().num_pe)]
RESV = [(7, 8, 0.0, 1000.0)] + reservation.maintenance(
    _NUM_PE, [(8, 200.0, 400.0), (4, 600.0, 700.0)])
SMALL_RESV = reservation.maintenance(_NUM_PE, [(8, 100.0, 200.0)]) + \
    [(8, 1, 300.0, 500.0)]
PLAN = dict(plan_ahead=True, policy=types.OPT_COST_TIME)
COMMODITY = dict(pricing_model="commodity", market_period=60.0,
                 market_gain=0.25)
AUCTION = dict(pricing_model="auction", auction_period=60.0, seed=5)
ECON_CELLS = (
    # name, n_users, n_jobs_per_user, scenario knobs
    ("20u_100j_resv", 20, 100, dict(reservations=RESV)),
    ("20u_100j_plan", 20, 100, dict(reservations=RESV, **PLAN)),
    ("20u_100j_commodity", 20, 100, COMMODITY),
    ("20u_100j_auction", 20, 100, AUCTION),
    ("4u_25j_resv", 4, 25, dict(reservations=SMALL_RESV)),
    ("4u_25j_plan", 4, 25, dict(reservations=SMALL_RESV, **PLAN)),
    ("4u_25j_commodity", 4, 25, COMMODITY),
    ("4u_25j_auction", 4, 25, AUCTION),
)


def econ_cells():
    """port_ref_econ.json's cells, each checked to exercise its path."""
    cells, runs = {}, {}
    for name, u, nj, knobs in ECON_CELLS:
        cells[name], runs[name] = scenario_cell(name, u, nj, knobs,
                                                net=False)
    for name, u, nj, knobs in ECON_CELLS:
        r = cells[name]["result"]
        if "reservations" in knobs:
            no_windows = {k: v for k, v in knobs.items()
                          if k != "reservations"}
            plain = scenario_cell(name, u, nj, no_windows,
                                  net=False)[0]["result"]
            assert (r["term_time"], r["spent"]) != \
                (plain["term_time"], plain["spent"]), name
        else:
            kind = des.K_MARKET if "market_period" in knobs else \
                des.K_AUCTION
            assert kind in r["trace_kind"], name
    no_plan = dict(ECON_CELLS[1][3], plan_ahead=False)
    plain = scenario_cell("20u_100j_plan", 20, 100, no_plan,
                          net=False)[0]["result"]
    r = cells["20u_100j_plan"]["result"]
    assert (r["term_time"], r["spent"], r["trace_t"]) != \
        (plain["term_time"], plain["spent"], plain["trace_t"])
    return cells


RAND_SEEDS = (0, 1, 3, 7)
N_WORDS = 4096


def rand_layout():
    """The PRNG of the current threefry layout: per seed the key, four
    successive ``split`` pairs, ``split(key, 3)``, and N_WORDS bits,
    uniforms and unit-mean exponentials (the engine's jitted draw)."""
    out = {}
    for seed in RAND_SEEDS:
        key = jax.random.PRNGKey(seed)
        chain, k = [], key
        for _ in range(4):
            k, sub = jax.random.split(k)
            chain.append(_ints(k) + _ints(sub))
        out[str(seed)] = {
            "key": _ints(key), "chain": chain,
            "split3": _ints(jax.random.split(key, 3)),
            "bits": _ints(jax.random.bits(key, (N_WORDS,), jnp.uint32)),
            "uniform": _bits(jax.random.uniform(key, (N_WORDS,))),
            "exponential": _bits(jax.jit(rand.exponential)(
                key, np.ones(N_WORDS, np.float32))),
        }
    return out


def rand_ref():
    """port_ref_rand.json's content (both layouts, exp2, log1p)."""
    layouts = {}
    for flag in (True, False):
        with jax.threefry_partitionable(flag):
            layouts[str(flag)] = rand_layout()
    mant = np.arange(2 ** 23, dtype=np.uint32) | np.uint32(0x3F800000)
    u = mant.view(np.float32) - np.float32(1.0)
    e = np.asarray(jax.jit(lambda u: -jnp.log1p(-u))(u))
    exp2 = jax.jit(jnp.exp2)(np.arange(31, dtype=np.float32))
    return {
        "partitionable": layouts,
        "exp2": _bits(exp2),
        "log1p_sha256": hashlib.sha256(e.tobytes()).hexdigest(),
        "log1p_about": "SHA-256 of the f32 bytes of jitted -log1p(-u), "
                       "u = the 2**23 uniforms in mantissa order",
    }


def direct_cell():
    """``run_direct`` on the Table 1 resource (time-shared, 2 PEs) with
    payloads over a contended link: the later dispatches wait as pending
    link entries, and transfers overlap on the link both ways."""
    length = np.array([10.0, 8.5, 9.5], np.float32)
    dispatch = np.array([0.0, 4.0, 7.0], np.float32)
    in_bytes = np.array([5.0, 3.0, 2.0], np.float32)
    out_bytes = np.array([2.0, 1.0, 3.0], np.float32)
    knobs = dict(baud_rate=1.0, bg_flows=0.5, net_cap=4, max_events=64)
    fleet = resource.table1_resource(types.TIME_SHARED)
    g = gridlet.make_batch(length, in_bytes=in_bytes, out_bytes=out_bytes)
    res = engine.run_direct(g, fleet, 0, dispatch, knobs["max_events"],
                            net_cap=knobs["net_cap"],
                            baud_rate=knobs["baud_rate"],
                            bg_flows=knobs["bg_flows"])
    tt, kind, who = (np.asarray(x) for x in res.trace)
    out = res.gridlets
    assert int(res.overflow) == 0 and np.all(np.asarray(out.status) ==
                                             types.DONE)
    return {
        "policy": types.TIME_SHARED, "resource": 0,
        "batch": engine.DEFAULT_BATCH, **knobs,
        "length_mi": _bits(length), "dispatch_time": _bits(dispatch),
        "in_bytes": _bits(in_bytes), "out_bytes": _bits(out_bytes),
        "result": {
            "spent": _bits(res.spent), "term_time": _bits(res.term_time),
            "n_events": int(res.n_events), "n_steps": int(res.n_steps),
            "n_spec": int(res.n_spec), "n_reseeds": int(res.n_reseeds),
            "n_scans": int(res.n_scans), "overflow": int(res.overflow),
            "trace_t": _bits(tt), "trace_kind": _ints(kind),
            "trace_who": _ints(who),
            "status": _ints(out.status),
            "start": _bits(out.start), "finish": _bits(out.finish),
            "returned": _bits(out.returned),
        },
    }


# The deadline x budget sweep and the strategy lanes.  A grid cell is
# ``simulation.sweep`` spelled out (its statics, its deadline-major
# lanes, ``engine.run_sweep_lanes`` under jit) so each lane's trace is
# kept; the CPU cells are checked against ``simulation.sweep`` itself.
COARSE = dict(sched_min_period=10.0, sched_frac=0.05)
SWEEP_CELLS = (
    # name, seed, n_users, n_jobs_per_user, deadlines, budgets, knobs, full
    ("sweep_1u_40j_3x3", 7, 1, 40, [100.0, 1100.0, 3100.0],
     [5000.0, 12000.0, 22000.0], {}, True),
    ("sweep_3u_8j_2x2", 5, 3, 8, [700.0, 1400.0], [6000.0, 14000.0],
     COARSE, True),
    ("sweep_1u_200j_8x18", 7, 1, 200, [100.0 + 500.0 * i for i in range(8)],
     [5000.0 + 1000.0 * i for i in range(18)], {}, False),
    ("sweep_20u_25j_2x2", 3, 20, 25, [1500.0, 2000.0], [15000.0, 22000.0],
     COARSE, False),
)
STRATEGIES = (("cost", types.OPT_COST), ("time", types.OPT_TIME),
              ("cost-time", types.OPT_COST_TIME), ("none", types.OPT_NONE))
LANE_CELLS = (
    # name, seed, n_users, n_jobs, base_mi, deadline, budget, max_events
    # (None: engine_bench's), full, threefry layout of the gridlets' draw
    # (the example's header table was made with the older layout, C1)
    ("strategies_1u_40j", 9, 1, 40, 50_000.0, 1200.0, 30_000.0, 8192, True,
     False),
    ("strategies_20u_25j", 3, 20, 25, 10_000.0, 2000.0, 22_000.0, None,
     False, True),
)
GRIDLET_OUT = (("status", np.int32), ("resource", np.int32),
               ("start", np.float32), ("finish", np.float32),
               ("returned", np.float32), ("cost", np.float32))


def _sha(x, dtype):
    return hashlib.sha256(np.ascontiguousarray(
        np.asarray(x).astype(dtype)).tobytes()).hexdigest()


def _lane_results(res, r, full):
    """One record per lane: every small field and the trace in full;
    the per-gridlet fields in full or as the SHA-256 of their bytes."""
    out = []
    for i in range(int(np.asarray(r.spent).shape[0])):
        lane = jax.tree_util.tree_map(lambda a: a[i], r)
        one = jax.tree_util.tree_map(lambda a: a[i], res)
        rec = _result(lane, one)
        if not full:
            for f, dtype in GRIDLET_OUT:
                rec[f] = _sha(getattr(lane.gridlets, f), dtype)
        out.append(rec)
    return out


def _run_lanes(g, fleet, p_lanes, n_users, max_events, max_jobs, batch):
    res = jax.jit(lambda pp: engine.run_sweep_lanes(
        g, fleet, pp, n_users, max_events, max_jobs, batch=batch))(p_lanes)
    r = jax.vmap(lambda a, p: simulation.summarize(
        a, p, n_users, fleet.r, max_events))(res, p_lanes)
    return res, r


def sweep_cell(name, seed, n_users, n_jobs, deadlines, budgets, knobs,
               full):
    fleet = resource.wwg_fleet()
    g = gridlet.task_farm(jax.random.PRNGKey(seed), n_jobs=n_jobs,
                          n_users=n_users)
    scenario = simulation.Scenario(**knobs)
    dl = jnp.asarray(deadlines, jnp.float32)
    bl = jnp.asarray(budgets, jnp.float32)
    template, max_events, max_jobs, batch, net_cap = \
        simulation._sweep_statics(g, fleet, dl, types.OPT_COST, n_users,
                                  None, scenario, None, 0, True)
    dd = jnp.repeat(dl, bl.shape[0])
    bb = jnp.tile(bl, dl.shape[0])
    p_lanes = jax.vmap(lambda d, b: simulation._scenario_point(
        template, d, b, n_users))(dd, bb)
    res, r = _run_lanes(g, fleet, p_lanes, n_users, max_events, max_jobs,
                        batch)
    if full:
        ref = simulation.sweep(g, fleet, dl, bl, types.OPT_COST, n_users,
                               scenario=scenario)
        for f in ("n_done", "spent", "term_time", "n_steps", "n_spec",
                  "n_reseeds", "n_scans", "n_events"):
            a = np.asarray(getattr(ref, f)).reshape(
                (dd.shape[0],) + np.asarray(getattr(r, f)).shape[1:])
            assert np.array_equal(a, np.asarray(getattr(r, f))), (name, f)
    lanes = _lane_results(res, r, full)
    assert len({(x["term_time"][0], x["spent"][0]) for x in lanes}) > 1, \
        f"{name}: every lane ends alike"
    return {
        "kind": "grid", "seed": seed, "n_users": n_users,
        "n_jobs_per_user": n_jobs, "base_mi": 10_000.0,
        "deadlines": _bits(dl), "budgets": _bits(bl), "scenario": knobs,
        "opt": types.OPT_COST, "batch": batch, "max_events": max_events,
        "max_jobs": max_jobs, "full": full,
        "fleet": _fleet_fields(fleet, "wwg"),
        "length_mi": _bits(g.length_mi), "lanes": lanes,
    }


def lane_cell(name, seed, n_users, n_jobs, base_mi, deadline, budget,
              max_events, full, partitionable):
    """``engine.run_sweep_lanes`` over ``Scenario(policy=)`` lanes, as
    ``examples/table1_strategies.py`` and ``engine_bench._strategy_sweep``
    call it (no job-slot bound: J = N); the gridlets drawn in the
    ``partitionable`` threefry layout."""
    fleet = resource.wwg_fleet()
    with jax.threefry_partitionable(partitionable):
        g = gridlet.task_farm(jax.random.PRNGKey(seed), n_jobs=n_jobs,
                              n_users=n_users, base_mi=base_mi)
    if max_events is None:
        max_events = simulation._max_events(g.n, n_users, deadline, 1.0)
    ps = [simulation._scenario_params(fleet, deadline, budget,
                                      types.OPT_COST, n_users,
                                      simulation.Scenario(policy=opt))
          for _, opt in STRATEGIES]
    p_lanes = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *ps)
    batch = engine.DEFAULT_BATCH
    res, r = _run_lanes(g, fleet, p_lanes, n_users, max_events, None, batch)
    return {
        "kind": "lanes", "seed": seed, "n_users": n_users,
        "n_jobs_per_user": n_jobs, "base_mi": base_mi,
        "partitionable": partitionable,
        "deadline": deadline, "budget": budget,
        "policies": [opt for _, opt in STRATEGIES],
        "names": [n for n, _ in STRATEGIES],
        "batch": batch, "max_events": max_events, "max_jobs": None,
        "full": full, "fleet": _fleet_fields(fleet, "wwg"),
        "length_mi": _bits(g.length_mi),
        "lanes": _lane_results(res, r, full),
    }


def sweep_cells(names=None):
    cells = {}
    for c in SWEEP_CELLS:
        if names is None or c[0] in names:
            cells[c[0]] = sweep_cell(*c)
            print(f"  {c[0]} done", flush=True)
    for c in LANE_CELLS:
        if names is None or c[0] in names:
            cells[c[0]] = lane_cell(*c)
            print(f"  {c[0]} done", flush=True)
    return cells


def _header(about):
    return {
        "_about": about + " (tests/data/gen_port_ref.py); floats as "
                          "uint32 bits",
        "jax_version": jax.__version__,
        "jax_threefry_partitionable": bool(
            jax.config.jax_threefry_partitionable),
    }


def main(which=("main", "net", "fail", "rand", "econ", "sweep")):
    if "main" in which:
        ref = dict(_header("JAX reference results for the port's "
                           "main-path cells"),
                   cells={c[0]: cell(*c) for c in CELLS})
        with open(OUT, "w") as f:
            json.dump(ref, f, separators=(",", ":"))
        print(f"wrote {OUT}")
    if "net" in which:
        cells = {c[0]: scenario_cell(*c)[0] for c in NET_CELLS}
        # the trunk cap binds: the capped runs differ from the uncapped
        for users in ("20u_100j", "4u_25j"):
            a = cells[f"{users}_net"]["result"]
            b = cells[f"{users}_trunknet"]["result"]
            assert a["trace_t"] != b["trace_t"] or \
                a["finish"] != b["finish"], users
        assert cells["20u_100j_net"]["result"]["trace_t"] != \
            cells["20u_100j_trunknet"]["result"]["trace_t"]
        cells["direct_net"] = direct_cell()
        ref = dict(_header("JAX reference results for the port's "
                           "contended-network cells"), cells=cells)
        with open(OUT_NET, "w") as f:
            json.dump(ref, f, separators=(",", ":"))
        print(f"wrote {OUT_NET}")
    if "fail" in which:
        ref = dict(_header("JAX reference results for the port's "
                           "dynamic-resource cells"),
                   cells={c[0]: fail_cell(*c) for c in FAIL_CELLS})
        with open(OUT_FAIL, "w") as f:
            json.dump(ref, f, separators=(",", ":"))
        print(f"wrote {OUT_FAIL}")
    if "rand" in which:
        ref = dict(_header("jax.random draws and XLA:CPU transcendentals "
                           "for the port's threefry"), **rand_ref())
        with open(OUT_RAND, "w") as f:
            json.dump(ref, f, separators=(",", ":"))
        print(f"wrote {OUT_RAND}")
    if "econ" in which:
        ref = dict(_header("JAX reference results for the port's "
                           "grid-economy cells"), cells=econ_cells())
        with open(OUT_ECON, "w") as f:
            json.dump(ref, f, separators=(",", ":"))
        print(f"wrote {OUT_ECON}")
    if "sweep" in which:
        ref = dict(_header("JAX reference results for the port's "
                           "sweep cells"), cells=sweep_cells())
        with open(OUT_SWEEP, "w") as f:
            json.dump(ref, f, separators=(",", ":"))
        print(f"wrote {OUT_SWEEP}")


if __name__ == "__main__":
    main(tuple(sys.argv[1:]) or ("main", "net", "fail", "rand", "econ",
                                 "sweep"))
