"""High-level experiment drivers (the paper's section-4 "recipe"; port
of ``repro.core.simulation``).

``run_experiment`` = create resources + users + brokers, start the
clock, collect statistics -- one call, on the card unless the caller
passes ``device="cpu"``.  ``Scenario`` keeps the reference's knobs and
defaults, and every one of them runs as in the reference: the failure
streams (``mtbf``/``mttr``, seeded from ``seed``), the fault trace and
the fault-tolerant broker's knobs, reservation and maintenance windows
(``reservations``), commodity and auction pricing (the auction seeded
from ``auction_seed``, else ``seed``) and the plan-ahead broker.  The
network knobs (``baud_rate``, ``bg_flows``, ``trunk_*``) take effect
with ``net_cap != 0``.  ``sweep`` runs a deadline x budget grid (paper
Figs 21-24) through the lane-batched engine (``engine.run_sweep_lanes``:
one lane a grid point, deadline-major) and ``sweep_sharded`` splits its
lanes across devices; both run the default scenario sources and raise
``NotImplementedError`` for a setting the sweep engine has not ported
(failure streams, a fault trace, windows, dynamic pricing, plan-ahead,
``net_cap != 0``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from . import economy, engine, numerics, rand
from .segments import segment_count
from .types import DONE, OPT_COST, replace, resolve_device, to_device


class Scenario(NamedTuple):
    """Dynamic-resource scenario knobs (all optional; see the
    reference for each one's meaning)."""
    mtbf: Any = None
    mttr: Any = None
    reservations: Any = None
    seed: int = 0
    baud_rate: Any = None
    bg_flows: Any = None
    sched_min_period: Any = None
    sched_frac: Any = None
    policy: Any = None
    pricing_model: Any = None
    market_period: Any = None
    market_gain: Any = None
    auction_period: Any = None
    auction_seed: Any = None
    plan_ahead: Any = None
    trunk_of: Any = None
    trunk_baud: Any = None
    trunk_bg: Any = None
    fault_trace: Any = None
    retry_limit: Any = None
    backoff_base: Any = None
    blacklist_cooldown: Any = None


@dataclasses.dataclass(frozen=True)
class ExperimentResult:
    n_done: torch.Tensor          # f32[U] gridlets completed per user
    spent: torch.Tensor           # f32[U] budget spent per user
    term_time: torch.Tensor       # f32[U] broker termination time
    time_utilization: torch.Tensor    # f32[U] term_time / deadline
    budget_utilization: torch.Tensor  # f32[U] spent / budget
    per_resource_done: torch.Tensor   # f32[U,R] completions by resource
    gridlets: object
    n_events: torch.Tensor        # i32 events applied by the engine
    n_steps: torch.Tensor         # i32 committing supersteps
    overflow: torch.Tensor        # i32 job-slot allocation failures (== 0)
    n_failed: torch.Tensor        # i32 gridlets hit by a resource failure
    n_resubmits: torch.Tensor     # i32 FAILED gridlets re-dispatched
    downtime: torch.Tensor        # f32[R] accumulated down intervals
    truncated: torch.Tensor       # bool: hit max_events before finishing
    n_spec: torch.Tensor          # i32 speculative supersteps
    n_reseeds: torch.Tensor       # i32 scans that re-sorted the table
    n_scans: torch.Tensor         # i32 scans performed
    trace: tuple = ()             # the engine's (t, kind, who) event trace
    host_syncs: int = 0           # device-to-host reads of the host loop


engine._dataclass_pytree(ExperimentResult, static=("host_syncs",))


def _max_events(n_gridlets: int, n_users: int, horizon: float,
                min_period: float) -> int:
    # 4 events per gridlet lifecycle + broker polls over the horizon.
    return int(4 * n_gridlets + horizon / max(min_period, 1e-6) + 64)


def _done_counts(g, n_users: int, n_resources: int):
    """Gridlets DONE per user, f32[U], and per (user, resource), f32[U, R]
    (integer-valued f32 sums: exact in any order)."""
    done = g.status == DONE
    u = g.user.to(torch.int64)
    ur = u * n_resources + torch.clamp(g.resource.to(torch.int64), 0,
                                       n_resources - 1)
    return (segment_count(done, u, n_users).to(torch.float32),
            segment_count(done, ur, n_users * n_resources).to(
                torch.float32).reshape(n_users, n_resources))


def summarize(res: engine.SimResult, params, n_users: int,
              n_resources: int,
              max_events: int | None = None) -> ExperimentResult:
    """The experiment's statistics from the engine's result; a
    lane-batched ``res`` and ``params`` (every leaf with a leading lane
    axis, as ``engine.run_sweep_lanes`` takes and returns them) give
    every field with that axis."""
    g = res.gridlets
    if g.status.dim() == 2:
        n_done, per_res = engine._vmap(
            lambda x: _done_counts(x, n_users, n_resources), g)
    else:
        n_done, per_res = _done_counts(g, n_users, n_resources)
    truncated = (res.n_steps + res.n_spec >= max_events
                 if max_events is not None
                 else torch.zeros_like(res.n_steps, dtype=torch.bool))
    return ExperimentResult(
        n_done=n_done,
        spent=res.spent,
        term_time=res.term_time,
        time_utilization=res.term_time / torch.clamp_min(params.deadline,
                                                         1e-30),
        budget_utilization=res.spent / torch.clamp_min(params.budget,
                                                       1e-30),
        per_resource_done=per_res,
        gridlets=g,
        n_events=res.n_events,
        n_steps=res.n_steps,
        overflow=res.overflow,
        n_failed=res.n_failed,
        n_resubmits=res.n_resubmits,
        downtime=res.downtime,
        truncated=truncated,
        n_spec=res.n_spec,
        n_reseeds=res.n_reseeds,
        n_scans=res.n_scans,
        trace=res.trace,
        host_syncs=res.host_syncs,
    )


def safe_max_jobs(gridlets_batch, params, fleet) -> int:
    """Static bound on concurrently RUNNING gridlets per resource: at
    most max_gridlet_per_pe * num_pe in flight per (user, resource)."""
    limit = int(params.max_gridlet_per_pe) * fleet.max_pe
    return min(gridlets_batch.n, params.deadline.shape[0] * limit)


def safe_net_cap(gridlets_batch, params, fleet, n_users: int = 1) -> int:
    """Static bound on concurrent transfers per resource link: at most
    max_gridlet_per_pe * num_pe gridlets in flight per (user, resource),
    each holding at most one transfer at a time (capped at N)."""
    limit = int(params.max_gridlet_per_pe) * fleet.max_pe
    return min(gridlets_batch.n, n_users * limit)


def _scenario_params(fleet, deadline, budget, opt, n_users,
                     scenario: Scenario | None,
                     device="cpu") -> engine.SimParams:
    s = scenario or Scenario()
    p = engine.default_params(
        deadline, budget,
        opt if s.policy is None else s.policy,
        n_users, fleet.r,
        mtbf=s.mtbf, mttr=s.mttr, reservations=s.reservations,
        fail_key=rand.PRNGKey(s.seed, device),
        link_baud=(fleet.baud_rate if s.baud_rate is None
                   else s.baud_rate),
        bg_flows=s.bg_flows,
        pricing_model=economy.as_pricing_model(s.pricing_model),
        market_period=s.market_period,
        market_gain=s.market_gain,
        auction_period=s.auction_period,
        auction_key=rand.PRNGKey(
            s.seed if s.auction_seed is None else s.auction_seed, device),
        plan_ahead=bool(s.plan_ahead) if s.plan_ahead is not None
        else False,
        trunk_of=s.trunk_of, trunk_baud=s.trunk_baud,
        trunk_bg=s.trunk_bg, fault_trace=s.fault_trace,
        retry_limit=s.retry_limit, backoff_base=s.backoff_base,
        blacklist_cooldown=s.blacklist_cooldown, device=device)
    if s.sched_min_period is not None:
        p = replace(p, sched_min_period=torch.tensor(
            float(s.sched_min_period), device=device))
    if s.sched_frac is not None:
        p = replace(p, sched_frac=torch.tensor(float(s.sched_frac),
                                               device=device))
    return p


def run_experiment(gridlets_batch, fleet, deadline, budget,
                   opt=OPT_COST, n_users: int = 1,
                   max_events: int | None = None,
                   scenario: Scenario | None = None,
                   batch: int = engine.DEFAULT_BATCH,
                   net_cap: int | None = 0,
                   telemetry: int | None = None,
                   device="cuda") -> ExperimentResult:
    """Run one experiment on ``device``.  ``batch`` is the engine's
    k-step superstep batching factor (results are bit-for-bit identical
    for every value).  ``net_cap`` enables the contention-aware network:
    0 keeps the analytic links, ``None`` sizes the transfer-slot table
    with :func:`safe_net_cap`, a positive int is the slot count per
    link.  ``telemetry`` is not ported yet."""
    if telemetry:
        raise NotImplementedError("telemetry is not ported yet")
    dev = resolve_device(device)
    gridlets_batch = to_device(gridlets_batch, dev)
    fleet = to_device(fleet, dev)
    params = _scenario_params(fleet, deadline, budget, opt, n_users,
                              scenario, dev)
    if net_cap is None:
        net_cap = safe_net_cap(gridlets_batch, params, fleet, n_users)
    if max_events is None:
        horizon = float(params.deadline.max()) * 2.0 + 100.0
        max_events = _max_events(gridlets_batch.n, n_users, horizon, 1.0)
    res = engine.run(gridlets_batch, fleet, params, n_users, max_events,
                     max_jobs=safe_max_jobs(gridlets_batch, params, fleet),
                     batch=batch, net_cap=net_cap, device=dev)
    return summarize(res, params, n_users, fleet.r, max_events)


def run_experiment_factors(gridlets_batch, fleet, d_factor, b_factor,
                           opt=OPT_COST, n_users: int = 1,
                           max_events: int | None = None,
                           scenario: Scenario | None = None,
                           device="cuda"):
    """Paper 4.2.3: derive absolute deadline/budget from D-/B-factors."""
    dev = resolve_device(device)
    gridlets_batch = to_device(gridlets_batch, dev)
    fleet = to_device(fleet, dev)
    # XLA:CPU's summation order, so the derived deadline and budget are
    # the reference's to the last bit.
    total_mi = numerics.ordered_sum(gridlets_batch.length_mi)
    deadline = economy.deadline_from_factor(fleet, total_mi, d_factor)
    budget = economy.budget_from_factor(fleet, total_mi, b_factor)
    return run_experiment(gridlets_batch, fleet, deadline, budget, opt,
                          n_users, max_events, scenario,
                          device=dev), (deadline, budget)


def _scenario_point(template: engine.SimParams, d, b,
                    n_users: int) -> engine.SimParams:
    """Instantiate one grid point from the sweep's params template."""
    dev = template.deadline.device
    return replace(template,
                   deadline=torch.as_tensor(d, dtype=torch.float32,
                                            device=dev).broadcast_to(
                       (n_users,)).clone(),
                   budget=torch.as_tensor(b, dtype=torch.float32,
                                          device=dev).broadcast_to(
                       (n_users,)).clone())


def _lane_points(template, dd, bb, n_users: int) -> engine.SimParams:
    """The lane-batched params of the grid points (dd[i], bb[i])."""
    return engine._stack([_scenario_point(template, d, b, n_users)
                          for d, b in zip(dd, bb)])


def _run_lanes_flat(gridlets_batch, fleet, template, dd, bb, *, n_users,
                    max_events, max_jobs, batch, net_cap, device):
    """Run a flat vector of scenario lanes through the lane-batched
    engine (:func:`engine.run_sweep_lanes`) and summarize each."""
    p_lanes = _lane_points(template, dd, bb, n_users)
    res = engine.run_sweep_lanes(gridlets_batch, fleet, p_lanes, n_users,
                                 max_events, max_jobs, batch=batch,
                                 net_cap=net_cap, device=device)
    return summarize(res, p_lanes, n_users, fleet.r, max_events)


def _run_points(gridlets_batch, fleet, template, dd, bb, *, n_users,
                max_events, max_jobs, batch, net_cap, device):
    """The reference path of the same lanes: each point its own
    :func:`engine.run_inner`, the summaries stacked on a lane axis."""
    runs = []
    for d, b in zip(dd, bb):
        params = _scenario_point(template, d, b, n_users)
        res = engine.run_inner(gridlets_batch, fleet, params, n_users,
                               max_events, max_jobs, batch=batch,
                               net_cap=net_cap, device=device)
        runs.append(summarize(res, params, n_users, fleet.r, max_events))
    return dataclasses.replace(engine._stack(runs),
                               host_syncs=sum(r.host_syncs for r in runs))


def _grid_points(deadlines, budgets):
    """The grid's points flattened deadline-major: (deadline, budget)
    vectors of D * B lanes."""
    return (deadlines.repeat_interleave(budgets.shape[0]),
            budgets.repeat(deadlines.shape[0]))


def _grid_shape(out, lead):
    """Reshape the lane axis of every leaf of a result to ``lead``."""
    return engine._tree_map(lambda x: x.reshape(lead + x.shape[1:]), out)


def _sweep_grid(gridlets_batch, fleet, template, deadlines, budgets, *,
                n_users, max_events, max_jobs, batch, net_cap, select_free,
                device):
    """The deadline x budget grid, flattened deadline-major.  The
    select-free path runs every point as a lane of one lane-batched
    engine run; ``select_free=False`` runs the reference path, each
    point through :func:`engine.run_inner` (the same "what" fields)."""
    dd, bb = _grid_points(deadlines, budgets)
    run = _run_lanes_flat if select_free else _run_points
    out = run(gridlets_batch, fleet, template, dd, bb, n_users=n_users,
              max_events=max_events, max_jobs=max_jobs, batch=batch,
              net_cap=net_cap, device=device)
    return _grid_shape(out, (deadlines.shape[0], budgets.shape[0]))


def _sweep_statics(gridlets_batch, fleet, deadlines, opt, n_users,
                   max_events, scenario, batch, net_cap, select_free, dev):
    """Shared static-argument resolution for sweep / sweep_sharded."""
    if batch is None:
        batch = engine.DEFAULT_BATCH if select_free else 1
    if max_events is None:
        horizon = float(deadlines.max()) * 2.0 + 100.0
        max_events = _max_events(gridlets_batch.n, n_users, horizon, 1.0)
    template = _scenario_params(fleet, 0.0, 0.0, opt, n_users, scenario,
                                dev)
    max_jobs = safe_max_jobs(gridlets_batch, template, fleet)
    if net_cap is None:
        net_cap = safe_net_cap(gridlets_batch, template, fleet, n_users)
    engine._check_lane_settings(template, net_cap, None)
    return template, max_events, max_jobs, batch, net_cap


def sweep(gridlets_batch, fleet, deadlines, budgets, opt=OPT_COST,
          n_users: int = 1, max_events: int | None = None,
          scenario: Scenario | None = None, batch: int | None = None,
          net_cap: int | None = 0, select_free: bool = True,
          device="cuda"):
    """The full deadline x budget grid (paper Figs 21-24) on ``device``.

    deadlines: [D], budgets: [B] -> every field gains leading [D, B]
    dims.  ``select_free`` (default) runs every grid point as a lane of
    one lane-batched engine run (``batch`` defaults to
    ``engine.DEFAULT_BATCH``); ``select_free=False`` runs the reference
    path, each point through :func:`engine.run_inner` (``batch``
    defaults to 1).  The "what" fields are bit for bit the same either
    way."""
    dev = resolve_device(device)
    gridlets_batch = to_device(gridlets_batch, dev)
    fleet = to_device(fleet, dev)
    deadlines = torch.as_tensor(deadlines, dtype=torch.float32, device=dev)
    budgets = torch.as_tensor(budgets, dtype=torch.float32, device=dev)
    template, max_events, max_jobs, batch, net_cap = _sweep_statics(
        gridlets_batch, fleet, deadlines, opt, n_users, max_events,
        scenario, batch, net_cap, select_free, dev)
    return _sweep_grid(gridlets_batch, fleet, template, deadlines, budgets,
                       n_users=n_users, max_events=max_events,
                       max_jobs=max_jobs, batch=batch, net_cap=net_cap,
                       select_free=select_free, device=dev)


def sweep_sharded(gridlets_batch, fleet, deadlines, budgets,
                  opt=OPT_COST, n_users: int = 1,
                  max_events: int | None = None,
                  scenario: Scenario | None = None,
                  batch: int | None = None, net_cap: int | None = 0,
                  select_free: bool = True, devices=None):
    """:func:`sweep` with the scenario axis split across ``devices``
    (default: the one card; a list may name a device more than once).

    The [D, B] grid is flattened deadline-major into S = D * B lanes,
    padded to a multiple of ``len(devices)`` with copies of the last
    lane, and each device runs its contiguous chunk as one lane-batched
    engine run (the chunks one after another: the host drives each
    run's loop), so a chunk whose lanes finish early stops costing loop
    iterations the others still run.  The padding is dropped; the result
    is gathered on the first device, bit for bit :func:`sweep`'s."""
    devices = [resolve_device("cuda")] if devices is None else \
        [resolve_device(d) for d in devices]
    first = devices[0]
    deadlines = torch.as_tensor(deadlines, dtype=torch.float32)
    budgets = torch.as_tensor(budgets, dtype=torch.float32)
    d_grid, b_grid = deadlines.shape[0], budgets.shape[0]
    s = d_grid * b_grid
    n_dev = len(devices)
    s_pad = -(-s // n_dev) * n_dev
    dd, bb = _grid_points(deadlines, budgets)
    dd = torch.cat([dd, dd[-1:].expand(s_pad - s)])
    bb = torch.cat([bb, bb[-1:].expand(s_pad - s)])
    chunk = s_pad // n_dev

    def run_chunk(i):
        dev = devices[i]
        g = to_device(gridlets_batch, dev)
        f = to_device(fleet, dev)
        template, m_ev, m_jobs, k, cap = _sweep_statics(
            g, f, deadlines, opt, n_users, max_events, scenario, batch,
            net_cap, select_free, dev)
        sl = slice(i * chunk, (i + 1) * chunk)
        run = _run_lanes_flat if select_free else _run_points
        return run(g, f, template, dd[sl], bb[sl], n_users=n_users,
                   max_events=m_ev, max_jobs=m_jobs, batch=k, net_cap=cap,
                   device=dev)

    parts = [run_chunk(i) for i in range(n_dev)]
    syncs = sum(p.host_syncs for p in parts)
    parts = [engine._tree_map(lambda x: x.to(first), p) for p in parts]
    out = engine._tree_map(lambda *xs: torch.cat(xs)[:s], *parts)
    out = dataclasses.replace(out, host_syncs=syncs)
    return _grid_shape(out, (d_grid, b_grid))
