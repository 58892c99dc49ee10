"""High-level experiment drivers (the paper's section-4 "recipe"; port
of ``repro.core.simulation``).

``run_experiment`` = create resources + users + brokers, start the
clock, collect statistics -- one call, on the card unless the caller
passes ``device="cpu"``.  ``Scenario`` keeps the reference's knobs and
defaults; the ones that would switch on a source this slice does not
run (failures, reservations, dynamic pricing, plan-ahead, trunks, fault
traces) raise ``NotImplementedError``, as do the sweep drivers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from . import economy, engine
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


def _max_events(n_gridlets: int, n_users: int, horizon: float,
                min_period: float) -> int:
    # 4 events per gridlet lifecycle + broker polls over the horizon.
    return int(4 * n_gridlets + horizon / max(min_period, 1e-6) + 64)


def summarize(res: engine.SimResult, params, n_users: int,
              n_resources: int,
              max_events: int | None = None) -> ExperimentResult:
    g = res.gridlets
    done = g.status == DONE
    u = g.user.to(torch.int64)
    # integer-valued f32 sums: exact in any order
    n_done = segment_count(done, u, n_users).to(torch.float32)
    ur = u * n_resources + torch.clamp(g.resource.to(torch.int64), 0,
                                       n_resources - 1)
    per_res = segment_count(done, ur, n_users * n_resources).to(
        torch.float32).reshape(n_users, n_resources)
    dev = res.spent.device
    truncated = torch.tensor(
        max_events is not None and
        int(res.n_steps) + int(res.n_spec) >= max_events, device=dev)
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


def _scenario_params(fleet, deadline, budget, opt, n_users,
                     scenario: Scenario | None,
                     device="cpu") -> engine.SimParams:
    s = scenario or Scenario()
    p = engine.default_params(
        deadline, budget,
        opt if s.policy is None else s.policy,
        n_users, fleet.r,
        mtbf=s.mtbf, mttr=s.mttr, reservations=s.reservations,
        link_baud=(fleet.baud_rate if s.baud_rate is None
                   else s.baud_rate),
        bg_flows=s.bg_flows,
        pricing_model=economy.as_pricing_model(s.pricing_model),
        plan_ahead=bool(s.plan_ahead) if s.plan_ahead is not None
        else False,
        trunk_of=s.trunk_of, fault_trace=s.fault_trace,
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
    for every value).  ``net_cap`` and ``telemetry`` are not ported
    yet."""
    if net_cap is None or net_cap:
        raise NotImplementedError("the fair-share network (net_cap) is "
                                  "not ported yet")
    if telemetry:
        raise NotImplementedError("telemetry is not ported yet")
    dev = resolve_device(device)
    gridlets_batch = to_device(gridlets_batch, dev)
    fleet = to_device(fleet, dev)
    params = _scenario_params(fleet, deadline, budget, opt, n_users,
                              scenario, dev)
    if max_events is None:
        horizon = float(params.deadline.max()) * 2.0 + 100.0
        max_events = _max_events(gridlets_batch.n, n_users, horizon, 1.0)
    res = engine.run(gridlets_batch, fleet, params, n_users, max_events,
                     max_jobs=safe_max_jobs(gridlets_batch, params, fleet),
                     batch=batch, device=dev)
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
    total_mi = gridlets_batch.length_mi.sum()
    deadline = economy.deadline_from_factor(fleet, total_mi, d_factor)
    budget = economy.budget_from_factor(fleet, total_mi, b_factor)
    return run_experiment(gridlets_batch, fleet, deadline, budget, opt,
                          n_users, max_events, scenario,
                          device=dev), (deadline, budget)


def sweep(*args, **kwargs):
    """The deadline x budget sweep engine is not ported yet."""
    raise NotImplementedError("sweep is not ported yet")


def sweep_sharded(*args, **kwargs):
    """The sharded sweep engine is not ported yet."""
    raise NotImplementedError("sweep_sharded is not ported yet")
