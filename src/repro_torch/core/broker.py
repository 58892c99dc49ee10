"""Economic grid resource broker (paper section 4.2, Figs 18-20; port
of ``repro.core.broker``).

Each user owns a broker; a BROKER event runs every broker at once.
Per-gridlet arrays are [N], per-user [U], per-resource [R], the
measurement tables [U, R].  One event is the full Fig 20 cycle:
``_measure`` (discovery, trading, measured consumption rate, capacity
by the deadline), ``_release`` (over-committed jobs back to the queue),
``_assign`` (fill capacity slots in policy order under the budget) and
``_dispatch`` (stage jobs, committing their exact cost).

Float sums keep the reference's order (``numerics.segment_sum``,
``numerics.cumsum``) and its fused multiply-adds (``numerics.fma``), so
affordability decisions match it bit for bit.  ``_measure`` takes the
reservation windows into the advertised capacity: the reactive broker
subtracts the PEs held now, and the plan-ahead broker (cs/0203020;
``HostCounts.plan``, fixed at the run's start) advertises full PEs but
charges each window's PE-time before the user's deadline and the
queued bytes on each link (``network.fastest_drain``).
"""
from __future__ import annotations

import torch

from . import calendar, network, numerics
from . import reservation as resv_mod
from .segments import (group_prefix_sum, group_rank, segment_count,
                       segment_min)
from .types import (CREATED, DONE, FAILED, IN_TRANSIT, INF, OPT_COST,
                    OPT_COST_TIME, OPT_NONE, OPT_TIME, QUEUED, RETURNING,
                    RUNNING, replace)


def _policy_keys(opt, cost_per_mi, est_rate, r_index, plan_ahead=False):
    """Composite per-resource ordering key for each optimisation mode:
    cost (cheapest G$/MI first, ties by index), time (fastest estimated
    rate first), cost-time (cheapest first, equal costs fastest first),
    none (index order).  ``plan_ahead`` (a host bool) makes cost-time
    the exact cs/0203020 grouping: a dense rank of the cost (bit-equal
    costs share a group) plus a within-group term in [0, 0.5]."""
    shape = est_rate.shape
    est_norm = est_rate / torch.clamp_min(
        est_rate.max(dim=-1, keepdim=True).values, 1e-30)
    key_cost = numerics.fma(1e-7, r_index, cost_per_mi).expand(shape)
    key_time = numerics.fma(1e-7, r_index, -est_rate)
    if plan_ahead:
        cost = cost_per_mi.expand(shape)
        grp = (cost[..., None, :] < cost[..., :, None]).sum(dim=-1).to(
            torch.float32)
        key_cost_time = numerics.fma(1e-7, r_index,
                                     grp + (1.0 - est_norm) * 0.5)
    else:
        key_cost_time = numerics.fma(
            1e-7, r_index, numerics.fma(-1e-4, est_norm, cost_per_mi))
    key_none = (r_index * 1.0).expand(shape)
    o = opt[:, None]
    return torch.where(
        o == OPT_COST, key_cost, torch.where(
            o == OPT_TIME, key_time, torch.where(
                o == OPT_COST_TIME, key_cost_time, torch.where(
                    o == OPT_NONE, key_none, 0.0))))


def _retryable(g, params, t):
    """Dispatchable now: CREATED, or FAILED within its retry budget and
    past its backoff instant."""
    ok = (g.n_retries <= params.retry_limit) & (t >= g.retry_at)
    return (g.status == CREATED) | ((g.status == FAILED) & ok)


def _not_abandoned(g, params):
    """CREATED, or FAILED still inside its retry budget."""
    within = g.n_retries <= params.retry_limit
    return (g.status == CREATED) | ((g.status == FAILED) & within)


def _min_mi(g, n_users, params=None):
    if params is None:
        undispatched = (g.status == CREATED) | (g.status == FAILED)
    else:
        undispatched = _not_abandoned(g, params)
    return segment_min(torch.where(undispatched, g.length_mi, INF), g.user,
                       n_users)


def min_affordable_cost(g, fleet, n_users: int, price=None, params=None):
    """Cheapest possible next purchase per user: the smallest
    still-undispatched Gridlet priced at the best G$/MI (+inf when
    nothing is left to dispatch)."""
    per_mi = fleet.cost_per_mi() if price is None else price
    return _min_mi(g, n_users, params) * per_mi.min()


def affordable(state, params, n_users: int):
    """``spent + min_affordable_cost <= budget`` per user, with the
    multiply-add fused as the reference's compiled loop fuses it."""
    cost_next = numerics.fma(_min_mi(state.g, n_users, params),
                             state.price.min(), state.spent)
    return cost_next <= params.budget


def _measure(state, fleet, params, n_users: int):
    """Fig 20 steps 1-3: trading metrics, measured consumption rate,
    capacity by deadline.  Returns the per-event context dict."""
    g = state.g
    t = state.t
    R = fleet.r
    u_idx = g.user.to(torch.int64)
    width = state.width

    blacklisted = (t - state.recovered_at) < params.blacklist_cooldown
    registered = params.registered & state.res_up & ~blacklisted
    eff = calendar.effective_mips(fleet, t)                      # [R]
    # The reactive broker subtracts the PEs held now from the advertised
    # rate; plan-ahead advertises them all and charges the windows below.
    plan = state.host.plan
    n_windows = params.resv_res.shape[0]
    adv_pe = fleet.num_pe
    if n_windows and not plan:
        adv_pe = adv_pe - resv_mod.active_pes(
            params.resv_res, params.resv_pes, params.resv_start,
            params.resv_end, t, R)
    adv_rate = eff * torch.clamp_min(adv_pe, 0).to(torch.float32)
    cost_per_mi = state.price                                    # [R]

    cnt_per_user = segment_count(torch.ones_like(u_idx, dtype=torch.bool),
                                 u_idx, n_users)
    mi_per_user = numerics.segment_sum(g.length_mi, u_idx, n_users, width)
    avg_mi = mi_per_user / torch.clamp_min(
        cnt_per_user.to(torch.float32), 1.0)                     # [U]

    inflight = ((g.status == IN_TRANSIT) | (g.status == QUEUED) |
                (g.status == RUNNING) | (g.status == RETURNING))
    on_res = torch.clamp(g.resource.to(torch.int64), 0, R - 1)
    ur_res_key = u_idx * R + on_res
    frac = torch.where(inflight, 1.0 - g.remaining / g.length_mi, 0.0)
    progress = numerics.segment_sum(frac, ur_res_key, n_users * R, width)
    progress = progress.reshape(n_users, R) + state.done_on      # jobs-equiv

    elapsed = torch.clamp_min(t - state.first_dispatch, 1e-6)    # [U,R]
    adv_jobs = adv_rate[None, :] / torch.clamp_min(avg_mi[:, None], 1e-30)
    measured = progress / elapsed
    started = torch.isfinite(state.first_dispatch) & \
        (t > state.first_dispatch + 1e-9)
    est_jobs = torch.where(started, torch.minimum(measured, adv_jobs),
                           adv_jobs)
    est_jobs = torch.where(registered[None, :], est_jobs, 0.0)   # [U,R]

    time_left = torch.clamp_min(params.deadline - t, 0.0)        # [U]
    if plan:
        cap_jobs = _plan_capacity(state, params, eff, avg_mi, est_jobs,
                                  time_left, R)
    else:
        cap_jobs = torch.floor(est_jobs * time_left[:, None]).to(
            torch.int32)

    active = (t < params.deadline) & affordable(state, params, n_users)
    return dict(registered=registered, cost_per_mi=cost_per_mi,
                est_jobs=est_jobs, cap_jobs=cap_jobs, avg_mi=avg_mi,
                inflight=inflight, ur_res_key=ur_res_key, active=active)


def _window_pe_time(pe_time, resv_res, R):
    """Each resource's windowed PE-time, f32[U, R]: ``pe_time`` [U, K]
    summed over the windows booked on the resource.  The reference
    contracts it against a one-hot [R, K] (an XLA:CPU dot); for the
    shapes of its cells (U >= 2, R = 11) the dot adds the windows in
    four lanes, window k into lane k mod 4, sums the lanes as (0 + 1) +
    (2 + 3), then adds the last K mod 4 windows, (k0 + k1) + k2."""
    k = pe_time.shape[1]
    on_r = resv_res.to(torch.int64)[None, :] == torch.arange(
        R, device=resv_res.device)[:, None]                      # [R,K]
    v = torch.where(on_r[None], pe_time[:, None, :], 0.0)        # [U,R,K]
    n4 = k // 4 * 4
    total = torch.zeros(v.shape[:2], dtype=torch.float32, device=v.device)
    if n4:
        lanes = v[..., :4]
        for c in range(4, n4, 4):
            lanes = lanes + v[..., c:c + 4]
        total = (lanes[..., 0] + lanes[..., 1]) + \
            (lanes[..., 2] + lanes[..., 3])
    if k > n4:
        tail = v[..., n4]
        for c in range(n4 + 1, k):
            tail = tail + v[..., c]
        total = tail if not n4 else total + tail
    return total


def _plan_capacity(state, params, eff, avg_mi, est_jobs, time_left, R):
    """Plan-ahead capacity by the deadline (cs/0203020), i32[U, R]: the
    jobs the estimated rate completes after the link's queued bytes
    drain, less the jobs-equivalent of the PE-time each reservation
    window blocks over [t, deadline_u] at the current calendar rate."""
    t = state.t
    ov = torch.clamp_min(
        torch.minimum(params.resv_end[None, :], params.deadline[:, None]) -
        torch.maximum(params.resv_start[None, :], t), 0.0)      # [U,K]
    pe_time = params.resv_pes.to(torch.float32)[None, :] * ov
    blocked_jobs = _window_pe_time(pe_time, params.resv_res, R) * \
        eff[None, :] / torch.clamp_min(avg_mi[:, None], 1e-30)
    if state.link_rem.shape[1] > 0:
        link_delay = network.fastest_drain(
            numerics.ordered_sum_rows(state.link_rem[:R]),
            params.link_baud, params.bg_flows)                   # [R]
    else:
        link_delay = torch.zeros((R,), dtype=torch.float32,
                                 device=t.device)
    window = torch.clamp_min(time_left[:, None] - link_delay[None, :], 0.0)
    return torch.floor(torch.clamp_min(
        numerics.fma(est_jobs, window, -blocked_jobs), 0.0)).to(torch.int32)


def _release(state, ctx, params, n_users: int, R: int):
    """Fig 20 step 4: release over-committed undispatched jobs."""
    g = state.g
    u_idx = g.user.to(torch.int64)
    idx = torch.arange(g.n, device=u_idx.device)
    ur_key = u_idx * R + torch.clamp(g.assigned.to(torch.int64), 0, R - 1)

    committed = (g.assigned >= 0) & (g.status != DONE)
    n_committed = segment_count(committed, ur_key,
                                n_users * R).reshape(n_users, R)

    undispatched = _retryable(g, params, state.t) & (g.assigned >= 0)
    rel_rank, n_undisp = group_rank(ur_key, undispatched, -idx,
                                    n_users * R)
    n_release = torch.minimum(
        torch.clamp_min(n_committed - ctx["cap_jobs"], 0),
        n_undisp.reshape(n_users, R))
    n_release = torch.where(ctx["active"][:, None], n_release, 0)
    release = undispatched & (
        rel_rank < n_release.reshape(-1)[
            torch.clamp(ur_key, 0, n_users * R - 1)])
    assigned = torch.where(release, -1, g.assigned)
    return assigned, n_committed - n_release


def _assign(state, ctx, assigned, n_committed, params, n_users: int,
            R: int):
    """Fig 20 step 5: fill per-resource capacity slots with unassigned
    jobs in policy order under the budget constraint."""
    g = state.g
    dev = g.user.device
    u_idx = g.user.to(torch.int64)
    idx = torch.arange(g.n, device=dev)
    cost_per_mi = ctx["cost_per_mi"]
    registered = ctx["registered"]
    a_r = torch.clamp(assigned.to(torch.int64), 0, R - 1)

    exact_cost_now = g.length_mi * cost_per_mi[a_r]
    planned = (assigned >= 0) & _retryable(g, params, state.t)
    planned_cost = numerics.segment_sum(
        torch.where(planned, exact_cost_now, 0.0), u_idx, n_users,
        state.width)
    budget_left = torch.clamp_min(
        params.budget - state.spent - planned_cost, 0.0)

    r_f = torch.arange(R, dtype=torch.float32, device=dev)[None, :]
    keys = _policy_keys(params.opt, cost_per_mi[None, :], ctx["est_jobs"],
                        r_f, plan_ahead=state.host.plan)
    keys = torch.where(registered[None, :], keys, INF)
    order = torch.sort(keys, dim=-1, stable=True).indices        # [U,R]
    inv_order = torch.zeros_like(order).scatter(
        1, order, torch.arange(R, device=dev).expand(n_users, R))

    slots = torch.clamp_min(ctx["cap_jobs"] - n_committed, 0)    # [U,R]
    job_cost_est = ctx["avg_mi"][:, None] * cost_per_mi[None, :]  # [U,R]

    unassigned = _retryable(g, params, state.t) & (assigned < 0)
    n_unassigned = segment_count(unassigned, u_idx, n_users)
    active = ctx["active"]

    # The reference's fori_loop over the policy order, one column per
    # pass, every user at once.
    taken = torch.zeros(n_users, dtype=torch.int32, device=dev)
    budget_rem = budget_left
    take_at = []
    for j in range(R):
        r = order[:, j:j + 1]                                    # [U,1]
        s = slots.gather(1, r)[:, 0]
        c = job_cost_est.gather(1, r)[:, 0]
        by_budget = torch.floor(budget_rem / torch.clamp_min(c, 1e-30))
        by_budget = torch.clamp(by_budget, 0, 2 ** 30).to(torch.int32)
        n_fit = torch.minimum(torch.minimum(s, by_budget),
                              n_unassigned - taken)
        n_fit = torch.where(active & registered[r[:, 0]], n_fit, 0)
        take_at.append(n_fit)
        taken = taken + n_fit
        budget_rem = numerics.fma(-n_fit.to(torch.float32), c, budget_rem)
    cum_take = torch.cumsum(torch.stack(take_at, dim=-1), dim=-1)  # [U,R]

    k, _ = group_rank(u_idx, unassigned, idx, n_users)
    cum_for_g = cum_take[u_idx]                                  # [N,R]
    j_star = (cum_for_g <= k[:, None]).sum(dim=-1)
    gets = unassigned & (k < taken[u_idx]) & (j_star < R)
    new_assigned = torch.where(
        gets, order[u_idx, torch.clamp(j_star, 0, R - 1)].to(torch.int32),
        assigned)
    return new_assigned, inv_order


def _dispatch(state, fleet, ctx, params, new_assigned, inv_order,
              n_users: int, R: int):
    """Fig 20 step 6: stage up to MaxGridletPerPE * num_pe jobs per
    resource, committing exact processing cost against the budget."""
    g = state.g
    t = state.t
    dev = g.user.device
    u_idx = g.user.to(torch.int64)
    idx = torch.arange(g.n, device=dev)
    cost_per_mi = ctx["cost_per_mi"]
    na_r = torch.clamp(new_assigned.to(torch.int64), 0, R - 1)

    ur_key2 = u_idx * R + na_r
    cand = _retryable(g, params, t) & (new_assigned >= 0)
    n_inflight_ur = segment_count(ctx["inflight"], ctx["ur_res_key"],
                           n_users * R).reshape(n_users, R)
    limit = params.max_gridlet_per_pe * fleet.num_pe[None, :]
    disp_slots = torch.clamp_min(limit - n_inflight_ur, 0)       # [U,R]
    disp_rank, _ = group_rank(ur_key2, cand, idx, n_users * R)
    eligible = cand & (disp_rank < disp_slots.reshape(-1)[
        torch.clamp(ur_key2, 0, n_users * R - 1)])
    eligible = eligible & ctx["active"][u_idx] & ctx["registered"][na_r]

    exact_cost = g.length_mi * cost_per_mi[na_r]
    disp_order_key = (inv_order[u_idx, na_r].to(torch.float32) *
                      (g.n + 1.0) + idx.to(torch.float32))
    prefix = group_prefix_sum(u_idx, eligible, disp_order_key, exact_cost,
                              n_users)
    fits = numerics.fma(g.length_mi, cost_per_mi[na_r], prefix) <= \
        (params.budget - state.spent)[u_idx]
    dispatch = eligible & fits

    in_delay = network.transfer_delay(g.in_bytes, fleet.baud_rate[na_r])
    g2 = replace(
        g,
        assigned=new_assigned,
        status=torch.where(dispatch, IN_TRANSIT, g.status),
        resource=torch.where(dispatch, new_assigned, g.resource),
        t_event=torch.where(dispatch, t + in_delay, g.t_event),
        cost=torch.where(dispatch, exact_cost, g.cost),
        # A resubmitted FAILED gridlet restarts from scratch.
        remaining=torch.where(dispatch, g.length_mi, g.remaining),
    )
    spent = numerics.segment_sum(
        torch.where(dispatch, exact_cost, 0.0), u_idx, n_users, state.width,
        init=state.spent)
    fd = segment_min(torch.where(dispatch, t, INF),
                     torch.where(dispatch, ur_key2, n_users * R),
                     n_users * R + 1)[:n_users * R].reshape(n_users, R)
    first_dispatch = torch.minimum(state.first_dispatch, fd)
    n_resubmits = state.n_resubmits + (
        dispatch & (g.status == FAILED)).sum().to(torch.int32)
    return replace(state, g=g2, spent=spent,
                   first_dispatch=first_dispatch,
                   n_resubmits=n_resubmits)


def broker_event(state, fleet, params, n_users: int):
    """One full Fig 20 cycle for every broker, plus the next poll."""
    R = fleet.r
    ctx = _measure(state, fleet, params, n_users)
    assigned, n_committed = _release(state, ctx, params, n_users, R)
    new_assigned, inv_order = _assign(state, ctx, assigned, n_committed,
                                      params, n_users, R)
    state = _dispatch(state, fleet, ctx, params, new_assigned, inv_order,
                      n_users, R)

    # ---- next scheduling event (paper Fig 17 hold heuristic) ----------
    dl_left = torch.where(ctx["active"], params.deadline - state.t, 0.0)
    period = torch.maximum(params.sched_min_period,
                           params.sched_frac * dl_left.max())
    return replace(state, next_sched=state.t + period)
