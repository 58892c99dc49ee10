"""The vectorised discrete-event engine (paper sections 3.4-3.5; port of
``repro.core.engine``): a resource-major superstep loop over pluggable
event sources, with k-step speculative batching.

State layout follows the reference: gridlet state in the flat
``GridletBatch`` ([N]); every executing gridlet also holds one column of
the ``[R_pad, J]`` job-slot table (``SimState.slot`` / ``row_gridlet``).
Each superstep gathers ``remaining`` into the table and runs the Fig 8
share + forecast math in one ``kernels.ops.event_scan`` call; one
``kernels.ops.event_frontier`` pass over every source's candidate
instants picks the earliest instant t* (and, for the batched path, the
speculation horizon).  All jobs advance analytically to t*, then every
source due at t* applies, in the priority order of ``des.PRIORITY_ORDER``
except that BROKER applies before ARRIVAL.

Where the reference branches inside its compiled loop (``lax.cond``,
``lax.while_loop``, ``fori_loop``) the port branches on the host: state
stays on the device, and each predicate is read back once
(``HostCounts.read``, which also counts the reads).  Conditions whose
two branches give the same result (the reference's own select-free path
proves which) run unconditionally instead, with no read.

This slice runs the paper's experiment: COMPLETION, RETURN, ARRIVAL,
CALENDAR_STEP and BROKER.  FAILURE, RECOVERY, TRACE, RESERVATION,
MARKET, AUCTION and NETWORK are registered with +inf candidates and no
apply body, so trace codes and apply order match the reference;
``run``/``run_direct`` refuse every setting that would switch one on.
Resources therefore never go down here (``res_up`` stays all True), so
no arrival can fail and no superstep restructures the slab carry through
an interfering source.
"""
from __future__ import annotations

import dataclasses

import torch

from . import broker as broker_mod
from . import calendar, des, network, numerics
from . import economy as econ_mod
from ..kernels import event_scan as _event_kernels
from ..kernels import ops as kernel_ops
from ..kernels.event_scan import BIG as _BIG
from .segments import group_rank, segment_count
from .types import (DONE, IN_TRANSIT, INF, QUEUED, RETURNING, RUNNING, SJF,
                    SPACE_SHARED, TIME_SHARED, replace, resolve_device,
                    to_device)

TRACE_LEN = 64
BLOCK_R = 8          # resource axis padded to it (the reference's layout)
DEFAULT_BATCH = 8    # superstep batching factor k (see step_batched)


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Per-experiment knobs (the reference's field names; the knobs of
    sources this slice does not run must keep their off values)."""
    deadline: torch.Tensor        # f32[U]
    budget: torch.Tensor          # f32[U]
    opt: torch.Tensor             # i32[U] broker optimisation strategy
    max_gridlet_per_pe: torch.Tensor  # i32[] dispatch staging limit (2)
    sched_min_period: torch.Tensor    # f32[] broker poll floor (1.0)
    sched_frac: torch.Tensor          # f32[] fraction of deadline-left
    measure_alpha: torch.Tensor       # f32[] measurement smoothing
    registered: torch.Tensor      # bool[R] GIS availability mask
    mtbf: torch.Tensor            # f32[R] mean time between failures (0)
    mttr: torch.Tensor            # f32[R] mean time to recovery
    link_baud: torch.Tensor       # f32[R] link capacity (net mode only)
    bg_flows: torch.Tensor        # f32[R] background flows (net mode)
    pricing_model: torch.Tensor   # i32[] economy.PRICE_* (static only)
    plan_ahead: torch.Tensor      # bool[] plan-ahead DBC (off only)
    retry_limit: torch.Tensor     # i32[] resubmission budget
    backoff_base: torch.Tensor    # f32[] exponential backoff unit
    blacklist_cooldown: torch.Tensor  # f32[] broker cooldown


def default_params(deadline, budget, opt, n_users: int,
                   n_resources: int = 1, registered=None, mtbf=None,
                   mttr=None, reservations=None, link_baud=None,
                   bg_flows=None, pricing_model=econ_mod.PRICE_STATIC,
                   plan_ahead=False, trunk_of=None, fault_trace=None,
                   retry_limit=None, backoff_base=None,
                   blacklist_cooldown=None, device="cpu") -> SimParams:
    """``mtbf``/``mttr`` broadcast to [R]; the failure, reservation,
    dynamic-pricing, plan-ahead, trunk and fault-trace settings are not
    ported yet and raise ``NotImplementedError`` when switched on."""
    def t(x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=device)

    f = lambda x: t(x).broadcast_to((n_users,)).clone()
    r = lambda x: t(0.0 if x is None else x).broadcast_to(
        (n_resources,)).clone()
    if registered is None:
        registered = torch.ones((n_resources,), dtype=torch.bool,
                                device=device)
    if mtbf is not None and bool((r(mtbf) > 0).any()):
        raise NotImplementedError("failure streams (mtbf > 0) are not "
                                  "ported yet")
    if reservations is not None and len(list(reservations)) > 0:
        raise NotImplementedError("reservations are not ported yet")
    if econ_mod.as_pricing_model(pricing_model) != econ_mod.PRICE_STATIC:
        raise NotImplementedError("dynamic pricing is not ported yet")
    if plan_ahead:
        raise NotImplementedError("plan_ahead is not ported yet")
    if trunk_of is not None:
        raise NotImplementedError("shared trunks are not ported yet")
    if fault_trace is not None:
        raise NotImplementedError("fault traces are not ported yet")
    return SimParams(
        deadline=f(deadline), budget=f(budget),
        opt=t(opt, torch.int32).broadcast_to((n_users,)).clone(),
        max_gridlet_per_pe=t(2, torch.int32),
        sched_min_period=t(1.0),
        sched_frac=t(0.01),
        measure_alpha=t(0.5),
        registered=t(registered, torch.bool),
        mtbf=r(mtbf), mttr=r(mttr),
        link_baud=t(INF if link_baud is None else link_baud).broadcast_to(
            (n_resources,)).clone(),
        bg_flows=r(bg_flows),
        pricing_model=t(econ_mod.PRICE_STATIC, torch.int32),
        plan_ahead=t(False, torch.bool),
        retry_limit=t(2 ** 30 if retry_limit is None else retry_limit,
                      torch.int32),
        backoff_base=t(0.0 if backoff_base is None else backoff_base),
        blacklist_cooldown=t(0.0 if blacklist_cooldown is None
                             else blacklist_cooldown),
    )


@dataclasses.dataclass
class HostCounts:
    """Host-side loop counters: the supersteps the reference counts in
    its loop carry (committing ``n_steps``, speculative ``n_spec``, Fig 8
    scans ``n_scans`` and the ones that re-sorted, ``n_reseeds``), plus
    ``syncs``, the device-to-host reads the host loop made."""
    n_steps: int = 0
    n_spec: int = 0
    n_scans: int = 0
    n_reseeds: int = 0
    syncs: int = 0

    def read(self, pred) -> bool:
        """Read one device predicate back to the host."""
        self.syncs += 1
        return bool(pred)


@dataclasses.dataclass(frozen=True)
class SimState:
    t: torch.Tensor               # f32 current simulation time
    g: object                     # GridletBatch
    slot: torch.Tensor            # i32[N] job-slot column (-1 = none)
    row_gridlet: torch.Tensor     # i32[R_pad, J] slot -> gridlet (-1 = free)
    spent: torch.Tensor           # f32[U] committed budget
    done_on: torch.Tensor         # f32[U,R] jobs of u completed on r
    first_dispatch: torch.Tensor  # f32[U,R] first dispatch instant (inf)
    next_sched: torch.Tensor      # f32 next broker event
    term_time: torch.Tensor       # f32[U] broker termination instant
    res_up: torch.Tensor          # bool[R] resource currently up
    next_fail: torch.Tensor       # f32[R] scheduled failure (inf = none)
    next_recover: torch.Tensor    # f32[R] scheduled recovery
    fail_since: torch.Tensor      # f32[R] instant the resource went down
    downtime: torch.Tensor        # f32[R] accumulated down intervals
    recovered_at: torch.Tensor    # f32[R] instant of the last recovery
    price: torch.Tensor           # f32[R] posted G$/MI trading metric
    next_market: torch.Tensor     # f32 next repricing instant (inf)
    next_auction: torch.Tensor    # f32 next auction round (inf)
    n_events: torch.Tensor        # i32 applied events
    n_trace: torch.Tensor         # i32 trace entries written
    n_failed: torch.Tensor        # i32 gridlets hit by a failure
    n_resubmits: torch.Tensor     # i32 FAILED gridlets re-dispatched
    overflow: torch.Tensor        # i32 job-slot allocation failures (== 0)
    trace_t: torch.Tensor         # f32[TRACE_LEN]
    trace_kind: torch.Tensor      # i32[TRACE_LEN] des.K_* codes
    trace_who: torch.Tensor       # i32[TRACE_LEN]
    host: HostCounts              # host-side counters (shared, mutable)
    width: int                    # most gridlets any one user owns


@dataclasses.dataclass(frozen=True)
class SimResult:
    gridlets: object
    spent: torch.Tensor
    term_time: torch.Tensor
    n_events: torch.Tensor
    trace: tuple
    n_steps: torch.Tensor
    overflow: torch.Tensor
    n_failed: torch.Tensor
    n_resubmits: torch.Tensor
    downtime: torch.Tensor
    n_spec: torch.Tensor
    n_reseeds: torch.Tensor
    n_scans: torch.Tensor
    host_syncs: int = 0           # device-to-host reads of the run


# ----------------------------------------------------------------------
# Small tensor helpers
# ----------------------------------------------------------------------

def _pad(x, n: int, value):
    """Append ``n`` copies of ``value`` to a 1-D tensor."""
    return torch.cat([x, torch.full((n,), value, dtype=x.dtype,
                                    device=x.device)])


def _set_drop(table, rows, cols, values):
    """``table.at[rows, cols].set(values, mode="drop")``: writes whose
    row or column is out of range go to a scratch cell and vanish."""
    r, j = table.shape
    flat = torch.cat([table.reshape(-1), table.new_zeros(1)])
    rows = rows.to(torch.int64)
    cols = cols.to(torch.int64)
    ok = (rows >= 0) & (rows < r) & (cols >= 0) & (cols < j)
    flat[torch.where(ok, rows * j + cols, r * j)] = values
    return flat[:r * j].reshape(r, j)


def _set_drop_1d(arr, pos, values):
    """``arr.at[pos].set(values, mode="drop")`` for a 1-D ``arr``."""
    return _set_drop(arr.reshape(1, -1), torch.zeros_like(pos),
                     pos, values).reshape(-1)


# ----------------------------------------------------------------------
# Resource dynamics
# ----------------------------------------------------------------------

def _rates(state, fleet, n_resources):
    """Per-gridlet execution rate under Fig 8 shares, in the flat layout
    (the reference's oracle for the kernel path)."""
    g = state.g
    running = g.status == RUNNING
    res = torch.clamp(g.resource.to(torch.int64), 0, n_resources - 1)
    eff = calendar.effective_mips(fleet, state.t)
    policy = fleet.policy[res]
    ts_member = running & (policy == TIME_SHARED)
    rank, counts = group_rank(res, ts_member, g.remaining, n_resources)
    g_on_r = counts[res]
    p_r = fleet.num_pe[res]
    min_jobs = torch.div(g_on_r, torch.clamp_min(p_r, 1),
                         rounding_mode="floor")
    extra = torch.remainder(g_on_r, torch.clamp_min(p_r, 1))
    max_share_count = (p_r - extra) * min_jobs
    divisor = min_jobs + (rank >= max_share_count).to(torch.int32)
    ts_rate = eff[res] / torch.clamp_min(divisor, 1).to(torch.float32)
    rate = torch.where(policy == TIME_SHARED, ts_rate, eff[res])
    return torch.where(running, rate, 0.0)


def _reserved_pes(params, t, n_resources):
    """PEs blocked by reservation windows at ``t``: none on this slice
    (the reservation source is not ported yet)."""
    return torch.zeros((n_resources,), dtype=torch.int32,
                       device=params.deadline.device)


def _table_inputs(state, fleet, params, n_resources, r_pad):
    """Gather the [R_pad, J] job-slot table and the per-row kernel
    inputs.  An occupied slot whose remaining underflowed to exactly 0
    is clamped to 1e-30 (0 is the empty-slot sentinel)."""
    g = state.g
    rg = state.row_gridlet
    occupied = rg >= 0
    gid = torch.clamp(rg.to(torch.int64), 0, g.n - 1)
    rem_rj = torch.where(occupied,
                         torch.clamp_min(g.remaining[gid], 1e-30), 0.0)
    tie_rj = torch.where(occupied, rg, 2 ** 30).to(torch.float32)
    pad = r_pad - n_resources
    eff = _pad(calendar.effective_mips(fleet, state.t), pad, 1.0)
    npe = _pad(fleet.num_pe, pad, 1)
    pol = _pad(fleet.policy, pad, 0)
    blocked = _pad(_reserved_pes(params, state.t, n_resources).to(
        torch.float32), pad, 0.0)
    row_ok = _pad(state.res_up, pad, True).to(torch.float32)
    return rem_rj, tie_rj, eff, npe, pol, blocked, row_ok


def _scan_events(table, rank=None):
    """Resource-major Fig 8 scan of ``_table_inputs``' tuple through
    kernels.ops.event_scan: (rate [R_pad, J], t_min [R_pad], argmin col
    [R_pad], occupancy [R_pad], rank [R_pad, J])."""
    rem_rj, tie_rj, eff, npe, pol, blocked, row_ok = table
    return kernel_ops.event_scan(rem_rj, eff, npe, tie=tie_rj, policy=pol,
                                 pe_blocked=blocked, row_ok=row_ok,
                                 rank=rank, with_rank=True)


# ----------------------------------------------------------------------
# Batched event application
# ----------------------------------------------------------------------

def _free_slots(state, mask, res, r_pad):
    """Release the job slots of every gridlet in ``mask``."""
    j_cap = state.row_gridlet.shape[1]
    rows = torch.where(mask, res, r_pad)
    cols = torch.where(mask, torch.clamp(state.slot, 0, j_cap - 1), 0)
    rg = _set_drop(state.row_gridlet, rows, cols, -1)
    return replace(state, row_gridlet=rg,
                   slot=torch.where(mask, -1, state.slot))


def _count_rank(res, mask, n_resources):
    """Rank of each masked element among its resource's masked set, in
    flat-index order (a running segmented count).  Non-members get
    garbage (callers mask)."""
    res = res.to(torch.int64)
    onehot = ((res[:, None] == torch.arange(n_resources,
                                            device=res.device)[None, :])
              & mask[:, None]).to(torch.int64)
    excl = torch.cumsum(onehot, dim=0) - onehot
    return torch.gather(excl, 1, res[:, None])[:, 0]


def _alloc_slots(state, mask, res, n_resources, r_pad):
    """Allocate a free job-slot column to every gridlet in ``mask``, in
    flat-index order within a resource; gridlets that find no free
    column are counted in ``overflow``.  The rank-th free column comes
    from a binary search over the row's running free count."""
    g = state.g
    n = g.n
    dev = res.device
    j_cap = state.row_gridlet.shape[1]
    res = res.to(torch.int64)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    free = state.row_gridlet < 0
    n_free = free.sum(dim=1)                              # [R_pad]
    rank = _count_rank(res, mask, n_resources)
    ok = mask & (rank < n_free[res])
    cumfree = torch.cumsum(free.to(torch.int64), dim=1)   # [R_pad, J]
    want = rank + 1
    lo = torch.zeros((n,), dtype=torch.int64, device=dev)
    hi = torch.full((n,), j_cap - 1, dtype=torch.int64, device=dev)
    for _ in range(max(1, (j_cap - 1).bit_length())):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        ge = cumfree[res, mid] >= want
        lo = torch.where(ge, lo, mid + 1)
        hi = torch.where(ge, mid, hi)
    col = hi
    rows = torch.where(ok, res, r_pad)
    cols = torch.where(ok, col, 0)
    rg = _set_drop(state.row_gridlet, rows, cols, idx)
    return replace(
        state, row_gridlet=rg,
        slot=torch.where(ok, col.to(torch.int32), state.slot),
        overflow=state.overflow + (mask & ~ok).sum().to(torch.int32))


def _apply_completions(state, fleet, params, completes, t_next,
                       n_resources, r_pad):
    """RUNNING -> RETURNING for the whole batch; job slots freed.  The
    result-return instant is analytic: ``t_next + out_delay``."""
    g = state.g
    res = torch.clamp(g.resource.to(torch.int64), 0, n_resources - 1)
    t_ev = t_next + network.transfer_delay(g.out_bytes,
                                           fleet.baud_rate[res])
    g = replace(
        g,
        status=torch.where(completes, RETURNING, g.status),
        finish=torch.where(completes, t_next, g.finish),
        t_event=torch.where(completes, t_ev, g.t_event),
    )
    return _free_slots(replace(state, g=g), completes, res, r_pad)


def _queue_rank(state, fleet, n_resources):
    """Fresh FCFS/SJF within-resource rank of every QUEUED gridlet."""
    g = state.g
    res = torch.clamp(g.resource.to(torch.int64), 0, n_resources - 1)
    queued = g.status == QUEUED
    qkey = torch.where(fleet.queue_policy[res] == SJF, g.length_mi,
                       g.t_event)
    return group_rank(res, queued, qkey, n_resources)[0]


def _admit_queued(state, fleet, free_pe, t_next, n_resources, qrank):
    """Freed space-shared PEs admit the next queued Gridlets in FCFS/SJF
    order (Fig 10 step 3).  Returns (state, admitted mask)."""
    g = state.g
    res = torch.clamp(g.resource.to(torch.int64), 0, n_resources - 1)
    queued = g.status == QUEUED
    admitq = queued & (qrank < free_pe[res])
    g = replace(
        g,
        status=torch.where(admitq, RUNNING, g.status),
        start=torch.where(admitq, torch.minimum(g.start, t_next), g.start),
        t_event=torch.where(admitq, INF, g.t_event),
    )
    return replace(state, g=g), admitq


def _apply_returns(state, fleet, t_next, n_users, n_resources):
    """RETURNING & due -> DONE for the whole batch; the broker's
    per-resource completion counts (paper 4.2.1 step 6)."""
    g = state.g
    ret_due = (g.status == RETURNING) & (g.t_event <= t_next)
    g = replace(g,
                status=torch.where(ret_due, DONE, g.status),
                returned=torch.where(ret_due, t_next, g.returned))
    ur = g.user.to(torch.int64) * n_resources + torch.clamp(
        g.resource.to(torch.int64), 0, n_resources - 1)
    # Integer-valued f32 counts: exact in any summation order.
    done_on = state.done_on + segment_count(
        ret_due, ur, n_users * n_resources).to(torch.float32).reshape(
        n_users, n_resources)
    return replace(state, g=g, done_on=done_on), ret_due


def _apply_arrivals(state, fleet, params, free_pe, arr_pre, t_next,
                    n_users, n_resources):
    """IN_TRANSIT & due -> RUNNING (time-shared / free PE) or QUEUED.
    Space-shared arrivals fill the ``free_pe`` PEs left after this
    superstep's admissions, pre-broker arrivals (``arr_pre``) first,
    flat-index order within each class; the rest queue, stamped with
    their arrival instant.  (No resource is ever down on this slice, so
    no arrival fails.)  Returns (state, arrivals, newly running, newly
    queued)."""
    g = state.g
    n = g.n
    res = torch.clamp(g.resource.to(torch.int64), 0, n_resources - 1)
    idx = torch.arange(n, device=res.device)
    arr_due = (g.status == IN_TRANSIT) & (g.t_event <= t_next)
    is_ss = fleet.policy[res] == SPACE_SHARED
    arr_ss = arr_due & is_ss
    order = torch.where(arr_pre, idx, idx + n)
    # Only arr_ss members consult the rank, so computing it without the
    # reference's arr_ss.any() cond gives the same result.
    rank = group_rank(res, arr_ss, order, n_resources)[0]
    arr_run = arr_due & (~is_ss | (rank < free_pe[res]))
    arr_queue = arr_ss & ~arr_run
    g = replace(
        g,
        status=torch.where(arr_run, RUNNING,
                           torch.where(arr_queue, QUEUED, g.status)),
        start=torch.where(arr_run, torch.minimum(g.start, t_next), g.start),
        t_event=torch.where(arr_run, INF,
                            torch.where(arr_queue, t_next, g.t_event)),
    )
    return replace(state, g=g), arr_due, arr_run, arr_queue


# ----------------------------------------------------------------------
# Event sources (des.FnSource protocol)
# ----------------------------------------------------------------------

def _identity(state, now):
    return state


def _make_sources(fleet, params, n_users, ctx):
    """The engine's event sources, ordered by des.PRIORITY_ORDER.
    ``ctx`` is the per-superstep scratch dict the sources share (scan
    outputs, event masks, the remaining free-PE budget).  Sources not on
    this slice expose +inf candidates of the reference's sizes and apply
    as the identity."""
    n_resources = fleet.r

    # -- COMPLETION: the kernel scan IS the candidate computation -------
    def completion_candidates(state):
        # _step_commit stores this superstep's scan before it asks.
        tmin = ctx["scan"][1]
        return torch.where(tmin < _BIG, state.t + tmin, INF)

    def completion_apply(state, now):
        host = state.host
        r_pad = state.row_gridlet.shape[0]
        completes, res = ctx["completes"], ctx["res"]
        occ_rows = ctx["scan"][3]
        state = _apply_completions(state, fleet, params, completes, now,
                                   n_resources, r_pad)
        # Freed PEs admit queued Gridlets (kernel occupancy minus this
        # batch's completions is the exact busy count).
        n_comp_r = segment_count(completes, res, n_resources)
        ctx["n_comp_r"] = n_comp_r
        avail = fleet.num_pe - _reserved_pes(params, now, n_resources)
        free_pe = torch.clamp_min(avail - (occ_rows[:n_resources] -
                                           n_comp_r), 0)
        free_pe = torch.where((fleet.policy == SPACE_SHARED) &
                              state.res_up, free_pe, 0)
        ss_freed = completes & (fleet.policy[res] == SPACE_SHARED)
        pred = ss_freed.any() & (state.g.status == QUEUED).any()
        qr0, qok = ctx["qcarry"]
        if host.read(pred):
            qr = qr0 if host.read(qok) else _queue_rank(state, fleet,
                                                        n_resources)
            state, admitq = _admit_queued(state, fleet, free_pe, now,
                                          n_resources, qr)
        else:
            qr, admitq = qr0, torch.zeros_like(completes)
        n_admit_r = segment_count(admitq, res, n_resources)
        ctx["qcarry"] = (qr - n_admit_r[res], qok | pred)
        ctx["free_pe"] = free_pe - n_admit_r
        ctx["newly"] = admitq
        ctx[("count", des.K_COMPLETION)] = completes.sum().to(torch.int32)
        return state

    # -- RETURN / ARRIVAL / CALENDAR / BROKER ---------------------------
    def return_candidates(state):
        g = state.g
        return torch.where(g.status == RETURNING, g.t_event, INF)

    def return_apply(state, now):
        state, ret_due = _apply_returns(state, fleet, now, n_users,
                                        n_resources)
        ctx[("count", des.K_RETURN)] = ret_due.sum().to(torch.int32)
        ctx[("who", des.K_RETURN)] = torch.argmax(
            ret_due.to(torch.int32)).to(torch.int32)
        return state

    def arrival_candidates(state):
        g = state.g
        return torch.where(g.status == IN_TRANSIT, g.t_event, INF)

    def arrival_apply(state, now):
        state, arr_due, arr_run, arr_queue = _apply_arrivals(
            state, fleet, params, ctx["free_pe"], ctx["arr_pre"], now,
            n_users, n_resources)
        ctx[("count", des.K_ARRIVAL)] = arr_due.sum().to(torch.int32)
        ctx[("who", des.K_ARRIVAL)] = torch.argmax(
            arr_due.to(torch.int32)).to(torch.int32)
        ctx["newly"] = ctx["newly"] | arr_run
        qr, qok = ctx["qcarry"]
        ctx["qcarry"] = (qr, qok & ~arr_queue.any())
        return state

    def calendar_candidates(state):
        return calendar.next_boundary(fleet, state.t)   # per resource

    def broker_candidates(state):
        active, _ = _user_flags(state, params, fleet, n_users)
        return torch.where(active.any(),
                           torch.maximum(state.next_sched, state.t),
                           INF).reshape(1)

    def broker_apply(state, now):
        g = state.g
        ctx["arr_pre"] = (g.status == IN_TRANSIT) & (g.t_event <= now)
        if state.host.read(ctx["fired_b"]):
            state = broker_mod.broker_event(state, fleet, params, n_users)
        return state

    sources = (
        des.FnSource(des.K_COMPLETION, "completion",
                     completion_candidates, completion_apply,
                     horizon_fn=des.no_interference),
        des.FnSource(des.K_FAILURE, "failure",
                     lambda s: s.next_fail, _identity),
        des.FnSource(des.K_RECOVERY, "recovery",
                     lambda s: s.next_recover, _identity),
        des.FnSource(des.K_TRACE, "trace",
                     lambda s: torch.full_like(s.t, INF).reshape(1),
                     _identity),
        des.FnSource(des.K_RESERVATION, "reservation",
                     lambda s: s.t.new_zeros((0,)), _identity),
        des.FnSource(des.K_MARKET, "market",
                     lambda s: s.next_market.reshape(1), _identity),
        des.FnSource(des.K_AUCTION, "auction",
                     lambda s: s.next_auction.reshape(1), _identity),
        des.FnSource(des.K_NETWORK, "network",
                     lambda s: s.t.new_zeros((0,)), _identity),
        des.FnSource(des.K_RETURN, "return", return_candidates,
                     return_apply, horizon_fn=des.no_interference),
        des.FnSource(des.K_ARRIVAL, "arrival", arrival_candidates,
                     arrival_apply),
        des.FnSource(des.K_CALENDAR, "calendar_step",
                     calendar_candidates, _identity),
        des.FnSource(des.K_BROKER, "broker", broker_candidates,
                     broker_apply),
    )
    if tuple(s.kind for s in sources) != des.PRIORITY_ORDER:
        raise AssertionError("engine sources out of sync with "
                             "des.PRIORITY_ORDER")
    return sources


# ----------------------------------------------------------------------
# Main loop
# ----------------------------------------------------------------------

def _user_flags(state, params, fleet, n_users):
    """(active, finished) per user -- paper 4.2.1 step 7 semantics."""
    g = state.g
    u = g.user.to(torch.int64)
    n_not_done = segment_count(g.status != DONE, u, n_users)
    inflight = ((g.status == IN_TRANSIT) | (g.status == QUEUED) |
                (g.status == RUNNING) | (g.status == RETURNING))
    n_inflight = segment_count(inflight, u, n_users)
    all_done = n_not_done == 0
    active = ((state.t < params.deadline) &
              broker_mod.affordable(state, params, n_users) & ~all_done)
    finished = (all_done | ~active) & (n_inflight == 0)
    return active, finished


def _advance_jobs(state, ctx, t_next, any_event, n_resources):
    """Advance every running job over [t, t_next) by the kernel rates
    in ``ctx["scan"]``; records the completion batch and its trace
    representative in ``ctx`` and moves the clock to ``t_next``."""
    g = state.g
    j_cap = state.row_gridlet.shape[1]
    rate_rj, tmin_rows, amin_rows = ctx["scan"][:3]
    res = torch.clamp(g.resource.to(torch.int64), 0, n_resources - 1)
    has_slot = (g.status == RUNNING) & (state.slot >= 0)
    col = torch.clamp(state.slot.to(torch.int64), 0, j_cap - 1)
    rate = torch.where(has_slot, rate_rj[res, col], 0.0)
    rel = torch.where(has_slot,
                      g.remaining / torch.clamp_min(rate, 1e-30), INF)
    dt = torch.clamp_min(t_next - state.t, 0.0)
    completes = has_slot & any_event & (state.t + rel <= t_next)
    new_remaining = torch.where(
        completes, 0.0,
        torch.clamp_min(numerics.fma(-rate, dt, g.remaining), 0.0))
    # Trace representative: the kernel's argmin of the earliest row.
    r_star = torch.argmin(tmin_rows)
    who_c = state.row_gridlet[
        r_star, torch.clamp(amin_rows[r_star].to(torch.int64), 0,
                            j_cap - 1)]
    ctx["completes"], ctx["res"] = completes, res
    ctx[("who", des.K_COMPLETION)] = who_c
    return replace(state, g=replace(g, remaining=new_remaining), t=t_next)


def _alloc_newly(state, ctx, n_resources, r_pad):
    """Allocate job slots for everything newly RUNNING this superstep
    (a no-op on an empty mask, so it runs without the reference's
    ``newly.any()`` cond)."""
    newly = ctx["newly"] & (state.g.status == RUNNING)
    res_now = torch.clamp(state.g.resource.to(torch.int64), 0,
                          n_resources - 1)
    return _alloc_slots(state, newly, res_now, n_resources, r_pad)


def _bookkeep(state, fleet, params, n_users, kinds, counts, whos, t_next):
    """Termination instants, trace rows and the event counter for one
    superstep; ``kinds``/``counts``/``whos`` are aligned [S] vectors in
    priority order (a kind with count 0 writes no row).  Returns
    ``(state, finished)``."""
    _, finished = _user_flags(state, params, fleet, n_users)
    term = torch.where(finished & ~torch.isfinite(state.term_time),
                       t_next, state.term_time)
    fired = counts > 0
    fired_i = fired.to(torch.int32)
    off = torch.cumsum(fired_i, dim=0) - fired_i
    pos = torch.where(fired, state.n_trace + off, TRACE_LEN)
    return replace(
        state,
        term_time=term,
        n_events=state.n_events + counts.sum().to(torch.int32),
        n_trace=state.n_trace + fired_i.sum().to(torch.int32),
        trace_t=_set_drop_1d(state.trace_t, pos, t_next),
        trace_kind=_set_drop_1d(state.trace_kind, pos, kinds),
        trace_who=_set_drop_1d(state.trace_who, pos, whos),
    ), finished


def _empty_slab(state):
    """The no-carry slab: ``(rank f32[R_pad, J], ok, qrank i32[N],
    qok)``; forces the next scan and queue admission to reseed."""
    dev = state.t.device
    false = torch.tensor(False, device=dev)
    return (torch.zeros(state.row_gridlet.shape, dtype=torch.float32,
                        device=dev), false,
            torch.zeros((state.g.n,), dtype=torch.int32, device=dev), false)


def _partition_ok(rem, tie, valid, rank, npe_e, g, pol):
    """True iff the carried rank still yields the exact Fig 8 rate
    assignment the fresh lexsort rank would: the carried MaxShare side's
    lexicographic max lies strictly below the MinShare side's min."""
    m = torch.clamp_min(npe_e, 1.0)
    k = torch.floor(g / m)
    extra = g - k * m
    msc = (npe_e - extra) * k
    left = valid & (rank < msc)
    right = valid & (rank >= msc)
    rem_lo = torch.where(left, rem, -_BIG).max(dim=1, keepdim=True).values
    rem_hi = torch.where(right, rem, _BIG).min(dim=1, keepdim=True).values
    tie_lo = torch.where(left & (rem == rem_lo), tie, -_BIG).max(
        dim=1, keepdim=True).values
    tie_hi = torch.where(right & (rem == rem_hi), tie, _BIG).min(
        dim=1, keepdim=True).values
    row_ok = (rem_lo < rem_hi) | ((rem_lo == rem_hi) & (tie_lo < tie_hi))
    rank_free = (pol > 0.5) | (g <= npe_e)
    return (rank_free | row_ok).all()


def _checked_scan(state, fleet, params, n_resources, r_pad, slab):
    """The Fig 8 scan, fed the carried rank when it still describes the
    table (the kernel's injected-rank form, no sort), else one fresh
    rank.  Returns (scan outputs, reseeded)."""
    rank_carry, slab_ok = slab[0], slab[1]
    table = _table_inputs(state, fleet, params, n_resources, r_pad)
    rem, tie, _, npe, pol, blk, row_ok = table
    pol_f = pol.to(torch.float32)[:, None]
    npe_e, valid, g = _event_kernels._row_masks(
        rem, npe.to(torch.float32)[:, None], pol_f, blk[:, None],
        row_ok[:, None])
    use = state.host.read(slab_ok & _partition_ok(rem, tie, valid,
                                                  rank_carry, npe_e, g,
                                                  pol_f))
    return _scan_events(table, rank_carry if use else None), not use


def _slab_after(state, ctx, scan, fleet, n_resources, r_pad):
    """The slab carry after a superstep: survivors' ranks shift down by
    the per-row completed count; the carry stays valid unless a
    newly-RUNNING job landed on a time-shared row (no interfering
    source runs on this slice)."""
    n_comp_r = _pad(ctx["n_comp_r"], r_pad - n_resources, 0)
    rank = scan[4] - n_comp_r[:, None].to(torch.float32)
    res = torch.clamp(state.g.resource.to(torch.int64), 0, n_resources - 1)
    ts_newly = ctx["newly"] & (fleet.policy[res] == TIME_SHARED)
    qrank, qok = ctx["qcarry"]
    return (rank, ~ts_newly.any(), qrank, qok)


def _step_commit(state, fleet, params, n_users, slab):
    """The committing superstep: frontier over every source's
    candidates, advance over [t, t*), apply every source due at t*.
    Returns ``(state, slab, finished)``."""
    n_resources = fleet.r
    r_pad = state.row_gridlet.shape[0]
    host = state.host

    ctx = {}
    ctx["scan"], reseeded = _checked_scan(state, fleet, params,
                                          n_resources, r_pad, slab)
    ctx["qcarry"] = (slab[2], slab[3])
    host.n_scans += 1
    host.n_reseeds += int(reseeded)
    sources = _make_sources(fleet, params, n_users, ctx)
    cands = [s.candidates(state) for s in sources]
    sizes = tuple(c.shape[0] for c in cands)
    t_star, fired, _, _, _ = kernel_ops.event_frontier(torch.cat(cands),
                                                       sizes)
    any_event = torch.isfinite(t_star)
    t_next = torch.where(any_event, t_star, state.t)

    state = _advance_jobs(state, ctx, t_next, any_event, n_resources)
    pos_of = {s.kind: i for i, s in enumerate(sources)}
    ctx["fired_b"] = fired[pos_of[des.K_BROKER]]

    # priority order, except BROKER before ARRIVAL
    order = list(range(len(sources)))
    order.remove(pos_of[des.K_BROKER])
    order.insert(order.index(pos_of[des.K_ARRIVAL]), pos_of[des.K_BROKER])
    for i in order:
        state = sources[i].apply(state, t_next)

    state = _alloc_newly(state, ctx, n_resources, r_pad)

    no_who = torch.tensor(-1, dtype=torch.int32, device=t_next.device)
    fired_i = fired.to(torch.int32)
    counts = torch.stack([ctx.get(("count", s.kind), fired_i[i])
                          for i, s in enumerate(sources)])
    whos = torch.stack([ctx.get(("who", s.kind), no_who).to(torch.int32)
                        for s in sources])
    kinds = torch.tensor([s.kind for s in sources], dtype=torch.int32,
                         device=t_next.device)
    state, finished = _bookkeep(state, fleet, params, n_users, kinds,
                                counts, whos, t_next)
    host.n_steps += 1
    return state, _slab_after(state, ctx, ctx["scan"], fleet, n_resources,
                              r_pad), finished


_SPEC_KINDS = (des.K_COMPLETION, des.K_RETURN)


def _speculative_step(state, fleet, params, n_users, t_safe, slab,
                      finished):
    """One speculative micro-superstep: applies the earliest pending
    COMPLETION/RETURN batch if, and only if, it lies strictly inside
    the speculation horizon ``t_safe``.  (The reference's micro-steps
    also fire FAILURE/RECOVERY strikes; on this slice those streams are
    +inf.)  Returns ``(state, fired, slab', finished')``; when nothing
    fires the state is untouched and the scan just made seeds the
    carry."""
    n_resources = fleet.r
    r_pad = state.row_gridlet.shape[0]
    host = state.host
    ctx = {}
    sources = _make_sources(fleet, params, n_users, ctx)
    by_kind = {s.kind: s for s in sources}
    comp, ret = by_kind[des.K_COMPLETION], by_kind[des.K_RETURN]

    ctx["scan"], reseeded = _checked_scan(state, fleet, params,
                                          n_resources, r_pad, slab)
    ctx["qcarry"] = (slab[2], slab[3])
    host.n_scans += 1
    host.n_reseeds += int(reseeded)

    tmin = ctx["scan"][1].min()
    t_comp = torch.where(tmin < _BIG, state.t + tmin, INF)
    t_next = torch.minimum(t_comp, ret.next_time(state))
    fire = (torch.isfinite(t_next) & (t_next < t_safe) &
            ~finished.all())
    if not host.read(fire):
        return state, False, (ctx["scan"][4],
                              torch.tensor(True, device=t_next.device),
                              slab[2], slab[3]), finished

    state = _advance_jobs(state, ctx, t_next, fire, n_resources)
    state = comp.apply(state, t_next)     # completions + queue admissions
    state = ret.apply(state, t_next)      # incl. zero-delay returns
    state = _alloc_newly(state, ctx, n_resources, r_pad)
    kinds = torch.tensor(_SPEC_KINDS, dtype=torch.int32,
                         device=t_next.device)
    counts = torch.stack([ctx[("count", k)] for k in _SPEC_KINDS])
    whos = torch.stack([ctx[("who", k)].to(torch.int32)
                        for k in _SPEC_KINDS])
    state, finished = _bookkeep(state, fleet, params, n_users, kinds,
                                counts, whos, t_next)
    host.n_spec += 1
    return state, True, _slab_after(state, ctx, ctx["scan"], fleet,
                                    n_resources, r_pad), finished


def _speculation_horizon(state, fleet, params, n_users):
    """Earliest instant at which any source could interfere with the
    speculative COMPLETION/RETURN batching, from every source's
    ``horizon_candidates`` through the frontier kernel."""
    sources = _make_sources(fleet, params, n_users, {})
    cands = [s.horizon_candidates(state) for s in sources]
    sizes = tuple(c.shape[0] for c in cands)
    return kernel_ops.event_frontier(torch.cat(cands), sizes)[3]


def step_batched(state, fleet, params, n_users: int, batch: int,
                 slab=None):
    """One batched loop iteration: a committing superstep, then up to
    ``batch - 1`` speculative COMPLETION/RETURN supersteps strictly
    inside the safety horizon, fed by the carried rank.  Returns
    ``(state, slab, finished)``; results are bit for bit the same for
    every ``batch``."""
    if slab is None:
        slab = _empty_slab(state)
    state, slab, finished = _step_commit(state, fleet, params, n_users,
                                         slab)
    if batch <= 1:
        return state, slab, finished
    t_safe = _speculation_horizon(state, fleet, params, n_users)
    for _ in range(batch - 1):
        state, alive, slab, finished = _speculative_step(
            state, fleet, params, n_users, t_safe, slab, finished)
        if not alive:   # state unchanged: every later micro-step declines
            break
    return state, slab, finished


def _continue(state, finished, max_events):
    """Loop condition: some user unfinished and the total superstep
    budget (committing + speculative) not spent."""
    host = state.host
    return (host.n_steps + host.n_spec < max_events and
            host.read(~finished.all()))


def init_state(gridlets, fleet, n_users: int, first_sched: float = 0.0,
               max_jobs: int | None = None, params=None) -> SimState:
    """``max_jobs`` bounds concurrently RUNNING gridlets per resource
    (the J axis of the job-slot table; default N).  With no failure
    stream on this slice, ``next_fail`` is +inf (the reference's
    exponential draw of a zero MTBF) and no random key is kept."""
    n = gridlets.n
    dev = gridlets.length_mi.device
    j_cap = n if max_jobs is None else min(max_jobs, n)
    r = fleet.r
    r_pad = -(-r // BLOCK_R) * BLOCK_R

    def full(shape, v, dtype=torch.float32):
        return torch.full(shape, v, dtype=dtype, device=dev)

    zero_i = full((), 0, torch.int32)
    width = int(torch.bincount(gridlets.user.to(torch.int64)).max()) \
        if n else 0
    return SimState(
        t=full((), 0.0),
        g=gridlets,
        slot=full((n,), -1, torch.int32),
        row_gridlet=full((r_pad, j_cap), -1, torch.int32),
        spent=full((n_users,), 0.0),
        done_on=full((n_users, r), 0.0),
        first_dispatch=full((n_users, r), INF),
        next_sched=full((), first_sched),
        term_time=full((n_users,), INF),
        res_up=full((r,), True, torch.bool),
        next_fail=full((r,), INF),
        next_recover=full((r,), INF),
        fail_since=full((r,), INF),
        downtime=full((r,), 0.0),
        recovered_at=full((r,), -INF),
        price=fleet.cost_per_mi().to(torch.float32).broadcast_to(
            (r,)).clone(),
        next_market=full((), INF),
        next_auction=full((), INF),
        n_events=zero_i, n_trace=zero_i, n_failed=zero_i,
        n_resubmits=zero_i, overflow=zero_i,
        trace_t=full((TRACE_LEN,), INF),
        trace_kind=full((TRACE_LEN,), -1, torch.int32),
        trace_who=full((TRACE_LEN,), -1, torch.int32),
        host=HostCounts(),
        width=width,
    )


def _finalize(state) -> SimResult:
    # Users that never started (e.g. zero budget) terminate at final t.
    term = torch.where(torch.isfinite(state.term_time), state.term_time,
                       state.t)
    downtime = state.downtime + torch.where(
        state.res_up, 0.0, state.t - state.fail_since)
    host = state.host

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=state.t.device)

    return SimResult(gridlets=state.g, spent=state.spent, term_time=term,
                     n_events=state.n_events,
                     trace=(state.trace_t, state.trace_kind,
                            state.trace_who),
                     n_steps=i32(host.n_steps), overflow=state.overflow,
                     n_failed=state.n_failed,
                     n_resubmits=state.n_resubmits, downtime=downtime,
                     n_spec=i32(host.n_spec), n_reseeds=i32(host.n_reseeds),
                     n_scans=i32(host.n_scans), host_syncs=host.syncs)


def _check_params(params: SimParams):
    if bool((params.mtbf > 0).any()):
        raise NotImplementedError("failure streams are not ported yet")
    if int(params.pricing_model) != econ_mod.PRICE_STATIC:
        raise NotImplementedError("dynamic pricing is not ported yet")
    if bool(params.plan_ahead):
        raise NotImplementedError("plan_ahead is not ported yet")


def _run(gridlets, fleet, params, n_users, max_events, max_jobs, batch):
    _check_params(params)
    state = init_state(gridlets, fleet, n_users, max_jobs=max_jobs,
                       params=params)
    _, finished = _user_flags(state, params, fleet, n_users)
    slab = _empty_slab(state)
    while _continue(state, finished, max_events):
        state, slab, finished = step_batched(state, fleet, params, n_users,
                                             batch, slab)
    return _finalize(state)


def run(gridlets, fleet, params: SimParams, n_users: int,
        max_events: int, max_jobs: int | None = None,
        batch: int = DEFAULT_BATCH, net_cap: int = 0,
        telemetry: int | None = None, device="cuda") -> SimResult:
    """Run a full experiment: broker-driven scheduling + execution, on
    ``device``.  ``batch`` is the superstep batching factor k (results
    are bit-for-bit identical for every k).  ``net_cap`` (the fair-share
    network) and ``telemetry`` are not ported yet."""
    if net_cap:
        raise NotImplementedError("the fair-share network (net_cap) is "
                                  "not ported yet")
    if telemetry:
        raise NotImplementedError("telemetry is not ported yet")
    dev = resolve_device(device)
    return _run(to_device(gridlets, dev), to_device(fleet, dev),
                to_device(params, dev), n_users, max_events, max_jobs,
                batch)


def run_direct(gridlets, fleet, resource_idx, dispatch_time,
               max_events: int, reservations=None,
               batch: int = DEFAULT_BATCH, net_cap: int = 0,
               baud_rate=None, bg_flows=None, device="cuda") -> SimResult:
    """Broker-less mode: Gridlets are pre-routed into the fleet and the
    brokers stay inert -- the paper's Table 1 / Figs 9 and 12 scenario.
    ``resource_idx`` / ``dispatch_time`` broadcast to [N]; each gridlet
    arrives after its input transfer at the resource's baud rate."""
    if net_cap:
        raise NotImplementedError("the fair-share network (net_cap) is "
                                  "not ported yet")
    dev = resolve_device(device)
    gridlets = to_device(gridlets, dev)
    fleet = to_device(fleet, dev)
    n = gridlets.n
    r = torch.as_tensor(resource_idx, dtype=torch.int32,
                        device=dev).broadcast_to((n,)).clone()
    t0 = torch.as_tensor(dispatch_time, dtype=torch.float32,
                         device=dev).broadcast_to((n,))
    link_baud = fleet.baud_rate if baud_rate is None else \
        torch.as_tensor(baud_rate, dtype=torch.float32,
                        device=dev).broadcast_to((fleet.r,))
    t_ev = t0 + network.transfer_delay(gridlets.in_bytes,
                                       fleet.baud_rate[r.to(torch.int64)])
    g = replace(gridlets,
                status=torch.full((n,), IN_TRANSIT, dtype=torch.int32,
                                  device=dev),
                resource=r, assigned=r.clone(), t_event=t_ev)
    params = default_params(-1.0, 0.0, 0, 1, fleet.r,
                            reservations=reservations, link_baud=link_baud,
                            bg_flows=bg_flows, device=dev)
    return _run(g, fleet, params, 1, max_events, None, batch)


def run_inner(*args, **kwargs):
    """The unjitted inner loop the reference runs under its sweeps is
    not ported yet."""
    raise NotImplementedError("run_inner is not ported yet")


def run_sweep(*args, **kwargs):
    """The select-free sweep engine is not ported yet."""
    raise NotImplementedError("run_sweep is not ported yet")


def run_sweep_lanes(*args, **kwargs):
    """The lane-batched sweep engine is not ported yet."""
    raise NotImplementedError("run_sweep_lanes is not ported yet")
