"""The vectorised discrete-event engine (paper sections 3.4-3.5; port of
``repro.core.engine``): a resource-major superstep loop over pluggable
event sources, with k-step speculative batching.

State layout follows the reference: gridlet state in the flat
``GridletBatch`` ([N]); every executing gridlet also holds one column of
the ``[R_pad, J]`` job-slot table (``SimState.slot`` / ``row_gridlet``).
Each superstep gathers ``remaining`` into the table and runs the Fig 8
share + forecast math in one checked ``event_scan`` call
(``kernels.event_scan.event_scan_checked_*``: the gather, the check of
the carried rank and the reseed count run on the device); one
``event_frontier`` pass over every source's candidate instants picks the
earliest instant t* (and, for the batched path, the speculation
horizon).  On the card both write into the run's reused outputs
(``HostCounts.scratch``).  All jobs advance analytically to t*, then every
source due at t* applies, in the priority order of ``des.PRIORITY_ORDER``
except that BROKER applies before ARRIVAL.

Where the reference branches inside its compiled loop (``lax.cond``,
``lax.while_loop``, ``fori_loop``) the port branches on the host: state
stays on the device, and each predicate is read back once
(``HostCounts.read``, which also counts the reads).  Conditions whose
two branches give the same result (the reference's own select-free path
proves which) run unconditionally instead, with no read.

The port runs the paper's experiment (COMPLETION, RETURN, ARRIVAL,
CALENDAR_STEP, BROKER) and the fair-share network (NETWORK, with
``net_cap > 0``): a ``[R_pad, T]`` transfer-slot table (``SimState.xslot``
/ ``link_gridlet`` / ``link_rem``) holds the remaining bytes of every
in-flight staging and result return that can contend for its link
(``network.link_tabled``); concurrent transfers split the link's baud
rate equally, capped by their shared trunk's fair share where the
params name trunks, and the link scan (``link_scan``'s engine form,
``kernels.event_scan.link_scan_tabled_*``: the tie key, the trunk
occupancy and caps in the kernel) forecasts the next drain exactly as
``event_scan`` forecasts the next completion.
Resources are dynamic as in the reference: the FAILURE and RECOVERY
sources draw MTBF/MTTR holding times from the run's threefry key
(``rand``, bit for bit ``jax.random``), the TRACE source replays a
time-sorted fault trace whose trunk targets flip a whole failure domain,
and the residents of a downed resource (and arrivals at one) move to
FAILED with their cost refunded and a retry backoff
(``_fail_gridlets``); the broker resubmits them.  The economy runs as
in the reference: RESERVATION wakes the loop at every window boundary
(``params.resv_*``, half-open windows whose PEs leave the scan's shares
and the space-shared admission) and re-admits queued work when a window
closes; MARKET reprices by excess demand and AUCTION draws a sealed-bid
round from the run's auction key, each every period, moving the posted
price the broker trades at.  A run without failure streams, trace,
windows or dynamic pricing runs none of this: the gates are fixed at
its start (``HostCounts.strikes`` / ``trace`` / ``market`` /
``auction``, and the window table's length), as the reference's
``fault_time is None`` gate is static, so such a run is today's program
op for op.

The sweep engine (:func:`run_sweep_lanes`) runs many scenarios as lanes
of one loop: every leaf carries a lane axis, the kernels' lane forms
serve every lane in one launch, the tensor code runs under
``torch.func.vmap`` and finished lanes are frozen; each lane is bit for
bit its own :func:`run`.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.utils._pytree as pytree

from . import broker as broker_mod
from . import calendar, des, network, numerics, rand
from . import economy as econ_mod
from . import reservation as resv_mod
from ..kernels import event_scan as _event_kernels
from ..kernels.event_scan import BIG as _BIG
from .gridlet import GridletBatch
from .segments import group_rank, segment_count
from .types import (DONE, FAILED, IN_TRANSIT, INF, QUEUED, RETURNING, RUNNING,
                    SJF, SPACE_SHARED, TIME_SHARED, replace, resolve_device,
                    to_device)

TRACE_LEN = 64
BLOCK_R = 8          # resource axis padded to it (the reference's layout)
DEFAULT_BATCH = 8    # superstep batching factor k (see step_batched)


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Per-experiment knobs (the reference's field names)."""
    deadline: torch.Tensor        # f32[U]
    budget: torch.Tensor          # f32[U]
    opt: torch.Tensor             # i32[U] broker optimisation strategy
    max_gridlet_per_pe: torch.Tensor  # i32[] dispatch staging limit (2)
    sched_min_period: torch.Tensor    # f32[] broker poll floor (1.0)
    sched_frac: torch.Tensor          # f32[] fraction of deadline-left
    measure_alpha: torch.Tensor       # f32[] measurement smoothing
    registered: torch.Tensor      # bool[R] GIS availability mask
    mtbf: torch.Tensor            # f32[R] mean time between failures
                                  #     (0 = no failure stream)
    mttr: torch.Tensor            # f32[R] mean time to recovery
    fail_key: torch.Tensor        # i64[2] key seeding the MTBF/MTTR streams
    resv_res: torch.Tensor        # i32[K] reservation -> resource
    resv_pes: torch.Tensor        # i32[K] PEs held
    resv_start: torch.Tensor      # f32[K] window start (inclusive)
    resv_end: torch.Tensor        # f32[K] window end (exclusive)
    link_baud: torch.Tensor       # f32[R] link capacity (net mode only)
    bg_flows: torch.Tensor        # f32[R] background flows (net mode)
    pricing_model: torch.Tensor   # i32[] economy.PRICE_* (0 = static)
    market_period: torch.Tensor   # f32[] commodity repricing period
    market_gain: torch.Tensor     # f32[] price move per unit excess demand
    price_floor: torch.Tensor     # f32[] posted-price clamp, x base price
    price_cap: torch.Tensor       # f32[] posted-price clamp, x base price
    auction_period: torch.Tensor  # f32[] sealed-bid round period
    auction_key: torch.Tensor     # i64[2] key seeding the bid draws
    plan_ahead: torch.Tensor      # bool[] plan-ahead DBC dispatch
    retry_limit: torch.Tensor     # i32[] resubmission budget
    backoff_base: torch.Tensor    # f32[] exponential backoff unit
    blacklist_cooldown: torch.Tensor  # f32[] broker cooldown
    # shared trunks (None = private links only): per-resource trunk id
    # (-1 = none), trunk capacity and background flows, gathered out to
    # per-resource form by network.trunk_topology
    trunk_of: torch.Tensor | None = None      # i32[R]
    trunk_baud: torch.Tensor | None = None    # f32[R]
    trunk_bg: torch.Tensor | None = None      # f32[R]
    # trace-driven fault injection (None = no trace): time-sorted rows;
    # a target 0..R-1 names a resource, R + id names trunk id
    fault_time: torch.Tensor | None = None    # f32[K]
    fault_target: torch.Tensor | None = None  # i32[K]
    fault_up: torch.Tensor | None = None      # bool[K] True = bring up


def default_params(deadline, budget, opt, n_users: int,
                   n_resources: int = 1, registered=None, mtbf=None,
                   mttr=None, reservations=None, fail_key=None,
                   link_baud=None, bg_flows=None,
                   pricing_model=econ_mod.PRICE_STATIC, market_period=None,
                   market_gain=None, price_floor=None, price_cap=None,
                   auction_period=None, auction_key=None, plan_ahead=False,
                   trunk_of=None, trunk_baud=None, trunk_bg=None,
                   fault_trace=None, retry_limit=None, backoff_base=None,
                   blacklist_cooldown=None, device="cpu") -> SimParams:
    """``mtbf``/``mttr`` broadcast to [R] (0 disables the failure
    stream), seeded by ``fail_key`` (default ``rand.PRNGKey(0)``);
    ``link_baud``/``bg_flows`` feed the fair-share network (consulted
    only with ``net_cap > 0``); ``trunk_of`` (per-resource trunk id, -1
    = private) with the per-trunk ``trunk_baud``/``trunk_bg`` enables
    shared trunks.  ``fault_trace`` is an iterable of (time, target, up)
    rows or a [K, 3] array: target 0..R-1 names a resource, R + id a
    trunk (its whole failure domain flips at once); the rows are sorted
    by time here (stably).  ``retry_limit``/``backoff_base``/
    ``blacklist_cooldown`` are the fault-tolerant broker's knobs.
    ``reservations`` is a ``ReservationBook``, an iterable of (resource,
    pes, start, end) tuples, or the 4-tensor table itself.
    ``pricing_model`` (``economy.PRICE_*`` or its name) picks the dynamic
    pricing source; its knobs default to the reference's (a round every
    10 time units, +-25% a unit of excess demand, posted prices clamped
    to [0.5, 2.0] x base, ``auction_key`` ``rand.PRNGKey(0)``).
    ``plan_ahead`` prices the windows and link queues into the broker's
    capacity and groups equal costs exactly (``broker._measure``)."""
    def t(x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=device)

    f = lambda x: t(x).broadcast_to((n_users,)).clone()
    r = lambda x: t(0.0 if x is None else x).broadcast_to(
        (n_resources,)).clone()
    if registered is None:
        registered = torch.ones((n_resources,), dtype=torch.bool,
                                device=device)
    if reservations is None:
        resv = resv_mod.empty_tables(device)
    elif hasattr(reservations, "as_tables"):
        resv = reservations.as_tables(device)
    elif (isinstance(reservations, tuple) and len(reservations) == 4
          and all(hasattr(x, "dtype") for x in reservations)):
        resv = tuple(torch.as_tensor(x, dtype=d, device=device)
                     for x, d in zip(reservations, (torch.int32, torch.int32,
                                                    torch.float32,
                                                    torch.float32)))
    else:
        resv = resv_mod.as_tables(reservations, device)
    ft = ftgt = fup = None
    if fault_trace is not None:
        tr = torch.as_tensor(
            fault_trace if hasattr(fault_trace, "shape") else
            [(float(a), int(b), bool(c)) for a, b, c in fault_trace],
            dtype=torch.float32, device=device).reshape(-1, 3)
        tr = tr[torch.sort(tr[:, 0], stable=True).indices]
        ft, ftgt, fup = (tr[:, 0].contiguous(), tr[:, 1].to(torch.int32),
                         tr[:, 2] > 0.5)
    trunks = (None, None, None) if trunk_of is None else \
        network.trunk_topology(trunk_of, n_resources, trunk_baud=trunk_baud,
                               trunk_bg=trunk_bg, device=device)
    return SimParams(
        deadline=f(deadline), budget=f(budget),
        opt=t(opt, torch.int32).broadcast_to((n_users,)).clone(),
        max_gridlet_per_pe=t(2, torch.int32),
        sched_min_period=t(1.0),
        sched_frac=t(0.01),
        measure_alpha=t(0.5),
        registered=t(registered, torch.bool),
        mtbf=r(mtbf), mttr=r(mttr),
        fail_key=(rand.PRNGKey(0, device) if fail_key is None
                  else torch.as_tensor(fail_key, dtype=torch.int64,
                                       device=device)),
        resv_res=resv[0], resv_pes=resv[1],
        resv_start=resv[2], resv_end=resv[3],
        link_baud=t(INF if link_baud is None else link_baud).broadcast_to(
            (n_resources,)).clone(),
        bg_flows=r(bg_flows),
        pricing_model=t(econ_mod.as_pricing_model(pricing_model),
                        torch.int32),
        market_period=t(10.0 if market_period is None else market_period),
        market_gain=t(0.25 if market_gain is None else market_gain),
        price_floor=t(0.5 if price_floor is None else price_floor),
        price_cap=t(2.0 if price_cap is None else price_cap),
        auction_period=t(10.0 if auction_period is None
                         else auction_period),
        auction_key=(rand.PRNGKey(0, device) if auction_key is None
                     else torch.as_tensor(auction_key, dtype=torch.int64,
                                          device=device)),
        plan_ahead=t(bool(plan_ahead), torch.bool),
        retry_limit=t(2 ** 30 if retry_limit is None else retry_limit,
                      torch.int32),
        backoff_base=t(0.0 if backoff_base is None else backoff_base),
        blacklist_cooldown=t(0.0 if blacklist_cooldown is None
                             else blacklist_cooldown),
        trunk_of=trunks[0], trunk_baud=trunks[1], trunk_bg=trunks[2],
        fault_time=ft, fault_target=ftgt, fault_up=fup,
    )


@dataclasses.dataclass
class HostCounts:
    """Host-side loop state: the supersteps the reference counts in its
    loop carry (committing ``n_steps``, speculative ``n_spec``, Fig 8
    scans ``n_scans``), ``syncs``, the device-to-host reads the host
    loop made, and, on the device, ``n_reseeds`` (i32[], the scans that
    re-sorted: the checked scan adds to it without a read), the
    ``scratch`` its kernels write their outputs to and the link scan's
    padded per-row inputs, ``link_rows`` (built on its first call; the
    sweep engine's scan keeps its lane-constant row inputs in
    ``lane_rows``, made at the start of its run).

    The run's static gates, fixed at its start (the reference's static
    ``fault_time is None`` gate, widened to the failure streams and the
    economy): ``strikes`` (some ``mtbf > 0``: FAILURE and RECOVERY
    apply), ``trace`` (a fault trace is replayed), ``market`` /
    ``auction`` (that pricing model with a positive period: the source
    fires), ``plan`` (the broker plans ahead).  Reservation windows gate
    on the table's length (``params.resv_res.shape[0]``), which the host
    knows.  ``maybe_down`` is False while the host knows every resource
    is up, so no arrival can fail: a strike or a trace row sets it, and
    a recovery reads it back."""
    n_reseeds: torch.Tensor
    n_steps: int = 0
    n_spec: int = 0
    n_scans: int = 0
    syncs: int = 0
    scratch: _event_kernels.Scratch = dataclasses.field(
        default_factory=_event_kernels.Scratch)
    link_rows: _event_kernels.LinkRows | None = None
    lane_rows: tuple | None = None
    strikes: bool = False
    trace: bool = False
    market: bool = False
    auction: bool = False
    plan: bool = False
    maybe_down: bool = False

    def read(self, pred) -> bool:
        """Read one device predicate back to the host."""
        self.syncs += 1
        return bool(pred)

    def read_flags(self, preds) -> list:
        """Read a bool vector back to the host in one sync."""
        self.syncs += 1
        return preds.tolist()


@dataclasses.dataclass(frozen=True)
class SimState:
    t: torch.Tensor               # f32 current simulation time
    g: object                     # GridletBatch
    slot: torch.Tensor            # i32[N] job-slot column (-1 = none)
    row_gridlet: torch.Tensor     # i32[R_pad, J] slot -> gridlet (-1 = free)
    xslot: torch.Tensor           # i32[N] transfer-slot column (-1 = none)
    link_gridlet: torch.Tensor    # i32[R_pad, T] transfer slot -> gridlet
                                  #     (-1 = free); T = 0: analytic links
    link_rem: torch.Tensor        # f32[R_pad, T] bytes still to move
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
    trace_ptr: torch.Tensor       # i32 fault-trace cursor (rows < it applied)
    rng_key: torch.Tensor         # i64[2] key of the MTBF/MTTR streams
    price: torch.Tensor           # f32[R] posted G$/MI trading metric
    next_market: torch.Tensor     # f32 next repricing instant (inf)
    next_auction: torch.Tensor    # f32 next auction round (inf)
    auction_key: torch.Tensor     # i64[2] key of the bid draws
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


def _resv_on(params) -> bool:
    """The run books reservation windows (K > 0; the host knows K)."""
    return params.resv_res.shape[0] > 0


def _reserved_pes(params, t, n_resources):
    """PEs blocked by reservation windows at ``t``: i32[R]."""
    if not _resv_on(params):
        return torch.zeros((n_resources,), dtype=torch.int32,
                           device=params.deadline.device)
    return resv_mod.active_pes(params.resv_res, params.resv_pes,
                               params.resv_start, params.resv_end, t,
                               n_resources)


def _row_inputs(state, fleet, params, n_resources, r_pad):
    """The per-row scan inputs, f32 [R_pad]: effective MIPS, PEs,
    policy, reserved PEs and row up (padded rows: 1 MIPS, 1 PE,
    time-shared, none reserved, up).  The table itself is gathered from
    ``row_gridlet`` inside the scan."""
    pad = r_pad - n_resources
    f32 = torch.float32
    eff = _pad(calendar.effective_mips(fleet, state.t), pad, 1.0)
    npe = _pad(fleet.num_pe, pad, 1).to(f32)
    pol = _pad(fleet.policy, pad, 0).to(f32)
    blocked = _pad(_reserved_pes(params, state.t, n_resources).to(f32),
                   pad, 0.0)
    row_ok = _pad(state.res_up, pad, True).to(f32)
    return eff, npe, pol, blocked, row_ok


def _frontier(state, cands):
    """The event frontier over every source's candidates: the kernel on
    the card (into the run's scratch), the plain version on the CPU."""
    cand = torch.cat(cands)
    sizes = tuple(c.shape[0] for c in cands)
    if cand.device.type == "cuda":
        return _event_kernels.event_frontier_cuda(
            cand, sizes, scratch=state.host.scratch)
    return _event_kernels.event_frontier_ref(cand, sizes)


# ----------------------------------------------------------------------
# Fair-share link dynamics (the network subsystem)
# ----------------------------------------------------------------------
#
# ``net_cap`` sizes the [R_pad, T] transfer-slot table (T = 0 disables
# the subsystem: every function below is skipped and transfers keep
# their analytic timestamps).  A tabled transfer holds its remaining
# bytes in ``link_rem``; remainders advance piecewise-constantly between
# events like remaining MI under Fig 8 shares, and the NETWORK source
# releases a drained transfer's ARRIVAL/RETURN instant to "now" so it
# folds into the same superstep.

def _net_on(state) -> bool:
    """The fair-share network subsystem is enabled (T > 0)."""
    return state.link_rem.shape[1] > 0


def _xfer_bytes(g):
    """Payload of each gridlet's transfer: input files while staging
    (IN_TRANSIT), result files on the way back."""
    return torch.where(g.status == IN_TRANSIT, g.in_bytes, g.out_bytes)


def _link_rows(state, params, n_resources, r_pad):
    """The link scan's per-row inputs (``LinkRows``: link rate,
    background flows and any trunk topology) padded to R_pad (padded
    rows: baud 1, no background flow, no trunk; they never hold a
    transfer), made on the run's first call and kept in ``host``."""
    host = state.host
    if host.link_rows is None:
        pad = r_pad - n_resources
        trunks = () if params.trunk_of is None else (
            _pad(params.trunk_of, pad, -1), _pad(params.trunk_baud, pad, 1.0),
            _pad(params.trunk_bg, pad, 0.0))
        host.link_rows = _event_kernels.LinkRows(
            _pad(params.link_baud, pad, 1.0), _pad(params.bg_flows, pad, 0.0),
            *trunks)
    return host.link_rows


def _link_scan(state, params, n_resources, r_pad):
    """Fair-share rates and the next-drain forecast per link: the
    engine form of the link scan, the flat gridlet index (from
    ``link_gridlet``) as the tie key.  With shared trunks each row's
    rate is also capped at its trunk's capacity over the occupancy
    summed across every member row.  On the card one kernel launch does
    all of it, into the run's scratch; on the CPU the plain version."""
    rows = _link_rows(state, params, n_resources, r_pad)
    if state.t.device.type == "cuda":
        return _event_kernels.link_scan_tabled_cuda(
            state.link_gridlet, state.link_rem, rows,
            scratch=state.host.scratch)
    return _event_kernels.link_scan_tabled_ref(state.link_gridlet,
                                               state.link_rem, rows)


def _pending_entries(state, params, n_resources):
    """Transfers with a future network-entry instant (pre-routed
    ``run_direct`` dispatches): tabled payloads holding their entry
    time in ``t_event`` while they wait for a transfer slot."""
    g = state.g
    res = torch.clamp(g.resource.to(torch.int64), 0, n_resources - 1)
    moving = (g.status == IN_TRANSIT) | (g.status == RETURNING)
    return (moving & (state.xslot < 0) & torch.isfinite(g.t_event) &
            network.link_tabled(_xfer_bytes(g), params.link_baud[res]))


def _advance_transfers(state, ctx, t_next, any_event):
    """Advance every in-flight transfer over [t, t_next) by the rates in
    ``ctx["net_scan"]`` (must run while ``state.t`` is the interval
    start).  Transfers that drain by ``t_next`` are zeroed and recorded
    in ``ctx["xfer_done"]``; survivors are clamped to 1e-30 so rounding
    never empties an occupied slot.  ``rem - rate * dt`` is one fused
    multiply-add, as XLA:CPU compiles it."""
    rate_lt = ctx["net_scan"][0]
    occupied = state.link_gridlet >= 0
    rem = state.link_rem
    rel = torch.where(occupied, rem / torch.clamp_min(rate_lt, 1e-30), INF)
    dt = torch.clamp_min(t_next - state.t, 0.0)
    due = occupied & any_event & (state.t + rel <= t_next)
    new_rem = torch.where(
        due, 0.0,
        torch.where(occupied,
                    torch.clamp_min(numerics.fma(-rate_lt, dt, rem), 1e-30),
                    rem))
    ctx["xfer_done"] = due
    return replace(state, link_rem=new_rem)


def _enqueue_transfers(state, mask, n_resources, r_pad):
    """Give each masked gridlet a transfer-slot column on its resource's
    link, load its payload as the remaining bytes, and hand its pending
    instant to the NETWORK source (``t_event = inf``).  Gridlets that
    find no free column are counted in ``overflow``."""
    g = state.g
    res = torch.clamp(g.resource.to(torch.int64), 0, n_resources - 1)
    col, ok = _free_columns(state.link_gridlet, mask, res, n_resources)
    rows = torch.where(ok, res, r_pad)
    cols = torch.where(ok, col, 0)
    idx = torch.arange(g.n, dtype=torch.int32, device=res.device)
    return replace(
        state,
        g=replace(g, t_event=torch.where(ok, INF, g.t_event)),
        link_gridlet=_set_drop(state.link_gridlet, rows, cols, idx),
        link_rem=_set_drop(state.link_rem, rows, cols, _xfer_bytes(g)),
        xslot=torch.where(ok, col.to(torch.int32), state.xslot),
        overflow=state.overflow + (mask & ~ok).sum().to(torch.int32))


def _enqueue_new_transfers(state, params, n_resources, r_pad):
    """End of superstep: transfers created in it (broker dispatches,
    completions' result returns -- tabled, ``t_event`` inf, no slot)
    enter their links."""
    g = state.g
    moving = (g.status == IN_TRANSIT) | (g.status == RETURNING)
    new = moving & (state.xslot < 0) & ~torch.isfinite(g.t_event)
    if state.host.read(new.any()):
        state = _enqueue_transfers(state, new, n_resources, r_pad)
    return state


def _free_link_slots(state, mask):
    """Release the transfer slots of every gridlet in ``mask`` (their
    transfer was consumed by an ARRIVAL/RETURN)."""
    r_pad, t_cap = state.link_gridlet.shape
    rows = torch.where(mask, torch.clamp(state.g.resource.to(torch.int64),
                                         0, r_pad - 1), r_pad)
    cols = torch.where(mask, torch.clamp(state.xslot.to(torch.int64), 0,
                                         t_cap - 1), 0)
    return replace(state,
                   link_gridlet=_set_drop(state.link_gridlet, rows, cols, -1),
                   link_rem=_set_drop(state.link_rem, rows, cols, 0.0),
                   xslot=torch.where(mask, -1, state.xslot))


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


def _free_columns(table, mask, res, n_resources):
    """The free column of ``table`` (-1 = free) each gridlet in ``mask``
    takes on its row ``res``, in flat-index order within a row: the
    rank-th free column, from a binary search over the row's running
    free count.  Returns (col i64[N], ok: a column was free)."""
    n = mask.shape[0]
    dev = res.device
    width = table.shape[1]
    free = table < 0
    rank = _count_rank(res, mask, n_resources)
    ok = mask & (rank < free.sum(dim=1)[res])
    cumfree = torch.cumsum(free.to(torch.int64), dim=1)   # [R_pad, width]
    want = rank + 1
    lo = torch.zeros((n,), dtype=torch.int64, device=dev)
    hi = torch.full((n,), width - 1, dtype=torch.int64, device=dev)
    for _ in range(max(1, (width - 1).bit_length())):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        ge = cumfree[res, mid] >= want
        lo = torch.where(ge, lo, mid + 1)
        hi = torch.where(ge, mid, hi)
    return hi, ok


def _alloc_slots(state, mask, res, n_resources, r_pad):
    """Allocate a free job-slot column to every gridlet in ``mask``;
    gridlets that find no free column are counted in ``overflow``."""
    res = res.to(torch.int64)
    col, ok = _free_columns(state.row_gridlet, mask, res, n_resources)
    rows = torch.where(ok, res, r_pad)
    cols = torch.where(ok, col, 0)
    idx = torch.arange(state.g.n, dtype=torch.int32, device=res.device)
    rg = _set_drop(state.row_gridlet, rows, cols, idx)
    return replace(
        state, row_gridlet=rg,
        slot=torch.where(ok, col.to(torch.int32), state.slot),
        overflow=state.overflow + (mask & ~ok).sum().to(torch.int32))


def _apply_completions(state, fleet, params, completes, t_next,
                       n_resources, r_pad):
    """RUNNING -> RETURNING for the whole batch; job slots freed.  The
    result-return instant is analytic (``t_next + out_delay``) unless
    the network subsystem is on and the payload contends for its link:
    then it is load-dependent (``t_event = inf``) and the transfer
    enters the table at the end of the superstep."""
    g = state.g
    res = torch.clamp(g.resource.to(torch.int64), 0, n_resources - 1)
    if _net_on(state):
        baud = params.link_baud[res]
        t_ev = torch.where(
            network.link_tabled(g.out_bytes, baud), INF,
            t_next + network.transfer_delay(g.out_bytes, baud))
    else:
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


def _apply_returns(state, fleet, t_next, n_users, n_resources, gate=None):
    """RETURNING & due -> DONE for the whole batch; the broker's
    per-resource completion counts (paper 4.2.1 step 6).  ``gate`` (a
    device bool: the sweep engine's masked micro-steps) empties the due
    mask when False."""
    g = state.g
    ret_due = (g.status == RETURNING) & (g.t_event <= t_next)
    if gate is not None:
        ret_due = ret_due & gate
    g = replace(g,
                status=torch.where(ret_due, DONE, g.status),
                returned=torch.where(ret_due, t_next, g.returned))
    ur = g.user.to(torch.int64) * n_resources + torch.clamp(
        g.resource.to(torch.int64), 0, n_resources - 1)
    # Integer-valued f32 counts: exact in any summation order.
    done_on = state.done_on + segment_count(
        ret_due, ur, n_users * n_resources).to(torch.float32).reshape(
        n_users, n_resources)
    state = replace(state, g=g, done_on=done_on)
    if _net_on(state):    # consumed transfers release their link slots
        state = _free_link_slots(state, ret_due & (state.xslot >= 0))
    return state, ret_due


def _fail_gridlets(state, victims, n_users, now, params):
    """The fail-and-refund invariant of FAILURE, TRACE and an arrival at
    a down resource: ``victims`` move to FAILED, drop their broker
    assignment and pending instant, and their committed cost is refunded
    (segment sums in index order, as the reference adds them).  Each
    victim's retry count ticks, and it may be re-dispatched from ``now +
    backoff_base * 2**(n_retries - 1)`` on (XLA:CPU's ``exp2``, from
    ``numerics.EXP2_BITS``; the add is one fused multiply-add).  Every
    write is gated on ``victims``."""
    g = state.g
    refund = numerics.segment_sum(torch.where(victims, g.cost, 0.0),
                                  g.user, n_users, state.width)
    n_retries = g.n_retries + victims.to(torch.int32)
    unit = numerics.exp2_table(n_retries - 1)
    g = replace(
        g,
        status=torch.where(victims, FAILED, g.status),
        assigned=torch.where(victims, -1, g.assigned),
        t_event=torch.where(victims, INF, g.t_event),
        cost=torch.where(victims, 0.0, g.cost),
        n_retries=n_retries,
        retry_at=torch.where(victims,
                             numerics.fma(params.backoff_base, unit, now),
                             g.retry_at),
    )
    return replace(state, g=g, spent=state.spent - refund,
                   n_failed=state.n_failed + victims.sum().to(torch.int32))


def _apply_arrivals(state, fleet, params, free_pe, arr_pre, t_next,
                    n_users, n_resources):
    """IN_TRANSIT & due -> RUNNING (time-shared / free PE) or QUEUED;
    arrivals at a down resource fail-and-refund.  Space-shared arrivals
    fill the ``free_pe`` PEs left after this superstep's admissions,
    pre-broker arrivals (``arr_pre``) first, flat-index order within
    each class; the rest queue, stamped with their arrival instant.
    Returns (state, arrivals, newly running, newly queued)."""
    g = state.g
    n = g.n
    res = torch.clamp(g.resource.to(torch.int64), 0, n_resources - 1)
    idx = torch.arange(n, device=res.device)
    arr_due = (g.status == IN_TRANSIT) & (g.t_event <= t_next)
    arr_live = arr_due
    if state.host.maybe_down:
        arr_fail = arr_due & ~state.res_up[res]
        if state.host.read(arr_fail.any()):
            arr_live = arr_due & ~arr_fail
            state = _fail_gridlets(state, arr_fail, n_users, t_next, params)
            g = state.g
    is_ss = fleet.policy[res] == SPACE_SHARED
    arr_ss = arr_live & is_ss
    order = torch.where(arr_pre, idx, idx + n)
    # Only arr_ss members consult the rank, so computing it without the
    # reference's arr_ss.any() cond gives the same result.
    rank = group_rank(res, arr_ss, order, n_resources)[0]
    arr_run = arr_live & (~is_ss | (rank < free_pe[res]))
    arr_queue = arr_ss & ~arr_run
    g = replace(
        g,
        status=torch.where(arr_run, RUNNING,
                           torch.where(arr_queue, QUEUED, g.status)),
        start=torch.where(arr_run, torch.minimum(g.start, t_next), g.start),
        t_event=torch.where(arr_run, INF,
                            torch.where(arr_queue, t_next, g.t_event)),
    )
    state = replace(state, g=g)
    if _net_on(state):    # consumed transfers release their link slots
        state = _free_link_slots(state, arr_due & (state.xslot >= 0))
    return state, arr_due, arr_run, arr_queue


def _residents_r(state, n_resources):
    """bool[R]: the resource hosts RUNNING or QUEUED work, which a strike
    would fail (the speculation horizon's interference test)."""
    g = state.g
    res = torch.clamp(g.resource.to(torch.int64), 0, n_resources - 1)
    resident = (g.status == RUNNING) | (g.status == QUEUED)
    return segment_count(resident, res, n_resources) > 0


def _apply_failures(state, fleet, params, due_r, now, n_users,
                    n_resources, r_pad):
    """Down the resources in ``due_r``: RUNNING/QUEUED residents fail and
    refund, their slots are freed, the brokers' measurement window on
    the resource resets, and the MTTR stream (one ``split`` of the run's
    key) schedules each one's recovery."""
    g = state.g
    key, k1 = rand.split(state.rng_key)
    repair = torch.where(params.mttr > 0.0,
                         rand.exponential(k1, params.mttr), 0.0)
    on_r = torch.clamp(g.resource.to(torch.int64), 0, n_resources - 1)
    victim = ((g.status == RUNNING) | (g.status == QUEUED)) & due_r[on_r]
    state = _fail_gridlets(state, victim, n_users, now, params)
    state = replace(
        state, rng_key=key,
        res_up=state.res_up & ~due_r,
        next_fail=torch.where(due_r, INF, state.next_fail),
        next_recover=torch.where(due_r, now + repair, state.next_recover),
        fail_since=torch.where(due_r, now, state.fail_since),
        first_dispatch=torch.where(due_r[None, :], INF,
                                   state.first_dispatch))
    return _free_slots(state, victim & (state.slot >= 0), on_r, r_pad)


def _apply_recoveries(state, params, due_r, now):
    """Bring the resources in ``due_r`` back up: downtime accrues, the
    broker's cooldown stamp moves, and the MTBF stream (one ``split``)
    schedules each one's next failure."""
    key, k1 = rand.split(state.rng_key)
    uptime = rand.exponential(k1, params.mtbf)     # inf where mtbf <= 0
    return replace(
        state, rng_key=key,
        res_up=state.res_up | due_r,
        next_fail=torch.where(due_r, now + uptime, state.next_fail),
        next_recover=torch.where(due_r, INF, state.next_recover),
        downtime=state.downtime + torch.where(due_r, now - state.fail_since,
                                              0.0),
        fail_since=torch.where(due_r, INF, state.fail_since),
        recovered_at=torch.where(due_r, now, state.recovered_at))


def _trace_masks(params, due, n_resources):
    """The due fault-trace rows as per-resource (down, up) masks: target
    ``r < R`` names resource r, ``R + id`` every resource on trunk id."""
    tgt = params.fault_target
    r_idx = torch.arange(n_resources, dtype=torch.int32, device=tgt.device)
    hit = tgt[None, :] == r_idx[:, None]                    # [R, K]
    if params.trunk_of is not None:
        hit = hit | ((tgt[None, :] - n_resources) ==
                     params.trunk_of[:, None])
    down_r = (hit & (due & ~params.fault_up)[None, :]).any(dim=1)
    up_r = (hit & (due & params.fault_up)[None, :]).any(dim=1)
    return down_r, up_r


def _apply_trace(state, fleet, params, due, down_r, up_r, now, n_users,
                 n_resources, r_pad):
    """Apply one batch of due trace rows, downs before ups (a down and an
    up of one resource at one instant nets to up): a down fails its
    residents like FAILURE and clears any pending strike, an up accrues
    downtime and stamps the cooldown like RECOVERY; no draw."""
    g = state.g
    on_r = torch.clamp(g.resource.to(torch.int64), 0, n_resources - 1)
    eff_down = down_r & state.res_up
    victim = ((g.status == RUNNING) | (g.status == QUEUED)) & down_r[on_r]
    state = _fail_gridlets(state, victim, n_users, now, params)
    state = replace(
        state,
        res_up=state.res_up & ~down_r,
        next_fail=torch.where(down_r, INF, state.next_fail),
        next_recover=torch.where(down_r, INF, state.next_recover),
        fail_since=torch.where(eff_down, now, state.fail_since),
        first_dispatch=torch.where(eff_down[None, :], INF,
                                   state.first_dispatch),
        trace_ptr=state.trace_ptr + due.sum().to(torch.int32))
    state = _free_slots(state, victim & (state.slot >= 0), on_r, r_pad)
    eff_up = up_r & ~state.res_up
    return replace(
        state,
        res_up=state.res_up | up_r,
        next_recover=torch.where(up_r, INF, state.next_recover),
        downtime=state.downtime + torch.where(
            eff_up & torch.isfinite(state.fail_since),
            now - state.fail_since, 0.0),
        fail_since=torch.where(eff_up, INF, state.fail_since),
        recovered_at=torch.where(eff_up, now, state.recovered_at))


def _admit_after_reservation(state, fleet, params, now, n_resources,
                             qrank, gate):
    """A window boundary changed the blocked-PE counts: re-admit queued
    work onto whatever space-shared capacity is free now.  ``gate`` (a
    device bool) zeroes the free-PE budget when False, which makes the
    admission a no-op.  Returns (state, admitted mask)."""
    g = state.g
    res = torch.clamp(g.resource.to(torch.int64), 0, n_resources - 1)
    busy = segment_count(g.status == RUNNING, res, n_resources)
    avail = fleet.num_pe - _reserved_pes(params, now, n_resources) - busy
    free_pe = torch.where((fleet.policy == SPACE_SHARED) & state.res_up,
                          torch.clamp_min(avail, 0), 0)
    free_pe = torch.where(gate, free_pe, 0)
    return _admit_queued(state, fleet, free_pe, now, n_resources, qrank)


def _apply_market(state, fleet, params, now, n_resources):
    """One commodity-market round: demand is the resident (RUNNING or
    QUEUED) jobs a PE, the posted price moves by it, and the next round
    is a period away."""
    g = state.g
    res = torch.clamp(g.resource.to(torch.int64), 0, n_resources - 1)
    resident = (g.status == RUNNING) | (g.status == QUEUED)
    # integer-valued f32 counts: exact in any summation order
    n_res = segment_count(resident, res, n_resources).to(torch.float32)
    demand = n_res / torch.clamp_min(fleet.num_pe.to(torch.float32), 1.0)
    base = fleet.cost_per_mi().to(torch.float32)
    price = econ_mod.commodity_reprice(state.price, base, demand,
                                       params.market_gain,
                                       params.price_floor, params.price_cap)
    return replace(state, price=price,
                   next_market=now + params.market_period)


def _apply_auction(state, fleet, params, now):
    """One sealed-bid round: one ``split`` of the run's auction key, the
    bids drawn from its second half, the next round a period away."""
    key, kbid = rand.split(state.auction_key)
    base = fleet.cost_per_mi().to(torch.float32)
    price = econ_mod.auction_round(kbid, base, params.price_floor,
                                   params.price_cap)
    return replace(state, price=price, auction_key=key,
                   next_auction=now + params.auction_period)


# ----------------------------------------------------------------------
# Event sources (des.FnSource protocol)
# ----------------------------------------------------------------------

def _identity(state, now):
    return state


def _due(state, ctx, kind, pred) -> bool:
    """Whether source ``kind`` has events due: the flag the superstep
    already read for it (``ctx["due"]``), else one read of ``pred``."""
    known = ctx.get("due", {}).get(kind)
    return state.host.read(pred) if known is None else known


def _make_sources(fleet, params, n_users, ctx):
    """The engine's event sources, ordered by des.PRIORITY_ORDER.
    ``ctx`` is the per-superstep scratch dict the sources share (scan
    outputs, event masks, the remaining free-PE budget, the due flags
    read for this superstep).  FAILURE and RECOVERY apply only in a run
    with a failure stream, TRACE only with a fault trace, RESERVATION
    only with windows, MARKET and AUCTION only under their pricing model
    (the run's static gates, ``HostCounts``); gated off, each exposes
    the reference's candidates of its off state (none, or one +inf) and
    applies as the identity."""
    n_resources = fleet.r
    resv_on = _resv_on(params)

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

    # -- FAILURE / RECOVERY: MTBF/MTTR renewal streams ------------------
    def _no_strike(kind, state):
        ctx[("count", kind)] = torch.zeros((), dtype=torch.int32,
                                           device=state.t.device)
        ctx[("who", kind)] = ctx[("count", kind)]
        return state

    def failure_apply(state, now):
        if not state.host.strikes:
            return state
        due_r = torch.isfinite(state.next_fail) & (state.next_fail <= now)
        if not _due(state, ctx, des.K_FAILURE, due_r.any()):
            return _no_strike(des.K_FAILURE, state)
        ctx[("count", des.K_FAILURE)] = due_r.sum().to(torch.int32)
        ctx[("who", des.K_FAILURE)] = torch.argmax(due_r.to(torch.int32))
        # QUEUED victims leave the queue mid-rank: the carried ordering
        # no longer describes it.
        qr, qok = ctx["qcarry"]
        ctx["qcarry"] = (qr, torch.zeros_like(qok))
        state.host.maybe_down = True
        return _apply_failures(state, fleet, params, due_r, now, n_users,
                               n_resources, state.row_gridlet.shape[0])

    def recovery_apply(state, now):
        if not state.host.strikes:
            return state
        due_r = torch.isfinite(state.next_recover) & \
            (state.next_recover <= now)
        if not _due(state, ctx, des.K_RECOVERY, due_r.any()):
            return _no_strike(des.K_RECOVERY, state)
        ctx[("count", des.K_RECOVERY)] = due_r.sum().to(torch.int32)
        ctx[("who", des.K_RECOVERY)] = torch.argmax(due_r.to(torch.int32))
        state = _apply_recoveries(state, params, due_r, now)
        state.host.maybe_down = state.host.read((~state.res_up).any())
        return state

    # A strike on a resource with resident work cuts the speculation
    # horizon; one on a resource without any fires in the micro-steps.
    # (With no failure stream both streams are +inf and cut nothing.)
    def failure_horizon(state):
        if not state.host.strikes:
            return state.next_fail
        return torch.where(_residents_r(state, n_resources),
                           state.next_fail, INF)

    def recovery_horizon(state):
        if not state.host.strikes:
            return state.next_recover
        return torch.where(_residents_r(state, n_resources),
                           state.next_recover, INF)

    # -- TRACE: the replayed fault-injection schedule -------------------
    # A cursor walks the time-sorted rows; the due rows are its prefix of
    # instants <= now.  Without a trace: one +inf candidate, no apply.
    def trace_candidates(state):
        if params.fault_time is None:
            return torch.full_like(state.t, INF).reshape(1)
        k_idx = torch.arange(params.fault_time.shape[0], dtype=torch.int32,
                             device=state.t.device)
        return torch.where(k_idx >= state.trace_ptr, params.fault_time, INF)

    def trace_apply(state, now):
        if params.fault_time is None:
            return state
        k_idx = torch.arange(params.fault_time.shape[0], dtype=torch.int32,
                             device=state.t.device)
        due = (k_idx >= state.trace_ptr) & (params.fault_time <= now)
        if not _due(state, ctx, des.K_TRACE, due.any()):
            return state
        down_r, up_r = _trace_masks(params, due, n_resources)
        ctx[("count", des.K_TRACE)] = due.sum().to(torch.int32)
        ctx[("who", des.K_TRACE)] = params.fault_target[
            torch.argmax(due.to(torch.int32))]
        # QUEUED victims leave the queue mid-rank (ups only add capacity)
        qr, qok = ctx["qcarry"]
        ctx["qcarry"] = (qr, qok & ~down_r.any())
        state = _apply_trace(state, fleet, params, due, down_r, up_r, now,
                             n_users, n_resources,
                             state.row_gridlet.shape[0])
        state.host.maybe_down = state.host.read((~state.res_up).any())
        return state

    # -- RESERVATION: windows open and close at params.resv_* ----------
    def reservation_candidates(state):
        if not resv_on:
            return state.t.new_zeros((0,))
        return resv_mod.boundary_candidates(params.resv_start,
                                            params.resv_end, state.t)

    def reservation_apply(state, now):
        # ctx["due"] holds "fired, and work was QUEUED when the superstep
        # began"; QUEUED work appears only with ARRIVAL, after this
        # source, so without it the reference's predicate is False and
        # the apply the identity.  With it, the predicate is exact on
        # the device: earlier applies may have emptied the queue.
        if not resv_on or not ctx["due"][des.K_RESERVATION]:
            return state
        res = torch.clamp(state.g.resource.to(torch.int64), 0,
                          n_resources - 1)
        pred = (state.g.status == QUEUED).any()
        qr0, qok = ctx["qcarry"]
        qr = torch.where(qok, qr0, _queue_rank(state, fleet, n_resources))
        state, admitq = _admit_after_reservation(state, fleet, params, now,
                                                 n_resources, qr, pred)
        n_admit_r = segment_count(admitq, res, n_resources)
        ctx["qcarry"] = (qr - n_admit_r[res], qok | pred)
        ctx["newly"] = ctx["newly"] | admitq
        ctx["free_pe"] = ctx["free_pe"] - n_admit_r
        return state

    # -- MARKET / AUCTION: dynamic pricing rounds (economy layer) -------
    # Both write only the posted price, their next instant and (AUCTION)
    # the bid key; the price never enters the Fig 8 arithmetic, so
    # neither invalidates the slab carry.  Both keep the default horizon
    # (their own instants cut the slab): they fire only in committing
    # supersteps.
    def market_apply(state, now):
        nxt = state.next_market
        if not state.host.market or not _due(
                state, ctx, des.K_MARKET, torch.isfinite(nxt) & (nxt <= now)):
            return state
        return _apply_market(state, fleet, params, now, n_resources)

    def auction_apply(state, now):
        nxt = state.next_auction
        if not state.host.auction or not _due(
                state, ctx, des.K_AUCTION, torch.isfinite(nxt) & (nxt <= now)):
            return state
        return _apply_auction(state, fleet, params, now)

    # -- NETWORK: fair-share links (the [R_pad, T] transfer table) ------
    def network_candidates(state):
        if not _net_on(state):
            return state.t.new_zeros((0,))
        ctx["net_scan"] = _link_scan(state, params, n_resources,
                                     state.row_gridlet.shape[0])
        tmin = ctx["net_scan"][1]
        # per-link next drain, then the pending entries' entry instants
        pend = _pending_entries(state, params, n_resources)
        return torch.cat([torch.where(tmin < _BIG, state.t + tmin, INF),
                          torch.where(pend, state.g.t_event, INF)])

    def network_apply(state, now):
        if not _net_on(state):
            return state
        r_pad = state.row_gridlet.shape[0]
        n = state.g.n
        # (1) drained transfers release their gridlet's pending instant
        # to `now`; this superstep's RETURN/ARRIVAL batches consume it
        lg = state.link_gridlet.to(torch.int64)
        hit = torch.zeros((n + 1,), dtype=torch.bool, device=lg.device)
        hit[torch.where(ctx["xfer_done"], lg, n).reshape(-1)] = True
        done_n = hit[:n]
        state = replace(state, g=replace(
            state.g, t_event=torch.where(done_n, now, state.g.t_event)))
        # (2) pending entries whose entry instant arrived join their link
        pend = _pending_entries(state, params, n_resources) & \
            (state.g.t_event <= now)
        if state.host.read(pend.any()):
            state = _enqueue_transfers(state, pend, n_resources, r_pad)
        ctx[("count", des.K_NETWORK)] = (done_n.sum() + pend.sum()).to(
            torch.int32)
        ctx[("who", des.K_NETWORK)] = torch.where(
            done_n.any(), torch.argmax(done_n.to(torch.int32)),
            torch.argmax(pend.to(torch.int32))).to(torch.int32)
        return state

    def network_horizon(state):
        """Pending entries' instants, and for every in-flight staging a
        lower bound on its drain (``network.fastest_drain``): a staging
        drain matures an ARRIVAL, which only a committing superstep
        applies.  Result-return drains cut nothing."""
        if not _net_on(state):
            return state.t.new_zeros((0,))
        g = state.g
        rows = _link_rows(state, params, n_resources,
                          state.row_gridlet.shape[0])
        gid = state.link_gridlet
        staging = (gid >= 0) & (g.status[torch.clamp(
            gid.to(torch.int64), 0, g.n - 1)] == IN_TRANSIT)
        bound = state.t + network.fastest_drain(
            state.link_rem, rows.baud[:, None], rows.bg[:, None])
        pend = _pending_entries(state, params, n_resources)
        return torch.cat([torch.where(staging, bound, INF).reshape(-1),
                          torch.where(pend, g.t_event, INF)])

    def _untabled(state, nbytes, mask):
        """``mask`` minus the tabled transfers still waiting for a slot:
        the NETWORK source owns those until they drain."""
        if not _net_on(state):
            return mask
        res = torch.clamp(state.g.resource.to(torch.int64), 0,
                          n_resources - 1)
        return mask & ~(network.link_tabled(nbytes, params.link_baud[res])
                        & (state.xslot < 0))

    # -- RETURN / ARRIVAL / CALENDAR / BROKER ---------------------------
    def return_candidates(state):
        g = state.g
        mask = _untabled(state, g.out_bytes, g.status == RETURNING)
        return torch.where(mask, g.t_event, INF)

    def return_apply(state, now):
        state, ret_due = _apply_returns(state, fleet, now, n_users,
                                        n_resources)
        ctx[("count", des.K_RETURN)] = ret_due.sum().to(torch.int32)
        ctx[("who", des.K_RETURN)] = torch.argmax(
            ret_due.to(torch.int32)).to(torch.int32)
        return state

    def arrival_candidates(state):
        g = state.g
        mask = _untabled(state, g.in_bytes, g.status == IN_TRANSIT)
        return torch.where(mask, g.t_event, INF)

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
        pre_transit = g.status == IN_TRANSIT
        if _due(state, ctx, des.K_BROKER, ctx["fired_b"]):
            state = broker_mod.broker_event(state, fleet, params, n_users)
        if _net_on(state):
            # Re-time fresh dispatches: contending payloads become
            # load-dependent (t_event inf; they enter their link at the
            # end of the superstep), the rest take the analytic delay at
            # the subsystem's link_baud.
            g2 = state.g
            res = torch.clamp(g2.resource.to(torch.int64), 0,
                              n_resources - 1)
            newt = (g2.status == IN_TRANSIT) & ~pre_transit
            baud = params.link_baud[res]
            t_ev = torch.where(
                newt & network.link_tabled(g2.in_bytes, baud), INF,
                torch.where(newt,
                            now + network.transfer_delay(g2.in_bytes, baud),
                            g2.t_event))
            state = replace(state, g=replace(g2, t_event=t_ev))
        return state

    sources = (
        des.FnSource(des.K_COMPLETION, "completion",
                     completion_candidates, completion_apply,
                     horizon_fn=des.no_interference),
        des.FnSource(des.K_FAILURE, "failure",
                     lambda s: s.next_fail, failure_apply,
                     horizon_candidates_fn=failure_horizon),
        des.FnSource(des.K_RECOVERY, "recovery",
                     lambda s: s.next_recover, recovery_apply,
                     horizon_candidates_fn=recovery_horizon),
        # every pending trace instant cuts the speculation horizon, so
        # trace rows fire only in committing supersteps
        des.FnSource(des.K_TRACE, "trace", trace_candidates, trace_apply),
        des.FnSource(des.K_RESERVATION, "reservation",
                     reservation_candidates, reservation_apply),
        des.FnSource(des.K_MARKET, "market",
                     lambda s: s.next_market.reshape(1), market_apply),
        des.FnSource(des.K_AUCTION, "auction",
                     lambda s: s.next_auction.reshape(1), auction_apply),
        des.FnSource(des.K_NETWORK, "network", network_candidates,
                     network_apply,
                     horizon_candidates_fn=network_horizon),
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


def _checked_scan(state, fleet, params, n_resources, r_pad, slab):
    """The Fig 8 scan in the reference's select-free form: every row
    takes the carried rank when it still describes the table (the
    slab's flag and ``_partition_ok``), else a fresh rank, and
    ``host.n_reseeds`` counts the fresh ones -- the gather, the check,
    the choice and the count all on the device, with no host read (the
    kernel's checked form on the card).  Returns (rate [R_pad, J], t_min
    [R_pad], argmin col [R_pad], occupancy [R_pad], rank [R_pad, J])."""
    host = state.host
    args = (state.row_gridlet, state.g.remaining,
            *_row_inputs(state, fleet, params, n_resources, r_pad),
            slab[0], slab[1], host.n_reseeds)
    if state.t.device.type == "cuda":
        return _event_kernels.event_scan_checked_cuda(*args,
                                                      scratch=host.scratch)
    return _event_kernels.event_scan_checked_ref(*args)


def _slab_after(state, ctx, scan, fired_interfering: bool, fleet,
                n_resources, r_pad):
    """The slab carry after a superstep: survivors' ranks shift down by
    the per-row completed count; the carry stays valid unless a
    newly-RUNNING job landed on a time-shared row or an interfering
    source (FAILURE, RECOVERY, TRACE: they rewrite slots and row masks;
    RESERVATION: it moves the rows' blocked PEs) fired, which the host
    knows from the flags it read."""
    n_comp_r = _pad(ctx["n_comp_r"], r_pad - n_resources, 0)
    rank = scan[4] - n_comp_r[:, None].to(torch.float32)
    res = torch.clamp(state.g.resource.to(torch.int64), 0, n_resources - 1)
    ts_newly = ctx["newly"] & (fleet.policy[res] == TIME_SHARED)
    ok = ~ts_newly.any()
    if fired_interfering:
        ok = torch.zeros_like(ok)
    qrank, qok = ctx["qcarry"]
    return (rank, ok, qrank, qok)


def _step_commit(state, fleet, params, n_users, slab):
    """The committing superstep: frontier over every source's
    candidates, advance over [t, t*), apply every source due at t*.
    Returns ``(state, slab, finished)``."""
    n_resources = fleet.r
    r_pad = state.row_gridlet.shape[0]
    host = state.host

    ctx = {}
    ctx["scan"] = _checked_scan(state, fleet, params, n_resources, r_pad,
                                slab)
    ctx["qcarry"] = (slab[2], slab[3])
    host.n_scans += 1
    sources = _make_sources(fleet, params, n_users, ctx)
    t_star, fired, _, _, _ = _frontier(
        state, [s.candidates(state) for s in sources])
    any_event = torch.isfinite(t_star)
    t_next = torch.where(any_event, t_star, state.t)

    # transfers first: both advances read the interval start from state.t
    if _net_on(state):
        state = _advance_transfers(state, ctx, t_next, any_event)
    state = _advance_jobs(state, ctx, t_next, any_event, n_resources)
    pos_of = {s.kind: i for i, s in enumerate(sources)}
    ctx["fired_b"] = fired[pos_of[des.K_BROKER]]
    interfering = False
    resv_on = _resv_on(params)
    if host.strikes or host.trace or resv_on or host.market or \
            host.auction:
        # one read of every source's flag stands for the FAILURE, TRACE,
        # MARKET, AUCTION and BROKER reads; RECOVERY's holds unless a
        # failure fired (a repair may round to zero time and recover in
        # this superstep).  With windows the read also carries whether
        # work is QUEUED now, before any apply (RESERVATION's predicate)
        vec = fired if not resv_on else torch.cat(
            [fired, (state.g.status == QUEUED).any().reshape(1)])
        flags = host.read_flags(vec)
        due = {k: flags[pos_of[k]] for k in (des.K_FAILURE, des.K_TRACE,
                                             des.K_MARKET, des.K_AUCTION,
                                             des.K_BROKER)}
        if not due[des.K_FAILURE]:
            due[des.K_RECOVERY] = flags[pos_of[des.K_RECOVERY]]
        due[des.K_RESERVATION] = resv_on and \
            flags[pos_of[des.K_RESERVATION]] and flags[-1]
        ctx["due"] = due
        interfering = any(flags[pos_of[k]] for k in (
            des.K_FAILURE, des.K_RECOVERY, des.K_TRACE,
            des.K_RESERVATION))

    # priority order, except BROKER before ARRIVAL
    order = list(range(len(sources)))
    order.remove(pos_of[des.K_BROKER])
    order.insert(order.index(pos_of[des.K_ARRIVAL]), pos_of[des.K_BROKER])
    for i in order:
        state = sources[i].apply(state, t_next)

    state = _alloc_newly(state, ctx, n_resources, r_pad)
    if _net_on(state):    # transfers created this superstep enter links
        state = _enqueue_new_transfers(state, params, n_resources, r_pad)

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
    return state, _slab_after(state, ctx, ctx["scan"], interfering, fleet,
                              n_resources, r_pad), finished


def _speculative_step(state, fleet, params, n_users, t_safe, slab,
                      finished):
    """One speculative micro-superstep: applies the earliest pending
    COMPLETION / FAILURE / RECOVERY / NETWORK-drain / RETURN batch if,
    and only if, it lies strictly inside the speculation horizon
    ``t_safe`` (strikes on resources with resident work and staging
    drains, which mature an ARRIVAL, cut the horizon, so only strikes on
    idle resources and result-return drains fire here).  Returns
    ``(state, fired, slab', finished')``; when nothing fires the state
    is untouched and the scan just made seeds the carry."""
    n_resources = fleet.r
    r_pad = state.row_gridlet.shape[0]
    host = state.host
    ctx = {}
    sources = _make_sources(fleet, params, n_users, ctx)
    by_kind = {s.kind: s for s in sources}
    ret = by_kind[des.K_RETURN]
    net = _net_on(state)

    ctx["scan"] = _checked_scan(state, fleet, params, n_resources, r_pad,
                                slab)
    ctx["qcarry"] = (slab[2], slab[3])
    host.n_scans += 1
    if net:
        ctx["net_scan"] = _link_scan(state, params, n_resources, r_pad)

    tmin = ctx["scan"][1].min()
    t_comp = torch.where(tmin < _BIG, state.t + tmin, INF)
    t_next = torch.minimum(t_comp, ret.next_time(state))
    strikes = host.strikes
    f_due = r_due = False
    if strikes:
        t_next = torch.minimum(t_next, state.next_fail.min())
        t_next = torch.minimum(t_next, state.next_recover.min())
    if net:
        tmin_l = ctx["net_scan"][1].min()
        t_next = torch.minimum(
            t_next, torch.where(tmin_l < _BIG, state.t + tmin_l, INF))
    fire = (torch.isfinite(t_next) & (t_next < t_safe) &
            ~finished.all())
    if strikes:
        # the strikes' due flags ride on the fire read; RECOVERY's is
        # read again after a failure (a zero-time repair)
        f_due = (torch.isfinite(state.next_fail) &
                 (state.next_fail <= t_next)).any()
        r_due = (torch.isfinite(state.next_recover) &
                 (state.next_recover <= t_next)).any()
        alive, f_due, r_due = host.read_flags(torch.stack([fire, f_due,
                                                           r_due]))
        ctx["due"] = {des.K_FAILURE: f_due}
        if not f_due:
            ctx["due"][des.K_RECOVERY] = r_due
    else:
        alive = host.read(fire)
    if not alive:
        return state, False, (ctx["scan"][4],
                              torch.tensor(True, device=t_next.device),
                              slab[2], slab[3]), finished

    if net:
        state = _advance_transfers(state, ctx, t_next, fire)
    state = _advance_jobs(state, ctx, t_next, fire, n_resources)
    # the committing superstep's apply order, restricted to these
    # sources: COMPLETION > FAILURE > RECOVERY > NETWORK > RETURN
    spec_kinds = [des.K_COMPLETION]
    if strikes:
        spec_kinds += [des.K_FAILURE, des.K_RECOVERY]
    if net:
        spec_kinds.append(des.K_NETWORK)
    spec_kinds.append(des.K_RETURN)
    for kind in spec_kinds:
        state = by_kind[kind].apply(state, t_next)
    state = _alloc_newly(state, ctx, n_resources, r_pad)
    if net:
        state = _enqueue_new_transfers(state, params, n_resources, r_pad)
    kinds = torch.tensor(spec_kinds, dtype=torch.int32,
                         device=t_next.device)
    counts = torch.stack([ctx[("count", k)] for k in spec_kinds])
    whos = torch.stack([ctx[("who", k)].to(torch.int32)
                        for k in spec_kinds])
    state, finished = _bookkeep(state, fleet, params, n_users, kinds,
                                counts, whos, t_next)
    host.n_spec += 1
    # a strike restructures rows and slots: the next scan reseeds
    interfering = f_due or r_due
    return state, True, _slab_after(state, ctx, ctx["scan"], interfering,
                                    fleet, n_resources, r_pad), finished


def _speculation_horizon(state, fleet, params, n_users):
    """Earliest instant at which any source could interfere with the
    speculative COMPLETION/RETURN batching, from every source's
    ``horizon_candidates`` through the frontier kernel."""
    sources = _make_sources(fleet, params, n_users, {})
    return _frontier(state, [s.horizon_candidates(state)
                             for s in sources])[3]


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
               max_jobs: int | None = None, params=None,
               net_cap: int = 0) -> SimState:
    """``max_jobs`` bounds concurrently RUNNING gridlets per resource
    (the J axis of the job-slot table; default N); ``net_cap`` sizes
    the transfer-slot table (T per link, capped at N; 0 = analytic
    links).  ``params`` seeds the failure stream: ``key, k1 =
    split(fail_key)``, the first failure ``exponential(k1, mtbf)``; and
    the pricing rounds: the first one period in under its model (else
    +inf), the bids from ``auction_key``.  The run's static gates are
    fixed here (``HostCounts``): with no ``mtbf > 0`` nothing is drawn,
    ``next_fail`` is the draw's +inf and the key is never used."""
    n = gridlets.n
    dev = gridlets.length_mi.device
    j_cap = n if max_jobs is None else min(max_jobs, n)
    t_cap = min(max(net_cap, 0), n)
    r = fleet.r
    r_pad = -(-r // BLOCK_R) * BLOCK_R

    def full(shape, v, dtype=torch.float32):
        return torch.full(shape, v, dtype=dtype, device=dev)

    zero_i = full((), 0, torch.int32)
    width = int(torch.bincount(gridlets.user.to(torch.int64)).max()) \
        if n else 0
    strikes = params is not None and bool((params.mtbf > 0).any())
    trace = params is not None and params.fault_time is not None
    key = rand.PRNGKey(0, dev) if params is None else params.fail_key
    next_fail = full((r,), INF)
    if strikes:
        key, k1 = rand.split(key)
        next_fail = rand.exponential(k1, params.mtbf)
    model = econ_mod.PRICE_STATIC if params is None else \
        int(params.pricing_model)
    market = model == econ_mod.PRICE_COMMODITY and \
        float(params.market_period) > 0
    auction = model == econ_mod.PRICE_AUCTION and \
        float(params.auction_period) > 0
    plan = params is not None and bool(params.plan_ahead)
    return SimState(
        t=full((), 0.0),
        g=gridlets,
        slot=full((n,), -1, torch.int32),
        row_gridlet=full((r_pad, j_cap), -1, torch.int32),
        xslot=full((n,), -1, torch.int32),
        link_gridlet=full((r_pad, t_cap), -1, torch.int32),
        link_rem=full((r_pad, t_cap), 0.0),
        spent=full((n_users,), 0.0),
        done_on=full((n_users, r), 0.0),
        first_dispatch=full((n_users, r), INF),
        next_sched=full((), first_sched),
        term_time=full((n_users,), INF),
        res_up=full((r,), True, torch.bool),
        next_fail=next_fail,
        next_recover=full((r,), INF),
        fail_since=full((r,), INF),
        downtime=full((r,), 0.0),
        recovered_at=full((r,), -INF),
        trace_ptr=zero_i,
        rng_key=key,
        price=fleet.cost_per_mi().to(torch.float32).broadcast_to(
            (r,)).clone(),
        next_market=(params.market_period.to(torch.float32).clone()
                     if market else full((), INF)),
        next_auction=(params.auction_period.to(torch.float32).clone()
                      if auction else full((), INF)),
        auction_key=(rand.PRNGKey(0, dev) if params is None
                     else params.auction_key),
        n_events=zero_i, n_trace=zero_i, n_failed=zero_i,
        n_resubmits=zero_i, overflow=zero_i,
        trace_t=full((TRACE_LEN,), INF),
        trace_kind=full((TRACE_LEN,), -1, torch.int32),
        trace_who=full((TRACE_LEN,), -1, torch.int32),
        host=HostCounts(n_reseeds=zero_i.clone(), strikes=strikes,
                        trace=trace, market=market, auction=auction,
                        plan=plan),
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
                     n_spec=i32(host.n_spec), n_reseeds=host.n_reseeds,
                     n_scans=i32(host.n_scans), host_syncs=host.syncs)


def _run(gridlets, fleet, params, n_users, max_events, max_jobs, batch,
         net_cap=0):
    state = init_state(gridlets, fleet, n_users, max_jobs=max_jobs,
                       params=params, net_cap=net_cap)
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
    are bit-for-bit identical for every k).  ``net_cap > 0`` enables the
    contention-aware network: payloads over finite links fair-share each
    resource's ``params.link_baud`` through up to ``net_cap`` transfer
    slots per link.  ``telemetry`` is not ported yet."""
    if telemetry:
        raise NotImplementedError("telemetry is not ported yet")
    dev = resolve_device(device)
    return _run(to_device(gridlets, dev), to_device(fleet, dev),
                to_device(params, dev), n_users, max_events, max_jobs,
                batch, net_cap)


def run_direct(gridlets, fleet, resource_idx, dispatch_time,
               max_events: int, reservations=None,
               batch: int = DEFAULT_BATCH, net_cap: int = 0,
               baud_rate=None, bg_flows=None, device="cuda") -> SimResult:
    """Broker-less mode: Gridlets are pre-routed into the fleet and the
    brokers stay inert -- the paper's Table 1 / Figs 9 and 12 scenario.
    ``resource_idx`` / ``dispatch_time`` broadcast to [N]; each gridlet
    arrives after its input transfer at the resource's baud rate -- or,
    with ``net_cap > 0``, after its fair share of the contended link
    (``baud_rate``/``bg_flows``, default ``fleet.baud_rate`` and 0) has
    moved the payload.  ``reservations`` books windows on the fleet (see
    :func:`default_params`)."""
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
    r64 = r.to(torch.int64)
    if net_cap:
        # Contending payloads hold their network-entry instant until the
        # NETWORK source tables them at exactly t0.
        t_ev = torch.where(
            network.link_tabled(gridlets.in_bytes, link_baud[r64]), t0,
            t0 + network.transfer_delay(gridlets.in_bytes, link_baud[r64]))
    else:
        t_ev = t0 + network.transfer_delay(gridlets.in_bytes,
                                           fleet.baud_rate[r64])
    g = replace(gridlets,
                status=torch.full((n,), IN_TRANSIT, dtype=torch.int32,
                                  device=dev),
                resource=r, assigned=r.clone(), t_event=t_ev)
    params = default_params(-1.0, 0.0, 0, 1, fleet.r,
                            reservations=reservations, link_baud=link_baud,
                            bg_flows=bg_flows, device=dev)
    return _run(g, fleet, params, 1, max_events, None, batch, net_cap)


def run_inner(gridlets, fleet, params: SimParams, n_users: int,
              max_events: int, max_jobs: int | None = None,
              batch: int = 1, net_cap: int = 0,
              telemetry: int | None = None, device="cuda") -> SimResult:
    """The per-scenario loop the reference runs under its sweeps'
    ``vmap``: :func:`run` at ``batch=1`` by default (the port's loop
    is already unjitted, so this is :func:`run` itself)."""
    return run(gridlets, fleet, params, n_users, max_events, max_jobs,
               batch=batch, net_cap=net_cap, telemetry=telemetry,
               device=device)


# ----------------------------------------------------------------------
# The lane-batched sweep engine: the scenario axis inside the loop
# ----------------------------------------------------------------------
#
# Every tensor leaf of the lane state -- the SimState, the slab carry,
# the per-user finished flags and the "how" counters -- carries a
# leading lane axis L, as in the reference's ``run_sweep_lanes``.  Each
# superstep piece runs once over all lanes: the scan and the frontier
# are the kernels' lane forms (one launch serves every lane), the
# per-lane tensor code runs under ``torch.func.vmap`` (each op batched
# by its own rule; the shared helpers are written out of place so that
# no op falls back to a loop over lanes), and a lane whose run ended is
# frozen by a ``torch.where`` over every leaf (:func:`_tree_where`).
# Where the reference branches on an any-lane predicate the host reads
# it once; where its select-free path proves both branches agree the
# piece runs unconditionally.  Ported for the default scenario sources
# (static pricing, analytic links, no failure streams, trace or
# windows): lanes may differ in deadline, budget, policy and every knob
# that only changes parameter values.

def _dataclass_pytree(cls, static=()):
    """Register a frozen dataclass with ``torch.utils._pytree``: its
    tensor fields are the children; ``static`` fields and fields that are
    None ride in the context."""
    names = tuple(f.name for f in dataclasses.fields(cls))

    def flatten(obj):
        kids = tuple(n for n in names if n not in static and
                     getattr(obj, n) is not None)
        return ([getattr(obj, n) for n in kids],
                (kids, {n: getattr(obj, n) for n in names if n not in kids}))

    def unflatten(children, context):
        kids, rest = context
        return cls(**dict(zip(kids, children)), **rest)

    pytree.register_pytree_node(cls, flatten, unflatten)


_dataclass_pytree(SimState, static=("host", "width"))
_dataclass_pytree(SimResult, static=("host_syncs",))
_dataclass_pytree(GridletBatch)
_dataclass_pytree(SimParams)


def _tree_map(fn, *trees):
    """``fn`` over the aligned tensor leaves of pytrees of one layout
    (contexts are not compared: a SimState's holds its HostCounts)."""
    leaves, spec = pytree.tree_flatten(trees[0])
    rest = [pytree.tree_flatten(t)[0] for t in trees[1:]]
    return pytree.tree_unflatten([fn(*xs) for xs in zip(leaves, *rest)],
                                 spec)


def _stack(trees):
    """Stack pytrees of one layout along a new leading lane axis."""
    return _tree_map(lambda *xs: torch.stack(xs), *trees)


def _lane(tree, i):
    """Lane ``i`` of a lane-batched pytree."""
    return _tree_map(lambda x: x[i], tree)


def _tree_where(pred, new, old):
    """Per-lane select over whole pytrees: ``pred`` is bool[L] and every
    leaf carries a leading lane axis (the reference's ``_tree_where``); a
    leaf that is the same tensor in both is kept as it is."""
    return _tree_map(lambda a, b: a if a is b else torch.where(
        pred.reshape(pred.shape + (1,) * (a.dim() - 1)), a, b), new, old)


def _vmap(fn, *args):
    """``fn`` over the lane axis of every argument, by vmap's batching
    rules (never a loop over lanes)."""
    return torch.func.vmap(fn)(*args)


def _check_lane_settings(params, net_cap, telemetry):
    """The sweep engine runs the default scenario sources only; every
    other lane setting raises until it is ported."""
    if telemetry:
        raise NotImplementedError("telemetry is not ported yet")
    if net_cap:
        raise NotImplementedError("the sweep engine's contended network "
                                  "(net_cap != 0) is not ported yet")
    if bool((params.mtbf > 0).any()):
        raise NotImplementedError("the sweep engine's failure streams are "
                                  "not ported yet")
    if params.fault_time is not None:
        raise NotImplementedError("the sweep engine's fault trace is not "
                                  "ported yet")
    if params.resv_res.shape[-1] > 0:
        raise NotImplementedError("the sweep engine's reservation windows "
                                  "are not ported yet")
    if bool((params.pricing_model != econ_mod.PRICE_STATIC).any()):
        raise NotImplementedError("the sweep engine's dynamic pricing is "
                                  "not ported yet")
    if bool(params.plan_ahead.any()):
        raise NotImplementedError("the sweep engine's plan-ahead broker is "
                                  "not ported yet")


def _scan_lanes(state, fleet, slab, reseed):
    """The checked scan over every lane at once (the kernel's lane form
    on the card, its plain version on the CPU).  ``reseed``: a lane
    whose carry went stale takes a fresh rank (the committing
    superstep); else every lane scans with its carried rank (the
    micro-steps, which decline instead).  Returns (rate [L, R_pad, J],
    t_min, argmin, occupancy [L, R_pad], rank [L, R_pad, J]) and use
    bool[L], whether each lane's carry held."""
    pad = state.row_gridlet.shape[1] - fleet.r
    npe, pol, blocked = state.host.lane_rows
    eff, row_ok = _vmap(lambda s: (
        _pad(calendar.effective_mips(fleet, s.t), pad, 1.0),
        _pad(s.res_up, pad, True).to(torch.float32)), state)
    # the kernel reads each lane's rows at lane * (row count): a leaf may
    # come out of vmap as a view with a wider lane stride
    args = (state.row_gridlet.contiguous(), state.g.remaining.contiguous(),
            eff.contiguous(), npe, pol, blocked, row_ok.contiguous(),
            slab[0].contiguous(), slab[1].contiguous())
    if state.t.device.type == "cuda":
        return _event_kernels.event_scan_checked_lanes_cuda(
            *args, reseed=reseed, scratch=state.host.scratch)
    return _event_kernels.event_scan_checked_lanes_ref(*args, reseed=reseed)


def _frontier_lanes(state, params, fleet, n_users, tmin=None):
    """The event frontier of every lane in one launch: over the sources'
    candidates (``tmin``, the scan's forecasts, given) or, without
    ``tmin``, over their horizon candidates (the speculation horizon)."""
    sizes = []

    def cands(s, p, tm):
        ctx = {} if tm is None else {"scan": (None, tm)}
        sources = _make_sources(fleet, p, n_users, ctx)
        out = [src.horizon_candidates(s) if tm is None else
               src.candidates(s) for src in sources]
        sizes[:] = [c.shape[0] for c in out]
        return torch.cat(out)

    if tmin is None:
        cand = _vmap(lambda s, p: cands(s, p, None), state, params)
    else:
        cand = _vmap(cands, state, params, tmin)
    cand = cand.contiguous()
    if cand.device.type == "cuda":
        return _event_kernels.event_frontier_lanes_cuda(
            cand, tuple(sizes), scratch=state.host.scratch)
    return _event_kernels.event_frontier_lanes_ref(cand, tuple(sizes))


def _complete_masked(state, fleet, params, ctx, now, sort_free):
    """COMPLETION's apply in the reference's select-free form (one lane,
    under vmap): the batch in ``ctx["completes"]`` leaves its slots, and
    freed space-shared PEs admit queued work with the free-PE budget
    masked to zero when no admission is due, ranked by the carried queue
    rank (``sort_free``: the micro-steps, whose gate guarantees it holds)
    or where it went stale a fresh one."""
    n_resources = fleet.r
    r_pad = state.row_gridlet.shape[0]
    completes, res = ctx["completes"], ctx["res"]
    state = _apply_completions(state, fleet, params, completes, now,
                               n_resources, r_pad)
    n_comp_r = segment_count(completes, res, n_resources)
    avail = fleet.num_pe - _reserved_pes(params, now, n_resources)
    free_pe = torch.clamp_min(avail - (ctx["scan"][3][:n_resources] -
                                       n_comp_r), 0)
    free_pe = torch.where((fleet.policy == SPACE_SHARED) & state.res_up,
                          free_pe, 0)
    ss_freed = completes & (fleet.policy[res] == SPACE_SHARED)
    pred = ss_freed.any() & (state.g.status == QUEUED).any()
    qr0, qok = ctx["qcarry"]
    qr = qr0 if sort_free else torch.where(
        qok, qr0, _queue_rank(state, fleet, n_resources))
    state, admitq = _admit_queued(state, fleet,
                                  torch.where(pred, free_pe, 0), now,
                                  n_resources, qr)
    n_admit_r = segment_count(admitq, res, n_resources)
    ctx["n_comp_r"] = n_comp_r
    ctx["qcarry"] = (qr - n_admit_r[res], qok | pred)
    ctx["free_pe"] = free_pe - n_admit_r
    ctx["newly"] = admitq
    ctx[("count", des.K_COMPLETION)] = completes.sum().to(torch.int32)
    return state


def _continue_lanes(fin, cnt, max_events):
    """:func:`_continue` per lane, on the device: bool[L]."""
    return ~fin.all(dim=1) & (cnt[0] + cnt[1] < max_events)


def _commit_lanes(state, fleet, params, n_users, slab, cnt, alive):
    """The committing superstep over every lane (the reference's
    ``_commit_lanes`` for the default sources).  Every lane runs the
    scan (a fresh rank only where its carry went stale), the frontier,
    the advance, COMPLETION and RETURN; BROKER runs over every lane when
    some live lane's poll fired, and a per-lane select keeps it only
    where it did (the reference's select-free ``broker_apply``); ARRIVAL
    runs when the broker ran or some live lane has an arrival due before
    it (``arr_pre``, taken before the broker: the ARRIVAL > BROKER
    tie-break), and otherwise is the identity.  Both predicates come
    back in one read.  Returns (state, slab, finished, counters)."""
    n_resources = fleet.r
    r_pad = state.row_gridlet.shape[1]
    host = state.host
    pos = {k: i for i, k in enumerate(des.PRIORITY_ORDER)}
    scan, use = _scan_lanes(state, fleet, slab, reseed=True)
    n_steps, n_spec, n_scans, n_reseeds = cnt
    cnt = (n_steps + 1, n_spec, n_scans + 1,
           n_reseeds + (~use).to(torch.int32))
    t_star, fired = _frontier_lanes(state, params, fleet, n_users,
                                    scan[1])[:2]

    def head(state, params, scan, slab, t_star):
        ctx = {"scan": scan, "qcarry": (slab[2], slab[3])}
        any_event = torch.isfinite(t_star)
        t_next = torch.where(any_event, t_star, state.t)
        state = _advance_jobs(state, ctx, t_next, any_event, n_resources)
        state = _complete_masked(state, fleet, params, ctx, t_next,
                                 sort_free=False)
        state, ret_due = _apply_returns(state, fleet, t_next, n_users,
                                        n_resources)
        g = state.g
        arr_pre = (g.status == IN_TRANSIT) & (g.t_event <= t_next)
        pack = {k: ctx[k] for k in ("qcarry", "free_pe", "newly",
                                    "n_comp_r")}
        pack["count"] = {des.K_COMPLETION: ctx[("count", des.K_COMPLETION)],
                         des.K_RETURN: ret_due.sum().to(torch.int32)}
        pack["who"] = {des.K_COMPLETION: ctx[("who", des.K_COMPLETION)],
                       des.K_RETURN: torch.argmax(
                           ret_due.to(torch.int32)).to(torch.int32)}
        return state, t_next, arr_pre, pack

    state, t_next, arr_pre, pack = _vmap(head, state, params, scan, slab,
                                         t_star)
    fired_b = fired[:, pos[des.K_BROKER]]
    broker_due, arrival_due = host.read_flags(torch.stack([
        (fired_b & alive).any(), (arr_pre & alive[:, None]).any()]))
    if broker_due:
        polled = _vmap(lambda s, p: broker_mod.broker_event(
            s, fleet, p, n_users), state, params)
        state = _tree_where(fired_b, polled, state)
    if broker_due or arrival_due:
        def arrive(state, params, t_next, arr_pre, pack):
            state, arr_due, arr_run, arr_queue = _apply_arrivals(
                state, fleet, params, pack["free_pe"], arr_pre, t_next,
                n_users, n_resources)
            qr, qok = pack["qcarry"]
            return state, dict(
                pack, newly=pack["newly"] | arr_run,
                qcarry=(qr, qok & ~arr_queue.any()),
                count={**pack["count"],
                       des.K_ARRIVAL: arr_due.sum().to(torch.int32)},
                who={**pack["who"], des.K_ARRIVAL: torch.argmax(
                    arr_due.to(torch.int32)).to(torch.int32)})

        state, pack = _vmap(arrive, state, params, t_next, arr_pre, pack)

    def tail(state, params, scan, t_next, fired, pack):
        ctx = dict(pack, scan=scan)
        state = _alloc_newly(state, ctx, n_resources, r_pad)
        counts = torch.stack([
            pack["count"].get(k, fired[i].to(torch.int32))
            for i, k in enumerate(des.PRIORITY_ORDER)])
        no_who = torch.full_like(t_next, -1, dtype=torch.int32)
        whos = torch.stack([pack["who"].get(k, no_who)
                            for k in des.PRIORITY_ORDER])
        kinds = torch.tensor(des.PRIORITY_ORDER, dtype=torch.int32,
                             device=t_next.device)
        state, finished = _bookkeep(state, fleet, params, n_users, kinds,
                                    counts, whos, t_next)
        return state, _slab_after(state, ctx, scan, False, fleet,
                                  n_resources, r_pad), finished

    state, slab, fin = _vmap(tail, state, params, scan, t_next, fired,
                             pack)
    return state, slab, fin, cnt


def _micro_lanes(state, fleet, params, n_users, t_safe, slab, fin, cnt,
                 alive):
    """One masked speculative micro-step over every lane (the
    reference's ``_sweep_micro``): the scan always injects the carried
    rank, and a lane fires only if its next batch lies strictly inside
    its horizon, its carry held, any space-shared admission can ride
    the carried queue rank, and it is still ``alive``; a lane that
    declines is a bitwise no-op.  Returns (state, fire bool[L], slab,
    finished, counters)."""
    n_resources = fleet.r
    r_pad = state.row_gridlet.shape[1]
    scan, use = _scan_lanes(state, fleet, slab, reseed=False)

    def one(state, params, scan, use, t_safe, slab, fin, alive):
        ctx = {"scan": scan, "qcarry": (slab[2], slab[3])}
        g = state.g
        tmin = scan[1].min()
        t_comp = torch.where(tmin < _BIG, state.t + tmin, INF)
        ret_due_at = torch.where(g.status == RETURNING, g.t_event, INF)
        t_next = torch.minimum(t_comp, ret_due_at.min())
        # would this batch need a space-shared admission? (the scan's
        # outputs are meaningless where the carry failed, but then
        # ``use`` already closes the gate)
        res = torch.clamp(g.resource.to(torch.int64), 0, n_resources - 1)
        j_cap = state.row_gridlet.shape[1]
        has_slot = (g.status == RUNNING) & (state.slot >= 0)
        rate = torch.where(has_slot, scan[0][res, torch.clamp(
            state.slot.to(torch.int64), 0, j_cap - 1)], 0.0)
        rel = torch.where(has_slot,
                          g.remaining / torch.clamp_min(rate, 1e-30), INF)
        would_c = has_slot & (state.t + rel <= t_next)
        pred_admit = ((would_c & (fleet.policy[res] == SPACE_SHARED)).any()
                      & (g.status == QUEUED).any())
        fire = (torch.isfinite(t_next) & (t_next < t_safe) & use & alive &
                (slab[3] | ~pred_admit) & ~fin.all())
        t_eff = torch.where(fire, t_next, state.t)
        state = _advance_jobs(state, ctx, t_eff, fire, n_resources)
        state = _complete_masked(state, fleet, params, ctx, t_eff,
                                 sort_free=True)
        state, ret_due = _apply_returns(state, fleet, t_eff, n_users,
                                        n_resources, gate=fire)
        state = _alloc_newly(state, ctx, n_resources, r_pad)
        kinds = torch.tensor([des.K_COMPLETION, des.K_RETURN],
                             dtype=torch.int32, device=t_eff.device)
        counts = torch.stack([ctx[("count", des.K_COMPLETION)],
                              ret_due.sum().to(torch.int32)])
        whos = torch.stack([ctx[("who", des.K_COMPLETION)].to(torch.int32),
                            torch.argmax(ret_due.to(torch.int32)).to(
                                torch.int32)])
        state, fin = _bookkeep(state, fleet, params, n_users, kinds, counts,
                               whos, t_eff)
        n_comp_r = _pad(ctx["n_comp_r"], r_pad - n_resources, 0)
        slab = (scan[4] - n_comp_r[:, None].to(torch.float32), slab[1],
                *ctx["qcarry"])
        return state, fire, slab, fin

    state, fire, slab, fin = _vmap(one, state, params, scan, use, t_safe,
                                   slab, fin, alive)
    n_steps, n_spec, n_scans, n_reseeds = cnt
    return state, fire, slab, fin, (n_steps, n_spec + fire.to(torch.int32),
                                    n_scans + alive.to(torch.int32),
                                    n_reseeds)


def _step_sweep_lanes(state, fleet, params, n_users, batch, slab, fin, cnt,
                      alive, max_events):
    """One lane-batched loop iteration: the committing superstep, then
    up to ``batch - 1`` masked micro-steps, which stop once every lane
    declined (a declined micro-step is a bitwise no-op, counters
    included, so running one past the last that fired changes no
    result).  ``alive`` seeds the micro-steps' gates, so a frozen lane
    never keeps the loop going.  The host reads, in one sync, whether
    any lane fired and whether any lane goes on to the next iteration
    after micro-steps 1, 3, 7, ... and the last: at most
    ceil(log2(batch)) reads an iteration, however many lanes keep
    firing.  Returns (state, slab, finished, counters, the lanes that
    go on bool[L], whether any does)."""
    host = state.host
    state, slab, fin, cnt = _commit_lanes(state, fleet, params, n_users,
                                          slab, cnt, alive)
    if batch <= 1:
        going = alive & _continue_lanes(fin, cnt, max_events)
        return state, slab, fin, cnt, going, host.read(going.any())
    t_safe = _frontier_lanes(state, params, fleet, n_users)[3]
    fire = alive
    for k in range(1, batch):
        state, fire, slab, fin, cnt = _micro_lanes(
            state, fleet, params, n_users, t_safe, slab, fin, cnt, fire)
        if k & (k + 1) and k < batch - 1:     # not 1, 3, 7, ... nor last
            continue
        going = alive & _continue_lanes(fin, cnt, max_events)
        more, any_going = host.read_flags(torch.stack([fire.any(),
                                                       going.any()]))
        if not more:
            break
    return state, slab, fin, cnt, going, any_going


def _finalize_lanes(state, cnt) -> SimResult:
    """:func:`_finalize` over the lane axis, with the per-lane counters."""
    t = state.t[:, None]
    term = torch.where(torch.isfinite(state.term_time), state.term_time, t)
    downtime = state.downtime + torch.where(state.res_up, 0.0,
                                            t - state.fail_since)
    return SimResult(gridlets=state.g, spent=state.spent, term_time=term,
                     n_events=state.n_events,
                     trace=(state.trace_t, state.trace_kind,
                            state.trace_who),
                     n_steps=cnt[0], overflow=state.overflow,
                     n_failed=state.n_failed,
                     n_resubmits=state.n_resubmits, downtime=downtime,
                     n_spec=cnt[1], n_reseeds=cnt[3], n_scans=cnt[2],
                     host_syncs=state.host.syncs)


def run_sweep_lanes(gridlets, fleet, params: SimParams, n_users: int,
                    max_events: int, max_jobs: int | None = None,
                    batch: int = DEFAULT_BATCH, net_cap: int = 0,
                    telemetry: int | None = None,
                    device="cuda") -> SimResult:
    """The lane-batched sweep engine: one scenario per lane of
    ``params`` (every leaf carries a leading lane axis L, e.g.
    ``simulation._lane_points`` or ``convert.params`` of the reference's
    lane-stacked params), with the lane axis inside the loop.  Each
    superstep piece serves every lane in one pass; lanes that finished
    are frozen.  Every lane is bit for bit its own :func:`run`, and the
    "how" counters (``n_steps``/``n_spec``/``n_scans``/``n_reseeds``,
    now [L]) are the reference's ``run_sweep_lanes``'.  The result's
    leaves carry the lane axis; ``host_syncs`` counts the whole run's
    reads.  Raises ``NotImplementedError`` for a lane setting not ported
    yet (failure streams, a fault trace, reservation windows, dynamic
    pricing, plan-ahead, ``net_cap != 0``, telemetry)."""
    dev = resolve_device(device)
    _check_lane_settings(params, net_cap, telemetry)
    gridlets, fleet = to_device(gridlets, dev), to_device(fleet, dev)
    params = to_device(params, dev)
    n_lanes = params.deadline.shape[0]
    states = [init_state(gridlets, fleet, n_users, max_jobs=max_jobs,
                         params=_lane(params, i)) for i in range(n_lanes)]
    state = _stack(states)
    host = state.host
    # the scan's row inputs that are the same in every lane: PEs, policy,
    # and no PE reserved (the sweep engine runs no window)
    r_pad = state.row_gridlet.shape[1]
    host.lane_rows = tuple(
        x.to(torch.float32).expand(n_lanes, r_pad).contiguous()
        for x in (_pad(fleet.num_pe, r_pad - fleet.r, 1),
                  _pad(fleet.policy, r_pad - fleet.r, 0),
                  fleet.num_pe.new_zeros((r_pad,))))
    slab = _stack([_empty_slab(s) for s in states])
    fin = _vmap(lambda s, p: _user_flags(s, p, fleet, n_users)[1], state,
                params)
    zero = torch.zeros((n_lanes,), dtype=torch.int32, device=dev)
    cnt = (zero, zero, zero, zero)
    alive = _continue_lanes(fin, cnt, max_events)
    going = host.read(alive.any())
    while going:
        out = _step_sweep_lanes(state, fleet, params, n_users, batch, slab,
                                fin, cnt, alive, max_events)
        state, slab, fin, cnt = _tree_where(alive, out[:4],
                                            (state, slab, fin, cnt))
        alive, going = out[4:]
    return _finalize_lanes(state, cnt)


def run_sweep(gridlets, fleet, params: SimParams, n_users: int,
              max_events: int, max_jobs: int | None = None,
              batch: int = DEFAULT_BATCH, net_cap: int = 0,
              telemetry: int | None = None, device="cuda") -> SimResult:
    """The select-free sweep engine over one scenario:
    :func:`run_sweep_lanes` with a single lane (``params`` without a lane
    axis; the result has none either).  Bit for bit :func:`run`; the
    "how" counters are the reference's ``run_sweep``'s."""
    res = run_sweep_lanes(gridlets, fleet, _stack([params]), n_users,
                          max_events, max_jobs, batch=batch,
                          net_cap=net_cap, telemetry=telemetry,
                          device=device)
    return dataclasses.replace(_lane(res, 0), host_syncs=res.host_syncs)
