"""Discrete-event primitives (port of ``repro.core.des``): the
:class:`FnSource` event-source contract the superstep engine enumerates
its event kinds through, and the fixed-capacity array calendar
(:class:`EventQueue`).

A source exposes ``candidates(state) -> f32[C]`` (its pending instants,
+inf where nothing is pending), ``apply(state, now)`` (apply every event
of its kind due by ``now``; the identity when nothing is due) and the
speculation-safety hook ``horizon_candidates(state)``.  Trace codes
double as the tie-break priority; see ``PRIORITY_ORDER``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .types import INF

K_COMPLETION = 0    # forecast completion materialises
K_RETURN = 1        # processed Gridlet reaches its broker
K_ARRIVAL = 2       # dispatched Gridlet reaches its resource
K_BROKER = 3        # periodic broker scheduling event
K_FAILURE = 4       # resource goes down (MTBF stream)
K_RECOVERY = 5      # resource comes back up (MTTR stream)
K_RESERVATION = 6   # advance-reservation window opens/closes
K_CALENDAR = 7      # local load calendar step (weekend boundary)
K_NETWORK = 8       # fair-share link event
K_MARKET = 9        # commodity-market repricing round
K_AUCTION = 10      # sealed-bid auction/tender round
K_TRACE = 11        # trace-driven fault-injection step

# Tie-break order among sources due at the same instant.
PRIORITY_ORDER = (K_COMPLETION, K_FAILURE, K_RECOVERY, K_TRACE,
                  K_RESERVATION, K_MARKET, K_AUCTION, K_NETWORK,
                  K_RETURN, K_ARRIVAL, K_CALENDAR, K_BROKER)


def no_interference(state, t_max):
    """``horizon_fn`` for speculation-safe sources (COMPLETION, RETURN):
    never cuts the speculation horizon."""
    return INF


def tree_select(pred, on_true, on_false):
    """``torch.where(pred, ...)`` over every tensor field of a pair of
    dataclasses of the same type (fields that are not tensors must be
    equal and are taken from ``on_true``)."""
    out = {}
    for f in dataclasses.fields(on_true):
        a, b = getattr(on_true, f.name), getattr(on_false, f.name)
        if dataclasses.is_dataclass(a):
            out[f.name] = tree_select(pred, a, b)
        elif isinstance(a, torch.Tensor):
            out[f.name] = torch.where(pred, a, b)
        else:
            out[f.name] = a
    return dataclasses.replace(on_true, **out)


@dataclasses.dataclass(frozen=True)
class FnSource:
    """An event source built from closures (see the module docstring).
    ``horizon_fn`` set to :func:`no_interference` declares the source
    speculation-safe; ``horizon_candidates_fn`` supplies a per-stream
    vector; the default is every candidate cuts (conservative)."""
    kind: int
    name: str
    candidates_fn: Callable
    apply_fn: Callable
    horizon_fn: Callable | None = None
    horizon_candidates_fn: Callable | None = None

    def candidates(self, state) -> torch.Tensor:
        """Pending instants f32[C], +inf-padded (C may be 0)."""
        return torch.atleast_1d(self.candidates_fn(state))

    def next_time(self, state) -> torch.Tensor:
        """Earliest pending instant (+inf when none)."""
        c = self.candidates(state)
        if c.shape[0]:
            return c.min()
        return torch.tensor(INF, dtype=torch.float32, device=c.device)

    def apply(self, state, now):
        return self.apply_fn(state, now)

    def masked_apply(self, state, now, fire):
        """Bitwise ``apply`` when ``fire`` is True, bitwise identity
        when False."""
        return tree_select(fire, self.apply_fn(state, now), state)

    def horizon_candidates(self, state) -> torch.Tensor:
        """Instants at which this source could interfere with
        speculative batching; empty for speculation-safe sources."""
        if self.horizon_fn is no_interference:
            return state.t.new_zeros((0,))
        if self.horizon_candidates_fn is not None:
            return torch.atleast_1d(self.horizon_candidates_fn(state))
        if self.horizon_fn is not None:
            return torch.as_tensor(self.horizon_fn(state, INF),
                                   dtype=torch.float32).reshape(1)
        return self.candidates(state)

    def horizon(self, state, t_max):
        """Scalar wrapper over :meth:`horizon_candidates`."""
        if self.horizon_fn is not None:
            return self.horizon_fn(state, t_max)
        c = self.horizon_candidates(state)
        return c.min() if c.shape[0] else torch.full_like(state.t, INF)


@dataclasses.dataclass(frozen=True)
class EventQueue:
    time: torch.Tensor      # f32[C], INF = free slot
    src: torch.Tensor       # i32[C]
    dst: torch.Tensor       # i32[C]
    tag: torch.Tensor       # i32[C]
    data: torch.Tensor      # f32[C, K]
    seq: torch.Tensor       # i32[C] FIFO tiebreak among equal timestamps
    next_seq: torch.Tensor  # i32[]
    overflow: torch.Tensor  # i32[] events dropped on a full calendar

    @property
    def capacity(self) -> int:
        return self.time.shape[0]


def make_queue(capacity: int, payload: int = 1, device="cpu") -> EventQueue:
    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return EventQueue(
        time=torch.full((capacity,), INF, dtype=torch.float32,
                        device=device),
        src=z(capacity), dst=z(capacity), tag=z(capacity),
        data=z(capacity, payload, dtype=torch.float32),
        seq=z(capacity), next_seq=z(), overflow=z())


def schedule(q: EventQueue, time, src, dst, tag, data=None) -> EventQueue:
    """sim_schedule: place one event in the first free slot.  A full
    calendar drops the event and increments ``overflow``."""
    free = ~torch.isfinite(q.time)
    has_free = free.any()
    slot = torch.argmax(free.to(torch.int32))
    dev = q.time.device
    k = q.data.shape[1]
    data = torch.zeros((k,), dtype=torch.float32, device=dev) \
        if data is None else torch.as_tensor(
            data, dtype=torch.float32, device=dev).reshape(k)

    def put(arr, value, dtype):
        new = arr.clone()
        new[slot] = torch.as_tensor(value, dtype=dtype, device=dev)
        return torch.where(has_free, new, arr)

    return EventQueue(
        time=put(q.time, time, torch.float32),
        src=put(q.src, src, torch.int32),
        dst=put(q.dst, dst, torch.int32),
        tag=put(q.tag, tag, torch.int32),
        data=put(q.data, data, torch.float32),
        seq=put(q.seq, q.next_seq, torch.int32),
        next_seq=q.next_seq + 1,
        overflow=q.overflow + (~has_free).to(torch.int32))


def peek_time(q: EventQueue) -> torch.Tensor:
    return q.time.min()


def size(q: EventQueue) -> torch.Tensor:
    return torch.isfinite(q.time).sum()


def pop_next(q: EventQueue):
    """Remove + return the earliest event (FIFO among ties).  Returns
    (queue', (time, src, dst, tag, data, valid)); ``valid`` is False
    when the calendar is empty."""
    tmin = q.time.min()
    at_min = q.time == tmin
    seq_key = torch.where(at_min, q.seq, torch.iinfo(torch.int32).max)
    slot = torch.argmin(seq_key)
    valid = torch.isfinite(tmin)
    ev = (q.time[slot], q.src[slot], q.dst[slot], q.tag[slot],
          q.data[slot], valid)
    time = q.time.clone()
    time[slot] = INF
    return dataclasses.replace(q, time=time), ev


def cancel(q: EventQueue, predicate) -> EventQueue:
    """Discard events matching a mask (the paper's stale-internal-event
    rule for user-defined entities)."""
    mask = predicate(q)
    return dataclasses.replace(q, time=torch.where(mask, INF, q.time))
