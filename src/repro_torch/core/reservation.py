"""Advance reservation (paper feature list: "Resources can be booked";
port of ``repro.core.reservation``).

Two layers, as in the reference:

* ``ReservationBook`` -- the booking calendar with conflict detection,
  pure Python.  Drivers book here, then export with
  :meth:`ReservationBook.as_tables` / :func:`as_tables`.
* tensor helpers over the exported ``(resource, pes, start, end)``
  tables (i32 / i32 / f32 / f32, shape ``[K]`` each, ``K`` may be 0).
  The engine's RESERVATION source wakes the loop at every window
  boundary (:func:`boundary_candidates`) and subtracts the PEs held
  *now* (:func:`active_pes`) from what the ``[R, J]`` job-slot table
  exposes: time-shared rows share out only the unreserved PEs, and
  space-shared rows admit only onto them.  Windows are half-open
  ``[start, end)``.  Reservations gate *admission*: jobs running when a
  window opens are not preempted.
"""
from __future__ import annotations

import bisect
import dataclasses
import itertools
from typing import List

import torch


@dataclasses.dataclass(frozen=True)
class Reservation:
    rid: int
    resource: int
    pes: int
    start: float
    end: float
    user: int = 0


class ReservationBook:
    """Per-resource booking calendar with conflict detection."""

    def __init__(self, num_pe: List[int]):
        self.num_pe = [int(p) for p in num_pe]
        self._by_resource: List[List[Reservation]] = \
            [[] for _ in self.num_pe]
        self._ids = itertools.count()

    def peak_usage(self, resource: int, start: float, end: float) -> int:
        """Most PEs booked at once over [start, end)."""
        events = []
        for r in self._by_resource[resource]:
            if r.end <= start or r.start >= end:
                continue
            events.append((max(r.start, start), r.pes))
            events.append((min(r.end, end), -r.pes))
        events.sort()
        peak = cur = 0
        for _, d in events:
            cur += d
            peak = max(peak, cur)
        return peak

    def book(self, resource: int, pes: int, start: float,
             end: float, user: int = 0) -> Reservation:
        if not 0 <= resource < len(self.num_pe):
            raise ValueError(f"no such resource {resource}")
        if pes <= 0 or end <= start:
            raise ValueError("reservation must hold >0 PEs over >0 time")
        if self.peak_usage(resource, start, end) + pes \
                > self.num_pe[resource]:
            raise ValueError("reservation conflict: not enough free PEs")
        res = Reservation(next(self._ids), resource, pes, start, end, user)
        bisect.insort(self._by_resource[resource], res,
                      key=lambda r: r.start)
        return res

    def cancel(self, res: Reservation) -> None:
        self._by_resource[res.resource].remove(res)

    def reserved_pes(self, resource: int, t: float) -> int:
        return sum(r.pes for r in self._by_resource[resource]
                   if r.start <= t < r.end)

    def load_factor(self, resource: int, t: float) -> float:
        """Reservation-induced load for calendar.effective_mips."""
        return self.reserved_pes(resource, t) / max(self.num_pe[resource], 1)

    def book_maintenance(self, resource: int, start: float,
                         end: float) -> Reservation:
        """Hold every PE of ``resource`` over [start, end): planned
        downtime, conflict-checked like any booking."""
        return self.book(resource, self.num_pe[resource], start, end)

    def as_tables(self, device="cpu"):
        """Every booking as the engine's (res, pes, start, end) tables,
        ordered by (start, booking id)."""
        rows = sorted((r for per in self._by_resource for r in per),
                      key=lambda r: (r.start, r.rid))
        return as_tables([(r.resource, r.pes, r.start, r.end)
                          for r in rows], device=device)


def as_tables(bookings, device="cpu"):
    """(resource, pes, start, end) tuples -> i32/i32/f32/f32 [K]."""
    bookings = list(bookings or [])

    def col(i, dtype):
        return torch.tensor([b[i] for b in bookings], dtype=dtype,
                            device=device)

    return (col(0, torch.int32), col(1, torch.int32),
            col(2, torch.float32), col(3, torch.float32))


def empty_tables(device="cpu"):
    """The K = 0 table (no reservations, the default)."""
    return as_tables([], device=device)


def maintenance(num_pe, windows):
    """Maintenance windows as booking tuples: each ``(resource, start,
    end)`` holds ALL PEs of its resource over [start, end).  ``num_pe``
    is the fleet's per-resource PE count (a tensor or a list); combine
    with other bookings by concatenating the lists."""
    pes = [int(p) for p in num_pe]
    return [(int(r), pes[int(r)], float(s), float(e))
            for r, s, e in windows]


def active_pes(resv_res, resv_pes, resv_start, resv_end, t,
               n_resources: int):
    """PEs held by the windows open at ``t``: i32[R] (an integer segment
    sum, exact in any order; K = 0 gives zeros).  At ``t == end`` the PEs
    are free again."""
    active = (resv_start <= t) & (t < resv_end)
    res = torch.clamp(resv_res.to(torch.int64), 0, n_resources - 1)
    held = torch.zeros(n_resources, dtype=torch.int32,
                       device=resv_pes.device)
    return held.index_add_(0, res, torch.where(active, resv_pes, 0).to(
        torch.int32))


def boundary_candidates(resv_start, resv_end, t):
    """Window open/close instants strictly after ``t``, f32[2K] (+inf
    where passed): the RESERVATION source's candidates."""
    cand = torch.cat([resv_start, resv_end])
    return torch.where(cand > t, cand, float("inf"))


def next_boundary(resv_start, resv_end, t):
    """Earliest window boundary strictly after ``t`` (+inf when none
    remains, e.g. for K = 0)."""
    cand = boundary_candidates(resv_start, resv_end, t)
    inf = torch.full((1,), float("inf"), dtype=torch.float32,
                     device=cand.device)
    return torch.cat([cand, inf]).min()
