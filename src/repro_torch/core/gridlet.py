"""Gridlet batches (port of ``repro.core.gridlet``): one fixed-capacity
struct-of-arrays table holds every Gridlet of every user."""
from __future__ import annotations

import dataclasses

import torch

from . import rand
from .types import CREATED, INF


@dataclasses.dataclass(frozen=True)
class GridletBatch:
    """All per-gridlet state. Shape [N] everywhere."""

    # --- immutable description (gridsim.Gridlet fields) ---
    length_mi: torch.Tensor      # f32: processing requirement in MI
    in_bytes: torch.Tensor       # f32: input file size
    out_bytes: torch.Tensor      # f32: output file size
    user: torch.Tensor           # i32: originating user entity
    created: torch.Tensor        # f32: submission time at the broker

    # --- mutable lifecycle state (gridsim.ResGridlet fields) ---
    status: torch.Tensor         # i32: types.CREATED .. FAILED
    resource: torch.Tensor       # i32: assigned resource (-1 = none)
    assigned: torch.Tensor       # i32: broker's planned resource
    remaining: torch.Tensor      # f32: remaining MI
    t_event: torch.Tensor        # f32: pending arrival/return instant
    start: torch.Tensor          # f32: first execution instant
    finish: torch.Tensor         # f32: completion instant
    returned: torch.Tensor       # f32: instant the result reached the broker
    cost: torch.Tensor           # f32: committed processing cost (G$)
    n_retries: torch.Tensor      # i32: times failed+refunded
    retry_at: torch.Tensor       # f32: earliest re-dispatch instant

    @property
    def n(self) -> int:
        return self.length_mi.shape[0]


def make_batch(length_mi, in_bytes=None, out_bytes=None, user=None,
               created=None, device="cpu") -> GridletBatch:
    length_mi = torch.as_tensor(length_mi, dtype=torch.float32,
                                device=device)
    dev = length_mi.device
    n = length_mi.shape[0]

    def arr(x, default, dtype=torch.float32):
        if x is None:
            return default
        return torch.as_tensor(x, dtype=dtype, device=dev).broadcast_to(
            (n,)).clone()

    def full(v, dtype=torch.float32):
        return torch.full((n,), v, dtype=dtype, device=dev)

    return GridletBatch(
        length_mi=length_mi,
        in_bytes=arr(in_bytes, full(0.0)),
        out_bytes=arr(out_bytes, full(0.0)),
        user=arr(user, full(0, torch.int32), torch.int32),
        created=arr(created, full(0.0)),
        status=full(CREATED, torch.int32),
        resource=full(-1, torch.int32),
        assigned=full(-1, torch.int32),
        remaining=length_mi.clone(),
        t_event=full(INF),
        start=full(INF),
        finish=full(INF),
        returned=full(INF),
        cost=full(0.0),
        n_retries=full(0, torch.int32),
        retry_at=full(0.0),
    )


def task_farm(gen: torch.Generator, n_jobs: int, n_users: int = 1,
              base_mi: float = 10_000.0, noise: float = 0.10,
              in_bytes: float = 0.0, out_bytes: float = 0.0,
              device="cpu") -> GridletBatch:
    """Paper section 5.2 application model: ``n_jobs`` Gridlets per
    user, each ``base_mi`` MI plus a 0..``noise`` positive variation
    drawn from ``gen``."""
    n = n_jobs * n_users
    mi = rand.real(gen, torch.full((n,), base_mi, dtype=torch.float32,
                                   device=device), 0.0, noise)
    user = torch.repeat_interleave(
        torch.arange(n_users, dtype=torch.int32, device=device), n_jobs)
    return make_batch(mi, in_bytes=in_bytes, out_bytes=out_bytes,
                      user=user, device=device)
