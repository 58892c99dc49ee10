"""Grid resource fleet (port of ``repro.core.resource``).

One struct-of-arrays table, shape [R] everywhere; the paper's Table 2
constants are this module's own copy.
"""
from __future__ import annotations

import dataclasses

import torch

from .types import FCFS, SPACE_SHARED, TIME_SHARED


@dataclasses.dataclass(frozen=True)
class Fleet:
    """All per-resource state. Shape [R] everywhere."""

    num_pe: torch.Tensor        # i32
    mips_per_pe: torch.Tensor   # f32: SPEC/MIPS rating of one PE
    cost_per_sec: torch.Tensor  # f32: G$ per PE-time-unit
    policy: torch.Tensor        # i32: TIME_SHARED | SPACE_SHARED
    queue_policy: torch.Tensor  # i32: FCFS | SJF (space-shared only)
    time_zone: torch.Tensor     # f32: hours offset
    base_load: torch.Tensor     # f32: [0,1) background load factor
    weekend_load: torch.Tensor  # f32: additional weekend load factor
    baud_rate: torch.Tensor     # f32: bytes / time-unit to+from resource

    @property
    def r(self) -> int:
        return self.num_pe.shape[0]

    @property
    def max_pe(self) -> int:
        return int(self.num_pe.max())

    def peak_rate(self) -> torch.Tensor:
        """Aggregate advertised MIPS per resource."""
        return self.mips_per_pe * self.num_pe.to(torch.float32)

    def cost_per_mi(self) -> torch.Tensor:
        """G$ per MI -- the broker's resource-trading metric (Table 2)."""
        return self.cost_per_sec / self.mips_per_pe


def make_fleet(num_pe, mips_per_pe, cost_per_sec, policy,
               queue_policy=None, time_zone=None, base_load=None,
               weekend_load=None, baud_rate=None, device="cpu") -> Fleet:
    num_pe = torch.as_tensor(num_pe, dtype=torch.int32, device=device)
    r = num_pe.shape[0]

    def arr(x, default, dtype=torch.float32):
        if x is None:
            x = default
        return torch.as_tensor(x, dtype=dtype, device=device).broadcast_to(
            (r,)).clone()

    return Fleet(
        num_pe=num_pe,
        mips_per_pe=arr(mips_per_pe, None),
        cost_per_sec=arr(cost_per_sec, None),
        policy=arr(policy, None, torch.int32),
        queue_policy=arr(queue_policy, FCFS, torch.int32),
        time_zone=arr(time_zone, 0.0),
        base_load=arr(base_load, 0.0),
        weekend_load=arr(weekend_load, 0.0),
        baud_rate=arr(baud_rate, 9600.0),  # GridSimTags.DEFAULT_BAUD_RATE
    )


# Paper Table 2: the WWG testbed fleet used in every section-5 experiment.
# (name, PEs, SPEC/MIPS rating, manager type, G$/PE-time-unit)
WWG_TABLE2 = [
    ("R0", 4, 515, TIME_SHARED, 8.0),    # Compaq AlphaServer, VPAC Melbourne
    ("R1", 4, 377, TIME_SHARED, 4.0),    # Sun Ultra, AIST Tokyo
    ("R2", 4, 377, TIME_SHARED, 3.0),    # Sun Ultra, AIST Tokyo
    ("R3", 2, 377, TIME_SHARED, 3.0),    # Sun Ultra, AIST Tokyo
    ("R4", 2, 380, TIME_SHARED, 2.0),    # Intel VC820, CNR Pisa
    ("R5", 6, 410, TIME_SHARED, 5.0),    # SGI Origin 3200, ZIB Berlin
    ("R6", 16, 410, TIME_SHARED, 5.0),   # SGI Origin 3200, ZIB Berlin
    ("R7", 16, 410, SPACE_SHARED, 4.0),  # SGI Origin 3200, Charles U Prague
    ("R8", 2, 380, TIME_SHARED, 1.0),    # Intel VC820, Portsmouth UK
    ("R9", 4, 410, TIME_SHARED, 6.0),    # SGI Origin 3200, Manchester UK
    ("R10", 8, 377, TIME_SHARED, 3.0),   # Sun Ultra, ANL Chicago
]

WWG_TIME_ZONES = [10.0, 9.0, 9.0, 9.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0, -6.0]


def wwg_fleet(baud_rate: float = 28000.0, device="cpu") -> Fleet:
    """The simulated WWG testbed of paper Table 2."""
    return make_fleet(
        num_pe=[x[1] for x in WWG_TABLE2],
        mips_per_pe=[float(x[2]) for x in WWG_TABLE2],
        cost_per_sec=[x[4] for x in WWG_TABLE2],
        policy=[x[3] for x in WWG_TABLE2],
        time_zone=WWG_TIME_ZONES,
        baud_rate=baud_rate,
        device=device,
    )


def table1_resource(policy: int, device="cpu") -> Fleet:
    """The 2-PE, 1-MIPS resource of paper Table 1 / Figs 9 and 12."""
    return make_fleet(num_pe=[2], mips_per_pe=1.0, cost_per_sec=1.0,
                      policy=policy, baud_rate=float("inf"), device=device)
