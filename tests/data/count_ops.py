"""Count the PyTorch operations the port dispatches for a reference cell,
on the CPU: each operation is one kernel launch on the card, so the
count per superstep says what a change costs the host loop without a
card, and two trees give equal counts when they run the same program.

Run from the repo root (or from a copy of this file placed at the same
path in another tree, to count that tree):

    PYTHONPATH=src python tests/data/count_ops.py [--max-events N] CELL...

CELL names a cell of chip_smoke.py's CELLS (e.g. 20u_100j,
4u_25j_fail, 20u_100j_resv).  For each cell it prints the operations,
supersteps (committing + speculative), committing supersteps and host
syncs of the run (the first N supersteps with --max-events), and the
operations a superstep by the port function that dispatched them.
"""
import argparse
import collections
import os
import sys
import traceback

from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (puts the tree's src on the path)


class Count(TorchDispatchMode):
    """Counts dispatched operations, and by the innermost port frame."""

    def __init__(self):
        super().__init__()
        self.by_fn = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        for fr in reversed(traceback.extract_stack(limit=12)):
            if "repro_torch" in fr.filename:
                key = f"{os.path.basename(fr.filename)}:{fr.name}"
                self.by_fn[key] += 1
                break
        else:
            self.by_fn["(other)"] += 1
        return func(*args, **(kwargs or {}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("cells", nargs="+")
    ap.add_argument("--max-events", type=int, default=None)
    ap.add_argument("--top", type=int, default=8)
    a = ap.parse_args()
    from repro_torch.core import simulation
    cells = chip_smoke.load_cells("cpu")
    for name in a.cells:
        c, g, fleet = cells[name]
        kw = chip_smoke.experiment_kwargs(c, "cpu")
        if a.max_events is not None:
            kw["max_events"] = a.max_events
        with Count() as m:
            res = simulation.run_experiment(g, fleet, c["deadline"],
                                            c["budget"], **kw)
        steps = int(res.n_steps) + int(res.n_spec)
        ops = sum(m.by_fn.values())
        print(f"{name}: {ops} operations, {steps} supersteps "
              f"({int(res.n_steps)} committing), {ops / steps:.1f} a "
              f"superstep, host syncs {res.host_syncs}")
        for fn, n in m.by_fn.most_common(a.top):
            print(f"  {fn:40s} {n / steps:8.2f} a superstep")


if __name__ == "__main__":
    main()
