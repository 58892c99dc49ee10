"""Regenerate tests/data/port_ref_main.json -- the reference results the
PyTorch port is held against on the main path.

Run from the repo root with the JAX reference on the CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/data/gen_port_ref.py

Three cells of ``benchmarks/engine_bench.py``: 1u_200j and 20u_100j on
the WWG fleet, 4u_512j on the deep 2 x 80-PE fleet; gridlets from
``task_farm(PRNGKey(3))``, cost optimisation, the engine's default
batch.  Every float (inputs and results) is stored as its uint32 bit
pattern, so the comparison is bitwise and needs no JAX.
"""
import json
import os

import jax
import numpy as np

from repro.core import engine, gridlet, resource, simulation, types

OUT = os.path.join(os.path.dirname(__file__), "port_ref_main.json")

CELLS = (
    # name, n_users, n_jobs_per_user, fleet, deadline, budget
    ("1u_200j", 1, 200, "wwg", 2000.0, 22000.0),
    ("20u_100j", 20, 100, "wwg", 2000.0, 22000.0),
    ("4u_512j", 4, 512, "deep_2x80pe", 2000.0, 500000.0),
)


def _fleet(name):
    if name == "wwg":
        return resource.wwg_fleet()
    return resource.make_fleet([80, 80], [100.0, 120.0], [1.0, 2.0],
                               types.TIME_SHARED)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32).ravel().tolist()


def _ints(x):
    return np.asarray(x).astype(np.int64).ravel().tolist()


def cell(name, n_users, n_jobs, fleet_name, deadline, budget):
    """``simulation.run_experiment`` spelled out (the same params, event
    budget, job-slot width and batch) so the engine's trace is kept."""
    fleet = _fleet(fleet_name)
    g = gridlet.task_farm(jax.random.PRNGKey(3), n_jobs=n_jobs,
                          n_users=n_users)
    params = simulation._scenario_params(fleet, deadline, budget,
                                         types.OPT_COST, n_users, None)
    max_events = simulation._max_events(g.n, n_users,
                                        deadline * 2.0 + 100.0, 1.0)
    res = engine.run(g, fleet, params, n_users, max_events,
                     max_jobs=simulation.safe_max_jobs(g, params, fleet))
    r = simulation.summarize(res, params, n_users, fleet.r, max_events)
    tt, kind, who = (np.asarray(x) for x in res.trace)
    out = r.gridlets
    return {
        "n_users": n_users, "n_jobs_per_user": n_jobs,
        "deadline": deadline, "budget": budget, "opt": types.OPT_COST,
        "batch": engine.DEFAULT_BATCH,
        "fleet": {
            "name": fleet_name,
            "num_pe": _ints(fleet.num_pe),
            "mips_per_pe": _bits(fleet.mips_per_pe),
            "cost_per_sec": _bits(fleet.cost_per_sec),
            "policy": _ints(fleet.policy),
            "time_zone": _bits(fleet.time_zone),
            "baud_rate": _bits(fleet.baud_rate),
        },
        "length_mi": _bits(g.length_mi),
        "result": {
            "n_done": _bits(r.n_done),
            "spent": _bits(r.spent),
            "term_time": _bits(r.term_time),
            "per_resource_done": _bits(r.per_resource_done),
            "n_events": int(r.n_events), "n_steps": int(r.n_steps),
            "n_spec": int(r.n_spec), "n_reseeds": int(r.n_reseeds),
            "n_scans": int(r.n_scans), "overflow": int(r.overflow),
            "truncated": bool(r.truncated),
            "trace_t": _bits(tt), "trace_kind": _ints(kind),
            "trace_who": _ints(who),
            "status": _ints(out.status),
            "resource": _ints(out.resource),
            "start": _bits(out.start),
            "finish": _bits(out.finish),
            "returned": _bits(out.returned),
            "cost": _bits(out.cost),
        },
    }


def main():
    ref = {
        "_about": "JAX reference results for the port's main-path cells "
                  "(tests/data/gen_port_ref.py); floats as uint32 bits",
        "jax_version": jax.__version__,
        "jax_threefry_partitionable": bool(
            jax.config.jax_threefry_partitionable),
        "cells": {c[0]: cell(*c) for c in CELLS},
    }
    with open(OUT, "w") as f:
        json.dump(ref, f, separators=(",", ":"))
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
