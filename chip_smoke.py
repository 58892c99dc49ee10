"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. card     -- the card's name and power limit (nvidia-smi);
2. build    -- nvcc builds the kernels from src/repro_torch/kernels/csrc;
3. kernels  -- each kernel against its plain PyTorch version on the card,
               bitwise, at the engine's shapes;
4. main     -- ``simulation.run_experiment`` on the card for the 20u_100j
               (paper section 5 scale) and 4u_512j cells, held bitwise
               against the JAX reference in tests/data/port_ref_main.json;
               the kernels' launch counters must be above 0 and the plain
               versions' at 0;
5. profile  -- the first WINDOW supersteps of 20u_100j under the
               profiler: device busy time, idle share, top kernels;
6. times    -- each kernel's device time (profiler) and call time (CUDA
               events) at the main-path shapes, beside its plain version
               and its bound.

Prints a ``{"kernels": [...]}`` line, then the result line
``{"ok": true, "device": {...}}`` last.  Imports no JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
MAIN_CELL = "20u_100j"
CELLS = ("20u_100j", "4u_512j")
SCAN_SHAPES = ((16, 32), (16, 640), (16, 2000), (8, 640))
WINDOW = 300          # supersteps of the main path under the profiler


def phase(name):
    print(f"== {name}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bits_equal(a, b):
    a = a.detach().cpu().contiguous()
    b = b.detach().cpu().contiguous()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def abs_err(a, b):
    """Largest |a - b| over a float output (equal infinities count 0)."""
    if not a.dtype.is_floating_point:
        return float((a.long() - b.long()).abs().max()) if a.numel() else 0.0
    d = torch.where(a == b, 0.0, (a.double() - b.double()).abs())
    return float(d.max()) if d.numel() else 0.0


def scan_inputs(r, j, gen, dev):
    """Random job-slot tables: ~20% empty slots, ~10% exact duplicates
    of another slot's remaining (ties decided by the tie key), random
    time/space-shared rows, reservation-blocked PEs and down rows."""
    rem = torch.rand((r, j), generator=gen) * 500.0
    rem[torch.rand((r, j), generator=gen) < 0.2] = 0.0
    dup = torch.rand((r, j), generator=gen) < 0.1
    rem = torch.where(dup, rem.roll(1, dims=1), rem)
    tie = torch.stack([torch.randperm(j, generator=gen) for _ in range(r)]
                      ).to(torch.float32)
    tie = torch.where(rem > 0, tie, float(2 ** 30))
    mips = torch.randint(100, 600, (r,), generator=gen).to(torch.float32)
    npe = torch.randint(1, 17, (r,), generator=gen)
    pol = (torch.rand(r, generator=gen) < 0.25).to(torch.int32)
    blk = torch.where(torch.rand(r, generator=gen) < 0.25,
                      torch.randint(0, 4, (r,), generator=gen), 0
                      ).to(torch.float32)
    ok = (torch.rand(r, generator=gen) > 0.1).to(torch.float32)
    return tuple(x.to(dev) for x in (rem, tie, mips, npe, pol, blk, ok))


def engine_layout(n_users, n_jobs, n_res, r_pad):
    """The frontier's segment layout in the committing superstep:
    COMPLETION (R_pad rows), FAILURE/RECOVERY (R), TRACE (1),
    RESERVATION (0), MARKET/AUCTION (1), NETWORK (0), RETURN/ARRIVAL (N),
    CALENDAR (R), BROKER (1)."""
    n = n_users * n_jobs
    return (r_pad, n_res, n_res, 1, 0, 1, 1, 0, n, n, n_res, 1)


def frontier_inputs(sizes, gen, dev):
    c = sum(sizes)
    cand = torch.floor(torch.rand(c, generator=gen) * 50.0) + 100.0
    cand[torch.rand(c, generator=gen) < 0.6] = float("inf")
    cuts = torch.rand(c, generator=gen) < 0.7
    return cand.to(dev), cuts.to(dev)


def time_ms(fn, reps=200):
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(fn, kernel=None, reps=100):
    """Mean device time per call (ms) from the profiler: the kernels
    whose name contains ``kernel``, or every kernel ``fn`` launched.
    None when the profiler recorded no device time."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in device_events(prof)
             if kernel is None or kernel in e.name)
    return us / reps / 1e3 if us > 0 else None


def load_cells(dev):
    from repro_torch.core import gridlet, resource
    with open(os.path.join(ROOT, "tests", "data",
                           "port_ref_main.json")) as f:
        ref = json.load(f)["cells"]

    def f32(bits):
        return torch.from_numpy(np.asarray(bits, np.uint32).view(
            np.float32).copy())

    out = {}
    for name in CELLS:
        c = ref[name]
        fl = c["fleet"]
        fleet = resource.make_fleet(
            fl["num_pe"], f32(fl["mips_per_pe"]), f32(fl["cost_per_sec"]),
            fl["policy"], time_zone=f32(fl["time_zone"]),
            baud_rate=f32(fl["baud_rate"]), device=dev)
        u, nj = c["n_users"], c["n_jobs_per_user"]
        g = gridlet.make_batch(
            f32(c["length_mi"]),
            user=torch.arange(u, dtype=torch.int32).repeat_interleave(nj),
            device=dev)
        out[name] = (c, g, fleet)
    return out


def check_cell(name, c, res):
    """Bitwise comparison with the reference; returns failures."""
    r = c["result"]
    bad = []

    def ints(x):
        return torch.as_tensor(r[x], dtype=torch.int64)

    def f32(x):
        return torch.from_numpy(np.asarray(r[x], np.uint32).view(
            np.int32).copy())

    def got_bits(t):
        return t.detach().cpu().contiguous().view(torch.int32).reshape(-1)

    g = res.gridlets
    pairs = [
        ("n_done", got_bits(res.n_done), f32("n_done")),
        ("spent", got_bits(res.spent), f32("spent")),
        ("term_time", got_bits(res.term_time), f32("term_time")),
        ("per_resource_done", got_bits(res.per_resource_done),
         f32("per_resource_done")),
        ("trace_t", got_bits(res.trace[0]), f32("trace_t")),
        ("trace_kind", res.trace[1].cpu().long(), ints("trace_kind")),
        ("trace_who", res.trace[2].cpu().long(), ints("trace_who")),
        ("status", g.status.cpu().long(), ints("status")),
        ("resource", g.resource.cpu().long(), ints("resource")),
        ("start", got_bits(g.start), f32("start")),
        ("finish", got_bits(g.finish), f32("finish")),
        ("returned", got_bits(g.returned), f32("returned")),
        ("cost", got_bits(g.cost), f32("cost")),
    ]
    for key in ("n_events", "n_steps", "n_spec", "n_reseeds", "n_scans",
                "overflow"):
        pairs.append((key, torch.tensor([int(getattr(res, key))]),
                      torch.tensor([r[key]])))
    pairs.append(("truncated", torch.tensor([bool(res.truncated)]),
                  torch.tensor([r["truncated"]])))
    for key, got, want in pairs:
        if got.shape != want.shape or not torch.equal(got, want):
            n = int((got != want).sum()) if got.shape == want.shape else -1
            bad.append(f"{name}.{key}: {n} differ")
    return bad


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    failures = []

    phase("card")
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    phase("build")
    from repro_torch.kernels import _build
    from repro_torch.kernels import event_scan as ek
    t0 = time.perf_counter()
    _build.build(verbose=True)
    ek._lib()
    print(f"built {_build.library_path().name} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    phase("kernels against their plain versions (bitwise)")
    gen = torch.Generator().manual_seed(0)
    errs = {"event_scan": 0.0, "event_frontier": 0.0}
    for r, j in SCAN_SHAPES:
        rem, tie, mips, npe, pol, blk, ok = scan_inputs(r, j, gen, dev)
        kw = dict(tie=tie, policy=pol, pe_blocked=blk, row_ok=ok,
                  with_rank=True)
        want = ek.event_scan_ref(rem, mips, npe, **kw)
        got = ek.event_scan_cuda(rem, mips, npe, **kw)
        rank_in = want[4]
        want_i = ek.event_scan_ref(rem, mips, npe, rank=rank_in, **kw)
        got_i = ek.event_scan_cuda(rem, mips, npe, rank=rank_in, **kw)
        torch.cuda.synchronize()
        for form, w, gt in (("fresh", want, got), ("injected", want_i,
                                                   got_i)):
            names = ("rate", "t_min", "argmin", "occ", "rank")
            same = [bits_equal(a, b) for a, b in zip(w, gt)]
            errs["event_scan"] = max([errs["event_scan"]] + [
                abs_err(a, b) for a, b in zip(w, gt)])
            print(f"event_scan {form:8s} [{r},{j}]: " + " ".join(
                f"{n}={'ok' if s else 'DIFF'}" for n, s in zip(names, same)),
                flush=True)
            if not all(same):
                failures.append(f"event_scan {form} [{r},{j}]")
    layouts = {"engine 20u_100j": engine_layout(20, 100, 11, 16),
               "engine 4u_512j": engine_layout(4, 512, 2, 8),
               "random": tuple(int(x) for x in torch.randint(
                   0, 300, (9,), generator=gen))}
    for name, sizes in layouts.items():
        cand, cuts = frontier_inputs(sizes, gen, dev)
        for use_cuts in (None, cuts):
            want = ek.event_frontier_ref(cand, sizes, use_cuts)
            got = ek.event_frontier_cuda(cand, sizes, use_cuts)
            torch.cuda.synchronize()
            same = all(bits_equal(a, b) for a, b in zip(want, got))
            errs["event_frontier"] = max([errs["event_frontier"]] + [
                abs_err(a, b) for a, b in zip(want, got)])
            print(f"event_frontier {name} (C={sum(sizes)}, "
                  f"cuts={'yes' if use_cuts is not None else 'no'}): "
                  f"{'ok' if same else 'DIFF'}", flush=True)
            if not same:
                failures.append(f"event_frontier {name}")

    phase("main path: run_experiment on the card vs the JAX reference")
    from repro_torch.core import simulation
    cells = load_cells(dev)
    launches = {}
    for name in CELLS:
        c, g, fleet = cells[name]
        ek.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = simulation.run_experiment(
            g, fleet, c["deadline"], c["budget"], opt=c["opt"],
            n_users=c["n_users"], batch=c["batch"], device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ek.LAUNCHES)
        plain = dict(ek.PLAIN_CALLS)
        if name == MAIN_CELL:
            launches = counts
        bad = check_cell(name, c, res)
        print(f"{name}: wall {wall:.3f} s, supersteps {int(res.n_steps)}, "
              f"speculative {int(res.n_spec)}, reseeds "
              f"{int(res.n_reseeds)}, scans {int(res.n_scans)}, events "
              f"{int(res.n_events)}, host syncs {res.host_syncs}, "
              f"launches {counts}, plain calls {plain}, done "
              f"{int(res.n_done.sum())}, spent {float(res.spent.sum())}",
              flush=True)
        print(f"{name}: " + ("bitwise equal to the reference (every "
                             "counter, trace, status and float field)"
                             if not bad else "; ".join(bad)), flush=True)
        failures += bad
        if min(counts.values()) <= 0:
            failures.append(f"{name}: a kernel was never launched")
        if max(plain.values()) > 0:
            failures.append(f"{name}: a plain version ran on the card")

    phase(f"where the time goes: the first {WINDOW} supersteps of "
          f"{MAIN_CELL}")
    c, g, fleet = cells[MAIN_CELL]
    window = dict(opt=c["opt"], n_users=c["n_users"], batch=c["batch"],
                  max_events=WINDOW, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = simulation.run_experiment(g, fleet, c["deadline"], c["budget"],
                                    **window)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        simulation.run_experiment(g, fleet, c["deadline"], c["budget"],
                                  **window)
        torch.cuda.synchronize()
    by_name = {}
    for e in device_events(prof):
        k = e.name.split("(")[0][-48:]
        n, us = by_name.get(k, (0, 0.0))
        by_name[k] = (n + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in by_name.values()) / 1e6
    n_kernels = sum(n for n, _ in by_name.values())
    steps = int(res.n_steps) + int(res.n_spec)
    print(f"window: {steps} supersteps, wall {wall:.3f} s (unprofiled), "
          f"device busy {busy:.3f} s, idle share {1 - busy / wall:.4f}, "
          f"{n_kernels} kernel launches ({n_kernels / steps:.0f} per "
          f"superstep), host syncs {res.host_syncs}", flush=True)
    for k, (n, us) in sorted(by_name.items(), key=lambda x: -x[1][1])[:8]:
        print(f"  {k:48s} {n:7d} launches {us / 1e3:9.3f} ms", flush=True)

    phase("times (ms per call: device time from the profiler, call time "
          "from CUDA events)")
    r, j = 16, min(g.n, c["n_users"] * 2 * int(fleet.num_pe.max()))
    rem, tie, mips, npe, pol, blk, ok = scan_inputs(r, j, gen, dev)
    kw = dict(tie=tie, policy=pol, pe_blocked=blk, row_ok=ok,
              with_rank=True)
    rank_in = ek.event_scan_ref(rem, mips, npe, **kw)[4]
    sizes = engine_layout(c["n_users"], c["n_jobs_per_user"], fleet.r, r)
    cand, _ = frontier_inputs(sizes, gen, dev)
    f4 = 4
    scan_bytes = (2 * r * j + 5 * r) * f4 + (r * j + 3 * r) * f4
    # The function's own work, not the kernel's: a fresh rank needs a
    # sort of each row (J log2 J compares), not the J^2 pairwise count.
    sort_ops = r * j * int(np.ceil(np.log2(max(j, 2))))
    rows = []
    for name, form, fn, plain_fn, nbytes, n_ops in (
            ("event_scan", "fresh",
             lambda: ek.event_scan_cuda(rem, mips, npe, **kw),
             lambda: ek.event_scan_ref(rem, mips, npe, **kw),
             scan_bytes + r * j * f4, sort_ops + 12 * r * j),
            ("event_scan", "injected",
             lambda: ek.event_scan_cuda(rem, mips, npe, rank=rank_in, **kw),
             lambda: ek.event_scan_ref(rem, mips, npe, rank=rank_in, **kw),
             scan_bytes + r * j * f4, 12 * r * j),
            ("event_frontier", "engine layout",
             lambda: ek.event_frontier_cuda(cand, sizes),
             lambda: ek.event_frontier_ref(cand, sizes),
             (sum(sizes) + len(sizes) + 1) * f4 + 3 * len(sizes) * f4,
             3 * sum(sizes))):
        call_ms = time_ms(fn)
        ms = device_ms(fn, kernel=f"{name}_kernel")
        if ms is None:
            failures.append(f"{name} {form}: the profiler recorded no "
                            f"device time for {name}_kernel")
        plain_ms = time_ms(plain_fn, reps=50)
        plain_dev = device_ms(plain_fn)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / F32_OPS_PER_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"{name} {form} [{r},{j}]: kernel {ms} ms device "
              f"({call_ms:.5f} ms per call), plain {plain_ms:.5f} ms per "
              f"call ({plain_dev} ms device), bound {bound_ms:.7f} ms "
              f"({by}: {nbytes} B, {n_ops} ops), library call: none",
              flush=True)
        rows.append((name, form, ms, plain_ms, bound_ms, by, call_ms,
                     plain_dev))
    ek.reset_counts()

    src = "src/repro_torch/kernels/csrc/event_scan.cu"
    replaces = {"event_scan": "src/repro/kernels/event_scan.py:353",
                "event_frontier": "src/repro/kernels/event_scan.py:1009"}
    kernels = []
    for name in ("event_scan", "event_frontier"):
        mine = [x for x in rows if x[0] == name]
        first = mine[0]   # event_scan: the fresh form (the larger time)
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces[name], "launches": launches.get(name, 0),
            "max_abs_err": errs[name],
            "ms": first[2], "plain_ms": first[3], "bound_ms": first[4],
            "bound_by": first[5], "library_ms": None,
            "call_ms": first[6], "plain_device_ms": first[7],
            "forms": {x[1]: {"ms": x[2], "plain_ms": x[3],
                             "bound_ms": x[4], "call_ms": x[6]}
                      for x in mine},
            "shape": [r, j] if name == "event_scan" else [sum(sizes)],
            "card": card})
    if failures:
        print("FAILED: " + "; ".join(failures), flush=True)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
