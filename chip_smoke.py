"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. card     -- the card's name and power limit (nvidia-smi);
2. build    -- nvcc builds the kernels from src/repro_torch/kernels/csrc;
               each kernel's registers and spill bytes from ptxas, and
               its tensor-core instructions
               (HGMMA, HMMA) from cuobjdump's SASS: a flash instance
               (bf16 or f32, one of each a head dim) or an SSD pass that
               multiplies matrices (states, output) fails if it spills or
               has no tensor-core instruction;
3. kernels  -- each kernel against its plain PyTorch version on the card,
               bitwise, at the engine's shapes: event_scan's fresh rank
               (a sort) and injected rank, also on tables of many equal
               remaining values with an all-invalid and a dead row; its
               checked form (the engine's: table gathered from the slot
               map, carried rank checked on the device) with the carry
               kept, the carry's flag off, and a carry that fails in one
               row only (every row reseeds), each with its reseed count;
               the one-launch frontier; the lane forms of the checked scan
               and the frontier at the Figs 21-24 grid's shapes ([144, 16,
               32], [144, C]); link_scan with and without the
               trunk cap, also with tie keys that tie at t_min in every way
               its argmin tells apart, and its engine form (tie key from the
               slot map, trunk occupancy and caps in the kernel) with and
               without trunks, through one Scratch twice;
4. main     -- ``simulation.run_experiment`` on the card for the 20u_100j
               (paper section 5 scale), 4u_512j and 200u_10j cells, held
               bitwise against the JAX reference in
               tests/data/port_ref_main.json, the contended-network cells
               20u_100j_net and 20u_100j_trunknet (``net_cap=None``)
               against tests/data/port_ref_net.json, then the
               dynamic-resource cells against tests/data/port_ref_fail.json:
               20u_100j_fail (MTBF/MTTR streams), 20u_100j_trunk (a
               trunk-wide fault trace, retry limit, backoff, cooldown) and
               their CPU-size twins 4u_25j_fail, 4u_25j_trunk and
               4u_25j_net_fail, failure counters, downtime and every
               gridlet's retry state included, then the grid-economy
               cells against tests/data/port_ref_econ.json: 20u_100j_resv
               (8 of R7's PEs booked, maintenance on R8 and R4),
               20u_100j_plan (the same windows, cost-time optimisation,
               the plan-ahead broker), 20u_100j_commodity and
               20u_100j_auction (posted prices moved every 60 time
               units), and their 4u_25j twins (windows on R8); every
               kernel of a cell's
               path must be launched (counts zeroed just before the run,
               read just after) and the plain versions never; each cell
               prints its wall, supersteps, reseeds, host syncs and
               kernel launches per superstep and its failures;
   sweep    -- the lane-batched sweep engine on the card against
               tests/data/port_ref_sweep.json: the paper's Figs 21-24
               grid (``simulation.sweep``, 8 deadlines x 18 budgets, 200
               gridlets, L = 144 lanes), the sweep bench's 2 x 2 grid at
               20 users and its four strategy lanes
               (``engine.run_sweep_lanes``), every lane bitwise with its
               "how" counters; both lane kernels launched and no plain
               version; each cell's wall, loop iterations and host syncs
               a loop iteration, then the grid's slowest lane alone
               (L = 1): its host syncs a loop iteration may exceed the
               lane's by 2 at most;
   rand     -- the threefry on the card: ``rand.exponential``'s
               ``-log1p(-u)`` over all 2**23 f32 uniforms, its SHA-256
               against jitted JAX's (tests/data/port_ref_rand.json), and
               the recorded PRNGKey / split chains and 4096-word bits,
               uniform and exponential draws in both threefry layouts,
               bitwise;
5. kernel API -- ``repro_torch.kernels.ops.{event_scan_slab, ssd_scan,
               flash_attention}`` on the card at published widths (the
               20u_100j / 4u_512j / fleet-scale job tables, and at
               [16, 640] the slab also at k 33 and 64 (associative: wave
               matrices in a workspace) and 257 and 640 (sequential);
               mamba2-130m and zamba2-1.2b SSD layers; qwen2-7b,
               gemma2-27b and gemma3-1b attention layers, bf16 and f32),
               counts zeroed just before and read just after: each
               launched once per call, no plain
               version; then each output against its plain version (the
               slab bitwise, SSD and f32 attention at the reference's
               kernel-vs-oracle tolerances, bf16 attention per query
               row: its largest error within 2e-2 of its largest |o|);
               SSD also with Mamba-2's own initialisation of dt and A,
               whose slow-decaying heads reach keys far below the
               diagonal and the state carried across chunks; each SSD
               case prints its worst |err| / (tol + tol |want|) and the
               blocks of its three passes;
6. times    -- each kernel's device time per call (profiler: the sum
               over the call's launches, every launch of every kernel of
               the call recorded, the profile repeated when records are
               missing) and call time (CUDA events) at the main-path and
               kernel-API shapes, beside its plain version, its bound
               and, where one PyTorch call computes the same function,
               that call's time; link_scan also in its engine form and as
               the engine's ``_link_scan`` call on the network cells' own
               rows (its kernels a call); the slab at every SLAB_SHAPES
               entry and at SLAB_WIDE's k;
7. profile  -- the first WINDOW supersteps of 20u_100j, 200u_10j,
               20u_100j_net, 20u_100j_trunknet, 20u_100j_fail,
               20u_100j_trunk, 20u_100j_resv and 20u_100j_auction under
               the profiler: device busy time,
               idle share, kernel launches, link_scan launches and host
               syncs per superstep, top kernels; then the first
               SWEEP_WINDOW supersteps of every lane of each sweep cell
               and of the grid's slowest lane alone (device idle share,
               kernel launches a loop iteration: the grid's may be twice
               the lane's at most).  Last: the profiler drops records now
               and then, and more after a profile this large.

Prints a ``{"kernels": [...]}`` line, then the result line
``{"ok": true, "device": {...}}`` last.  Imports no JAX.

    python3 chip_smoke.py --compare

runs only the card line, the engine's ``_link_scan`` call times, the f32
attention kernel's device times at the f32 FLASH_CASES shapes and the
profile windows, with no check and no result line: those use only what
earlier trees of the port also have, so a copy of this script beside an
earlier tree's ``src`` measures that tree the same way.

    python3 chip_smoke.py --sweep

runs only the card line, the build, the lane kernels' checks, the sweep
phase and the sweep windows (no result line).
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys
import time
import types

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
TF32_OPS_PER_S = 495e12       # H100 SXM TF32 tensor cores, dense
MAIN_CELL = "20u_100j"
NET_CELL = "20u_100j_net"
TRUNK_CELL = "20u_100j_trunknet"
NET_CELLS = (NET_CELL, TRUNK_CELL)
FAIL_CELLS = ("20u_100j_fail", "20u_100j_trunk")
ECON_WINDOWS = ("20u_100j_resv", "20u_100j_auction")
# the sweep engine's cells (tests/data/port_ref_sweep.json): the paper's
# Figs 21-24 grid (8 deadlines x 18 budgets, L = 144 lanes), the sweep
# bench's 2 x 2 grid and the four strategy lanes
SWEEP_GRID = "sweep_1u_200j_8x18"
SWEEP_CELLS = (SWEEP_GRID, "sweep_20u_25j_2x2", "strategies_20u_25j")
SWEEP_PATH = ("event_scan_lanes", "event_frontier_lanes")
# supersteps a lane of each profiled sweep window runs (its first
# iterations)
SWEEP_WINDOW = 10
# cell -> (reference file, the kernels its path runs)
PATH = ("event_scan", "event_frontier")
NET_PATH = PATH + ("link_scan",)
CELLS = {"20u_100j": ("port_ref_main.json", PATH),
         "4u_512j": ("port_ref_main.json", PATH),
         "200u_10j": ("port_ref_main.json", PATH),
         "20u_100j_net": ("port_ref_net.json", NET_PATH),
         "20u_100j_trunknet": ("port_ref_net.json", NET_PATH),
         "20u_100j_fail": ("port_ref_fail.json", PATH),
         "20u_100j_trunk": ("port_ref_fail.json", PATH),
         "4u_25j_fail": ("port_ref_fail.json", PATH),
         "4u_25j_trunk": ("port_ref_fail.json", PATH),
         "4u_25j_net_fail": ("port_ref_fail.json", NET_PATH),
         **{f"{users}_{knob}": ("port_ref_econ.json", PATH)
            for users in ("20u_100j", "4u_25j")
            for knob in ("resv", "plan", "commodity", "auction")}}
SCAN_SHAPES = ((16, 32), (16, 640), (16, 2000), (8, 640))
LINK_SHAPES = ((16, 640), (16, 32), (8, 2000))
# Supersteps of each profiled window (300 until the eighth window was
# added, 150 until the sweep windows were): the profiler's
# post-processing of a window's kernel records is most of the profile
# phase's time, which the script's time limit bounds.
WINDOW = 50
# The kernel-API phase: job tables of 20u_100j, 4u_512j and the fleet
# scale of the reference's slab test; SSD layers (name, B, S, H, P, N,
# chunk, x dtype, draws of dt and A: "test" as tests/test_kernels.py
# draws them, "mamba2" as Mamba-2 initialises them) and attention layers
# (name, B, Hq, Hkv, S, d, causal, window, cap, dtype) at published
# widths (src/repro/configs).
SLAB_SHAPES = ((16, 640), (8, 640), (256, 128))
SLAB_KS = (1, 4, 8)
# at [16, 640]: k at the associative form's shared-memory limit (32 at
# J = 640, its largest shared layout), past it (its wave matrices in a
# workspace) and past the sequential form's old cap
SLAB_WIDE = ((32, True), (33, True), (64, True), (257, False),
             (640, False))
BF16, F32 = torch.bfloat16, torch.float32
SSD_CASES = (("mamba2-130m", 2, 4096, 24, 64, 128, 256, BF16, "test"),
             ("zamba2-1.2b", 2, 4096, 64, 64, 64, 256, BF16, "test"),
             ("mamba2-130m", 2, 4096, 24, 64, 128, 256, F32, "test"),
             ("mamba2-130m", 2, 4096, 24, 64, 128, 256, BF16, "mamba2"),
             ("mamba2-130m", 2, 4096, 24, 64, 128, 256, F32, "mamba2"))
FLASH_CASES = (("qwen2-7b", 1, 28, 4, 4096, 128, True, 0, 0.0, BF16),
               ("gemma2-27b local", 1, 32, 16, 8192, 128, True, 4096, 50.0,
                BF16),
               ("gemma3-1b local", 1, 4, 1, 4096, 256, True, 512, 0.0, BF16),
               ("qwen2-7b bidirectional", 1, 28, 4, 2048, 128, False, 0,
                0.0, BF16),
               ("qwen2-7b", 1, 28, 4, 4096, 128, True, 0, 0.0, F32),
               ("gemma2-27b local", 1, 32, 16, 8192, 128, True, 4096, 50.0,
                F32),
               ("gemma3-1b local", 1, 4, 1, 4096, 256, True, 512, 0.0, F32))
SSD_TOL = {BF16: 5e-2, F32: 5e-4}     # tests/test_kernels.py:87
# tests/test_kernels.py:47; bf16 is held per query row (row_rel_err)
FLASH_TOL = {BF16: 2e-2, F32: 2e-5}
API = ("event_scan_slab", "ssd_scan", "flash_attention")
# the kernels one call of each wrapper launches (a name matches every
# kernel whose name contains it)
KERNEL_NAME = {"event_scan": ("event_scan_kernel",),
               "event_scan checked": ("event_scan_check_kernel",
                                      "event_scan_kernel"),
               "event_frontier": ("event_frontier_kernel",),
               "event_scan_lanes": ("event_scan_check_kernel",
                                    "event_scan_kernel"),
               "event_frontier_lanes": ("event_frontier_kernel",),
               "link_scan": ("link_scan_kernel",),
               "event_scan_slab": ("event_scan_slab_kernel",),
               "ssd_scan": ("ssd_states_kernel", "ssd_pass_kernel",
                            "ssd_output_kernel"),
               "flash_attention": ("flash_kernel",)}
# the SSD passes that multiply matrices (on the tensor cores)
SSD_PRODUCTS = ("states", "output")
SOURCE = {"ssd_scan": "src/repro_torch/kernels/csrc/ssd_scan.cu",
          "flash_attention": "src/repro_torch/kernels/csrc/"
                             "flash_attention.cu"}
REPLACES = {"event_scan": "src/repro/kernels/event_scan.py:353",
            "event_frontier": "src/repro/kernels/event_scan.py:1009",
            "event_scan_lanes": "src/repro/kernels/event_scan.py:353",
            "event_frontier_lanes": "src/repro/kernels/event_scan.py:1009",
            "link_scan": "src/repro/kernels/event_scan.py:872",
            "event_scan_slab": "src/repro/kernels/event_scan.py:677",
            "ssd_scan": "src/repro/kernels/ssd_scan.py:104",
            "flash_attention": "src/repro/kernels/flash_attention.py:116"}


_T0 = time.perf_counter()


def phase(name):
    print(f"== {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def instance(mangled):
    """'flash_attention bf16 d=128', 'flash_attention f32 d=64',
    'ssd_scan states bf16', 'ssd_scan pass', 'link_scan_kernel' ... for
    a kernel's mangled name, else None."""
    m = re.search(r"(event_scan|event_scan_check|event_frontier|link_scan|"
                  r"event_scan_slab)_kernel", mangled)
    if m is not None:
        return m.group(0)
    m = re.search(r"flash_kernel_(wgmma|tf32)ILi(\d+)E", mangled)
    if m is not None:
        dtype = "bf16" if m.group(1) == "wgmma" else "f32"
        return f"flash_attention {dtype} d={m.group(2)}"
    m = re.search(r"ssd_(states|pass|output)_kernel(I(f|13__nv_bfloat16)E)?",
                  mangled)
    if m is not None:
        dtype = {None: "", "f": " f32"}.get(m.group(3), " bf16")
        return f"ssd_scan {m.group(1)}{dtype}"
    return None


def ptxas_report(log):
    """{kernel instance: (registers, spill bytes)} from nvcc's -Xptxas -v
    output (spill stores plus spill loads)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = instance(m.group(1))
            if name:
                out[name] = [None, 0]
            continue
        if not name:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name][1] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name][0] = int(m.group(1))
    return out


def tensor_core_ops(lib, cuobjdump):
    """{kernel instance: number of HGMMA / HMMA instructions} in the
    library's SASS."""
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = instance(m.group(1))
            if name:
                out[name] = {"HGMMA": 0, "HMMA": 0}
            continue
        if name:
            for op in out[name]:
                if re.search(rf"\b{op}\.", line):
                    out[name][op] += 1
    return out


def check_kernel_build(failures):
    """Registers and spills (ptxas) and tensor-core instructions
    (cuobjdump) of every kernel (event_scan.cu's too); the flash
    instances (bf16 and f32, one of each a head dim) and the SSD passes
    that multiply matrices must have no spill and at least one
    tensor-core instruction."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fk
    regs = ptxas_report(_build.log_path().read_text())
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    mma = tensor_core_ops(_build.library_path(), cuobjdump)
    for name in sorted(set(regs) | set(mma)):
        n_reg, spill = regs.get(name, (None, None))
        ops = mma.get(name, {})
        print(f"{name}: {n_reg} registers, {spill} bytes spilled, SASS "
              f"{ops}", flush=True)
        if (name.startswith("flash_attention") or
                name.split()[:2] in (["ssd_scan", p] for p in SSD_PRODUCTS)):
            if spill != 0:
                failures.append(f"{name}: ptxas reports {spill} spill bytes")
            if not ops.get("HGMMA") and not ops.get("HMMA"):
                failures.append(f"{name}: no tensor-core instruction in "
                                f"its SASS")
    for dtype in ("bf16", "f32"):
        n_flash = sum(n.startswith(f"flash_attention {dtype}") for n in mma)
        if n_flash != len(fk.HEAD_DIMS):
            failures.append(f"flash_attention: {n_flash} {dtype} instances "
                            f"in the SASS, expected {len(fk.HEAD_DIMS)}")
    n_ssd = sum(n.startswith("ssd_scan") for n in mma)
    if n_ssd != 2 * len(SSD_PRODUCTS) + 1:
        failures.append(f"ssd_scan: {n_ssd} kernels in the SASS, expected "
                        f"{2 * len(SSD_PRODUCTS) + 1}")


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


def row_rel_err(got, want):
    """Largest over query rows of max |got - want| / max |want| along the
    row: relative to the row's own size.  An absolute tolerance would be
    as large as the typical |o| of a row that averages thousands of keys,
    and would miss a dropped or re-read key tile there."""
    got, want = got.float(), want.float()
    return float(((got - want).abs().amax(-1) /
                  want.abs().amax(-1).clamp_min(1e-30)).max())


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


def tie_heavy(rem, tie, ok):
    """The same table with many equal remaining values (whole multiples
    of 50), row 0 all invalid and row 1 dead."""
    rem = torch.floor(rem / 50.0) * 50.0
    rem[0] = 0.0
    tie = torch.where(rem > 0, tie, float(2 ** 30))
    ok = ok.clone()
    ok[1] = 0.0
    return rem, tie, ok


def slab_ops(args, k):
    """The slab's own operations at k on this table: a sort of each row,
    then, over the row's m = min(k, occupied) heads, a quotient and a sum
    a wave and the advance of every later head (share, product, clamp:
    ~8 operations), 2 m + 8 m (m - 1) / 2.  Both forms give the same
    results, so this least count bounds the associative form too."""
    from repro_torch.kernels import event_scan as ek
    rem, _, _, npe, pol, blk, ok = args
    r, j = rem.shape
    _, valid, _ = ek._row_masks(rem, npe[:, None], pol[:, None],
                                blk[:, None], ok[:, None])
    m = valid.sum(dim=1).clamp(max=k).to(torch.int64)
    return (r * j * int(np.ceil(np.log2(j))) +
            int((2 * m + 4 * m * (m - 1)).sum()))


def checked_inputs(r, j, gen, dev):
    """The checked scan's inputs at [r, j] (r >= 4): a slot map over
    N = 2 r j gridlets (~70% of slots occupied, each by its own
    gridlet), remaining values on a 10 MI grid (many equal; a zero is
    clamped to 1e-30 by the gather), time-shared rows with 1-4 PEs (so
    that ranks matter), row 1 space-shared, row 2 dead, row 3 empty.
    Returns (inputs, carries): "kept" is the fresh rank with each row's
    MaxShare side reversed (another rank, the same partition); "one
    row" is the same but for row 0, whose boundary pair (ranks msc - 1
    and msc) is swapped, so row 0 alone fails the check."""
    from repro_torch.kernels import event_scan as ek
    n = 2 * r * j
    ids = torch.randperm(n, generator=gen)[:r * j].reshape(r, j)
    rg = torch.where(torch.rand((r, j), generator=gen) < 0.7, ids,
                     -1).to(torch.int32)
    rg[3] = -1
    occ0 = torch.nonzero(rg[0] >= 0)[:, 0]
    if len(occ0) % 3 == 0:       # row 0: 3 PEs, some of them shared
        rg[0, occ0[0]] = -1
    remaining = torch.floor(torch.rand(n, generator=gen) * 20.0) * 10.0
    mips = torch.randint(100, 600, (r,), generator=gen).to(torch.float32)
    npe = torch.randint(1, 5, (r,), generator=gen).to(torch.float32)
    npe[0] = 3.0
    pol = torch.zeros(r)
    pol[1] = 1.0
    ok = torch.ones(r)
    ok[2] = 0.0
    args = tuple(x.to(dev) for x in (rg, remaining, mips, npe, pol,
                                     torch.zeros(r), ok))
    fresh = ek.event_scan_checked_ref(
        *args, torch.zeros((r, j), device=dev),
        torch.tensor(False, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev))[4]
    rem, _ = ek._gather_table(args[0], args[1])
    npe_e, valid, g = ek._row_masks(rem, args[3][:, None], args[4][:, None],
                                    args[5][:, None], args[6][:, None])
    m = torch.clamp_min(npe_e, 1.0)
    k = torch.floor(g / m)
    msc = (npe_e - (g - k * m)) * k
    kept = torch.where(valid & (fresh < msc),
                       torch.minimum(msc, g) - 1.0 - fresh, fresh)
    ms = float(msc[0, 0])
    assert 0 < ms < float(g[0, 0]), "row 0 must have both share sides"
    one = kept.clone()
    one[0] = torch.where(valid[0] & (fresh[0] == ms - 1), ms,
                         torch.where(valid[0] & (fresh[0] == ms), ms - 1,
                                     fresh[0]))
    return args, {"kept": kept, "one row": one}


CHECKED_CASES = (("carry kept", "kept", True), ("carry flag off", "kept",
                                                False),
                 ("one row fails", "one row", True))


def link_inputs(l, t, gen, dev):
    """Random transfer-slot tables: ~40% free slots, payloads in whole
    KB so forecasts tie at t_min, an empty row, dead rows (baud 0, at
    BIG, infinite), fractional background flows, and a trunk cap that
    binds on about half the rows."""
    rem = torch.randint(1, 6, (l, t), generator=gen).to(torch.float32)
    rem = rem * 1024.0
    rem[torch.rand((l, t), generator=gen) < 0.4] = 0.0
    rem[1] = 0.0
    tie = torch.stack([torch.randperm(t, generator=gen) for _ in range(l)]
                      ).to(torch.float32)
    tie = torch.where(rem > 0, tie, float(2 ** 30))
    baud = torch.rand(l, generator=gen) * 5e4 + 1e3
    baud[2], baud[3], baud[4] = 0.0, 3.0e38, float("inf")
    bg = torch.tensor([0.0, 0.5, 1.0, 2.5])[
        torch.randint(0, 4, (l,), generator=gen)]
    cap = torch.where(torch.rand(l, generator=gen) < 0.5,
                      torch.rand(l, generator=gen) * 100.0 + 10.0,
                      torch.tensor(3.0e38))
    return tuple(x.to(dev) for x in (rem, tie, baud, bg, cap))


def odd_ties(l, t, gen, dev):
    """Tie keys drawn from values the link scan's two-stage argmin tells
    apart at t_min: -0 and +0, BIG, above BIG and +-inf."""
    keys = torch.tensor([0.0, -0.0, 1.0, 3.0e38, 3.2e38, float("inf"),
                         -float("inf"), 2.0 ** 30])
    return keys[torch.randint(0, len(keys), (l, t), generator=gen)].to(dev)


def slot_map(rem, gen):
    """A transfer-slot map for a table: each transfer its own gridlet
    (distinct indices), -1 on free slots."""
    l, t = rem.shape
    ids = torch.randperm(2 * l * t, generator=gen)[:l * t].reshape(l, t)
    return torch.where(rem.cpu() > 0, ids, -1).to(torch.int32).to(rem.device)


def check_trunks(l, dev):
    """A trunk topology over l rows for the kernel check: two trunks
    (3,000 B/s with one background flow, 50,000 B/s with half of one)
    and private rows."""
    trunk_of = torch.tensor([i % 3 - 1 for i in range(l)], dtype=torch.int32)
    trunk_of[0] = 0
    return (trunk_of.to(dev),
            torch.where(trunk_of == 0, 3e3, 5e4).to(dev),
            torch.where(trunk_of == 0, 1.0, 0.5).to(dev))


def engine_link_state(c, fleet, t, gen, dev):
    """The engine's link scan at a network cell's own rows: its params
    (the cell's scenario), and a state whose [R_pad, t] transfer table
    holds link_inputs' payloads on the resources' rows (the padding rows
    empty) under a slot map -- what ``engine._link_scan`` reads.
    Returns (state, params, R, R_pad)."""
    from repro_torch.core import engine, simulation
    r_pad = -(-fleet.r // engine.BLOCK_R) * engine.BLOCK_R
    rem = link_inputs(r_pad, t, gen, dev)[0].clone()
    rem[fleet.r:] = 0.0
    params = simulation._scenario_params(
        fleet, c["deadline"], c["budget"], c["opt"], c["n_users"],
        simulation.Scenario(**c["scenario"]), dev)
    state = types.SimpleNamespace(
        t=torch.zeros((), device=dev), link_rem=rem,
        link_gridlet=slot_map(rem, gen),
        host=engine.HostCounts(n_reseeds=torch.zeros(
            (), dtype=torch.int32, device=dev)))
    return state, params, fleet.r, r_pad


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


def time_ms(fn, reps=200, warm=10):
    for _ in range(warm):
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


def device_ms(fn, kernels=None, reps=100, tries=3):
    """Device time (ms) per call of ``fn`` from the profiler.  With
    ``kernels`` (names, each launched once per call): the sum over the
    names of the mean time of that name's launches, so a record the
    profiler drops shifts no time between kernels; the profile is taken
    again, up to ``tries`` times, until every name has ``reps`` records,
    else the shortfall is printed.  Returns (ms, {name: ms}), or
    (None, {}) when no device time was recorded.  Without ``kernels``:
    every kernel ``fn`` launched, summed and divided by ``reps``."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = device_events(prof)
        if kernels is None:
            total = sum(e.time_range.elapsed_us() for e in events)
            return (total / reps / 1e3 if total > 0 else None), {}
        times = {k: [e.time_range.elapsed_us() for e in events
                     if k in e.name] for k in kernels}
        counts = {k: len(v) for k, v in times.items()}
        if all(n == reps for n in counts.values()):
            break
        print(f"  (profile {attempt + 1}: {sum(counts.values())} of "
              f"{reps * len(kernels)} records, calls x launches per call; "
              f"per kernel {counts})", flush=True)
    if not all(times.values()) or not any(sum(v) for v in times.values()):
        return None, {}
    per = {k: sum(v) / len(v) / 1e3 for k, v in times.items()}
    return sum(per.values()), per


def device_ops(fn, reps=50):
    """(device operations a call, their device ms a call) of ``fn`` from
    the profiler: every kernel and copy it puts on the card."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = device_events(prof)
    return (len(events) / reps,
            sum(e.time_range.elapsed_us() for e in events) / reps / 1e3)


def engine_link_calls(cells, gen, dev):
    """The engine's whole link-scan call, ``engine._link_scan``, on each
    network cell's rows at [R_pad, T] (T the cell's 640 slots): ms a
    call (CUDA events), and the device operations it makes a call."""
    from repro_torch.core import engine
    for name in NET_CELLS:
        c, g, fleet = cells[name]
        t = min(g.n, c["n_users"] * 2 * int(fleet.num_pe.max()))
        state, params, n_res, r_pad = engine_link_state(c, fleet, t, gen,
                                                        dev)

        def fn():
            return engine._link_scan(state, params, n_res, r_pad)
        call_ms = time_ms(fn)
        n_ops, ms = device_ops(fn)
        print(f"engine._link_scan {name} [{r_pad},{t}]: {call_ms:.5f} ms "
              f"per call (CUDA events), {n_ops:.2f} device operations a "
              f"call, {ms:.5f} ms device a call", flush=True)


def ssd_inputs(b, s, h, p, n, dtype, draws, gen, dev):
    """x ~ N(0, 1) in the working type, B and C ~ N(0, 1); dt and a as
    the reference test draws them ("test": dt = softplus(N(0, 1)), a =
    -exp(0.3 N(0, 1)), a row decays by ~e^-0.8 a step) or as Mamba-2
    initialises them ("mamba2": dt log-uniform in [1e-3, 1e-1], A =
    -U[1, 16]; mamba_ssm/modules/mamba2.py, Mamba2.__init__'s dt_min,
    dt_max and A_init_range), whose slow heads carry keys 100s of steps
    back and the state across chunks."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)
    x = randn(b, s, h, p).to(dtype)
    if draws == "test":
        dt = torch.nn.functional.softplus(randn(b, s, h))
        a = -torch.exp(randn(h) * 0.3)
    else:
        lo, hi = np.log(1e-3), np.log(1e-1)
        dt = torch.exp(rand(b, s, h) * (hi - lo) + lo)
        a = -(1.0 + 15.0 * rand(h))
    return x, dt, a, randn(b, s, n), randn(b, s, n)


def allclose_ratio(got, want, tol):
    """Worst |got - want| / (tol + tol |want|): allclose(rtol=tol,
    atol=tol) holds where this is at most 1."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (tol + tol * want.abs())).max())


def flash_inputs(b, hq, hkv, s, d, dtype, gen, dev):
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    return randn(b, hq, s, d), randn(b, hkv, s, d), randn(b, hkv, s, d)


def attended_pairs(sq, skv, causal, window):
    """(query, key) pairs that survive the causal and window masks."""
    q = np.arange(sq)
    hi = np.minimum(q, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(sq, int)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def library_attention(q, k, v, causal, window):
    """One PyTorch call for the same attention (the yardstick only)."""
    f = torch.nn.functional.scaled_dot_product_attention
    if not window:
        return lambda: f(q, k, v, is_causal=causal, enable_gqa=True)
    sq, skv = q.shape[2], k.shape[2]
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(skv, device=q.device)[None, :]
    keep = kp > qp - window
    if causal:
        keep &= kp <= qp
    return lambda: f(q, k, v, attn_mask=keep, enable_gqa=True)


def kernel_api(dev, failures):
    """The kernel-API phase: drives ``ops`` on the card with the counts
    zeroed just before and read just after, then holds every output
    against its plain version.  Returns (launches, max_abs_err, the
    inputs for the times phase)."""
    from repro_torch.kernels import event_scan as ek
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as sk
    gen = torch.Generator().manual_seed(14)
    dgen = torch.Generator(device=dev).manual_seed(14)
    slab_in = {shape: scan_inputs(*shape, gen, dev) for shape in SLAB_SHAPES}
    ssd_in = [ssd_inputs(*c[1:6], c[7], c[8], dgen, dev) for c in SSD_CASES]
    flash_in = [flash_inputs(*c[1:6], c[9], dgen, dev) for c in FLASH_CASES]
    lives = {v: torch.tensor(v, device=dev) for v in (True, False)}
    calls = dict.fromkeys(API, 0)
    outs = []
    ek.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for shape, (rem, tie, mips, npe, pol, blk, ok) in slab_in.items():
        for k in SLAB_KS:
            for assoc in (True, False):
                for live in (True, False):
                    outs.append(("event_scan_slab", (shape, k, assoc, live),
                                 ops.event_scan_slab(
                                     rem, mips, npe, k, tie=tie, policy=pol,
                                     pe_blocked=blk, row_ok=ok,
                                     live=lives[live], assoc=assoc)))
                    calls["event_scan_slab"] += 1
    rem, tie, mips, npe, pol, blk, ok = slab_in[SLAB_SHAPES[0]]
    limit = ek.event_scan_slab_max_k(SLAB_SHAPES[0][1])
    if limit != SLAB_WIDE[0][0]:
        failures.append(f"event_scan_slab: the associative limit at J = "
                        f"{SLAB_SHAPES[0][1]} is {limit}, SLAB_WIDE holds "
                        f"{SLAB_WIDE[0][0]}")
    for k, assoc in SLAB_WIDE:
        outs.append(("event_scan_slab", (SLAB_SHAPES[0], k, assoc, True),
                     ops.event_scan_slab(rem, mips, npe, k, tie=tie,
                                         policy=pol, pe_blocked=blk,
                                         row_ok=ok, live=lives[True],
                                         assoc=assoc)))
        calls["event_scan_slab"] += 1
    for case, args in zip(SSD_CASES, ssd_in):
        outs.append(("ssd_scan", case, ops.ssd_scan(*args, chunk=case[6])))
        calls["ssd_scan"] += 1
    for case, (q, k, v) in zip(FLASH_CASES, flash_in):
        outs.append(("flash_attention", case, ops.flash_attention(
            q, k, v, causal=case[6], window=case[7], cap=case[8])))
        calls["flash_attention"] += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(ek.LAUNCHES), dict(ek.PLAIN_CALLS)
    print(f"kernel API: {sum(calls.values())} calls in {wall:.3f} s, "
          f"calls {calls}, launches {launches}, plain calls {plain}",
          flush=True)
    for name in API:
        if launches[name] != calls[name]:
            failures.append(f"kernel API: {name} launched {launches[name]} "
                            f"times in {calls[name]} calls")
    if max(plain.values()) > 0 or any(launches[k] for k in launches
                                      if k not in API):
        failures.append("kernel API: a plain version or another kernel ran")

    errs = dict.fromkeys(API, 0.0)
    for name, case, got in outs:
        if name == "event_scan_slab":
            shape, k, assoc, live = case
            rem, tie, mips, npe, pol, blk, ok = slab_in[shape]
            want = ek.event_scan_slab_ref(
                rem, mips, npe, k, tie=tie, policy=pol, pe_blocked=blk,
                row_ok=ok, live=lives[live], assoc=assoc, tree=True)
            same = all(bits_equal(a, b) for a, b in zip(got, want))
            err = max(abs_err(a, b) for a, b in zip(got, want))
            label = (f"event_scan_slab {list(shape)} k={k} "
                     f"{'assoc' if assoc else 'sequential'} "
                     f"live={live}: {'bitwise' if same else 'DIFF'}")
            ok_ = same
        else:
            if name == "ssd_scan":
                args = ssd_in[SSD_CASES.index(case)]
                want = sk.ssd_scan_ref(*args, chunk=case[6])
                tol = SSD_TOL[case[7]]
                blocks = sk.launch_blocks(*case[1:6], chunk=case[6])
                shape = (f"B {case[1]} S {case[2]} H {case[3]} P {case[4]}"
                         f" N {case[5]} chunk {case[6]}, {case[8]} draws; "
                         f"blocks: states {blocks[0]}, pass {blocks[1]}, "
                         f"output {blocks[2]}")
                if blocks[0] + blocks[2] < 132:
                    failures.append(f"ssd_scan {case[0]}: {blocks[0]} + "
                                    f"{blocks[2]} blocks in the passes "
                                    f"with products, under 132 SMs")
            else:
                q, k, v = flash_in[FLASH_CASES.index(case)]
                want = fk.flash_attention_ref(q, k, v, causal=case[6],
                                              window=case[7], cap=case[8])
                tol = FLASH_TOL[case[9]]
                shape = (f"B {case[1]} Hq {case[2]} Hkv {case[3]} S "
                         f"{case[4]} d {case[5]} causal {case[6]} window "
                         f"{case[7]} cap {case[8]}")
            err = abs_err(got.float(), want.float())
            if name == "flash_attention" and case[9] == BF16:
                rel = row_rel_err(got, want)
                ok_ = rel <= tol
                held = f"row-relative {rel:.6g}, tolerance {tol} per row"
            else:
                ok_ = bool(torch.allclose(got.float(), want.float(),
                                          rtol=tol, atol=tol))
                held = (f"worst |err| / (tol + tol |want|) "
                        f"{allclose_ratio(got, want, tol):.6g}, tolerance "
                        f"{tol}")
            label = (f"{name} {case[0]} {str(got.dtype)[6:]} ({shape}): "
                     f"max_abs_err {err:.6g}, {held} "
                     f"{'ok' if ok_ else 'EXCEEDED'}")
        errs[name] = max(errs[name], err)
        print(label, flush=True)
        if not ok_:
            failures.append(label)
    return launches, errs, (slab_in, ssd_in, flash_in)


def load_cells(dev):
    """Each cell's reference record, gridlets (payloads included for the
    network cells) and fleet, from the committed reference files."""
    from repro_torch.core import gridlet, resource
    refs = {}
    for fname, _ in CELLS.values():
        if fname not in refs:
            with open(os.path.join(ROOT, "tests", "data", fname)) as f:
                refs[fname] = json.load(f)["cells"]

    def f32(bits):
        return torch.from_numpy(np.asarray(bits, np.uint32).view(
            np.float32).copy())

    out = {}
    for name, (fname, _) in CELLS.items():
        c = refs[fname][name]
        fl = c["fleet"]
        fleet = resource.make_fleet(
            fl["num_pe"], f32(fl["mips_per_pe"]), f32(fl["cost_per_sec"]),
            fl["policy"], time_zone=f32(fl["time_zone"]),
            baud_rate=f32(fl["baud_rate"]), device=dev)
        u, nj = c["n_users"], c["n_jobs_per_user"]
        payload = {k: f32(c[k]) for k in ("in_bytes", "out_bytes") if k in c}
        g = gridlet.make_batch(
            f32(c["length_mi"]),
            user=torch.arange(u, dtype=torch.int32).repeat_interleave(nj),
            device=dev, **payload)
        out[name] = (c, g, fleet)
    return out


def experiment_kwargs(c, dev, **kw):
    """``run_experiment``'s arguments for a reference cell: the scenario
    cells add their scenario, and those with payloads the auto-sized
    transfer table."""
    from repro_torch.core import simulation
    out = dict(opt=c["opt"], n_users=c["n_users"], batch=c["batch"],
               device=dev)
    if "scenario" in c:
        out.update(scenario=simulation.Scenario(**c["scenario"]),
                   net_cap=None if c["net_cap"] else 0)
    out.update(kw)
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
    if "n_failed" in r:          # the dynamic-resource cells
        pairs += [("downtime", got_bits(res.downtime), f32("downtime")),
                  ("n_retries", g.n_retries.cpu().long(), ints("n_retries")),
                  ("retry_at", got_bits(g.retry_at), f32("retry_at"))]
    for key in ("n_events", "n_steps", "n_spec", "n_reseeds", "n_scans",
                "overflow", "n_failed", "n_resubmits"):
        if key in r:
            pairs.append((key, torch.tensor([int(getattr(res, key))]),
                          torch.tensor([r[key]])))
    pairs.append(("truncated", torch.tensor([bool(res.truncated)]),
                  torch.tensor([r["truncated"]])))
    for key, got, want in pairs:
        if got.shape != want.shape or not torch.equal(got, want):
            n = int((got != want).sum()) if got.shape == want.shape else -1
            bad.append(f"{name}.{key}: {n} differ")
    return bad


def load_sweep_cells(dev):
    """Each sweep cell's record, gridlets and fleet
    (tests/data/port_ref_sweep.json)."""
    from repro_torch.core import gridlet, resource
    with open(os.path.join(ROOT, "tests", "data",
                           "port_ref_sweep.json")) as f:
        cells = json.load(f)["cells"]
    out = {}
    for name in SWEEP_CELLS:
        c = cells[name]
        fl = c["fleet"]
        fleet = resource.make_fleet(
            fl["num_pe"], f32_tensor(fl["mips_per_pe"]),
            f32_tensor(fl["cost_per_sec"]), fl["policy"],
            time_zone=f32_tensor(fl["time_zone"]),
            baud_rate=f32_tensor(fl["baud_rate"]), device=dev)
        u, nj = c["n_users"], c["n_jobs_per_user"]
        g = gridlet.make_batch(
            f32_tensor(c["length_mi"]),
            user=torch.arange(u, dtype=torch.int32).repeat_interleave(nj),
            device=dev)
        out[name] = (c, g, fleet)
    return out


def f32_tensor(bits):
    return torch.from_numpy(np.asarray(bits, np.uint32).view(
        np.float32).copy())


def sweep_lanes(c, g, fleet, dev, lanes=None, max_events=None):
    """A sweep cell through the lane-batched engine on ``dev``: a grid
    cell as ``simulation.sweep`` runs it (its lanes deadline-major), a
    strategy cell as ``engine.run_sweep_lanes`` over ``Scenario(policy=)``
    lanes; ``lanes`` picks some of them (a lane index list), and
    ``max_events`` cuts every lane's supersteps.  Returns the summarized
    lane-batched result."""
    from repro_torch.core import engine, simulation
    u = c["n_users"]
    if c["kind"] == "grid":
        scen = simulation.Scenario(**c["scenario"])
        dl = f32_tensor(c["deadlines"])
        bl = f32_tensor(c["budgets"])
        if lanes is None and max_events is None:   # the user's entry point
            out = simulation.sweep(g, fleet, dl, bl, opt=c["opt"], n_users=u,
                                   scenario=scen, device=dev)
            return engine._tree_map(
                lambda x: x.reshape((-1,) + x.shape[2:]), out)
        template = simulation._scenario_params(fleet, 0.0, 0.0, c["opt"], u,
                                               scen, dev)
        params = simulation._lane_points(
            template, dl.repeat_interleave(len(bl)), bl.repeat(len(dl)), u)
    else:
        params = engine._stack([simulation._scenario_params(
            fleet, c["deadline"], c["budget"], 0, u,
            simulation.Scenario(policy=opt), dev) for opt in c["policies"]])
    if lanes is not None:
        params = engine._stack([engine._lane(params, i) for i in lanes])
    m_ev = c["max_events"] if max_events is None else max_events
    res = engine.run_sweep_lanes(g, fleet, params, u, m_ev, c["max_jobs"],
                                 batch=c["batch"], device=dev)
    return simulation.summarize(res, params, u, fleet.r, m_ev)


def check_sweep_cell(name, c, out, lanes=None):
    """Every lane bitwise against the record: the small fields and the
    trace in full, the per-gridlet fields by the SHA-256 of their bytes
    (or in full where the record holds them), and the "how" counters;
    returns failures."""
    from repro_torch.core import engine
    bad = []
    lanes = range(len(c["lanes"])) if lanes is None else lanes
    if out.spent.shape[0] != len(lanes):
        return [f"{name}: {out.spent.shape[0]} lanes, {len(lanes)} recorded"]
    for got_i, i in enumerate(lanes):
        w = c["lanes"][i]
        lane = engine._lane(out, got_i)

        def words(t):
            t = t.detach().cpu().contiguous()
            if t.dtype == torch.float32:
                t = t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
            return t.reshape(-1).tolist()

        got = {"n_done": words(lane.n_done), "spent": words(lane.spent),
               "term_time": words(lane.term_time),
               "per_resource_done": words(lane.per_resource_done),
               "trace_t": words(lane.trace[0]),
               "trace_kind": words(lane.trace[1]),
               "trace_who": words(lane.trace[2]),
               "truncated": bool(lane.truncated)}
        for key in ("n_events", "n_steps", "n_spec", "n_reseeds", "n_scans",
                    "overflow"):
            got[key] = int(getattr(lane, key))
        for key, dtype in (("status", np.int32), ("resource", np.int32),
                           ("start", np.float32), ("finish", np.float32),
                           ("returned", np.float32), ("cost", np.float32)):
            x = getattr(lane.gridlets, key).detach().cpu().numpy()
            got[key] = (hashlib.sha256(np.ascontiguousarray(
                x.astype(dtype)).tobytes()).hexdigest()
                if isinstance(w[key], str) else words(torch.from_numpy(x)))
        for key, value in got.items():
            if value != w[key]:
                bad.append(f"{name} lane {i}.{key}")
    return bad


def lane_kernel_checks(dev, gen, failures):
    """The lane forms against their plain versions at the Figs 21-24
    grid's shapes: the checked scan over [144, 16, 32] (lanes of every
    carry case, their flags on and off) with and without the reseed,
    fresh outputs and then a Scratch twice; the frontier over [144, C]
    of the 1u_200j commit layout, with and without cuts, and through a
    Scratch.  Returns the largest |kernel - plain| of each."""
    from repro_torch.kernels import event_scan as ek
    errs = {"event_scan_lanes": 0.0, "event_frontier_lanes": 0.0}
    n_lanes, r, j = 144, 16, 32
    cases = [checked_inputs(r, j, gen, dev) for _ in range(4)]
    args, ranks, flags = [], [], []
    for i in range(n_lanes):
        a, carries = cases[i % 4]
        case, carry, flag = CHECKED_CASES[i % 3]
        args.append(a)
        ranks.append(carries[carry])
        flags.append(flag)
    args = [torch.stack(x) for x in zip(*args)]
    rank = torch.stack(ranks)
    flag = torch.tensor(flags, device=dev)
    names = ("rate", "t_min", "argmin", "occ", "rank")
    scratch = ek.Scratch()
    for reseed in (True, False):
        want, use = ek.event_scan_checked_lanes_ref(*args, rank, flag,
                                                    reseed=reseed)
        outs = [ek.event_scan_checked_lanes_cuda(*args, rank, flag,
                                                 reseed=reseed, scratch=sc)
                for sc in (None, scratch, scratch)]
        torch.cuda.synchronize()
        same = [all(bits_equal(a, o[0][i]) for o in outs)
                for i, a in enumerate(want)]
        same_use = all(bits_equal(use, o[1]) for o in outs)
        errs["event_scan_lanes"] = max([errs["event_scan_lanes"]] + [
            abs_err(a, b) for a, b in zip(want, outs[0][0])])
        print(f"event_scan checked lanes [{n_lanes},{r},{j}] reseed "
              f"{reseed}: " + " ".join(
                  f"{n}={'ok' if x else 'DIFF'}" for n, x in zip(names, same))
              + f" use={'ok' if same_use else 'DIFF'} ({int(use.sum())} of "
              f"{n_lanes} carries held; scratch twice)", flush=True)
        if not all(same) or not same_use:
            failures.append(f"event_scan lanes reseed {reseed}")
    sizes = engine_layout(1, 200, 11, r)
    cand = torch.stack([frontier_inputs(sizes, gen, dev)[0]
                        for _ in range(n_lanes)])
    cuts = torch.rand(cand.shape, generator=gen).to(dev) < 0.7
    for use_cuts in (None, cuts):
        want = ek.event_frontier_lanes_ref(cand, sizes, use_cuts)
        outs = [ek.event_frontier_lanes_cuda(cand, sizes, use_cuts)]
        if use_cuts is None:
            outs += [ek.event_frontier_lanes_cuda(cand, sizes,
                                                  scratch=scratch)
                     for _ in range(2)]
        torch.cuda.synchronize()
        same = all(bits_equal(a, o[i]) for o in outs
                   for i, a in enumerate(want))
        errs["event_frontier_lanes"] = max([errs["event_frontier_lanes"]] + [
            abs_err(a, b) for a, b in zip(want, outs[0])])
        print(f"event_frontier lanes [{n_lanes},{sum(sizes)}] cuts "
              f"{'yes' if use_cuts is not None else 'no'}: "
              f"{'ok' if same else 'DIFF'}", flush=True)
        if not same:
            failures.append("event_frontier lanes")
    return errs, (args, rank, flag, cand, sizes)


def sweep_window(c, g, fleet, dev, lanes=None):
    """The first SWEEP_WINDOW supersteps of every lane of a sweep cell,
    once unprofiled (wall, iterations, host syncs) and once under the
    profiler (device busy time, idle share, kernel launches a loop
    iteration, top kernels).  Returns (launches, iterations)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sweep_lanes(c, g, fleet, dev, lanes, max_events=SWEEP_WINDOW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sweep_lanes(c, g, fleet, dev, lanes, max_events=SWEEP_WINDOW)
        torch.cuda.synchronize()
    by_name = {}
    for e in device_events(prof):
        k = e.name.split("(")[0][-48:]
        n, us = by_name.get(k, (0, 0.0))
        by_name[k] = (n + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in by_name.values()) / 1e6
    n_kernels = sum(n for n, _ in by_name.values())
    iters = int(out.n_steps.max())
    print(f"window: {out.spent.shape[0]} lanes, {iters} loop iterations, "
          f"wall {wall:.3f} s (unprofiled), device busy {busy:.3f} s, idle "
          f"share {1 - busy / wall:.4f}, {n_kernels} kernel launches "
          f"({n_kernels / iters:.1f} a loop iteration), host syncs "
          f"{out.host_syncs} ({out.host_syncs / iters:.2f} a loop "
          f"iteration)", flush=True)
    for k, (n, us) in sorted(by_name.items(), key=lambda x: -x[1][1])[:8]:
        print(f"  {k:48s} {n:7d} launches {us / 1e3:9.3f} ms", flush=True)
    return n_kernels, iters


def sweep_phase(dev, failures):
    """The sweep engine on the card: each sweep cell against
    tests/data/port_ref_sweep.json (every lane bitwise, "how" counters
    included), both lane kernels launched (counts zeroed just before the
    run, read just after) and no plain version; each cell's wall, loop
    iterations and host syncs a loop iteration, then the same for the
    Figs 21-24 grid's slowest lane alone through the lane engine (L = 1),
    and a profiled window of each (kernel launches a loop iteration).
    Fails if the grid's launches a loop iteration exceed twice its
    slowest lane's, or its host syncs a loop iteration exceed the lane's
    by more than 2.  Returns the lane kernels' launches on the grid."""
    from repro_torch.kernels import event_scan as ek
    cells = load_sweep_cells(dev)
    launches, per_iter = {}, {}
    for name in SWEEP_CELLS:
        c, g, fleet = cells[name]
        ek.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sweep_lanes(c, g, fleet, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, plain = dict(ek.LAUNCHES), dict(ek.PLAIN_CALLS)
        bad = check_sweep_cell(name, c, out)
        iters = int(out.n_steps.max())
        if name == SWEEP_GRID:
            launches = {k: counts[k] for k in SWEEP_PATH}
            slowest = int(torch.argmax(out.n_steps + out.n_spec))
        print(f"{name}: {out.spent.shape[0]} lanes, wall {wall:.3f} s, "
              f"{iters} loop iterations, supersteps {int(out.n_steps.sum())}"
              f" + {int(out.n_spec.sum())} speculative over the lanes, "
              f"reseeds {int(out.n_reseeds.sum())}, host syncs "
              f"{out.host_syncs} ({out.host_syncs / iters:.2f} a loop "
              f"iteration), lane kernel launches "
              f"{ {k: counts[k] for k in SWEEP_PATH} } "
              f"({ {k: round(counts[k] / iters, 3) for k in SWEEP_PATH} } a "
              f"loop iteration), plain calls {plain}", flush=True)
        print(f"{name}: " + ("every lane bitwise equal to the reference "
                             "(the 'what' fields, the trace and the 'how' "
                             "counters)" if not bad else "; ".join(bad[:20])),
              flush=True)
        failures += bad
        if min(counts[k] for k in SWEEP_PATH) <= 0:
            failures.append(f"{name}: a lane kernel was never launched")
        if max(plain.values()) > 0:
            failures.append(f"{name}: a plain version ran on the card")
        per_iter[name] = (iters, out.host_syncs)
    c, g, fleet = cells[SWEEP_GRID]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = sweep_lanes(c, g, fleet, dev, lanes=[slowest])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    failures += check_sweep_cell(f"{SWEEP_GRID} slowest", c, one,
                                 lanes=[slowest])
    iters1 = int(one.n_steps.max())
    print(f"{SWEEP_GRID} slowest lane ({slowest}) alone (L = 1): wall "
          f"{wall:.3f} s, {iters1} loop iterations, host syncs "
          f"{one.host_syncs} ({one.host_syncs / iters1:.2f} a loop "
          f"iteration)", flush=True)
    iters, syncs = per_iter[SWEEP_GRID]
    sync_gap = syncs / iters - one.host_syncs / iters1
    print(f"{SWEEP_GRID}: host syncs a loop iteration {syncs / iters:.3f} "
          f"at L = 144 against {one.host_syncs / iters1:.3f} for its "
          f"slowest lane alone (+{sync_gap:.3f})", flush=True)
    if sync_gap > 2.0:
        failures.append(f"{SWEEP_GRID}: host syncs a loop iteration "
                        f"+{sync_gap}")
    return launches, (cells, slowest)


def sweep_windows(dev, cells, slowest, failures):
    """The profile phase's sweep windows: the first SWEEP_WINDOW
    supersteps of every lane of each sweep cell and of the Figs 21-24
    grid's slowest lane alone; fails if the grid's kernel launches a loop
    iteration exceed twice its slowest lane's."""
    found = {}
    for name in SWEEP_CELLS + ("slowest",):
        phase(f"where the time goes: the first {SWEEP_WINDOW} supersteps "
              f"of each lane of " + (name if name != "slowest" else
                                     f"{SWEEP_GRID}'s slowest lane alone"))
        c, g, fleet = cells[SWEEP_GRID if name == "slowest" else name]
        found[name] = sweep_window(
            c, g, fleet, dev, lanes=[slowest] if name == "slowest" else None)
    (n_l, it_l), (n_1, it_1) = found[SWEEP_GRID], found["slowest"]
    ratio = (n_l / it_l) / (n_1 / it_1)
    print(f"{SWEEP_GRID}: kernel launches a loop iteration {n_l / it_l:.1f} "
          f"at L = 144 against {n_1 / it_1:.1f} for its slowest lane alone "
          f"(x{ratio:.3f})", flush=True)
    if ratio > 2.0:
        failures.append(f"{SWEEP_GRID}: launches a loop iteration x{ratio}")


def check_rand(dev):
    """``rand.exponential``'s ``-log1p(-u)`` over every f32 uniform on the
    card against the SHA-256 of jitted JAX's, and the recorded draws of
    both threefry layouts, keys on the card; returns failures."""
    from repro_torch.core import numerics, rand
    with open(os.path.join(ROOT, "tests", "data", "port_ref_rand.json")) as f:
        ref = json.load(f)
    bad = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mant = torch.arange(2 ** 23, dtype=torch.int32, device=dev) | 0x3F800000
    u = mant.view(torch.float32) - 1.0
    e = -numerics.log1p(-u)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    digest = hashlib.sha256(e.cpu().numpy().tobytes()).hexdigest()
    ok = digest == ref["log1p_sha256"]
    print(f"exponential(1) over all 2**23 uniforms on the card: "
          f"{ms:.1f} ms, SHA-256 {'equal to' if ok else 'DIFFERS from'} "
          f"jitted JAX's", flush=True)
    if not ok:
        bad.append("rand: log1p over every uniform")

    def words(t):
        return t.detach().cpu().reshape(-1).tolist()

    def f32_bits(t):
        return words(t.contiguous().view(torch.int32).to(torch.int64) &
                     rand.MASK)

    for flag, seeds in ref["partitionable"].items():
        part = flag == "True"
        same = 0
        for seed, r in seeds.items():
            key = rand.PRNGKey(int(seed), dev)
            k, chain = key, []
            for _ in r["chain"]:
                k, sub = rand.split(k, partitionable=part)
                chain.append(words(k) + words(sub))
            n = len(r["bits"])
            got = {"key": words(key), "chain": chain,
                   "split3": words(rand.split(key, 3, part)),
                   "bits": words(rand.random_bits(key, (n,), part)),
                   "uniform": f32_bits(rand.uniform(key, (n,), part)),
                   "exponential": f32_bits(rand.exponential(
                       key, torch.ones(n, device=dev), part))}
            for name, want in got.items():
                if want == r[name]:
                    same += 1
                else:
                    bad.append(f"rand: partitionable={flag} seed {seed} "
                               f"{name}")
        print(f"threefry partitionable={flag}: {same} of "
              f"{6 * len(seeds)} recorded draws bitwise (keys, split "
              f"chains, split(key, 3), {n}-word bits, uniform, "
              f"exponential)", flush=True)
    return bad


def windows(cells, dev, names=(MAIN_CELL, "200u_10j") + NET_CELLS +
            FAIL_CELLS + ECON_WINDOWS):
    """The profile phase: the first WINDOW supersteps of the main cell,
    both network cells and (by default) 200u_10j, both full-width
    dynamic-resource cells and the reservation and auction cells, once
    unprofiled (wall, host syncs and
    link_scan launches) and once under the profiler (device busy time,
    idle share, kernel launches per superstep, top kernels)."""
    from repro_torch.core import simulation
    from repro_torch.kernels import event_scan as ek
    for name in names:
        phase(f"where the time goes: the first {WINDOW} supersteps of "
              f"{name}")
        c, g, fleet = cells[name]
        window = experiment_kwargs(c, dev, max_events=WINDOW)
        ek.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = simulation.run_experiment(g, fleet, c["deadline"],
                                        c["budget"], **window)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_link = ek.LAUNCHES["link_scan"]
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
              f"superstep), link_scan launches {n_link} "
              f"({n_link / steps:.2f} per superstep), host syncs "
              f"{res.host_syncs} ({res.host_syncs / steps:.2f} per "
              f"superstep)", flush=True)
        for k, (n, us) in sorted(by_name.items(),
                                 key=lambda x: -x[1][1])[:8]:
            print(f"  {k:48s} {n:7d} launches {us / 1e3:9.3f} ms",
                  flush=True)
    ek.reset_counts()


def f32_attention_times(dev):
    """Device ms per call of the f32 attention kernel at every f32
    FLASH_CASES shape."""
    from repro_torch.kernels import flash_attention as fk
    dgen = torch.Generator(device=dev).manual_seed(14)
    for case in FLASH_CASES:
        if case[9] != F32:
            continue
        q, k, v = flash_inputs(*case[1:6], F32, dgen, dev)
        kw = dict(causal=case[6], window=case[7], cap=case[8])
        ms, _ = device_ms(lambda: fk.flash_attention_cuda(q, k, v, **kw),
                          kernels=KERNEL_NAME["flash_attention"], reps=10)
        print(f"flash_attention {case[0]} float32: {ms} ms device per call",
              flush=True)


def compare(dev):
    """``--compare``: the card line, the engine's link-scan call, the f32
    attention kernel's times and the profile windows of the tree beside
    this script."""
    phase("card")
    print(card_line(), flush=True)
    cells = load_cells(dev)
    phase("the engine's link scan call")
    engine_link_calls(cells, torch.Generator().manual_seed(20), dev)
    phase("f32 attention")
    f32_attention_times(dev)
    windows(cells, dev, names=(MAIN_CELL,) + NET_CELLS)
    return 0


def sweep_only(dev):
    """``--sweep``: the card line, the build, the lane kernels' checks,
    the sweep phase and its windows; exits 1 on a failure."""
    phase("card")
    print(card_line(), flush=True)
    phase("build")
    from repro_torch.kernels import event_scan as ek
    ek._lib()
    failures = []
    phase("lane kernels against their plain versions (bitwise)")
    lane_kernel_checks(dev, torch.Generator().manual_seed(24), failures)
    phase("sweep")
    _, ctx = sweep_phase(dev, failures)
    sweep_windows(dev, *ctx, failures)
    print("FAILED: " + "; ".join(failures) if failures else "sweep ok",
          flush=True)
    return 1 if failures else 0


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    # the plain versions' f32 products stay in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    if sys.argv[1:] == ["--compare"]:
        return compare(dev)
    if sys.argv[1:] == ["--sweep"]:
        return sweep_only(dev)
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
    check_kernel_build(failures)

    phase("kernels against their plain versions (bitwise)")
    gen = torch.Generator().manual_seed(0)
    errs = {"event_scan": 0.0, "event_frontier": 0.0, "link_scan": 0.0}
    names = ("rate", "t_min", "argmin", "occ", "rank")
    for r, j in SCAN_SHAPES:
        rem, tie, mips, npe, pol, blk, ok = scan_inputs(r, j, gen, dev)
        hrem, htie, hok = tie_heavy(rem, tie, ok)
        for table, (rem, tie, ok) in (("", (rem, tie, ok)),
                                      (" ties", (hrem, htie, hok))):
            kw = dict(tie=tie, policy=pol, pe_blocked=blk, row_ok=ok,
                      with_rank=True)
            want = ek.event_scan_ref(rem, mips, npe, **kw)
            got = ek.event_scan_cuda(rem, mips, npe, **kw)
            rank_in = want[4]
            want_i = ek.event_scan_ref(rem, mips, npe, rank=rank_in, **kw)
            got_i = ek.event_scan_cuda(rem, mips, npe, rank=rank_in, **kw)
            torch.cuda.synchronize()
            for form, w, gt in (("fresh", want, got),
                                ("injected", want_i, got_i)):
                form += table
                same = [bits_equal(a, b) for a, b in zip(w, gt)]
                errs["event_scan"] = max([errs["event_scan"]] + [
                    abs_err(a, b) for a, b in zip(w, gt)])
                print(f"event_scan {form:14s} [{r},{j}]: " + " ".join(
                    f"{n}={'ok' if s else 'DIFF'}"
                    for n, s in zip(names, same)), flush=True)
                if not all(same):
                    failures.append(f"event_scan {form} [{r},{j}]")
        # the checked form, fresh outputs and then the engine's reused
        # ones (two calls of each case: both sets of the scratch)
        args, carries = checked_inputs(r, j, gen, dev)
        scratch = ek.Scratch()
        for case, carry, flag in CHECKED_CASES:
            flag = torch.tensor(flag, device=dev)
            n_want, n_got, n_scr = (torch.zeros((), dtype=torch.int32,
                                                device=dev) for _ in range(3))
            want = ek.event_scan_checked_ref(*args, carries[carry], flag,
                                             n_want)
            got = ek.event_scan_checked_cuda(*args, carries[carry], flag,
                                             n_got)
            same = [bits_equal(a, b) for a, b in zip(want, got)]
            for _ in range(2):
                ek.event_scan_checked_ref(*args, carries[carry], flag, n_want)
                scr = ek.event_scan_checked_cuda(*args, carries[carry], flag,
                                                 n_scr, scratch=scratch)
                same += [bits_equal(a, b) for a, b in zip(want, scr)]
            torch.cuda.synchronize()
            reseeds = (int(n_want), int(n_got), int(n_scr))
            same.append(reseeds == (3 * reseeds[1], reseeds[1],
                                    2 * reseeds[1]))
            errs["event_scan"] = max([errs["event_scan"]] + [
                abs_err(a, b) for a, b in zip(want, got)])
            used = "carry" if bits_equal(want[4], carries[carry]) else "fresh"
            print(f"event_scan checked [{r},{j}] {case}: rank {used}, "
                  f"reseeds {reseeds[1]}: " + " ".join(
                      f"{n}={'ok' if s else 'DIFF'}"
                      for n, s in zip(names, same)) +
                  f" (scratch {'ok' if all(same[5:]) else 'DIFF'})",
                  flush=True)
            if not all(same) or (used == "carry") != (case == "carry kept"):
                failures.append(f"event_scan checked [{r},{j}] {case}")
    layouts = {"engine 20u_100j": engine_layout(20, 100, 11, 16),
               "engine 4u_512j": engine_layout(4, 512, 2, 8),
               "random": tuple(int(x) for x in torch.randint(
                   0, 300, (9,), generator=gen))}
    scratch = ek.Scratch()
    for name, sizes in layouts.items():
        cand, cuts = frontier_inputs(sizes, gen, dev)
        for use_cuts in (None, cuts):
            want = ek.event_frontier_ref(cand, sizes, use_cuts)
            got = ek.event_frontier_cuda(cand, sizes, use_cuts)
            # the engine's call: candidates unchecked, reused outputs
            got_s = ((ek.event_frontier_cuda(cand, sizes, scratch=scratch),)
                     if use_cuts is None else ())
            torch.cuda.synchronize()
            same = all(bits_equal(a, b) for out in (got,) + got_s
                       for a, b in zip(want, out))
            errs["event_frontier"] = max([errs["event_frontier"]] + [
                abs_err(a, b) for a, b in zip(want, got)])
            print(f"event_frontier {name} (C={sum(sizes)}, "
                  f"cuts={'yes' if use_cuts is not None else 'no'}): "
                  f"{'ok' if same else 'DIFF'}", flush=True)
            if not same:
                failures.append(f"event_frontier {name}")

    lane_errs, lane_in = lane_kernel_checks(
        dev, torch.Generator().manual_seed(24), failures)
    errs.update(lane_errs)

    names = ("rate", "t_min", "argmin", "occ")
    for l, t in LINK_SHAPES:
        rem, tie, baud, bg, cap = link_inputs(l, t, gen, dev)
        odd = odd_ties(l, t, gen, dev)
        lg = slot_map(rem, gen)
        trunks = check_trunks(l, dev)
        scratch = ek.Scratch()
        for form, plain_fn, fn in (
                ("private", lambda: ek.link_scan_ref(rem, baud, bg=bg,
                                                     tie=tie),
                 lambda: (ek.link_scan_cuda(rem, baud, bg=bg, tie=tie),)),
                ("trunk cap", lambda: ek.link_scan_ref(rem, baud, bg=bg,
                                                       tie=tie, cap=cap),
                 lambda: (ek.link_scan_cuda(rem, baud, bg=bg, tie=tie,
                                            cap=cap),)),
                ("odd ties", lambda: ek.link_scan_ref(rem, baud, bg=bg,
                                                      tie=odd, cap=cap),
                 lambda: (ek.link_scan_cuda(rem, baud, bg=bg, tie=odd,
                                            cap=cap),)),
                # the engine form: fresh outputs, then both scratch sets
                ("engine", lambda: ek.link_scan_tabled_ref(
                    lg, rem, ek.LinkRows(baud, bg)),
                 lambda: tuple(ek.link_scan_tabled_cuda(
                     lg, rem, ek.LinkRows(baud, bg), scratch=sc)
                     for sc in (None, scratch, scratch))),
                ("engine trunk", lambda: ek.link_scan_tabled_ref(
                    lg, rem, ek.LinkRows(baud, bg, *trunks)),
                 lambda: tuple(ek.link_scan_tabled_cuda(
                     lg, rem, ek.LinkRows(baud, bg, *trunks), scratch=sc)
                     for sc in (None, scratch, scratch)))):
            want, gots = plain_fn(), fn()
            torch.cuda.synchronize()
            same = [all(bits_equal(a, out[i]) for out in gots)
                    for i, a in enumerate(want)]
            errs["link_scan"] = max([errs["link_scan"]] + [
                abs_err(a, b) for a, b in zip(want, gots[0])])
            # the scratch's two calls must write its two output sets
            rings = len(gots) < 3 or (gots[1][0].data_ptr() !=
                                      gots[2][0].data_ptr())
            print(f"link_scan {form:12s} [{l},{t}]: " + " ".join(
                f"{n}={'ok' if s_ else 'DIFF'}" for n, s_ in zip(names,
                                                                 same)) +
                ("" if len(gots) < 3 else
                 f" (scratch {'ok' if rings else 'ONE SET'})"), flush=True)
            if not all(same) or not rings:
                failures.append(f"link_scan {form} [{l},{t}]")

    phase("main path: run_experiment on the card vs the JAX reference")
    from repro_torch.core import simulation
    cells = load_cells(dev)
    launches = {}
    for name, (_, path) in CELLS.items():
        c, g, fleet = cells[name]
        ek.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = simulation.run_experiment(
            g, fleet, c["deadline"], c["budget"], **experiment_kwargs(c, dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ek.LAUNCHES)
        plain = dict(ek.PLAIN_CALLS)
        if name == MAIN_CELL:
            launches.update({k: counts[k] for k in PATH})
        if name == NET_CELL:
            launches["link_scan"] = counts["link_scan"]
        if name in NET_CELLS:
            net_steps = int(res.n_steps) + int(res.n_spec)
            print(f"{name}: per superstep {res.host_syncs / net_steps:.2f} "
                  f"host syncs, {counts['link_scan'] / net_steps:.2f} "
                  f"link_scan launches", flush=True)
        bad = check_cell(name, c, res)
        steps = int(res.n_steps) + int(res.n_spec)
        per_step = {k: round(counts[k] / steps, 3) for k in path}
        print(f"{name}: wall {wall:.3f} s, supersteps {int(res.n_steps)}, "
              f"speculative {int(res.n_spec)}, reseeds "
              f"{int(res.n_reseeds)}, scans {int(res.n_scans)}, events "
              f"{int(res.n_events)}, host syncs {res.host_syncs} "
              f"({res.host_syncs / steps:.2f} per superstep), "
              f"launches {counts} ({per_step} per superstep), plain calls "
              f"{plain}, done {int(res.n_done.sum())}, spent "
              f"{float(res.spent.sum())}, failed {int(res.n_failed)}, "
              f"resubmitted {int(res.n_resubmits)}", flush=True)
        print(f"{name}: " + ("bitwise equal to the reference (every "
                             "counter, trace, status and float field)"
                             if not bad else "; ".join(bad)), flush=True)
        failures += bad
        if min(counts[k] for k in path) <= 0:
            failures.append(f"{name}: a kernel was never launched")
        if max(plain.values()) > 0:
            failures.append(f"{name}: a plain version ran on the card")

    phase("sweep: simulation.sweep and engine.run_sweep_lanes on the card "
          "vs the JAX reference")
    sweep_launches, sweep_ctx = sweep_phase(dev, failures)
    launches.update(sweep_launches)

    phase("rand: the threefry and XLA:CPU's log1p on the card")
    failures += check_rand(dev)

    phase("kernel API: ops.event_scan_slab, ops.ssd_scan and "
          "ops.flash_attention on the card")
    api_launches, api_errs, api_in = kernel_api(dev, failures)
    launches.update({k: api_launches[k] for k in API})
    errs.update(api_errs)

    phase("times (ms per call: device time from the profiler, call time "
          "from CUDA events)")
    c, g, fleet = cells[MAIN_CELL]
    r, j = 16, min(g.n, c["n_users"] * 2 * int(fleet.num_pe.max()))
    rem, tie, mips, npe, pol, blk, ok = scan_inputs(r, j, gen, dev)
    kw = dict(tie=tie, policy=pol, pe_blocked=blk, row_ok=ok,
              with_rank=True)
    rank_in = ek.event_scan_ref(rem, mips, npe, **kw)[4]
    sizes = engine_layout(c["n_users"], c["n_jobs_per_user"], fleet.r, r)
    cand, _ = frontier_inputs(sizes, gen, dev)
    f4 = 4
    lt = min(g.n, c["n_users"] * 2 * int(fleet.num_pe.max()))
    lrem, ltie, lbaud, lbg, lcap = link_inputs(r, lt, gen, dev)
    # the engine form as the engine calls it: the trunk cell's own rows
    # (R_pad 16, resources 0-4 behind one trunk) and a slot map, into a
    # scratch
    from repro_torch.core import engine
    tc, _, tfleet = cells[TRUNK_CELL]
    estate, eparams, en, er = engine_link_state(tc, tfleet, lt, gen, dev)
    trunk_rows = engine._link_rows(estate, eparams, en, er)
    private_rows = trunk_rows._replace(trunk_of=None, trunk_baud=None,
                                       trunk_bg=None)
    elg, erem, escratch = estate.link_gridlet, estate.link_rem, ek.Scratch()
    # bytes: rem and tie read, rate written, the row vectors read and
    # written once each; the work is a few compares and one divide per
    # slot, far below the bytes' time
    link_bytes = 3 * r * lt * f4 + (2 + 3) * r * f4
    link_ops = 8 * r * lt
    scan_bytes = (2 * r * j + 5 * r) * f4 + (r * j + 3 * r) * f4
    # The function's own work, not the kernel's: a fresh rank needs a
    # sort of each row (J log2 J compares), not the J^2 pairwise count.
    sort_ops = r * j * int(np.ceil(np.log2(max(j, 2))))
    # the checked form as the engine calls it, with the carry kept (the
    # main path's common case): slot map, carry, the occupied slots'
    # remaining and the row vectors read, the flag and the counter read,
    # rate and rank and the row outputs written, the counter written;
    # the check's ~6 operations a slot and the scan's ~12
    cargs, carries = checked_inputs(r, j, gen, dev)
    ckept, cflag = carries["kept"], torch.tensor(True, device=dev)
    ccount, pcount = (torch.zeros((), dtype=torch.int32, device=dev)
                      for _ in range(2))
    cscratch = ek.Scratch()
    occupied = int((cargs[0] >= 0).sum())
    checked_bytes = ((2 * r * j + occupied + 5 * r + 1) * f4 + 1 +
                     (2 * r * j + 3 * r + 1) * f4)
    # the lane forms at the Figs 21-24 grid's shapes, as the sweep engine
    # calls them (into a scratch): per lane the checked form's bytes
    # (less the counter, plus the lane's use flag) and operations; the
    # frontier's candidates read and its outputs written, per lane
    largs, lrank, lflag, lcand, lsizes = lane_in
    n_lanes, lr, lj = largs[0].shape
    l_occ = int((largs[0] >= 0).sum())
    lane_bytes = ((2 * n_lanes * lr * lj + l_occ + 5 * n_lanes * lr) * f4 +
                  n_lanes + (2 * n_lanes * lr * lj + 3 * n_lanes * lr) * f4 +
                  n_lanes)
    lfront_bytes = (lcand.numel() + len(lsizes) + 1) * f4 + n_lanes * (
        2 * f4 + len(lsizes) * (1 + 2 * f4))
    lscratch = ek.Scratch()
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
            ("event_scan", "checked",
             lambda: ek.event_scan_checked_cuda(*cargs, ckept, cflag, ccount,
                                                scratch=cscratch),
             lambda: ek.event_scan_checked_ref(*cargs, ckept, cflag, pcount),
             checked_bytes, 18 * r * j),
            ("event_frontier", "engine layout",
             lambda: ek.event_frontier_cuda(cand, sizes, scratch=cscratch),
             lambda: ek.event_frontier_ref(cand, sizes),
             (sum(sizes) + len(sizes) + 1) * f4 + 2 * f4 +
             len(sizes) * (1 + 2 * f4), 3 * sum(sizes)),
            ("event_scan_lanes", "checked",
             lambda: ek.event_scan_checked_lanes_cuda(
                 *largs, lrank, lflag, scratch=lscratch),
             lambda: ek.event_scan_checked_lanes_ref(*largs, lrank, lflag),
             lane_bytes, 18 * n_lanes * lr * lj),
            ("event_frontier_lanes", "engine layout",
             lambda: ek.event_frontier_lanes_cuda(lcand, lsizes,
                                                  scratch=lscratch),
             lambda: ek.event_frontier_lanes_ref(lcand, lsizes),
             lfront_bytes, 3 * lcand.numel()),
            ("link_scan", "trunk cap",
             lambda: ek.link_scan_cuda(lrem, lbaud, bg=lbg, tie=ltie,
                                       cap=lcap),
             lambda: ek.link_scan_ref(lrem, lbaud, bg=lbg, tie=ltie,
                                      cap=lcap),
             link_bytes + r * f4, link_ops),
            ("link_scan", "private",
             lambda: ek.link_scan_cuda(lrem, lbaud, bg=lbg, tie=ltie),
             lambda: ek.link_scan_ref(lrem, lbaud, bg=lbg, tie=ltie),
             link_bytes, link_ops),
            ("link_scan", "engine trunk",
             lambda: ek.link_scan_tabled_cuda(elg, erem, trunk_rows,
                                              scratch=escratch),
             lambda: ek.link_scan_tabled_ref(elg, erem, trunk_rows),
             link_bytes + 3 * er * f4, link_ops),
            ("link_scan", "engine private",
             lambda: ek.link_scan_tabled_cuda(elg, erem, private_rows,
                                              scratch=escratch),
             lambda: ek.link_scan_tabled_ref(elg, erem, private_rows),
             link_bytes, link_ops)):
        call_ms = time_ms(fn)
        kernel_names = KERNEL_NAME.get(f"{name} {form}", KERNEL_NAME[name])
        ms, per = device_ms(fn, kernels=kernel_names)
        if ms is None:
            failures.append(f"{name} {form}: the profiler recorded no "
                            f"device time for {kernel_names}")
        if len(per) > 1:
            print(f"{name} {form}: {len(per)} launches per call, device ms "
                  f"per call by kernel {per}", flush=True)
        plain_ms = time_ms(plain_fn, reps=50)
        plain_dev, _ = device_ms(plain_fn)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / F32_OPS_PER_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        shape = {"link_scan": f"[{r},{lt}]",
                 "event_frontier": f"[{sum(sizes)}]",
                 "event_scan_lanes": f"[{n_lanes},{lr},{lj}]",
                 "event_frontier_lanes": f"[{n_lanes},{sum(lsizes)}]"}.get(
                     name, f"[{r},{j}]")
        print(f"{name} {form} {shape}: kernel {ms} ms device "
              f"({call_ms:.5f} ms per call), plain {plain_ms:.5f} ms per "
              f"call ({plain_dev} ms device), bound {bound_ms:.7f} ms "
              f"({by}: {nbytes} B, {n_ops} ops), library call: none",
              flush=True)
        rows.append((name, form, ms, plain_ms, bound_ms, by, call_ms,
                     plain_dev, None, shape))
    engine_link_calls(cells, gen, dev)

    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ssd_scan as sk
    slab_in, ssd_in, flash_in = api_in
    k_slab = SLAB_KS[-1]
    timed = []
    for sr, sj in SLAB_SHAPES:
        srem, stie, smips, snpe, spol, sblk, sok = slab_in[(sr, sj)]
        skw = dict(tie=stie, policy=spol, pe_blocked=sblk, row_ok=sok)
        n_ops = slab_ops(slab_in[(sr, sj)], k_slab)
        slab_bytes = (2 * sr * sj + 5 * sr) * f4 + sr * k_slab * 8
        where = "" if (sr, sj) == SLAB_SHAPES[0] else f" [{sr},{sj}]"
        for assoc in (True, False):
            timed.append((
                "event_scan_slab",
                ("assoc" if assoc else "sequential") + where,
                f"[{sr},{sj}] k={k_slab}",
                lambda a=assoc, x=(srem, smips, snpe), kw=skw:
                    ek.event_scan_slab_cuda(*x, k_slab, assoc=a, **kw),
                lambda a=assoc, x=(srem, smips, snpe), kw=skw:
                    ek.event_scan_slab_ref(*x, k_slab, assoc=a, tree=True,
                                           **kw),
                None, slab_bytes, n_ops, F32_OPS_PER_S, 200, 20, ""))
    srem, stie, smips, snpe, spol, sblk, sok = slab_in[SLAB_SHAPES[0]]
    sr, sj = SLAB_SHAPES[0]
    skw = dict(tie=stie, policy=spol, pe_blocked=sblk, row_ok=sok)
    for k_w, assoc in SLAB_WIDE:
        timed.append((
            "event_scan_slab",
            f"{'assoc' if assoc else 'sequential'} k={k_w}",
            f"[{sr},{sj}] k={k_w}",
            lambda a=assoc, k_=k_w: ek.event_scan_slab_cuda(
                srem, smips, snpe, k_, assoc=a, **skw),
            lambda a=assoc, k_=k_w: ek.event_scan_slab_ref(
                srem, smips, snpe, k_, assoc=a, tree=True, **skw),
            None, (2 * sr * sj + 5 * sr) * f4 + sr * k_w * 8,
            slab_ops(slab_in[SLAB_SHAPES[0]], k_w), F32_OPS_PER_S, 20, 3,
            ""))
    for case, args in zip(SSD_CASES, ssd_in):
        _, b, s_, h, p_, n, q_, dt_, draws = case
        pq = q_ * (q_ + 1) // 2       # causal (query, key) pairs a chunk
        ops_ = b * (s_ // q_) * (2 * pq * n + 2 * pq * h * p_ +
                                 4 * q_ * h * p_ * n)
        nbytes = 2 * args[0].numel() * args[0].element_size() + 4 * (
            b * s_ * h + h + 2 * b * s_ * n)
        # f32: the least time for the products at f32 accuracy is three
        # TF32 products each on the tensor cores; bf16 is bound by bytes
        ops_, peak = ((ops_, BF16_OPS_PER_S) if dt_ == BF16 else
                      (3 * ops_, TF32_OPS_PER_S))
        timed.append((
            "ssd_scan", f"{case[0]} {str(dt_)[6:]} {draws} draws",
            f"B {b} S {s_} H {h} P {p_} N {n} chunk {q_}",
            lambda a=args, c=q_: sk.ssd_scan_cuda(*a, chunk=c),
            lambda a=args, c=q_: sk.ssd_scan_ref(*a, chunk=c),
            None, nbytes, ops_, peak, 10, 10, ""))
    for case, (q, k, v) in zip(FLASH_CASES, flash_in):
        _, b, hq, hkv, s_, d, causal, window, cap, dt_ = case
        kw = dict(causal=causal, window=window, cap=cap)
        ops_ = 4 * b * hq * attended_pairs(s_, s_, causal, window) * d
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        # f32: the least time for the products at f32 accuracy is three
        # TF32 products each on the tensor cores; the same flops on the
        # FP32 pipes are printed beside it
        n_ops, peak, note = ops_, BF16_OPS_PER_S, ""
        if dt_ == F32:
            n_ops, peak = 3 * ops_, TF32_OPS_PER_S
            note = (f"; f32 bound {ops_ / F32_OPS_PER_S * 1e3:.7f} ms "
                    f"({ops_} ops at {F32_OPS_PER_S:.3g}/s)")
        timed.append((
            "flash_attention", f"{case[0]} {str(dt_)[6:]}",
            f"B {b} Hq {hq} Hkv {hkv} S {s_} d {d} causal {causal} "
            f"window {window} cap {cap}",
            lambda q=q, k=k, v=v, kw=kw: fk.flash_attention_cuda(q, k, v,
                                                                 **kw),
            lambda q=q, k=k, v=v, kw=kw: fk.flash_attention_ref(q, k, v,
                                                                **kw),
            None if cap else library_attention(q, k, v, causal, window),
            nbytes, n_ops, peak, 10, 10, note))
    for (name, form, shape, fn, plain_fn, lib_fn, nbytes, n_ops, peak,
         reps, plain_reps, note) in timed:
        call_ms = time_ms(fn, reps=reps, warm=min(reps, 10))
        ms, per = device_ms(fn, kernels=KERNEL_NAME[name], reps=reps)
        if ms is None:
            failures.append(f"{name} {form}: the profiler recorded no "
                            f"device time for {KERNEL_NAME[name]}")
        if len(per) > 1:
            print(f"{name} {form}: {len(per)} launches per call, device ms "
                  f"per call by kernel {per}", flush=True)
        plain_ms = time_ms(plain_fn, reps=plain_reps,
                           warm=min(plain_reps, 3))
        lib_ms = None if lib_fn is None else time_ms(lib_fn, reps=reps,
                                                     warm=3)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / peak * 1e3
        bound_ms = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"{name} {form} ({shape}): kernel {ms} ms device per call "
              f"({call_ms:.5f} ms per call, CUDA events), plain "
              f"{plain_ms:.5f} ms per call, bound {bound_ms:.7f} ms ({by}: "
              f"{nbytes} B, {n_ops} "
              f"ops at {peak:.3g}/s{note}), library call: "
              f"{'none' if lib_ms is None else f'{lib_ms:.5f} ms'}",
              flush=True)
        rows.append((name, form, ms, plain_ms, bound_ms, by, call_ms, None,
                     lib_ms, shape))
    ek.reset_counts()

    windows(cells, dev)
    sweep_windows(dev, *sweep_ctx, failures)

    kernels = []
    for name in REPLACES:
        mine = [x for x in rows if x[0] == name]
        # the first form of each kernel leads: event_scan fresh,
        # link_scan with the trunk cap, the slab's associative form, the
        # mamba2-130m bf16 SSD layer, the qwen2-7b bf16 attention layer
        first = mine[0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": SOURCE.get(
                name, "src/repro_torch/kernels/csrc/event_scan.cu"),
            "replaces": REPLACES[name], "launches": launches.get(name, 0),
            "max_abs_err": errs[name],
            "ms": first[2], "plain_ms": first[3], "bound_ms": first[4],
            "bound_by": first[5], "library_ms": first[8],
            "call_ms": first[6], "plain_device_ms": first[7],
            "forms": {x[1]: {"ms": x[2], "plain_ms": x[3],
                             "bound_ms": x[4], "bound_by": x[5],
                             "call_ms": x[6], "library_ms": x[8],
                             "shape": x[9]}
                      for x in mine},
            "shape": first[9], "card": card})
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
