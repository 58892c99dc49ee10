"""Builds the CUDA kernels at first use: one ``nvcc`` per ``csrc/*.cu``,
all started together, then one link into a shared library with a plain
C interface, loaded with ``ctypes``.

The library lands in ``build/repro_torch/`` at the repository root,
named by a hash of the sources, headers and flags, so an edit rebuilds
and an unchanged tree reuses it; nvcc's output (``-Xptxas -v``: each
kernel's registers, shared memory and spills) is kept beside it, in
:func:`log_path`.  ``-prec-div=true -fmad=false`` and no
``--use_fast_math``: the kernels must divide and multiply exactly as
the plain PyTorch versions do.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-prec-div=true", "-fmad=false"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def sources():
    return sorted(_CSRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def log_path() -> pathlib.Path:
    return library_path().with_suffix(".log")


def _run(procs):
    """Waits for every process; raises with the output of the first that
    failed.  Returns the concatenated output."""
    outs, failed = [], None
    for what, proc in procs:
        out, err = proc.communicate()
        outs.append(f"{what}:\n{out}{err}")
        if proc.returncode != 0 and failed is None:
            failed = outs[-1]
    if failed is not None:
        raise RuntimeError("nvcc failed on " + failed)
    return "".join(outs)


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the kernels unless an up-to-date library exists; returns
    its path.  Raises with nvcc's output if the build fails."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = os.path.join(tmp, src.stem + ".o")
            objs.append(obj)
            cmd = [nvcc, *FLAGS, "-Xptxas", "-v", "-c", "-o", obj, str(src)]
            procs.append((src.name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        log = _run(procs)
        lib = os.path.join(tmp, out.name)
        log += _run([("link", subprocess.Popen(
            [nvcc, *FLAGS, "-shared", "-o", lib, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))])
        if verbose:
            print(log)
        log_path().write_text(log)
        os.replace(lib, out)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    return ctypes.CDLL(str(build()))
