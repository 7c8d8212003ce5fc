"""Build the port's CUDA sources into shared libraries and load them.

Every source ``src/repro_torch/csrc/<name>.cu`` has a plain C interface
(kernel bodies shared by several sources sit in ``csrc/*.cuh``) and is
compiled on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/kernels/lib<name>.so <name>.cu

into ``build/kernels/`` at the root of the checkout, then loaded with
``ctypes``.  A library is rebuilt when its source changes (the source
hash is part of the file name).  :func:`build_all` starts one ``nvcc``
per source, all at once, and waits for them together.  ``-Xptxas -v``
makes ptxas report each kernel's registers, static shared memory and
spills; the report is kept beside the library (``.log``) and read back
by :func:`ptxas_report`.

Nothing here runs at import: the CPU test machines have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# <checkout>/build/kernels: src/repro_torch/kernels/build.py -> parents[3]
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# the port's kernels, then the empty kernel chip_smoke.py times as the
# launch floor
SOURCES = ("paged_attention", "kld_accept", "paged_attention_quant",
           "ngram_match", "ragged_attention", "launch_floor")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    """The library's path; its name carries a hash of the source and of
    every shared header in ``csrc/``, so an edit to either rebuilds it."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile every missing library in parallel; returns the seconds
    each source took (0 when already built).  Raises with nvcc's output
    if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = {name: 0.0 for name in names}
    procs = {}
    t0 = time.monotonic()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, out)
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n"
                               + log.decode(errors="replace"))
        out.with_suffix(".log").write_bytes(log)
        os.replace(tmp, out)
        seconds[name] = time.monotonic() - t0
    return seconds


def parse_ptxas(log: str) -> List[dict]:
    """Per kernel in an ``-Xptxas -v`` log: its name (demangled where
    ``c++filt`` exists), registers, static shared memory bytes and spill
    store / load bytes."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": m.group(1), "registers": None, "smem": 0,
                   "spill_stores": None, "spill_loads": None}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    filt = shutil.which("c++filt")
    if filt and rows:
        names = subprocess.run([filt], input="\n".join(r["kernel"] for r in rows),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
        if len(names) == len(rows):
            for r, n in zip(rows, names):
                r["kernel"] = n
    return rows


def ptxas_report(name: str) -> List[dict]:
    """:func:`parse_ptxas` of the build log of ``csrc/<name>.cu``."""
    return parse_ptxas(_target(name).with_suffix(".log").read_text(
        errors="replace"))


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib
