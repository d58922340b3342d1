"""Build the CUDA kernels with ``nvcc`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes one plain C function taking device pointers
and a stream.  It is compiled for ``sm_90a`` into ``_build/lib<name>-<key>.so``
inside the package (listed in ``.gitignore``), where ``<key>`` hashes the
source and the flags, so an edited source is rebuilt and an unchanged one is
reused.  Nothing here runs at import: a machine without ``nvcc`` imports the
package and uses the plain versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Sequence

__all__ = ["NVCC_FLAGS", "BuildResult", "build", "load"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

# -fmad=false and no fast math: NUM_MULTIPLE must round as the float32
# reference does (see csrc/assertion_eval_window.cu)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class BuildResult(NamedTuple):
    """One kernel library: its path, build seconds (0 if reused) and log."""

    name: str
    path: Path
    seconds: float
    log: str


_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(names: Sequence[str]) -> List[BuildResult]:
    """Compile every named source that is not built yet, all in parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    results = []
    for name in names:
        target = _target(name)
        if target.exists():
            results.append(BuildResult(name, target, 0.0, ""))
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((name, target, tmp, proc, time.perf_counter()))
    failed = []
    for name, target, tmp, proc, t0 in jobs:  # wait for every nvcc before raising
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
        results.append(BuildResult(name, target, seconds, log))
    if failed:
        raise RuntimeError("\n".join(failed))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        (result,) = build([name])
        lib = _libs[name] = ctypes.CDLL(str(result.path))
    return lib
