"""Build and bind the port's CUDA sources (``csrc/*.cu``) with ``nvcc``.

Each source compiles on its own, with its own flags, into a content-named
shared library under ``build/repro_torch_kernels/`` (git-ignored) at first
use, never at import; the library has a plain C interface and is loaded
with ``ctypes``.  ``build_many`` starts one ``nvcc`` per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
# every source: Hopper with wgmma/setmaxnreg available (sm_90a), a shared
# library with a C interface
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# loaded libraries by (source, flags): a launch looks its library up here
# without touching the file system
_LIBS: Dict[Tuple[Path, Tuple[str, ...]], ctypes.CDLL] = {}
# nvcc's output by library, for each library this process built
LOGS: Dict[Path, str] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    path = str(cand) if cand.exists() else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's "
                           "kernels are built from csrc/ at first use")
    return path


def lib_path(source: Path, flags: Sequence[str]) -> Path:
    tag = hashlib.sha1(source.read_bytes()
                       + " ".join(flags).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{source.stem}_{tag}.so"


def build_many(specs: Sequence[Tuple[Path, Sequence[str]]],
               verbose: bool = False) -> List[Tuple[Path, float]]:
    """Compile each (source, flags) that has no library yet, all ``nvcc``
    processes at once.  Returns (library path, seconds until that build
    finished; 0.0 when reused) per spec.  ``verbose`` adds ``-Xptxas -v``
    and prints each compiler report."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for source, flags in specs:
        out = lib_path(source, flags)
        if out.exists():
            jobs.append((out, None, None))
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *flags, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(source)]
        jobs.append((out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    results = []
    try:
        for out, tmp, proc in jobs:
            if proc is None:
                results.append((out, 0.0))
                continue
            log, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                                   f"{out.stem}:\n{log}")
            if verbose:
                print(log, flush=True)
            LOGS[out] = log
            os.replace(tmp, out)
            results.append((out, time.perf_counter() - t0))
    finally:
        for _, _, proc in jobs:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    return results


def load(source: Path, flags: Sequence[str],
         bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The built library of ``source`` (built first if need be), with its
    functions' ctypes signatures set by ``bind``; built and loaded once
    per (source, flags) and process."""
    key = (source, tuple(flags))
    lib = _LIBS.get(key)
    if lib is None:
        path, _ = build_many([(source, flags)])[0]
        lib = ctypes.CDLL(str(path))
        bind(lib)
        _LIBS[key] = lib
    return lib


def check(status: int, name: str) -> None:
    """Raise if a C launcher returned a CUDA error (its
    ``cudaGetLastError()`` after the launch)."""
    if status != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {status}")
