"""Build the port's CUDA kernels with ``nvcc`` at first use; bind with ctypes.

Each ``csrc/<name>.cu`` exports plain C functions and compiles on its own
into ``build/kernels/lib<name>-<hash>.so`` under the repository root (a
directory ``.gitignore`` lists). The sources include the shared headers
``csrc/*.cuh``. The hash covers the source, every header and the flags, so
an edited source or header rebuilds and an unchanged tree loads the library
left by an earlier run. Nothing here runs at import time: the CPU tests
import every module, and this machine class has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # ptxas reports registers, shared memory and spills per kernel; the
    # report is kept in ``build_logs``.
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: Per source: the compiler's report of the last build this process ran.
build_logs: Dict[str, str] = {}
#: Per source: seconds the last build took (0.0 when the library was cached).
build_seconds: Dict[str, float] = {}
#: Per source: seconds its first ``load`` in this process took (a build
#: when one was needed, then the ``dlopen``).
load_seconds: Dict[str, float] = {}


def kernel_sources() -> List[str]:
    """Names of every kernel source (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); "
            "the port's CUDA kernels are built at first use on a machine "
            "with the CUDA toolkit"
        )
    return path


def nvcc_command(src: Path, out: Path) -> List[str]:
    """The ``nvcc`` command that builds ``src`` into the library ``out``;
    ``src`` may be a copy outside ``csrc`` (its headers are found there)."""
    return [_nvcc(), *NVCC_FLAGS, "-I", str(SRC_DIR), "-o", str(out),
            str(src)]


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = ()) -> Dict[str, Path]:
    """Compile the named sources (all of them by default) that have no
    up-to-date library yet: one ``nvcc`` per source, all started together.
    Raises with the compiler's output if any build fails."""
    names = list(names) or kernel_sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    for n in names:
        if n not in todo:
            build_seconds[n] = 0.0
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        # Build under a private name and rename into place: a concurrent
        # process never loads a half-written library.
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (
            tmp,
            subprocess.Popen(
                nvcc_command(SRC_DIR / f"{n}.cu", tmp),
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            ),
        )
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_logs[n] = out
        build_seconds[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {n}.cu:\n{out}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu`` (built if needed)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            t0 = time.perf_counter()
            path = build_all([name])[name]
            lib = _libs[name] = ctypes.CDLL(str(path))
            load_seconds[name] = time.perf_counter() - t0
        return lib
