"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into
``build/torchdistx_tpu_torch/lib<name>.so`` (beside the package, at the
checkout's root; an installed package sets ``TDX_TORCH_BUILD_DIR`` to
another directory) with a plain C interface, at first use, and is rebuilt
when a source in ``csrc/`` is newer than the library.  Stale sources are
compiled in parallel, one nvcc process each.  A failed build raises with
nvcc's output.  Nothing here runs at import.

Each build is a compile in the compile observatory
(:mod:`torchdistx_tpu_torch.telemetry.perf`): ``compile.count`` and
``compile.time_s`` under ``program="kernel:<name>"``, timed by its nvcc
process's wall clock; a library that :func:`load` finds fresh on disk
counts once as a program load, timed by its ``dlopen``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

from ...telemetry import perf as _perf

__all__ = ["build", "load", "sources", "build_logs", "BUILD_DIR", "SRC_DIR"]

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(
    os.environ.get("TDX_TORCH_BUILD_DIR")
    or Path(__file__).resolve().parents[3] / "build" / "torchdistx_tpu_torch"
)

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register / shared-memory / spill report) per kernel
# source, from the builds this process ran.
build_logs: Dict[str, str] = {}
# Sources this process compiled: their libraries' loads are not counted
# again as program loads.
_built: set = set()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            f"nvcc not found on PATH or at {path}: the CUDA kernels cannot "
            "be built on this host"
        )
    return str(path)


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    deps = [SRC_DIR / f"{name}.cu", *SRC_DIR.glob("*.cuh")]
    return any(p.stat().st_mtime > built for p in deps)


def sources() -> List[str]:
    """Names of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def build(names: Optional[Iterable[str]] = None) -> List[str]:
    """Compile the named sources (default: all) that are missing or stale,
    all at once.  Returns the names that were compiled."""
    names = sources() if names is None else list(names)
    stale = [n for n in names if _stale(n)]
    if not stale:
        return []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    outs: Dict[str, str] = {}
    ended: Dict[str, float] = {}

    def wait(name, proc):  # each build's own end, whatever order they finish in
        outs[name] = proc.communicate()[0]
        ended[name] = time.perf_counter()

    for name in stale:
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        t0 = time.perf_counter()  # before the process starts, so its whole run counts
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        procs[name] = (proc, tmp, t0)
    waiters = [threading.Thread(target=wait, args=(name, procs[name][0])) for name in stale]
    for t in waiters:
        t.start()
    for t in waiters:
        t.join()
    failed = []
    for name, (proc, tmp, t0) in procs.items():
        build_logs[name] = outs[name]
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{outs[name]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(name))
            _built.add(name)
            _perf.record_compile(f"kernel:{name}", ended[name] - t0)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return stale


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(_lib_path(name)))
            if name not in _built:  # found fresh on disk: a program load
                _perf.record_compile(f"kernel:{name}", time.perf_counter() - t0)
            _libs[name] = lib
        return lib
