"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` into a shared
library with a plain C interface, for ``sm_90a`` (Hopper), and loaded with
``ctypes``.  The library's file name carries a hash of its source, of
every shared header (``csrc/*.cuh``) and of the flags, so an edited kernel
is rebuilt and a stale one never loaded.
Builds go to ``kernels/_build/`` beside this file (ignored by git), at
first use; :func:`build_all` starts one ``nvcc`` per source, all at once.
:func:`entry` hands the wrappers each C entry typed for ``ctypes`` once,
so a launch pays no lock and no re-typing.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.
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

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
_ENTRIES: dict = {}
_LOCK = threading.Lock()


class KernelError(RuntimeError):
    """A kernel that cannot run: ``nvcc`` missing, a build that failed, a
    library that does not load or lacks its entry, or a launch the card
    refused.  No retry and no other plan can mend it in this process, so
    the resilience layer fails fast on it (``core/resilience.py``) instead
    of re-planning without the kernel."""


def sources() -> list:
    """The kernel names: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                      "to build the port's CUDA kernels")


def lib_path(name: str) -> Path:
    """The library file of kernel ``name``: its name carries the hash of
    the source, the shared headers and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + headers +
                         " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{tag[:16]}.so"


def _start(name: str):
    """Start the nvcc of one kernel; None when its library is built."""
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)


def _finish(name: str, job) -> str:
    out, tmp, proc = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise KernelError(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> dict:
    """Build every kernel, one ``nvcc`` each, all started together.
    Returns ``{"seconds": wall, "logs": {name: nvcc output}}`` (the
    ``-Xptxas -v`` register and shared-memory report)."""
    t0 = time.perf_counter()
    jobs = {n: _start(n) for n in sources()}
    logs = {n: (_finish(n, j) if j is not None else "(cached)")
            for n, j in jobs.items()}
    return {"seconds": time.perf_counter() - t0, "logs": logs}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if need be."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            try:
                lib = ctypes.CDLL(str(lib_path(name)))
            except OSError as exc:
                raise KernelError(f"{name}: library does not load: "
                                  f"{exc}") from exc
            _LIBS[name] = lib
        return lib


def entry(name: str, symbol: str, *argtypes):
    """The C entry ``symbol`` of kernel ``name`` (built at first use),
    typed for ctypes at its first call and cached by ``(name, symbol)``;
    every entry returns ``cudaGetLastError()``."""
    fn = _ENTRIES.get((name, symbol))
    if fn is None:
        try:
            fn = getattr(load(name), symbol)
        except AttributeError as exc:
            raise KernelError(f"{name}: no entry {symbol}") from exc
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _ENTRIES[(name, symbol)] = fn
    return fn


def stream(device: torch.device) -> int:
    """The raw handle of the current CUDA stream of ``device`` (the
    current device where it names no index)."""
    index = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` code from a C entry."""
    if rc != 0:
        raise KernelError(f"{what}: CUDA error {rc} at launch")
