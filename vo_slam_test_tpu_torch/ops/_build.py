"""Build and bind the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exposes plain ``extern "C"`` launch functions that
return ``cudaGetLastError()``. It is compiled with ``nvcc`` for ``sm_90a`` into
``_build/lib<name>-<hash>.so`` (the hash covers the source and the flags, so
an edited source is rebuilt) at first use, loaded with ``ctypes`` and launched
on PyTorch's current stream. Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNEL_SOURCES = ("fast", "orb", "match", "epi", "ba")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, dict]:
    """Compile the named sources that are not built yet, one ``nvcc`` per
    source, all started together. Returns {name: {"seconds", "log"}} for the
    ones compiled here; raises with the compiler's output on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out, time.perf_counter())
    results = {}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        results[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return results


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    build([name])
    return ctypes.CDLL(str(library_path(name)))


class Kernel:
    """One ``extern "C"`` launch function of a ``csrc`` library, with its
    launch count: ``launches`` goes up by one each time the kernel is launched
    and nowhere else. Two objects may bind one symbol: each call site then
    keeps its own count."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0

    def reset(self) -> None:
        self.launches = 0

    @functools.cached_property
    def _fn(self):
        fn = getattr(load(self.source), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        return fn

    def __call__(self, *args) -> None:
        rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.source}.cu:{self.symbol} launch failed: cudaError {rc}")
        self.launches += 1
