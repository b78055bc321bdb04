"""ctypes wrapper and build at first use for the native dataset loader (port
of ``vo_slam_test_tpu/native/loader.py``).

``dataloader.cpp`` (this package's own copy) is compiled with ``g++`` into
``_build/libvoio-<hash>.so`` of this package, where the hash covers the
source and the flags, so an edited source is rebuilt. Nothing is built when
the module is imported. Without a compiler or libpng's headers the build
fails, ``native_available()`` is False and ``build_error()`` says why.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..ops._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "dataloader.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lpng", "-lz", "-lpthread")


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libvoio-{digest.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def _load() -> Tuple[Optional[ctypes.CDLL], str]:
    """(library, "") once built and loaded, else (None, the reason)."""
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp), *LIBS]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError:
            return None, "g++ not found"
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            lines = proc.stderr.strip().splitlines() or [""]
            first = next((ln for ln in lines if "error" in ln), lines[0])
            return None, f"g++ failed (rc {proc.returncode}): {first.strip()}"
        os.replace(tmp, so)
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:
        return None, f"cannot load {so.name}: {e}"
    lib.vio_open.restype = ctypes.c_void_p
    lib.vio_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.vio_next.restype = ctypes.c_int
    lib.vio_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.vio_close.restype = None
    lib.vio_close.argtypes = [ctypes.c_void_p]
    return lib, ""


def native_available() -> bool:
    return _load()[0] is not None


def build_error() -> str:
    """Why the native loader is unavailable ("" when it is available)."""
    return _load()[1]


class NativeTumLoader:
    """Ordered prefetching loader over (rgb, depth) PNG path pairs.

    Decode runs on C++ worker threads ahead of consumption; ``__getitem__``
    must be called in sequence (the streaming SLAM consumption order). Gray is
    BT.601 luma with cv::cvtColor's fixed-point rounding, depth is the 16-bit
    value over ``depth_scale`` in f32 meters.
    """

    def __init__(
        self,
        rgb_paths: List[str],
        depth_paths: List[str],
        timestamps: List[float],
        depth_scale: float = 5000.0,
        width: int = 640,
        height: int = 480,
        prefetch: int = 8,
        threads: int = 4,
    ):
        lib, why = _load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {why}")
        self._lib = lib
        self.timestamps = timestamps
        self.width, self.height = width, height
        self._n = len(rgb_paths)
        # the path arrays stay referenced until close: the workers read them
        self._rgb = (ctypes.c_char_p * self._n)(*[p.encode() for p in rgb_paths])
        self._dep = (ctypes.c_char_p * self._n)(*[p.encode() for p in depth_paths])
        self._handle = lib.vio_open(self._rgb, self._dep, self._n, depth_scale, prefetch,
                                    threads, width, height)
        self._next = 0

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray, float]:
        if i != self._next:
            raise ValueError(f"NativeTumLoader is sequential (asked {i}, next {self._next})")
        gray = np.empty((self.height, self.width), np.uint8)
        depth = np.empty((self.height, self.width), np.float32)
        w = ctypes.c_int()
        h = ctypes.c_int()
        idx = self._lib.vio_next(
            self._handle,
            gray.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(w), ctypes.byref(h),
        )
        if idx < 0:
            raise IOError(f"native loader failed at frame {i}")
        self._next = i + 1
        return gray, depth, self.timestamps[i]

    def close(self) -> None:
        if getattr(self, "_handle", None):  # None after close or a failed __init__
            self._lib.vio_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
