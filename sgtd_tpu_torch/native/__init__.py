"""ctypes bindings for the native C++ scan loader (port of sgtd_tpu.native).

``loader.cpp`` (the reference's own, copied) is compiled with g++ at first
use into ``build/sgtd_tpu_torch/`` under a name that carries a hash of the
source and flags, so an edited source rebuilds and an unchanged one is
reused (as ``ops/_build.py`` does for the kernels). Where no compiler
exists the NumPy readers of ``sgtd_tpu_torch.io.readers`` load the same
arrays, without prefetching. This is the host's file loader: no device
and no kernel is involved.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sgtd_tpu_torch"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_lock = threading.Lock()
_lib = None
_tried = False


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libsgtd_native_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    """g++ into a temporary name, renamed into place (a concurrent build
    never loads a half-written file); False where the compiler fails or is
    missing."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = Path(tmp) / out.name
        try:
            subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(lib)],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return False
        os.replace(lib, out)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, built on first use; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        i64, f32p = ctypes.c_longlong, ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.sgtd_read_bin.restype = i64
        lib.sgtd_read_bin.argtypes = [ctypes.c_char_p, f32p, i64]
        lib.sgtd_read_label.restype = i64
        lib.sgtd_read_label.argtypes = [ctypes.c_char_p, i32p, i32p, i64]
        lib.sgtd_load_scan.restype = i64
        lib.sgtd_load_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_float, f32p, i32p, i32p, i64,
        ]
        lib.sgtd_prefetch_open.restype = ctypes.c_void_p
        lib.sgtd_prefetch_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
            i64, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ]
        lib.sgtd_prefetch_get.restype = i64
        lib.sgtd_prefetch_get.argtypes = [ctypes.c_void_p, i64, f32p, i32p, i32p, i64]
        lib.sgtd_prefetch_close.restype = None
        lib.sgtd_prefetch_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def _buffers(cap: int):
    xyz = np.empty((cap, 3), np.float32)
    sem = np.empty(cap, np.int32)
    inst = np.empty(cap, np.int32)
    ptrs = (
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        sem.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        inst.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return (xyz, sem, inst), ptrs


def load_scan(
    bin_path: str,
    label_path: str | None = None,
    min_norm: float = 0.0,
    cap: int = 1 << 21,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fused scan and label load -> (xyz (N, 3) f32, sem (N,) i32, inst (N,)
    i32), points nearer the origin than ``min_norm`` dropped. The native
    loader where it is built, else the NumPy readers."""
    lib = get_lib()
    if lib is not None:
        (xyz, sem, inst), ptrs = _buffers(cap)
        n = lib.sgtd_load_scan(bin_path.encode(), (label_path or "").encode(),
                               ctypes.c_float(min_norm * min_norm), *ptrs, cap)
        if n >= 0:
            return xyz[:n].copy(), sem[:n].copy(), inst[:n].copy()
    from sgtd_tpu_torch.io import readers

    xyz = readers.read_bin(bin_path)[:, :3]
    if label_path:
        sem, inst = readers.read_label(label_path)
        n = min(len(xyz), len(sem))
        xyz, sem, inst = xyz[:n], sem[:n], inst[:n]
    else:
        sem = np.zeros(len(xyz), np.int32)
        inst = np.zeros(len(xyz), np.int32)
    if min_norm > 0:
        keep = np.sum(xyz * xyz, axis=1) >= min_norm * min_norm
        xyz, sem, inst = xyz[keep], sem[keep], inst[keep]
    return np.ascontiguousarray(xyz, np.float32), sem.astype(np.int32), inst.astype(np.int32)


class PrefetchingLoader:
    """Background-thread readahead over a scan list (native only; without
    the native library every ``get`` loads synchronously)."""

    def __init__(
        self,
        bin_paths: List[str],
        label_paths: List[str] | None = None,
        n_threads: int = 2,
        depth: int = 4,
        min_norm: float = 0.0,
        cap: int = 1 << 21,
    ):
        self._bins = list(bin_paths)
        self._labels = list(label_paths) if label_paths else None
        self._cap = cap
        self._min_norm = min_norm
        self._handle = None
        self._lib = get_lib()
        if self._lib is not None:
            n = len(self._bins)
            arr_b = (ctypes.c_char_p * n)(*[p.encode() for p in self._bins])
            arr_l = None
            if self._labels:
                arr_l = (ctypes.c_char_p * n)(*[p.encode() for p in self._labels])
            # The C++ side copies the paths at open time.
            self._handle = self._lib.sgtd_prefetch_open(
                arr_b, arr_l, n, n_threads, depth, ctypes.c_float(min_norm * min_norm)
            )

    def __len__(self):
        return len(self._bins)

    def get(self, idx: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self._handle is not None:
            (xyz, sem, inst), ptrs = _buffers(self._cap)
            n = self._lib.sgtd_prefetch_get(self._handle, idx, *ptrs, self._cap)
            if n >= 0:
                return xyz[:n].copy(), sem[:n].copy(), inst[:n].copy()
        return load_scan(
            self._bins[idx], self._labels[idx] if self._labels else None, self._min_norm, self._cap
        )

    def close(self):
        if self._handle is not None:
            self._lib.sgtd_prefetch_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
