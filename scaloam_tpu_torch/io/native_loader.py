"""ctypes binding for the native IO library (native/scaloam_io.cpp), with a
background-prefetch dataset iterator (a copy of
scaloam_tpu/io/native_loader.py).

The library is built on first use with g++ from the repository's
native/scaloam_io.cpp into build/native/ (never into native/); the file
name carries a hash of the source and flags, so an edited source is
rebuilt. It is built for the generic target (no -march=native), so a
build directory copied to another machine still loads. This is host file
IO, not a device path: every entry point keeps the reference's numpy
fallback for machines without g++.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import subprocess
import threading
from typing import Iterator, Sequence, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "scaloam_io.cpp")
_BUILD_DIR = os.path.join(_ROOT, "build", "native")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lib = None
_lib_tried = False
_lock = threading.Lock()


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libscaloam_io_{digest}.so")


def _build(path: str) -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True, timeout=120)
    except Exception:
        return False
    os.replace(tmp, path)
    return True


def _load_lib():
    global _lib, _lib_tried
    with _lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        if not os.path.exists(_SRC):
            return None
        path = _lib_path()
        if not os.path.exists(path) and not _build(path):
            return None
        lib = ctypes.CDLL(path)
        lib.scaloam_read_bin.restype = ctypes.c_int64
        lib.scaloam_read_bin.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float))
        ]
        lib.scaloam_read_pcd.restype = ctypes.c_int64
        lib.scaloam_read_pcd.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.scaloam_voxel_filter.restype = ctypes.c_int64
        lib.scaloam_voxel_filter.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
            ctypes.c_float, ctypes.POINTER(ctypes.c_float),
        ]
        lib.scaloam_range_filter.restype = ctypes.c_int64
        lib.scaloam_range_filter.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
            ctypes.c_float, ctypes.POINTER(ctypes.c_float),
        ]
        lib.scaloam_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def native_available() -> bool:
    return _load_lib() is not None


def _own(ptr, n, f):
    """Copy a malloc'd native buffer into numpy and free it."""
    lib = _load_lib()
    arr = np.ctypeslib.as_array(ptr, shape=(int(n) * f,)).reshape(int(n), f).copy()
    lib.scaloam_free(ptr)
    return arr


def read_bin(path: str) -> np.ndarray:
    lib = _load_lib()
    if lib is None:
        return np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    ptr = ctypes.POINTER(ctypes.c_float)()
    n = lib.scaloam_read_bin(path.encode(), ctypes.byref(ptr))
    if n < 0:
        raise IOError(f"failed to read {path}")
    return _own(ptr, n, 4)


def read_pcd(path: str) -> np.ndarray:
    from scaloam_tpu_torch.io import pcd as pcd_io

    lib = _load_lib()
    if lib is None:
        return pcd_io.read_pcd(path)
    ptr = ctypes.POINTER(ctypes.c_float)()
    nf = ctypes.c_int32(0)
    n = lib.scaloam_read_pcd(path.encode(), ctypes.byref(ptr), ctypes.byref(nf))
    if n < 0:  # non-binary or odd layout: python fallback
        return pcd_io.read_pcd(path)
    return _own(ptr, n, int(nf.value))


def voxel_filter(points: np.ndarray, leaf: float) -> np.ndarray:
    """Host centroid voxel filter (pcl::VoxelGrid semantics)."""
    pts = np.ascontiguousarray(points[:, :3], dtype=np.float32)
    lib = _load_lib()
    if lib is None:
        keys = np.floor(pts / leaf).astype(np.int64)
        _, inv = np.unique(keys, axis=0, return_inverse=True)
        sums = np.zeros((inv.max() + 1, 3))
        counts = np.bincount(inv)
        for d in range(3):
            sums[:, d] = np.bincount(inv, weights=pts[:, d])
        return (sums / counts[:, None]).astype(np.float32)
    out = np.empty_like(pts)
    n = lib.scaloam_voxel_filter(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(pts), 3,
        ctypes.c_float(leaf),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out[:n].copy()


def range_filter(points: np.ndarray, min_range: float) -> np.ndarray:
    pts = np.ascontiguousarray(points[:, :3], dtype=np.float32)
    lib = _load_lib()
    if lib is None:
        r2 = np.sum(pts * pts, axis=-1)
        return pts[np.isfinite(r2) & (r2 >= min_range * min_range)]
    out = np.empty_like(pts)
    n = lib.scaloam_range_filter(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(pts), 3,
        ctypes.c_float(min_range),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out[:n].copy()


class PrefetchLoader:
    """Background-thread scan loader: hides file IO + parse latency behind
    device compute (the kittiHelper publish loop analog, but ahead-of-time)."""

    def __init__(self, paths: Sequence[str], reader=None, depth: int = 4):
        self.paths = list(paths)
        self.reader = reader or read_bin
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._th = threading.Thread(target=self._worker, daemon=True)
        self._th.start()

    def _worker(self):
        for p in self.paths:
            self.q.put((p, self.reader(p)))
        self.q.put(None)

    def __iter__(self) -> Iterator[Tuple[str, np.ndarray]]:
        while True:
            item = self.q.get()
            if item is None:
                return
            yield item
