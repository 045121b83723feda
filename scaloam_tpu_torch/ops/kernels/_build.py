"""Build and load the hand-written CUDA kernels.

Each source in scaloam_tpu_torch/csrc is compiled by nvcc for sm_90a into
its own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds) and loaded with ctypes. All sources build in parallel,
one nvcc each, into `build/kernels/` beside the package; a library's file
name carries a hash of its source and flags, so an edited source is
rebuilt and an unchanged one is reused. `build` and `library` are safe to
call from several threads of one process: one lock serialises them, and
each build writes a temporary file named by process and thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("selection", "gn_odometry", "f32ops")
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()  # guards _loaded and the files in BUILD_DIR


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names=SOURCES) -> Dict[str, str]:
    """Compile every named source that has no current library, all nvcc
    processes started together. Returns {name: compiler output} for the
    sources built now (ptxas register/shared-memory report). Raises with
    the compiler's output if any build fails."""
    with _lock:
        return _build_locked(names)


def _build_locked(names) -> Dict[str, str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc_path(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building it first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                _build_locked((name,))
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
    return lib


def check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless t has the dtype, shape and device a kernel takes and
    is contiguous."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(
            f"{name}: want {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fold(t: torch.Tensor, dim, batch: int) -> torch.Tensor:
    """A custom op's argument under vmap, batch dimension `dim` (None: not
    batched, so expanded), as [batch * n, ...] rows: the vmap batch merged
    with the op's own leading axis n, contiguous."""
    t = t.movedim(dim, 0) if dim is not None else t.expand(batch, *t.shape)
    return t.reshape(batch * t.shape[1], *t.shape[2:]).contiguous()


def unfold(t: torch.Tensor, batch: int) -> torch.Tensor:
    """fold's inverse on an output: [batch * n, ...] -> [batch, n, ...]."""
    return t.reshape(batch, t.shape[0] // batch, *t.shape[1:])
