"""Explicit device selection for the port's entry points."""

from __future__ import annotations

import numpy as np
import torch


def resolve(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another. Without a GPU and without an explicit device this raises: the
    port never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on `device`. To a card it goes from pinned
    memory, so the host does not wait for the copy (the caching host
    allocator keeps the buffer until the copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)
