"""The port's device rule: entry points run on the card unless the caller
asks for the CPU.  There is no silent fall back to the CPU."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no CUDA
    device is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``.  To a card it goes through pinned host
    memory in one non-blocking copy on the current stream (the caching
    host allocator keeps the pinned block until the copy is done)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
