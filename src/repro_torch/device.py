"""Device resolution and host->device uploads shared by the port's modules.

The port's entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, as the CPU tests do); asking for the card on a machine
without one raises instead of quietly running on the host.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a machine without CUDA then raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the host")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def upload(a, device: torch.device) -> torch.Tensor:
    """Copy a host array (numpy, or a CPU tensor) to ``device`` without a
    host-side sync.

    On CUDA the array is staged in pinned memory and copied with
    ``non_blocking=True`` (a pageable copy would synchronise the stream).
    On the CPU the result is a copy, so callers may reuse their buffer."""
    t = a if isinstance(a, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


@contextlib.contextmanager
def sync_allowed(device: torch.device):
    """Suspend PyTorch's CUDA sync debug mode around a deliberate, counted
    device->host read, so code run under ``torch.cuda.set_sync_debug_mode``
    flags every other sync."""
    mode = torch.cuda.get_sync_debug_mode() if device.type == "cuda" else 0
    if mode == 0:
        yield
        return
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)
