"""Engram tables in pinned, device-mapped host memory, read in place by K1.

The port's form of the paper's CXL pool on one card: a CXL expander shows
up to the host as memory, and the card reads it as it reads host memory
that CUDA has pinned and mapped, over the host link, with a load in a
kernel (``csrc/engram_gather.cu``). ``host_empty`` makes such a buffer:
exact-size anonymous memory (``mmap``, page-aligned, its pages faulted in
by ``MAP_POPULATE``), registered with ``cudaHostRegister(Mapped |
Portable)`` through the kernel library's C entry. PyTorch's pinned
allocator is not used: it caches blocks and rounds a request up to a
power of two (65 MiB took 128 MiB on an H100 host, ``chip_smoke.py``
phase 14), and a table set of tens of gigabytes cannot afford either.

``device_pointer`` gives the address through which the card reads a CPU
tensor's first element, or None outside such a buffer;
``gather_rows_multi`` launches K1 on it. A buffer is unregistered when
the last tensor viewing it is freed: the tensor's storage holds the
mapping, and the mapping's ``__del__`` unregisters it before ``munmap``
(a ``weakref.finalize`` on an ``mmap`` would fire only after the unmap).
``pinned_bytes`` says how much is registered now.
"""
from __future__ import annotations

import ctypes
import math
import mmap

import torch

from ... import trace
from ..build import load

_MAPPED: dict[int, tuple[int, int]] = {}   # host base -> (bytes, device base)
_FNS: dict = {}


def _fn(name: str):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(load("engram_gather"), name)
        fn.argtypes = {
            "engram_host_register": [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_void_p)],
            "engram_host_unregister": [ctypes.c_void_p]}[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


class _Mapping(mmap.mmap):
    """Anonymous memory that unregisters itself from CUDA before it is
    unmapped."""
    base = 0

    def __del__(self):
        if _MAPPED.pop(self.base, None) is not None:
            _fn("engram_host_unregister")(self.base)


def host_empty(shape, dtype: torch.dtype) -> torch.Tensor:
    """An uninitialised CPU tensor of ``shape`` and ``dtype`` in its own
    registered buffer, pinned and mapped for the card. Raises if CUDA
    refuses the registration (no device, not enough lockable memory)."""
    numel = math.prod(shape)
    nbytes = numel * torch.empty((), dtype=dtype).element_size()
    if nbytes == 0:
        raise ValueError(f"host_empty: empty shape {tuple(shape)}")
    register = _fn("engram_host_register")   # loads (or builds) K1 first
    with trace.span("tables.host_map", bytes=nbytes):
        mm = _Mapping(-1, nbytes, flags=mmap.MAP_PRIVATE
                      | mmap.MAP_ANONYMOUS | getattr(mmap, "MAP_POPULATE", 0))
        t = torch.frombuffer(mm, dtype=dtype, count=numel).view(*shape)
        base = t.data_ptr()
        dev = ctypes.c_void_p()
        rc = register(base, nbytes, ctypes.byref(dev))
    if rc != 0:
        raise RuntimeError(f"cudaHostRegister of {nbytes} bytes failed: "
                           f"cudaError {rc}")
    mm.base = base
    _MAPPED[base] = (nbytes, dev.value)
    return t


def pinned_bytes() -> int:
    """Bytes registered through ``host_empty`` and not yet freed."""
    return sum(nbytes for nbytes, _ in _MAPPED.values())


def is_mapped(t: torch.Tensor) -> bool:
    """Whether the card can read CPU tensor ``t`` in place."""
    return t.device.type == "cpu" and device_pointer(t) is not None


def device_pointer(t: torch.Tensor):
    """The device address of CPU tensor ``t``'s first element inside a
    buffer from ``host_empty``; None for any other memory."""
    p = t.data_ptr()
    for base, (nbytes, dev) in _MAPPED.items():
        if base <= p < base + nbytes:
            return dev + (p - base)
    return None
