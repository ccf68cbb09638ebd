"""Wrapper for the gated_fuse kernel (``csrc/gated_fuse.cu``).

``engram_gated_fuse(h, e, wg, wp) = h + sigmoid(h @ wg) * (e @ wp)`` with
both products accumulated in f32 and the epilogue in f32. Leading dims are
flattened into the kernel's T rows; the kernel masks the ragged T edge, so
nothing is padded (the TPU wrapper pads T to its row tile and falls back to
the oracle when d or F is not lane-aligned; this kernel takes any width).

``engram_gated_fuse.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import load
from .ref import gated_fuse_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def _kernel():
    global _FN
    if _FN is None:
        fn = load("gated_fuse").gated_fuse_launch
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + \
            [ctypes.c_int64] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def engram_gated_fuse(h: torch.Tensor, e: torch.Tensor, wg: torch.Tensor,
                      wp: torch.Tensor) -> torch.Tensor:
    """h (..., d); e (..., F); wg (d, d); wp (F, d) -> (..., d) in h's
    dtype. CPU tensors take the plain version; CUDA tensors launch the
    kernel (bf16 or float32, all four of one dtype, contiguous)."""
    if h.device.type == "cpu":
        return gated_fuse_ref(h, e, wg, wp)
    d, F = h.shape[-1], e.shape[-1]
    if h.device.type != "cuda" or any(t.device != h.device
                                      for t in (e, wg, wp)):
        raise ValueError("engram_gated_fuse: all operands must be on one "
                         "CUDA device")
    if h.dtype not in _DTYPE_CODES or any(t.dtype != h.dtype
                                          for t in (e, wg, wp)):
        raise ValueError("engram_gated_fuse: operands must all be bfloat16 "
                         f"or all float32, got {h.dtype}, {e.dtype}, "
                         f"{wg.dtype}, {wp.dtype}")
    if (tuple(wg.shape) != (d, d) or tuple(wp.shape) != (F, d)
            or e.shape[:-1] != h.shape[:-1]):
        raise ValueError(f"engram_gated_fuse: shapes h {tuple(h.shape)}, e "
                         f"{tuple(e.shape)}, wg {tuple(wg.shape)}, wp "
                         f"{tuple(wp.shape)} do not match")
    if not all(t.is_contiguous() for t in (h, e, wg, wp)):
        raise ValueError("engram_gated_fuse: operands must be contiguous")
    out = torch.empty_like(h)
    if out.numel() == 0:
        return out                       # nothing to compute: no launch
    n_t = h.numel() // d
    rc = _kernel()(_DTYPE_CODES[h.dtype], h.data_ptr(), e.data_ptr(),
                   wg.data_ptr(), wp.data_ptr(), out.data_ptr(), n_t, d, F,
                   torch.cuda.current_stream(h.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gated_fuse kernel launch failed: cudaError {rc}")
    engram_gated_fuse.launches += 1
    return out


engram_gated_fuse.launches = 0
