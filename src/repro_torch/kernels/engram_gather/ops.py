"""Wrappers for the engram_gather kernel (``csrc/engram_gather.cu``).

``gather_rows`` is the kernel's one entry; ``engram_gather`` flattens the T
sub-tables of one Engram layer into a (T*V, hd) row space (row id
``idx + t*V``) so one launch covers every hash head. Unlike the TPU
wrappers, nothing is padded: the row count is whatever the wave needs and
the lane width is the table's own (the TPU's power-of-two row buckets and
128-lane padding guard against recompiles and VMEM tiling, neither of which
exists here).

``gather_rows.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import load
from .ref import gather_rows_ref

_FN = None


def _kernel():
    global _FN
    if _FN is None:
        fn = load("engram_gather").engram_gather_rows
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def gather_rows(table: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """out[i] = table[gid[i]]. table (R, hd) with unit stride along hd and
    any row stride; gid (N,) int64 (int32 is converted once) on the
    table's device -> out (N, hd) in the table's dtype.

    CPU tensors take the plain version. On CUDA the kernel launches on the
    current stream; row ids are not range-checked on the host (that would
    need a sync) — the kernel traps on one outside the table."""
    if table.device.type == "cpu":
        return gather_rows_ref(table, gid)
    if table.device.type != "cuda" or gid.device != table.device:
        raise ValueError(f"gather_rows: table on {table.device}, "
                         f"gid on {gid.device}")
    if table.dim() != 2 or table.stride(1) != 1:
        raise ValueError("gather_rows: table must be (rows, hd) with unit "
                         f"stride along hd, got shape {tuple(table.shape)} "
                         f"strides {table.stride()}")
    if gid.dim() != 1 or gid.dtype not in (torch.int64, torch.int32):
        raise ValueError(f"gather_rows: gid must be 1-D int64/int32, got "
                         f"{gid.dtype} {tuple(gid.shape)}")
    gid = gid.to(torch.int64).contiguous()
    R, hd = table.shape
    item = table.element_size()
    out = torch.empty((gid.shape[0], hd), dtype=table.dtype,
                      device=table.device)
    if out.numel() == 0:
        return out                       # nothing to copy: no launch
    rc = _kernel()(table.data_ptr(), table.stride(0) * item, R,
                   gid.data_ptr(), gid.shape[0], out.data_ptr(), hd * item,
                   torch.cuda.current_stream(table.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"engram_gather kernel launch failed: "
                           f"cudaError {rc}")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def engram_gather(tables: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tables (T, V, hd); idx (..., T) -> rows (..., T, hd), one launch."""
    T, V, hd = tables.shape
    if tables.stride(0) != V * tables.stride(1):
        raise ValueError("engram_gather: the T sub-tables must share one "
                         f"row stride, got strides {tables.stride()}")
    batch_shape = idx.shape[:-1]
    gid = (idx.to(torch.int64)
           + torch.arange(T, device=idx.device, dtype=torch.int64) * V)
    rows = gather_rows(tables.view(T * V, hd), gid.reshape(-1))
    return rows.reshape(*batch_shape, T, hd)
