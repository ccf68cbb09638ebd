"""Wrappers for the engram_gather kernel (``csrc/engram_gather.cu``).

``gather_rows_multi`` is the kernel's one entry: rows from up to 8 tables
(one per Engram layer) in one launch. ``gather_rows`` is its one-table
case, and ``engram_gather`` flattens the T sub-tables of one Engram layer
into a (T*V, hd) row space (row id ``idx + t*V``) so one launch covers
every hash head. Unlike the TPU wrappers, nothing is padded: the row count
is whatever the wave needs and the lane width is the table's own (the
TPU's power-of-two row buckets and 128-lane padding guard against
recompiles and VMEM tiling, neither of which exists here).

Where the tables live: on the card, or in pinned, device-mapped host
memory (``host.host_empty``; the ``pooled_host`` strategy), which K1 reads
in place over the host link and writes to rows on the card. Both are
served paths, held bit-equal to the plain version on the card. The row
ids decide where the call runs: ids on the CPU take the plain version
(every table must then be on the CPU); ids on the card launch the kernel,
and a CPU table that is not mapped for the card raises, never quietly
copies.

``gather_rows.launches`` counts the kernel's launches, through whichever
entry. The kernel has no backward (nor has the TPU kernel): a CUDA call
that autograd would record (grad mode on, a table requiring grad) raises.

The launch is the custom operator ``repro_torch::engram_gather``
(``torch.library.custom_op``) with a shape function (``register_fake``):
a fake or meta tensor passes through it and comes out with the kernel's
output shape and dtype, launching nothing and touching no module cache,
so a trace (``launch.dryrun``, ``roofline.counting``) sees the call by
name. Its CUDA implementation is the launch.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..build import load
from .host import device_pointer
from .ref import gather_rows_multi_ref, gather_rows_ref

MAX_TABLES = 8
_FN = None


def _kernel():
    global _FN
    if _FN is None:
        fn = load("engram_gather").engram_gather_tables
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def gather_rows_multi(tables: Sequence[torch.Tensor],
                      gid: torch.Tensor) -> torch.Tensor:
    """out[t, i] = tables[t][gid[t, i]]. tables: 1 to 8 (R_t, hd) tensors
    of one dtype and width, each with unit stride along hd and any row
    stride; gid (L, N) int64 (int32 is converted once) -> out (L, N, hd) in
    the tables' dtype on gid's device, in one launch.

    gid on the CPU takes the plain version, over CPU tables. gid on CUDA
    launches the kernel on the current stream, over tables on gid's device
    or in mapped host memory (read in place); a pageable CPU table raises.
    gid on the meta device (or a fake CUDA gid) gives the output's shape
    alone. Row ids are not range-checked on the host (that would need a
    sync) — the kernel traps on one outside its table."""
    if gid.device.type == "cpu":
        if any(t.device.type != "cpu" for t in tables):
            raise ValueError(f"gather_rows_multi: gid on the CPU, tables on "
                             f"{[str(t.device) for t in tables]}")
        return gather_rows_multi_ref(tables, gid)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tables):
        raise RuntimeError("gather_rows_multi: the kernel has no backward "
                           "and would cut the tables' gradient; train "
                           "through retrieve_local, or call it under "
                           "torch.no_grad/inference_mode")
    if not 1 <= len(tables) <= MAX_TABLES:
        raise ValueError(f"gather_rows_multi: 1 to {MAX_TABLES} tables, got "
                         f"{len(tables)}")
    if gid.device.type not in ("cuda", "meta"):
        raise ValueError(f"gather_rows_multi: gid on {gid.device}")
    first = tables[0]
    hd = first.shape[-1]
    for t in tables:
        if t.device != gid.device and not (t.device.type == "cpu"
                                           and gid.device.type == "cuda"):
            raise ValueError(f"gather_rows_multi: a table on {t.device}, "
                             f"row ids on {gid.device}")
        if t.dim() != 2 or t.stride(1) != 1 or t.shape[1] != hd or \
                t.dtype != first.dtype:
            raise ValueError("gather_rows_multi: each table must be (rows, "
                             f"{hd}) {first.dtype} with unit stride along "
                             f"hd, got {t.dtype} shape {tuple(t.shape)} "
                             f"strides {t.stride()}")
    if gid.dim() != 2 or gid.shape[0] != len(tables) or \
            gid.dtype not in (torch.int64, torch.int32):
        raise ValueError(f"gather_rows_multi: gid must be ({len(tables)}, N) "
                         f"int64/int32, got {gid.dtype} {tuple(gid.shape)}")
    return torch.ops.repro_torch.engram_gather.default(
        list(tables), gid.to(torch.int64).contiguous())


@torch.library.custom_op("repro_torch::engram_gather", mutates_args=(),
                         device_types="cuda")
def _gather_op(tables: list[torch.Tensor], gid: torch.Tensor) -> torch.Tensor:
    """The launch: ``gather_rows_multi``'s checked operands, gid (L, N)
    contiguous int64 on the card."""
    ptrs = [_device_address(t, gid.device) for t in tables]
    L, N = gid.shape
    first = tables[0]
    hd, item = first.shape[-1], first.element_size()
    out = torch.empty((L, N, hd), dtype=first.dtype, device=gid.device)
    if out.numel() == 0:
        return out                       # nothing to copy: no launch
    bases = (ctypes.c_void_p * L)(*ptrs)
    strides = (ctypes.c_int64 * L)(*[t.stride(0) * item for t in tables])
    n_rows = (ctypes.c_int64 * L)(*[t.shape[0] for t in tables])
    rc = _kernel()(bases, strides, n_rows, L, gid.data_ptr(), N,
                   out.data_ptr(), hd * item,
                   torch.cuda.current_stream(gid.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"engram_gather kernel launch failed: "
                           f"cudaError {rc}")
    gather_rows.launches += 1
    return out


@_gather_op.register_fake
def _(tables, gid):
    return torch.empty((*gid.shape, tables[0].shape[-1]),
                       dtype=tables[0].dtype, device=gid.device)


def _device_address(t: torch.Tensor, device: torch.device) -> int:
    """Where the kernel on ``device`` reads table ``t``: its own address on
    that device, or the mapped address of a host table."""
    if t.device == device:
        return t.data_ptr()
    if t.device.type == "cpu":
        ptr = device_pointer(t)
        if ptr is not None:
            return ptr
        raise ValueError("gather_rows_multi: a pageable CPU table with row "
                         f"ids on {device}; the card reads host tables only "
                         "in buffers pinned and mapped by host.host_empty")
    raise ValueError(f"gather_rows_multi: a table on {t.device}, row ids on "
                     f"{device}")


def gather_rows(table: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """out[i] = table[gid[i]]: the one-table case of ``gather_rows_multi``.
    table (R, hd) with unit stride along hd and any row stride; gid (N,)
    int64/int32 -> out (N, hd) on gid's device."""
    if table.device.type == "cpu" and gid.device.type == "cpu":
        return gather_rows_ref(table, gid)
    if gid.dim() != 1:
        raise ValueError(f"gather_rows: gid must be 1-D, got "
                         f"{tuple(gid.shape)}")
    return gather_rows_multi([table], gid.reshape(1, -1))[0]


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
