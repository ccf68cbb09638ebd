"""Wrapper for the gated_fuse kernel (``csrc/gated_fuse.cu``).

``engram_gated_fuse(h, e, wg, wp) = h + sigmoid(h @ wg) * (e @ wp)`` with
both products accumulated in f32 and the epilogue in f32. Leading dims are
flattened into the kernel's T rows; the kernel masks the ragged T edge, so
nothing is padded (the TPU wrapper pads T to its row tile and falls back to
the oracle when d or F is not lane-aligned; this kernel takes any width).

bf16 runs the tensor-core kernel. ``plan_split`` chooses its token tile
and how the contraction is split into parts (one block per column tile,
token tile and part), so that a small T still fills the card; the wrapper
allocates the parts' f32 workspace with ``torch.empty`` and owns the
per-tile arrival counters, zeroed once per device (the kernel leaves them
zero). Calls on one device are stream-ordered, as the port's are: two
concurrent launches on different streams would share the counters.
float32 runs the CUDA-core kernel, unsplit.

``engram_gated_fuse.launches`` counts kernel launches. The kernel has no
backward (nor has the TPU kernel): a CUDA call that autograd would record
(grad mode on, an operand requiring grad) raises instead of returning a
result cut from the graph.

The launch is the custom operator ``repro_torch::gated_fuse``
(``torch.library.custom_op``) with a shape function (``register_fake``):
a fake or meta tensor passes through it and comes out with the kernel's
output shape and dtype, launching nothing and touching no module cache
(the arrival counters are allocated only by the CUDA implementation), so
a trace (``launch.dryrun``, ``roofline.counting``) sees the call by name.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from ..build import load
from .ref import gated_fuse_ref

BM = 64              # output columns per block (csrc/gated_fuse.cu, tc::BM)
BK = 64              # contraction slab (tc::BK)
TOKEN_TILES = (8, 16, 32, 64, 128)
SMS = 132            # H100 SXM streaming multiprocessors
TARGET_BLOCKS = 2 * SMS

_FNS: dict = {}
_COUNTERS: dict = {}


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """How the bf16 kernel tiles one call: token tile ``bn``; g's d-slabs
    in ``s_g`` parts of ``q_g`` slabs, then p's F-slabs in ``s_p`` parts of
    ``q_p`` (the last part of each may be shorter)."""
    bn: int
    q_g: int
    s_g: int
    q_p: int
    s_p: int
    col_tiles: int
    tok_tiles: int

    @property
    def parts(self) -> int:
        return self.s_g + self.s_p

    @property
    def grid(self) -> tuple:
        return (self.col_tiles, self.tok_tiles, self.parts)

    @property
    def blocks(self) -> int:
        return self.col_tiles * self.tok_tiles * self.parts


def _even_parts(slabs: int, q: int) -> tuple:
    """(slabs per part, parts) cutting ``slabs`` into parts of at most
    about ``q``, as even as whole slabs allow, none empty."""
    if slabs == 0:
        return 1, 0
    s = -(-slabs // q)
    q = -(-slabs // s)
    return q, -(-slabs // q)


def plan_split(n_t: int, d: int, F: int) -> SplitPlan:
    """Token tile: the smallest of 8..128 that holds T (128 beyond). Parts:
    enough that column tiles x token tiles x parts reaches TARGET_BLOCKS
    (two blocks per SM), with g and p never sharing a part."""
    bn = next((b for b in TOKEN_TILES if b >= n_t), TOKEN_TILES[-1])
    col_tiles, tok_tiles = -(-d // BM), -(-n_t // bn)
    slabs_g, slabs_p = -(-d // BK), -(-F // BK)
    want = math.ceil(TARGET_BLOCKS / (col_tiles * tok_tiles))
    q = max(1, math.ceil((slabs_g + slabs_p) / want))
    q_g, s_g = _even_parts(slabs_g, q)
    q_p, s_p = _even_parts(slabs_p, q)
    return SplitPlan(bn, q_g, s_g, q_p, s_p, col_tiles, tok_tiles)


def _kernel(name: str):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(load("gated_fuse"), name)
        if name == "gated_fuse_bf16_launch":
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 3 + \
                [ctypes.c_int] * 5 + [ctypes.c_void_p]
        else:
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 3 + \
                [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed per-tile counters on ``device``, allocated
    (and zeroed) only when a call needs more tiles than any before."""
    c = _COUNTERS.get(device)
    if c is None or c.numel() < n:
        c = _COUNTERS[device] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                            device=device)
    return c


def engram_gated_fuse(h: torch.Tensor, e: torch.Tensor, wg: torch.Tensor,
                      wp: torch.Tensor) -> torch.Tensor:
    """h (..., d); e (..., F); wg (d, d); wp (F, d) -> (..., d) in h's
    dtype. CPU tensors take the plain version; CUDA tensors launch the
    kernel (bf16 or float32, all four of one dtype, contiguous); meta
    tensors (and fake CUDA ones) give the output's shape alone."""
    if h.device.type == "cpu":
        return gated_fuse_ref(h, e, wg, wp)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (h, e, wg, wp)):
        raise RuntimeError("engram_gated_fuse: the kernel has no backward "
                           "and would cut the gradient; train through "
                           "engram_fuse(use_kernel=False), or call it under "
                           "torch.no_grad/inference_mode")
    d, F = h.shape[-1], e.shape[-1]
    if h.device.type not in ("cuda", "meta") or any(
            t.device != h.device for t in (e, wg, wp)):
        raise ValueError("engram_gated_fuse: all operands must be on one "
                         "CUDA device")
    if h.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != h.dtype for t in (e, wg, wp)):
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
    return torch.ops.repro_torch.gated_fuse.default(h, e, wg, wp)


@torch.library.custom_op("repro_torch::gated_fuse", mutates_args=(),
                         device_types="cuda")
def _fuse_op(h: torch.Tensor, e: torch.Tensor, wg: torch.Tensor,
             wp: torch.Tensor) -> torch.Tensor:
    """The launch: ``engram_gated_fuse``'s checked operands on the card."""
    d, F = h.shape[-1], e.shape[-1]
    out = torch.empty_like(h)
    if out.numel() == 0:
        return out                       # nothing to compute: no launch
    n_t = h.numel() // d
    stream = torch.cuda.current_stream(h.device).cuda_stream
    ptrs = [t.data_ptr() for t in (h, e, wg, wp, out)]
    if h.dtype == torch.float32:
        rc = _kernel("gated_fuse_f32_launch")(*ptrs, n_t, d, F, stream)
    else:
        plan = plan_split(n_t, d, F)
        ws = torch.empty(plan.parts * plan.tok_tiles * plan.bn
                         * plan.col_tiles * BM, dtype=torch.float32,
                         device=h.device)
        cnt = _counters(h.device, plan.col_tiles * plan.tok_tiles)
        rc = _kernel("gated_fuse_bf16_launch")(
            *ptrs, ws.data_ptr(), cnt.data_ptr(), n_t, d, F, plan.bn,
            plan.q_g, plan.s_g, plan.q_p, plan.s_p, stream)
    if rc != 0:
        raise RuntimeError(f"gated_fuse kernel launch failed: cudaError {rc}")
    engram_gated_fuse.launches += 1
    return out


@_fuse_op.register_fake
def _(h, e, wg, wp):
    return torch.empty_like(h)


engram_gated_fuse.launches = 0
