"""Wrapper for the decode_attn kernel (``csrc/decode_attn.cu``), K3.

``decode_attention`` is one decode step's attention for a layer: it writes
the new k and v rows into the caches at each row's position (clamped into
the cache, as ``models.attention.write_rows`` does) and attends each query
head over the keys its row's mask lets through, reading the caches in
place, in their own dtype, and only up to each row's position, in one
launch. Scores and the softmax are f32 and the value sum is f32; the output
is rounded to the cache's dtype once.

Tensors on the CPU take the plain version (``ref.decode_attention_ref``);
CUDA tensors launch the kernel (bf16 or float32 caches, head dims 8, 16,
64, 128 and 256, at most ``MAX_GROUP`` query heads a KV head and
``MAX_ROWS`` rows) or raise.
``plan_chunk`` cuts each row's keys into splits of whole positions (one
task a split and KV head) so that both a wave of 32 rows and one of 8
fill the card; the positions stay on the device, so the plan follows the
cache's length, the bound on every row's position, and the kernel deals
out only the splits that hold keys a row attends. The wrapper allocates
the splits' f32
partials with ``torch.empty`` and owns the per-(row, KV head) arrival
counters, zeroed once per device (the kernel leaves them zero). Calls on
one device are stream-ordered, as the port's are: two concurrent launches
on different streams would share the counters.

``decode_attention.launches`` counts kernel launches. The kernel has no
backward: a CUDA call that autograd would record raises.

The launch is the custom operator ``repro_torch::decode_attention``
(``torch.library.custom_op``, mutating both caches) with a shape function
(``register_fake``): a fake or meta tensor passes through it and comes out
with the kernel's output shape and dtype, launching nothing and touching
no module cache, so a trace (``launch.dryrun``, ``roofline.counting``)
sees the call by name, charged by ``cost``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..build import load
from .ref import decode_attention_ref

HEAD_DIMS = (8, 16, 64, 128, 256)
MAX_GROUP = 8        # query heads a KV head serves (csrc/decode_attn.cu GMAX)
MAX_ROWS = 1024      # rows a launch takes (MAXB)
CHUNKS = (512, 256, 128, 64)
SMS = 132            # H100 SXM streaming multiprocessors
TARGET_ITEMS = 4 * SMS

_FN = None
_COUNTERS: dict = {}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def plan_chunk(rows: int, S: int) -> int:
    """Positions a split: the largest of ``CHUNKS`` that cuts ``rows`` (row,
    KV head) pairs of ``S`` positions into at least ``TARGET_ITEMS`` items,
    else the smallest."""
    return next((c for c in CHUNKS if rows * -(-S // c) >= TARGET_ITEMS),
                CHUNKS[-1])


def kv_heads_read(n_q: int, group: int, q_offset: int) -> int:
    """The KV heads that query heads 0 .. n_q - 1 read."""
    return (n_q - 1 + q_offset) // group - q_offset // group + 1


def cost(n_q: int, n_kv_read: int, n_kv: int, d: int, item: int, rows: int,
         keys: int) -> tuple:
    """(FLOPs, bytes) of ``rows`` rows attending ``keys`` keys in all, each
    key read once by the ``n_q`` query heads of a row through ``n_kv_read``
    KV heads: the score and value products; the attended K and V, the new
    rows of all ``n_kv`` KV heads read and written, q read, the output
    written and the positions (int64)."""
    flops = 4.0 * n_q * d * keys
    nbytes = item * (2 * n_kv_read * d * keys + 4 * rows * n_kv * d
                     + 2 * rows * n_q * d) + 8 * rows
    return flops, nbytes


def _kernel():
    global _FN
    if _FN is None:
        fn = load("decode_attn").decode_attn_launch
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int64] * 5 + \
            [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed arrival counters on ``device``, allocated (and
    zeroed) only when a call needs more than any before."""
    c = _COUNTERS.get(device)
    if c is None or c.numel() < n:
        c = _COUNTERS[device] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                            device=device)
    return c


def _aligned(t: torch.Tensor, dims) -> bool:
    item = t.element_size()
    return t.data_ptr() % 16 == 0 and t.stride(-1) == 1 and all(
        t.stride(i) * item % 16 == 0 for i in dims)


def decode_attention(q, k_new, v_new, k_cache, v_cache, positions, *,
                     window: int = 0, softcap: float = 0.0, group: int = 1,
                     q_offset: int = 0) -> torch.Tensor:
    """q (B, Hq, D) in the cache's dtype or f32; k_new, v_new (B, Hc, D);
    k_cache, v_cache (B, S, Hc, D), written in place; positions (B,) int32
    or int64 on the caches' device; query head i reads KV head ``(i +
    q_offset) // group`` of the caches. Returns out (B, Hq, D) in the
    caches' dtype (``ref.decode_attention_ref`` states the function)."""
    kw = dict(window=window, softcap=softcap, group=group, q_offset=q_offset)
    if k_cache.device.type == "cpu":
        return decode_attention_ref(q, k_new, v_new, k_cache, v_cache,
                                    positions, **kw)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (q, k_new, v_new)):
        raise RuntimeError("decode_attention: the kernel has no backward "
                           "and would cut the gradient; decode under "
                           "torch.no_grad/inference_mode")
    B, S, Hc, D = k_cache.shape
    Hq = q.shape[1]
    dtype = k_cache.dtype
    if dtype not in _DTYPES or v_cache.dtype != dtype or \
            q.dtype not in (dtype, torch.float32):
        raise ValueError(f"decode_attention: caches {dtype}/{v_cache.dtype} "
                         f"must both be bfloat16 or float32, q {q.dtype} "
                         "theirs or float32")
    if D not in HEAD_DIMS or not 1 <= group <= MAX_GROUP or q_offset < 0 \
            or window < 0 or B > MAX_ROWS:
        raise ValueError(f"decode_attention: head dim {D} (takes "
                         f"{HEAD_DIMS}), group {group} (1 to {MAX_GROUP}), "
                         f"q_offset {q_offset}, window {window}, {B} rows "
                         f"(at most {MAX_ROWS})")
    if tuple(v_cache.shape) != (B, S, Hc, D) or q.shape != (B, Hq, D) or \
            k_new.shape != (B, Hc, D) or v_new.shape != (B, Hc, D) or \
            positions.shape != (B,) or (Hq - 1 + q_offset) // group >= Hc:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, new "
                         f"{tuple(k_new.shape)}/{tuple(v_new.shape)}, caches "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}, "
                         f"positions {tuple(positions.shape)} with group "
                         f"{group}, q_offset {q_offset} do not match")
    if positions.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"decode_attention: positions {positions.dtype}")
    if any(t.device != k_cache.device
           for t in (q, k_new, v_new, v_cache, positions)):
        raise ValueError("decode_attention: all operands must be on one "
                         "CUDA device")
    return torch.ops.repro_torch.decode_attention.default(
        q, k_new.to(dtype), v_new.to(dtype), k_cache, v_cache,
        positions.contiguous(), int(window), float(softcap), int(group),
        int(q_offset))


@torch.library.custom_op("repro_torch::decode_attention",
                         mutates_args=("k_cache", "v_cache"),
                         device_types="cuda")
def _attn_op(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
             k_cache: torch.Tensor, v_cache: torch.Tensor,
             positions: torch.Tensor, window: int, softcap: float,
             group: int, q_offset: int) -> torch.Tensor:
    """The launch: ``decode_attention``'s checked operands on the card
    (their addresses checked here: a fake tensor has none)."""
    if not (_aligned(q, (0, 1)) and _aligned(k_new, (0, 1))
            and _aligned(v_new, (0, 1)) and _aligned(k_cache, (0, 1, 2))
            and _aligned(v_cache, (0, 1, 2))):
        raise ValueError("decode_attention: every operand needs unit stride "
                         "along D and 16-byte aligned rows")
    B, S, Hc, D = k_cache.shape
    Hq = q.shape[1]
    out = torch.empty((B, Hq, D), dtype=k_cache.dtype, device=q.device)
    if out.numel() == 0:
        return out                       # nothing to compute: no launch
    chunk = plan_chunk(B * Hc, S)
    ws = torch.empty(B * Hc * -(-S // chunk) * (2 + D) * MAX_GROUP,
                     dtype=torch.float32, device=q.device)
    cnt = _counters(q.device, B * Hc)
    strides = (ctypes.c_int64 * 12)(
        q.stride(0), q.stride(1), k_new.stride(0), k_new.stride(1),
        v_new.stride(0), v_new.stride(1), *k_cache.stride()[:3],
        *v_cache.stride()[:3])
    rc = _kernel()(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), positions.data_ptr(), out.data_ptr(),
        ws.data_ptr(), cnt.data_ptr(), strides, B, Hq, Hc, S, D, group,
        q_offset, window, softcap, 1.0 / math.sqrt(D), chunk,
        _DTYPES[k_cache.dtype], int(q.dtype == torch.float32 and
                                    k_cache.dtype != torch.float32),
        int(positions.dtype == torch.int64),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attn kernel launch failed: cudaError {rc}")
    decode_attention.launches += 1
    return out


@_attn_op.register_fake
def _(q, k_new, v_new, k_cache, v_cache, positions, window, softcap, group,
      q_offset):
    return q.new_empty((q.shape[0], q.shape[1], k_cache.shape[-1]),
                       dtype=k_cache.dtype)


decode_attention.launches = 0
