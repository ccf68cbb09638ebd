"""Pieces of the plain reference shared by both model families: the Engram
n-gram hash, RMS norm, RoPE, causal attention and the linear-layer hook.

Everything computes in float32 from the weights the benchmark drew (bf16
values, read exactly in f32). TF32 is switched off while the reference
runs (``f32_matmuls``): a float32 product may otherwise round its inputs
to 10 bits of mantissa on the card.

``Linear`` is the one place a matrix product happens; the control swaps it
for one that rounds both operands to float8 (e4m3) first, the precision a
later change might be tempted to serve in.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
M1 = 0x7FEB352D
M2 = 0x846CA68B


@contextlib.contextmanager
def f32_matmuls():
    """Float32 products in float32 (TF32 off), restored afterwards."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


class Linear:
    """``x @ w`` in float32 (``w`` of any float dtype, read in f32)."""

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x @ w.float()


class Float8Linear(Linear):
    """The control: both operands rounded to float8 e4m3 with a scale per
    row of ``x`` and per column of ``w`` (amax to 448), the product of the
    rounded values in float32."""

    @staticmethod
    def _round(t: torch.Tensor, dim: int) -> torch.Tensor:
        amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
        scale = amax / 448.0
        return (t / scale).to(torch.float8_e4m3fn).float() * scale

    def __call__(self, x, w):
        return self._round(x, -1) @ self._round(w.float(), 0)


# ---------------------------------------------------------------- hashing

def hash_constants(seed: int, n_tables: int, max_order: int) -> np.ndarray:
    """(n_tables, max_order) odd multipliers, one per (order, head,
    position), from the configuration's hash seed."""
    rng = np.random.RandomState(seed & 0x7FFFFFFF)
    c = rng.randint(1, 2 ** 31, size=(n_tables, max_order), dtype=np.int64)
    return ((c * 2 + 1) & MASK32).astype(np.uint64)


def _mix(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> np.uint64(16))
    x = (x * np.uint64(M1)) & np.uint64(MASK32)
    x = x ^ (x >> np.uint64(15))
    x = (x * np.uint64(M2)) & np.uint64(MASK32)
    return x ^ (x >> np.uint64(16))


def engram_indices(e: dict, tokens) -> np.ndarray:
    """A sequence's table rows, (S, n_tables) int64: for each n-gram order
    and each of its hash heads, a multiplicative mix of the order's window
    of token ids ending at each position (left-padded with ``pad_token``)
    into a row of that head's table. Table t = order_index * n_heads +
    head."""
    toks = np.asarray(tokens, np.uint64) & np.uint64(MASK32)
    S, H = toks.shape[0], e["n_heads"]
    orders = list(e["orders"])
    consts = hash_constants(e["hash_seed"], len(orders) * H, max(orders))
    out = np.empty((S, len(orders) * H), np.int64)
    pad = np.uint64(e["pad_token"])
    for oi, order in enumerate(orders):
        cols = []
        for j in range(order - 1, -1, -1):             # oldest ... newest
            col = np.full(S, pad, np.uint64)
            if j < S:
                col[j:] = toks[:S - j]
            cols.append(col)
        for h in range(H):
            t = oi * H + h
            acc = np.full(S, (0x9E3779B9 * (t + 1)) & MASK32, np.uint64)
            for j in range(order):
                acc = _mix(acc ^ ((cols[j] * consts[t, j])
                                  & np.uint64(MASK32)))
            out[:, t] = (acc % np.uint64(e["table_vocab"])).astype(np.int64)
    return out


def engram_rows(tables: torch.Tensor, idx: np.ndarray,
                device) -> torch.Tensor:
    """Rows (S, n_tables * row) in float32 on ``device``: table t's row
    ``idx[:, t]``, read from the tables wherever they lie."""
    T = tables.shape[0]
    ti = torch.arange(T).repeat(idx.shape[0])
    ri = torch.from_numpy(idx.reshape(-1))
    if tables.device.type != "cpu":
        ti, ri = ti.to(tables.device), ri.to(tables.device)
    rows = tables[ti, ri]
    return rows.to(device).float().reshape(idx.shape[0], -1)


# ------------------------------------------------------------- the layers

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, D) at positions 0..S-1: each half of D rotated against the
    other (``[x1 cos - x2 sin, x2 cos + x1 sin]``), frequencies
    theta^(-2i/D)."""
    S, D = x.shape[0], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                         device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, block: int = 512) -> torch.Tensor:
    """q (S, H, Dk), k (S, Hkv, Dk), v (S, Hkv, Dv); query head h reads KV
    head h // (H / Hkv). Softmax over the keys at or before each query,
    scores scaled by 1/sqrt(Dk); queries in blocks of ``block``."""
    S, H, Dk = q.shape
    g = H // k.shape[1]
    k = k.repeat_interleave(g, dim=1).permute(1, 2, 0)       # (H, Dk, S)
    v = v.repeat_interleave(g, dim=1).permute(1, 0, 2)       # (H, S, Dv)
    out = []
    pos = torch.arange(S, device=q.device)
    for a in range(0, S, block):
        b = min(S, a + block)
        s = torch.matmul(q[a:b].permute(1, 0, 2), k[:, :, :b]) \
            / math.sqrt(Dk)                                   # (H, q, b)
        s = s.masked_fill(pos[None, :b] > pos[a:b, None], float("-inf"))
        out.append(torch.matmul(torch.softmax(s, -1), v[:, :b])
                   .permute(1, 0, 2))
    return torch.cat(out)                                     # (S, H, Dv)
