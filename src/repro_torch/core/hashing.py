"""Multi-head N-gram hashing for Engram conditional memory (PyTorch port of
``repro.core.hashing``).

Indices depend ONLY on token IDs (the paper's prefetch-enabling property):
for each n-gram order and each of H hash heads, a murmur-style uint32 mix
maps the n-gram window to a row of that head's table.

The reference mixes in uint32 and relies on its wraparound. Here every value
is an int64 tensor holding a uint32 in [0, 2**32), and each 32-bit product is
taken on 16-bit halves of the constant so no partial product reaches 2**49
(``_mul32``); results are bit-equal to the reference on every device.
Packed segment keys are int64 throughout: the reference's int32 span guard
(``key_dtype``) exists only because of JAX's default 32-bit integers.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..configs.base import EngramConfig

_MASK32 = 0xFFFFFFFF
_M1 = 0x7FEB352D
_M2 = 0x846CA68B


def head_constants(ecfg: EngramConfig) -> np.ndarray:
    """(n_tables, max_order) odd uint32 per (order, head, position)."""
    rng = np.random.RandomState(ecfg.seed & 0x7FFFFFFF)
    max_order = max(ecfg.orders)
    c = rng.randint(1, 2**31, size=(ecfg.n_tables, max_order), dtype=np.int64)
    return (c * 2 + 1).astype(np.uint32)                  # odd


@functools.lru_cache(maxsize=16)
def _device_constants(seed: int, n_heads: int, orders: tuple,
                      device: torch.device) -> tuple:
    """Per-order (lo16, hi16) halves of the head constants on ``device``,
    each (n_heads, order). Built once per config and device: an upload per
    call would put a host->device copy on every wave."""
    ecfg = EngramConfig(orders=orders, n_heads=n_heads, seed=seed)
    c = head_constants(ecfg).astype(np.int64)
    out = []
    for oi, order in enumerate(orders):
        ct = torch.from_numpy(c[oi * n_heads:(oi + 1) * n_heads, :order].copy())
        out.append(((ct & 0xFFFF).to(device), (ct >> 16).to(device)))
    return tuple(out)


def _mul32(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``(x * c) mod 2**32`` for x in [0, 2**32) and c = hi * 2**16 + lo.

    x * lo < 2**48 and (x * hi mod 2**16) * 2**16 < 2**32, so int64 never
    overflows; ``lo``/``hi`` may be Python ints or broadcastable tensors."""
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _M1 & 0xFFFF, _M1 >> 16)
    x = x ^ (x >> 15)
    x = _mul32(x, _M2 & 0xFFFF, _M2 >> 16)
    x = x ^ (x >> 16)
    return x


def ngram_windows(tokens: torch.Tensor, order: int,
                  pad_token: int) -> torch.Tensor:
    """tokens (B,S) -> (B,S,order) windows [t_{i-order+1} ... t_i] (left-pad)."""
    B, S = tokens.shape
    cols = []
    for j in range(order - 1, -1, -1):                    # oldest ... newest
        if j == 0:
            cols.append(tokens)
        else:
            pad = tokens.new_full((B, min(j, S)), pad_token)
            cols.append(torch.cat([pad, tokens[:, :max(S - j, 0)]], dim=1))
    return torch.stack(cols, dim=-1)


def engram_indices(ecfg: EngramConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B,S) int -> indices (B,S,n_tables) int64 in [0, table_vocab).

    Table t = order_idx * n_heads + head. All heads of one order are hashed
    together along a trailing head axis."""
    H = ecfg.n_heads
    consts = _device_constants(ecfg.seed, H, tuple(ecfg.orders),
                               tokens.device)
    heads = torch.arange(H, device=tokens.device, dtype=torch.int64)
    outs = []
    for oi, order in enumerate(ecfg.orders):
        win = ngram_windows(tokens.to(torch.int64), order,
                            ecfg.pad_token) & _MASK32
        lo, hi = consts[oi]
        t = oi * H + heads
        acc = (0x9E3779B9 * (t + 1)) & _MASK32              # per-head seed
        acc = acc.expand(*win.shape[:-1], H)
        for j in range(order):
            acc = _mix(acc ^ _mul32(win[..., j, None], lo[:, j], hi[:, j]))
        outs.append(acc % ecfg.table_vocab)
    return torch.cat(outs, dim=-1)


def decode_engram_indices(ecfg: EngramConfig, last_tokens: torch.Tensor,
                          new_token: torch.Tensor) -> torch.Tensor:
    """Decode-step indices. last_tokens (B, max_order-1) most-recent history
    (oldest first), new_token (B,). Returns (B, 1, n_tables)."""
    ctx = torch.cat([last_tokens.to(torch.int64),
                     new_token.to(torch.int64)[:, None]], dim=1)
    idx = engram_indices(ecfg, ctx)                       # (B, max_order, T)
    return idx[:, -1:, :]


def pack_segment_keys(ecfg: EngramConfig, idx: torch.Tensor,
                      n_layer_slots: int) -> torch.Tensor:
    """``idx (..., T)`` -> ``(..., L, T)`` int64 keys
    ``(layer_slot * T + t) * table_vocab + row`` for every Engram layer slot
    at once — the device twin of ``pool.store.segment_keys``."""
    T = ecfg.n_tables
    tid = (torch.arange(n_layer_slots, device=idx.device,
                        dtype=torch.int64)[:, None] * T
           + torch.arange(T, device=idx.device, dtype=torch.int64)[None, :])
    return idx.to(torch.int64)[..., None, :] + tid * ecfg.table_vocab


def decode_engram_keys(ecfg: EngramConfig, last_tokens: torch.Tensor,
                       new_token: torch.Tensor,
                       n_layer_slots: int) -> torch.Tensor:
    """Decode-step indices, packed: (B, 1, L, T) int64 segment keys."""
    idx = decode_engram_indices(ecfg, last_tokens, new_token)
    return pack_segment_keys(ecfg, idx, n_layer_slots)


def update_last_tokens(last_tokens: torch.Tensor,
                       new_token: torch.Tensor) -> torch.Tensor:
    """Roll the (B, max_order-1) history window."""
    if last_tokens.shape[1] == 0:
        return last_tokens
    return torch.cat([last_tokens[:, 1:],
                      new_token.to(last_tokens.dtype)[:, None]], dim=1)
