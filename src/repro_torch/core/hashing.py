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
import zlib

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

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
    if is_fake(tokens) or tokens.device.type == "meta":
        # a trace (launch.dryrun) reads no values: stand-ins of the
        # constants' shapes, made without traffic and cached nowhere (a
        # fake tensor in the cache would reach the next real call)
        consts = [(torch.empty((H, o), dtype=torch.int64,
                               device=tokens.device),) * 2
                  for o in ecfg.orders]
    else:
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


def block_engram_indices(ecfg: EngramConfig, last_tokens: torch.Tensor,
                         block: torch.Tensor) -> torch.Tensor:
    """Indices for a block of new tokens. last_tokens (B, max_order-1)
    history (oldest first), block (B, m). Returns (B, m, n_tables): the
    whole block's indices from token IDs alone (a chunk-prefill wave's
    keys, a speculated window's prefetch)."""
    ctx = torch.cat([last_tokens.to(torch.int64),
                     block.to(torch.int64)], dim=1)
    idx = engram_indices(ecfg, ctx)                       # (B, o-1+m, T)
    return idx[:, -block.shape[1]:, :]


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


def block_engram_keys(ecfg: EngramConfig, last_tokens: torch.Tensor,
                      block: torch.Tensor, n_layer_slots: int) -> torch.Tensor:
    """Speculated-block indices, packed: (B, m, L, T) int64 segment keys
    covering the whole proposed window ``block`` (B, m) = [pending token,
    drafts...]."""
    idx = block_engram_indices(ecfg, last_tokens, block)
    return pack_segment_keys(ecfg, idx, n_layer_slots)


# ---------------------------------------------------------------------------
# host (numpy) twin, bit-equal to the device path
# ---------------------------------------------------------------------------
#
# The pipelined speculative wave predicts wave N+1's block on the host
# during wave N's verify. When every live slot's prediction survives, the
# engine skips wave N+1's device key read, which it can do only if it packs
# the block's keys on the host from token IDs alone. numpy's uint32
# arithmetic wraps as the reference's does.

_M1_U32 = np.uint32(_M1)
_M2_U32 = np.uint32(_M2)

# the host path runs once per live slot per speculative wave: a fresh
# RandomState per call would put constant work on the single-sync path
_HOST_CONSTS: dict = {}


def _host_head_constants(ecfg: EngramConfig) -> np.ndarray:
    key = (ecfg.seed, ecfg.n_tables, tuple(ecfg.orders))
    c = _HOST_CONSTS.get(key)
    if c is None:
        c = _HOST_CONSTS[key] = head_constants(ecfg)
    return c


def host_engram_indices(ecfg: EngramConfig, tokens: np.ndarray) -> np.ndarray:
    """numpy mirror of ``engram_indices``: tokens (B,S) -> (B,S,T) int32."""
    tokens = np.asarray(tokens)
    consts = _host_head_constants(ecfg)                    # (T, max_order) u32

    def mix(x):
        x = x ^ (x >> np.uint32(16))
        x = x * _M1_U32
        x = x ^ (x >> np.uint32(15))
        x = x * _M2_U32
        return x ^ (x >> np.uint32(16))

    outs = []
    for oi, order in enumerate(ecfg.orders):
        cols = []
        for j in range(order - 1, -1, -1):                 # oldest ... newest
            if j == 0:
                cols.append(tokens)
            else:
                cols.append(np.pad(tokens[:, :-j], ((0, 0), (j, 0)),
                                   constant_values=ecfg.pad_token))
        win = np.stack(cols, axis=-1).astype(np.uint32)
        for h in range(ecfg.n_heads):
            t = oi * ecfg.n_heads + h
            seed_t = np.uint32((0x9E3779B9 * (t + 1)) & _MASK32)
            acc = np.full(win.shape[:-1], seed_t, np.uint32)
            for j in range(order):
                acc = mix(acc ^ (win[..., j] * consts[t, j]))
            outs.append(acc % np.uint32(ecfg.table_vocab))
    return np.stack(outs, axis=-1).astype(np.int32)


def host_block_keys(ecfg: EngramConfig, stream, block,
                    n_layer_slots: int) -> np.ndarray:
    """numpy mirror of ``block_engram_keys`` for ONE slot: ``stream`` is the
    slot's token history *excluding* the block, ``block`` the m = [pending,
    drafts...] window. Returns packed (m, L, T) int64 keys, bit-equal to the
    device path (which sees the same trailing ``max_order - 1`` tokens
    through the state's ``last_tokens``)."""
    o = max(ecfg.orders)
    ctx = [int(t) for t in stream][-(o - 1):] if o > 1 else []
    if len(ctx) < o - 1:                      # early stream: pad like state
        ctx = [ecfg.pad_token] * (o - 1 - len(ctx)) + ctx
    block = [int(t) for t in block]
    toks = np.asarray([ctx + block], np.int32)            # (1, o-1+m)
    idx = host_engram_indices(ecfg, toks)[0, -len(block):, :]   # (m, T)
    T = ecfg.n_tables
    tid = (np.arange(n_layer_slots, dtype=np.int64)[:, None] * T
           + np.arange(T, dtype=np.int64)[None, :])             # (L, T)
    return (idx.astype(np.int64)[:, None, :]
            + tid[None, :, :] * ecfg.table_vocab)               # (m, L, T)


def update_last_tokens(last_tokens: torch.Tensor,
                       new_token: torch.Tensor) -> torch.Tensor:
    """Roll the (B, max_order-1) history window."""
    if last_tokens.shape[1] == 0:
        return last_tokens
    return torch.cat([last_tokens[:, 1:],
                      new_token.to(last_tokens.dtype)[:, None]], dim=1)


def prefix_chain_keys(tokens, block_tokens: int) -> list:
    """Chained keys over a prompt's whole ``block_tokens``-sized blocks
    (host only): key ``i`` identifies the entire token prefix through
    block ``i``, so two prompts share key ``i`` iff their first
    ``(i+1)*block_tokens`` tokens are equal — the prefix KV cache's
    identity. Two crc32 streams with different seeds folded into one
    64-bit key: the same in every process (unlike the salted ``hash()``).
    The trailing partial block gets no key."""
    if block_tokens <= 0:
        raise ValueError(f"block_tokens must be positive, got {block_tokens}")
    toks = [int(t) for t in tokens]
    h1, h2 = 0, 0x9E3779B9
    out = []
    for b in range(len(toks) // block_tokens):
        data = np.asarray(toks[b * block_tokens:(b + 1) * block_tokens],
                          np.int64).tobytes()
        h1 = zlib.crc32(data, h1)
        h2 = zlib.crc32(data, h2)
        out.append((h1 << 32) | h2)
    return out
