"""Model FLOPs per token and the least time of the port's kernels K1 and
K2, from shapes alone (a frozen copy of the formulas the port's
``roofline.counting`` applies to K1 and K2; the model formula is the
arithmetic of the model ``reference/model.py`` computes, each matrix
product at 2 x m x n x k). Its MLA and MoE are the port's mirror of the
JAX reference (routed experts of two products, ROADMAP.md F10; every expert
the router names), not the published DeepSeek-V2: a configuration that
states another model counts its FLOPs in its family
(``harness/family.py``); ``prefill`` and ``decode`` here are a family's
default.

A configuration is the JSON object of ``portbench/configs/`` (Hugging
Face key names, plus an ``engram`` group). Counted as model FLOPs: every
linear layer a token passes through (the experts a token is routed to,
the shared experts, the router), attention's score and value products
over the positions a token attends to (causal: position p attends p + 1
keys), the Engram fusion's two products (K2: the gate over the hidden
state, the projection of the rows) and the output head. A prompt's head
runs once, on its last position. Nothing the program computes beyond
that counts: padding, masked positions, the unused half of a fused
expert projection, f32 copies.
"""
from __future__ import annotations

from . import peaks


def _moe(c: dict) -> bool:
    return bool(c.get("n_routed_experts"))


def _mla(c: dict) -> bool:
    return bool(c.get("kv_lora_rank"))


def fuse_dim(c: dict) -> int:
    e = c["engram"]
    return len(e["orders"]) * e["emb_dim"]


def engram_layers(c: dict) -> list:
    L = c["num_hidden_layers"]
    return sorted(x for x in c["engram"]["layers"] if 0 < x < L)


def mixer_linear(c: dict) -> float:
    """Multiply-adds per token of one attention layer's projections."""
    d, H = c["hidden_size"], c["num_attention_heads"]
    if _mla(c):
        qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
        R, r = c["kv_lora_rank"], c["qk_rope_head_dim"]
        return (d * c["q_lora_rank"] + c["q_lora_rank"] * H * qk
                + d * (R + r) + R * H * (c["qk_nope_head_dim"]
                                         + c["v_head_dim"])
                + H * c["v_head_dim"] * d)
    hd = c.get("head_dim") or d // H
    hkv = c["num_key_value_heads"]
    return d * H * hd + 2 * d * hkv * hd + H * hd * d


def attn_pair(c: dict) -> float:
    """Multiply-adds of one (query, key) pair of one layer: the score and
    the value product over every head."""
    H = c["num_attention_heads"]
    if _mla(c):
        return H * (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
                    + c["v_head_dim"])
    hd = c.get("head_dim") or c["hidden_size"] // H
    return H * 2 * hd


def ffn_linear(c: dict, layer: int) -> float:
    """Multiply-adds per token of layer ``layer``'s FFN: a SwiGLU, or the
    router, the routed experts and the shared SwiGLU. The port's routed
    expert is ``act(x W_gate) W_down`` (it reads no up projection), so an
    expert counts two products."""
    d = c["hidden_size"]
    if not _moe(c) or layer < c.get("first_k_dense_replace", 0):
        return 3 * d * c["intermediate_size"]
    f = c["moe_intermediate_size"]
    return (d * c["n_routed_experts"]
            + c["num_experts_per_tok"] * 2 * d * f
            + 3 * d * c["n_shared_experts"] * f)


def fuse_linear(c: dict) -> float:
    """Multiply-adds per token of one Engram fusion (K2)."""
    d = c["hidden_size"]
    return d * d + fuse_dim(c) * d


def token_linear(c: dict) -> float:
    """FLOPs per token through every layer and fusion, without attention's
    score and value products and without the head."""
    L = c["num_hidden_layers"]
    mac = sum(mixer_linear(c) + ffn_linear(c, i) for i in range(L))
    mac += len(engram_layers(c)) * fuse_linear(c)
    return 2.0 * mac


def head(c: dict) -> float:
    return 2.0 * c["hidden_size"] * c["vocab_size"]


def attention(c: dict, pairs: float) -> float:
    """FLOPs of ``pairs`` (query, key) pairs in every layer."""
    return 2.0 * attn_pair(c) * pairs * c["num_hidden_layers"]


def prefill(c: dict, n: int) -> float:
    """A prompt of ``n`` tokens: every layer on every token, causal
    attention, the head on the last position."""
    return token_linear(c) * n + attention(c, n * (n + 1) / 2) + head(c)


def decode(c: dict, pos: int) -> float:
    """One decode step of the token at position ``pos`` (it attends
    ``pos + 1`` keys) and its head."""
    return token_linear(c) + attention(c, pos + 1) + head(c)


def k2_cost(h_shape, e_shape, itemsize: int = 2) -> tuple:
    """(FLOPs, bytes) of one K2 call: h (..., d), e (..., F); the gate (d, d)
    and the projection (F, d) read once, h read and the output written."""
    d, F = h_shape[-1], e_shape[-1]
    T = 1
    for s in h_shape[:-1]:
        T *= s
    return (2.0 * T * d * (d + F),
            itemsize * (2 * T * d + T * F + d * d + F * d))


def k2_least_s(h_shape, e_shape, itemsize: int = 2) -> float:
    f, b = k2_cost(h_shape, e_shape, itemsize)
    return max(f / peaks.BF16_FLOP_PER_S, b / peaks.HBM_BYTES_PER_S)


def k1_host_least_s(n_rows: int, row_bytes: int) -> float:
    """One K1 call over host rows: the rows read over the host link, or
    written to HBM, whichever takes longer."""
    nbytes = n_rows * row_bytes
    return max(nbytes / peaks.PCIE_BYTES_PER_S,
               nbytes / peaks.HBM_BYTES_PER_S)


def k1_hbm_least_s(n_rows: int, row_bytes: int) -> float:
    """One K1 call over rows in HBM: the rows read and written, both over
    HBM."""
    return 2 * n_rows * row_bytes / peaks.HBM_BYTES_PER_S
