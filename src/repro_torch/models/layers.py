"""Common layers: RMSNorm, RoPE, MLP, embeddings, softcap, f32 head
(PyTorch port of ``repro.models.layers``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .params import pd


def rmsnorm_defs(d: int):
    return {"scale": pd(d, init="ones")}


def mlp_defs(d: int, f: int, dtype: str, fan_in: int = 0):
    return {"gate": pd(d, f, dtype=dtype, fan_in=fan_in),
            "up": pd(d, f, dtype=dtype, fan_in=fan_in),
            "down": pd(f, d, dtype=dtype, fan_in=fan_in)}


def embed_defs(vocab: int, d: int, dtype: str):
    return {"w": pd(vocab, d, dtype=dtype, scale=1.0)}


def head_defs(vocab: int, d: int, dtype: str):
    return {"w": pd(d, vocab, dtype=dtype)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """f32 compute, result in ``x.dtype``."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)            # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D) w/ positions (..., S). Half-split rotation
    ``[x1·cos − x2·sin, x2·cos + x1·sin]`` over the two halves of D (not
    the interleaved-pairs form)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    angles = positions[..., None].float() * freqs            # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp(params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """SwiGLU (``act="silu"``) or GeGLU with the tanh-approximate GELU."""
    g = x @ params["gate"]
    u = x @ params["up"]
    a = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return (a * u) @ params["down"]


def embed_lookup(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["w"][tokens]


def with_f32_head(params: dict) -> dict:
    """Shallow copy of a param tree whose head also holds an f32 copy of its
    weight (``head["w32"]``), made once: ``head_logits`` computes in f32,
    and casting a bf16 head per call would allocate the f32 copy on every
    step. A tree that already holds ``w32`` comes back as it is, so engines
    built from one prepared tree (the router's replicas) share one f32
    head; an f32 head is shared, not copied (``.float()`` returns it)."""
    head = params["head"]
    if "w32" in head:
        return params
    out = dict(params)
    out["head"] = dict(head, w32=head["w"].float())
    return out


def head_logits(params, h: torch.Tensor, final_cap: float = 0.0
                ) -> torch.Tensor:
    """f32 logits ``h.float() @ W.float()`` (untied head)."""
    w = params.get("w32")
    if w is None:
        w = params["w"].float()
    return softcap(h.float() @ w, final_cap)
