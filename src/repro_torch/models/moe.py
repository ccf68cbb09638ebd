"""Mixture-of-Experts: the router, the dense reference and the sorted
dropless path (PyTorch port of ``repro.models.moe``).

  dense   every expert on every token, combined by the router's weights:
          O(T·E·f) FLOPs, the numerical reference (tests only; at full
          width it reads all experts for every token).
  ragged  the rows (token, choice) sorted by expert id (stable), one
          grouped GEMM per projection over the contiguous expert groups,
          each row scaled by its weight, then un-permuted to (T, k, d)
          and summed over k in a fixed order (no atomics: two runs give
          the same bits).

The reference's ``gather`` and ``alltoall`` strategies run the ragged
path when there is no mesh (``moe_ep_gather``/``moe_ep_alltoall`` fall back
to ``moe_ragged_local``); the port has no mesh, so those names map to the
ragged path here (expert parallelism: ROADMAP queue 1, item 9b).

The grouped GEMM (``grouped_mm``; the reference's ``jax.lax.ragged_dot``)
is ``torch._grouped_mm`` on the card, bf16 with the groups' end offsets as
a device int32 cumulative sum, and a loop over the experts on the CPU.
Nothing on the ragged path reads the device: the group offsets come from
``searchsorted`` over the sorted expert ids.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, MoEConfig
from .layers import mlp, mlp_defs
from .params import pd

def moe_defs(cfg: ModelConfig, dtype: str, fan_in: int = 0):
    m, d = cfg.moe, cfg.d_model
    defs = {
        "router": pd(d, m.n_experts, dtype="float32", fan_in=fan_in),
        # fused gate+up: (E, d, 2f); down: (E, f, d)
        "w_gu": pd(m.n_experts, d, 2 * m.d_ff_expert, dtype=dtype,
                   fan_in=fan_in),
        "w_down": pd(m.n_experts, m.d_ff_expert, d, dtype=dtype,
                     fan_in=fan_in),
    }
    if m.n_shared > 0:
        defs["shared"] = mlp_defs(d, m.n_shared * m.d_ff_expert, dtype,
                                  fan_in)
    return defs


def _route(m: MoEConfig, params, x_flat):
    """x_flat (T, d) -> (eids (T,k), weights (T,k) in x's dtype, aux):
    f32 router logits, softmax, top-k, the top-k renormalised and scaled
    by ``router_scale``; aux is the switch-style load-balance loss."""
    logits = x_flat.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    top_p, eids = probs.topk(m.top_k, dim=-1)
    w = top_p / top_p.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    w = (w * m.router_scale).to(x_flat.dtype)
    frac = torch.zeros(m.n_experts, device=x_flat.device).scatter_add_(
        0, eids.reshape(-1), torch.full((eids.numel(),), 1.0 / eids.numel(),
                                        device=x_flat.device))
    aux = m.n_experts * (frac * probs.mean(dim=0)).sum() * m.aux_loss_coef
    return eids, w, aux


def _act(g, act: str):
    return F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")


def grouped_mm_ref(rows, w, offs):
    """The grouped GEMM's plain version: rows (R, K) sorted by group,
    w (G, K, N), offs (G,) the groups' end offsets; group g's rows
    ``offs[g-1]:offs[g]`` times ``w[g]``, one matmul per non-empty
    group. Reads the offsets on the host."""
    out = rows.new_zeros((rows.shape[0], w.shape[-1]))
    ends = offs.tolist()
    for g, (a, b) in enumerate(zip([0] + ends[:-1], ends)):
        if b > a:
            out[a:b] = rows[a:b] @ w[g]
    return out


def grouped_mm(rows, w, offs):
    """``rows[offs[g-1]:offs[g]] @ w[g]`` for every group g, in one call:
    ``torch._grouped_mm`` on a CUDA tensor (``offs`` a device int32
    cumulative sum, never read on the host), the plain loop on the CPU.
    ``grouped_mm.launches`` counts the card's calls."""
    if rows.device.type == "cpu":
        return grouped_mm_ref(rows, w, offs)
    if not hasattr(torch, "_grouped_mm"):
        raise RuntimeError(f"torch {torch.__version__} has no _grouped_mm: "
                           "the MoE path needs it on the card")
    grouped_mm.launches += 1
    return torch._grouped_mm(rows, w, offs=offs)


grouped_mm.launches = 0


def _expert_mlp_rows(params, rows, offs, act: str):
    """The experts' MLP over rows sorted by expert (groups ending at
    ``offs``). As in the reference (``_expert_mlp_rows`` and
    ``moe_dense``), the fused gate+up product is computed whole but only
    its gate half is used: ``act(x @ W_gate) @ W_down``."""
    f = params["w_down"].shape[-2]
    h = grouped_mm(rows, params["w_gu"], offs)
    return grouped_mm(_act(h[:, :f], act), params["w_down"], offs)


def moe_dense(cfg: ModelConfig, params, x):
    m = cfg.moe
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    eids, w, aux = _route(m, params, xf)
    h = torch.einsum("td,edf->tef", xf, params["w_gu"])
    f = m.d_ff_expert
    y = torch.einsum("tef,efd->ted", _act(h[..., :f], cfg.ffn_act),
                     params["w_down"])
    comb = torch.zeros((xf.shape[0], m.n_experts), dtype=x.dtype,
                       device=x.device).scatter_add_(1, eids, w)
    out = torch.einsum("ted,te->td", y, comb)
    return out.reshape(B, S, d), aux


def moe_ragged_local(cfg: ModelConfig, params, x):
    """The sorted dropless path (capacity ``T*k``: every row is kept)."""
    m = cfg.moe
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    eids, w, aux = _route(m, params, xf)
    T, k = eids.shape
    flat_e = eids.reshape(-1)
    se, order = torch.sort(flat_e, stable=True)
    rows = xf.index_select(0, order // k)
    offs = torch.searchsorted(se, torch.arange(1, m.n_experts + 1,
                                               device=x.device),
                              out_int32=True)
    out_rows = _expert_mlp_rows(params, rows, offs, cfg.ffn_act)
    out_rows = out_rows * w.reshape(-1).index_select(0, order)[:, None]
    # un-permute to (T, k, d): row order[i] of the flat (T*k) layout
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=x.device))
    out = out_rows.index_select(0, inv).reshape(T, k, d).sum(dim=1)
    return out.reshape(B, S, d), aux


def moe_ffn(cfg: ModelConfig, params, x, *, strategy: str = "gather"):
    """Routed experts by ``strategy`` (dense | ragged | gather | alltoall;
    every name but ``dense`` runs the ragged path) plus the shared experts.
    Returns (out, aux)."""
    if strategy == "dense":
        out, aux = moe_dense(cfg, params, x)
    else:
        out, aux = moe_ragged_local(cfg, params, x)
    if cfg.moe.n_shared > 0:
        out = out + mlp(params["shared"], x, cfg.ffn_act)
    return out, aux
