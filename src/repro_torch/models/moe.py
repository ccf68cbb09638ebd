"""Mixture-of-Experts: the router and four execution strategies (PyTorch
port of ``repro.models.moe``).

  dense     every expert on every token, combined by the router's weights:
            O(T·E·f) FLOPs, the numerical reference (tests only; at full
            width it reads all experts for every token).
  ragged    the rows (token, choice) sorted by expert id (stable), one
            grouped GEMM per projection over the contiguous expert groups,
            each row scaled by its weight, then un-permuted to (T, k, d)
            and summed over k in a fixed order (no atomics: two runs give
            the same bits).
  gather    expert-parallel over the expert ("model") axis of the current
            mesh: tokens stay data-sharded (whole along the expert axis on
            every rank of it); each rank takes the window of the globally
            sorted rows that belongs to its experts, at most a fixed
            capacity of them (later rows are dropped), runs the grouped
            GEMMs, scatter-adds its partial outputs and sums them over the
            expert axis (``all_reduce``).
  alltoall  the production dispatch: each rank of the expert axis also
            takes one block of the sequence; rows go to their experts'
            rank with a fixed per-peer capacity through an all_to_all, are
            grouped-GEMM'd there and come back through the reverse one.
            Falls back to ``gather`` when the expert axis does not divide
            the sequence.

``gather`` and ``alltoall`` take the rank's share of the batch, whole along
the sequence, and the experts whole or as the rank's block of them
(``sharding.rules.rank_block``); they return the rank's share of the batch
(``alltoall`` reassembles its sequence blocks over the expert axis) and the
aux loss averaged over the expert axis. Without a mesh, or with one rank on
the expert axis, they run the ragged path, as the reference's do. The
shared experts are a ``layers.mlp``, split over "ffn" under a mesh.

The grouped GEMM (``grouped_mm``; the reference's ``jax.lax.ragged_dot``)
is ``torch._grouped_mm`` on the card, bf16 with the groups' end offsets as
a device int32 cumulative sum, and a loop over the experts on the CPU.
Nothing on these paths reads the device: the group offsets come from
``searchsorted`` or a cumulative ``bincount``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, MoEConfig
from ..sharding import collectives as coll
from ..sharding.rules import current_ctx, mesh_axes, rank_block
from .layers import mlp, mlp_defs, value_counts
from .params import pd


def moe_defs(cfg: ModelConfig, dtype: str, fan_in: int = 0):
    m, d = cfg.moe, cfg.d_model
    defs = {
        "router": pd(d, m.n_experts, axes=(None, None), dtype="float32",
                     fan_in=fan_in),
        # fused gate+up: (E, d, 2f); down: (E, f, d)
        "w_gu": pd(m.n_experts, d, 2 * m.d_ff_expert,
                   axes=("experts", None, None), dtype=dtype, fan_in=fan_in),
        "w_down": pd(m.n_experts, m.d_ff_expert, d,
                     axes=("experts", None, None), dtype=dtype,
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


def _offsets(group_sizes):
    """The groups' end offsets, int32, on the sizes' device."""
    return torch.cumsum(group_sizes, 0).to(torch.int32)


def _ep_local(cfg: ModelConfig, params_local, xf, eids, w, e0: int,
              e_loc: int, cap: int):
    """Partial MoE output for experts [e0, e0+e_loc) with capacity ``cap``.

    xf (T,d); eids/w (T,k). Returns (T, d): zeros for tokens not routed
    here. params_local w_gu/w_down are the (e_loc, ...) block. The window
    of ``cap`` rows starts at this block's first row of the stably sorted
    (token, choice) rows; rows past it are dropped."""
    T, d = xf.shape
    k = eids.shape[-1]
    R = T * k
    dev = xf.device
    flat_e = eids.reshape(R)
    se, order = torch.sort(flat_e, stable=True)
    st = order // k                                   # the rows' tokens
    sw = w.reshape(R)[order]
    start = (flat_e < e0).sum()                       # first local row
    idx = start + torch.arange(cap, device=dev)
    in_range = idx < R
    idx = idx.clamp(max=R - 1)
    sel_e, sel_t, sel_w = se[idx], st[idx], sw[idx]
    valid = in_range & (sel_e >= e0) & (sel_e < e0 + e_loc)
    rows = xf[sel_t] * valid[:, None].to(xf.dtype)
    group_sizes = value_counts(torch.where(valid, sel_e - e0, e_loc),
                               e_loc + 1)[:e_loc]
    # the valid rows lead the window, sorted by expert; the grouped GEMM
    # does not define the rows past the last group (on the card), so they
    # are masked by ``where``, not by a product
    out_rows = _expert_mlp_rows(params_local, rows, _offsets(group_sizes),
                                cfg.ffn_act)
    out_rows = torch.where(valid[:, None], out_rows * sel_w[:, None], 0)
    tgt = torch.where(valid, sel_t, T)                # drop invalid at row T
    return xf.new_zeros((T + 1, d)).index_add_(0, tgt, out_rows)[:T]


def _ep_axis(cfg: ModelConfig):
    """(ctx, the expert axis) when expert parallelism applies, else None:
    one mesh axis behind "experts" of more than one rank dividing the
    experts (the reference's conditions)."""
    ctx = current_ctx()
    e_axes = mesh_axes("experts")
    if ctx is None or len(e_axes) != 1 or ctx.axis_prod(e_axes) == 1 \
            or cfg.moe.n_experts % ctx.axis_prod(e_axes) != 0:
        return None
    return ctx, e_axes


def _ep_params(cfg: ModelConfig, params, ctx, axes):
    """The rank's block of the routed experts and the whole router."""
    E = cfg.moe.n_experts
    return {"w_gu": rank_block(params["w_gu"], 0, E, axes, ctx),
            "w_down": rank_block(params["w_down"], 0, E, axes, ctx),
            "router": params["router"]}


def moe_ep_gather(cfg: ModelConfig, params, x, *, token_chunk: int = 4096):
    """Expert-parallel MoE with the tokens whole along the expert axis:
    x (B_loc, S, d) -> (out (B_loc, S, d), aux)."""
    m = cfg.moe
    found = _ep_axis(cfg)
    if found is None:
        return moe_ragged_local(cfg, params, x)
    ctx, axes = found
    e_loc = m.n_experts // ctx.axis_prod(axes)
    pl = _ep_params(cfg, params, ctx, axes)
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    T = xf.shape[0]
    eids, wts, aux = _route(m, pl, xf)
    e0 = coll.axis_index(axes) * e_loc
    chunk = token_chunk if (T % token_chunk == 0 and T > token_chunk) else T
    cap = int(math.ceil(chunk * m.top_k * e_loc / m.n_experts
                        * m.capacity_factor))
    cap = max(16, min(cap, chunk * m.top_k))
    out = torch.cat([_ep_local(cfg, pl, xf[c:c + chunk], eids[c:c + chunk],
                               wts[c:c + chunk], e0, e_loc, cap)
                     for c in range(0, T, chunk)])
    out = coll.psum(out, axes)
    return out.reshape(x.shape), coll.pmean(aux, axes)


def moe_ep_alltoall(cfg: ModelConfig, params, x):
    """Expert-parallel MoE with the sequence sharded over the expert axis
    and rows exchanged through all_to_all: x (B_loc, S, d) -> (out
    (B_loc, S, d), aux). Rank i of the expert axis routes sequence block i
    and reassembles the blocks at the end."""
    m = cfg.moe
    found = _ep_axis(cfg)
    if found is None:
        return moe_ragged_local(cfg, params, x)
    ctx, axes = found
    ep = ctx.axis_prod(axes)
    B, S, d = x.shape
    if S % ep != 0:
        return moe_ep_gather(cfg, params, x)
    e_loc = m.n_experts // ep
    pl = _ep_params(cfg, params, ctx, axes)
    s_loc = S // ep
    xf = x[:, coll.axis_index(axes) * s_loc:][:, :s_loc].reshape(-1, d)
    T, k = xf.shape[0], m.top_k
    dev = xf.device
    eids, wts, aux = _route(m, pl, xf)
    R = T * k
    flat_e = eids.reshape(R)
    flat_w = wts.reshape(R)
    dest = flat_e // e_loc                       # owner rank per row
    s_dst, order = torch.sort(dest, stable=True)  # rows by peer
    s_e, s_t = flat_e[order], order // k
    cap = int(math.ceil(R / ep * m.capacity_factor))
    counts = value_counts(dest, ep)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(R, device=dev) - starts[s_dst]   # rank within bucket
    pos_c = torch.where(pos < cap, pos, cap)     # overflow -> spill slot
    # the spill slot (cap) is the only place two writes meet; it is sliced
    # away, and a slot is valid iff its rid was written (never-written
    # slots keep R)
    send_rows = xf.new_zeros((ep, cap + 1, d))
    send_le = torch.full((ep, cap + 1), e_loc, dtype=torch.int64, device=dev)
    send_rid = torch.full((ep, cap + 1), R, dtype=torch.int64, device=dev)
    send_rows[s_dst, pos_c] = xf[s_t]
    send_le[s_dst, pos_c] = s_e % e_loc
    send_rid[s_dst, pos_c] = order
    recv_rows = coll.all_to_all(send_rows[:, :cap], axes)
    recv_le = coll.all_to_all(send_le[:, :cap], axes)
    # grouped GEMMs on the owner rank
    rl = recv_le.reshape(ep * cap)
    sl, o2 = torch.sort(rl, stable=True)
    gs = value_counts(rl, e_loc + 1)[:e_loc]
    out_rows = _expert_mlp_rows(pl, recv_rows.reshape(ep * cap, d)[o2],
                                _offsets(gs), cfg.ffn_act)
    # empty slots (expert e_loc) sort last, past the last group, which the
    # grouped GEMM does not define
    out_rows = torch.where((sl < e_loc)[:, None], out_rows, 0)
    inv = torch.empty_like(o2).scatter_(0, o2, torch.arange(o2.numel(),
                                                            device=dev))
    back = coll.all_to_all(out_rows[inv].view(ep, cap, d), axes)
    # combine at the source: back[p, c] answers send slot (p, c)
    rid = send_rid[:, :cap].reshape(ep * cap)
    valid = rid < R
    rid_s = rid.clamp(max=R - 1)
    w_r = torch.where(valid, flat_w[rid_s], 0).to(xf.dtype)
    t_r = torch.where(valid, rid_s // k, T)
    contrib = back.reshape(ep * cap, d) * w_r[:, None]
    out = xf.new_zeros((T + 1, d)).index_add_(0, t_r, contrib)[:T]
    out = coll.gather_dim(out.view(B, s_loc, d), axes, dim=1)
    return out, coll.pmean(aux, axes)


def moe_ffn(cfg: ModelConfig, params, x, *, strategy: str = "gather"):
    """Routed experts by ``strategy`` (dense | ragged | gather | alltoall;
    any other name runs ``gather``, as in the reference) plus the shared
    experts. Returns (out, aux)."""
    if strategy == "dense":
        out, aux = moe_dense(cfg, params, x)
    elif strategy == "ragged":
        out, aux = moe_ragged_local(cfg, params, x)
    elif strategy == "alltoall":
        out, aux = moe_ep_alltoall(cfg, params, x)
    else:
        out, aux = moe_ep_gather(cfg, params, x)
    if cfg.moe.n_shared > 0:
        out = out + mlp(params["shared"], x, cfg.ffn_act,
                        cfg.moe.n_shared * cfg.moe.d_ff_expert)
    return out, aux
