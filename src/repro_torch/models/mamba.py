"""Mamba-1 selective SSM block, Jamba's mixer (PyTorch port of
``repro.models.mamba``).

Prefill runs the selective scan as a sequential loop over time in f32 with
per-step discretisation: the (B, S, d_inner, d_state) tensor is never
built, the carry is (B, d_inner, d_state). Decode is the same function
over one token, on the cache {conv: (B, d_conv-1, di), ssm: (B, di, N)}.
Every call returns new cache tensors (nothing is updated in place), so a
speculation snapshot of the state never aliases a later step's.

Under a sharding context the block runs on the rank's channels of
d_inner, split over "ffn" as the reference lays the leaves out:
``in_proj`` by parts (the rank's x and z channels, ``sharding.rules.
Fused``), the conv, ``dt_bias``, ``A_log`` and ``D`` per channel,
``x_proj`` row-parallel with a ``psum`` of (dt, B, C), ``dt_proj``
column-parallel and ``out_proj`` row-parallel with a ``psum``; the conv
and ssm states are the rank's channels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..sharding.rules import current_ctx
from .layers import mesh_blocks, row_psum
from .loops import stack_positions, trips
from .params import pd


def dt_rank(d_model: int) -> int:
    return -(-d_model // 16)


def mamba_defs(cfg: ModelConfig, dtype: str, fan_in: int = 0):
    d, mc = cfg.d_model, cfg.mamba
    di, N = mc.d_inner(d), mc.d_state
    r = dt_rank(d)
    return {
        "in_proj": pd(d, 2 * di, axes=(None, "ffn"),
                      dtype=dtype, fan_in=fan_in, parts=2),
        "conv_w": pd(mc.d_conv, di, axes=("conv", "ffn"),
                     dtype=dtype, fan_in=fan_in),
        "conv_b": pd(di, axes=("ffn",), dtype=dtype, init="zeros"),
        "x_proj": pd(di, r + 2 * N, axes=("ffn", None),
                     dtype=dtype, fan_in=fan_in),
        "dt_proj": pd(r, di, axes=(None, "ffn"), dtype=dtype, fan_in=fan_in),
        "dt_bias": pd(di, axes=("ffn",), dtype="float32", init="zeros"),
        "A_log": pd(di, N, axes=("ffn", "state"), dtype="float32",
                    init="zeros"),
        "D": pd(di, axes=("ffn",), dtype="float32", init="ones"),
        "out_proj": pd(di, d, axes=("ffn", None), dtype=dtype, fan_in=fan_in),
    }


def _conv_causal(params, x, conv_state):
    """Depthwise causal conv over time. x (B,S,di); conv_state (B,K-1,di).
    The taps are summed in order k = 0..K-1, as the reference sums them."""
    w = params["conv_w"]
    K, S = w.shape[0], x.shape[1]
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    out = xp[:, 0:S] * w[0]
    for k in range(1, K):
        out = out + xp[:, k:k + S] * w[k]
    new_state = xp[:, -(K - 1):] if K > 1 else conv_state
    return out + params["conv_b"], new_state


def _ssm_step(h, x_t, dt_t, B_t, C_t, A):
    """One selective-scan step. h (B,di,N); x_t/dt_t (B,di); B_t/C_t (B,N)."""
    dA = torch.exp(dt_t[..., None] * A)                     # (B,di,N)
    dBx = (dt_t * x_t)[..., None] * B_t[:, None, :]         # (B,di,N)
    h = dA * h + dBx
    y = torch.einsum("bdn,bn->bd", h, C_t)
    return h, y


def selective_scan(h, x, dt, Bm, Cm, A):
    """The scan over time in f32: ``_ssm_step`` once per position, one
    after the other. h (B,di,N); x/dt (B,S,di); Bm/Cm (B,S,N). Returns the
    final state and the outputs y (B,S,di), f32. The dry run may sample
    the positions of fake or meta tensors (``loops.trips``). Each input
    is unbound into its positions once: under autograd one backward
    stacks their gradients, where a slice per position would write a
    zero gradient of the whole input per position."""
    xs, dts, Bs, Cs = (t.float().unbind(1) for t in (x, dt, Bm, Cm))
    ys = []
    for t in trips(0, x.shape[1], x):
        h, y = _ssm_step(h, xs[t], dts[t], Bs[t], Cs[t], A)
        ys.append(y)
    return h, stack_positions(ys, x.shape[1], dim=1)


def mamba_forward(cfg: ModelConfig, params, x, cache=None):
    """x (B,S,d) -> (out (B,S,d), new_cache). cache None => zeros. Under a
    sharding context the rank's channels (module docstring)."""
    mc = cfg.mamba
    B, S, d = x.shape
    N, r = mc.d_state, dt_rank(d)
    rows = ()
    if current_ctx() is not None:
        params, split = mesh_blocks(params, mamba_defs(cfg, "float32"))
        rows = split("out_proj", 0)[2]
    di = params["conv_b"].shape[0]            # the rank's channels
    xz = x @ params["in_proj"]
    x_in, z = xz[..., :di], xz[..., di:]
    conv_state = (cache["conv"] if cache is not None else
                  x.new_zeros((B, mc.d_conv - 1, di)))
    x_c, conv_state = _conv_causal(params, x_in, conv_state)
    x_c = F.silu(x_c)
    proj = row_psum(x_c @ params["x_proj"], rows)
    dt_low, Bm, Cm = proj[..., :r], proj[..., r:r + N], proj[..., r + N:]
    dt = F.softplus(dt_low @ params["dt_proj"]
                    + params["dt_bias"].to(x.dtype))
    A = -torch.exp(params["A_log"])                          # (di,N) f32

    h = (cache["ssm"] if cache is not None else
         torch.zeros((B, di, N), dtype=torch.float32, device=x.device))
    h, y = selective_scan(h, x_c, dt, Bm, Cm, A)
    y = y.to(x.dtype)                                        # (B,S,di)
    y = y + params["D"].to(x.dtype) * x_c
    y = y * F.silu(z)
    out = row_psum(y @ params["out_proj"], rows)
    return out, {"conv": conv_state, "ssm": h}


def mamba_decode(cfg: ModelConfig, params, x, cache):
    """Single-token decode. x (B,1,d)."""
    return mamba_forward(cfg, params, x, cache)


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device) -> dict:
    """Zero conv and ssm states: under a sharding context the rank's
    channels."""
    mc = cfg.mamba
    di = mc.d_inner(cfg.d_model)
    if current_ctx() is not None:
        di = current_ctx().dim_block((di,), ("ffn",), 0)[1]
    return {
        "conv": torch.zeros((batch, mc.d_conv - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, di, mc.d_state), dtype=torch.float32,
                           device=device),
    }
