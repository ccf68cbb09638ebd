"""Mamba-1 selective SSM block, Jamba's mixer (PyTorch port of
``repro.models.mamba``).

Prefill runs the selective scan as a sequential loop over time in f32 with
per-step discretisation: the (B, S, d_inner, d_state) tensor is never
built, the carry is (B, d_inner, d_state). Decode is the same function
over one token, on the cache {conv: (B, d_conv-1, di), ssm: (B, di, N)}.
Every call returns new cache tensors (nothing is updated in place), so a
speculation snapshot of the state never aliases a later step's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
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
                      dtype=dtype, fan_in=fan_in),
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
    the positions of fake or meta tensors (``loops.trips``)."""
    xs, dts, Bs, Cs = (t.float() for t in (x, dt, Bm, Cm))
    ys = []
    for t in trips(0, x.shape[1], xs):
        h, y = _ssm_step(h, xs[:, t], dts[:, t], Bs[:, t], Cs[:, t], A)
        ys.append(y)
    return h, stack_positions(ys, x.shape[1], dim=1)


def mamba_forward(cfg: ModelConfig, params, x, cache=None):
    """x (B,S,d) -> (out (B,S,d), new_cache). cache None => zeros."""
    mc = cfg.mamba
    B, S, d = x.shape
    di, N = mc.d_inner(d), mc.d_state
    r = dt_rank(d)
    xz = x @ params["in_proj"]
    x_in, z = xz[..., :di], xz[..., di:]
    conv_state = (cache["conv"] if cache is not None else
                  x.new_zeros((B, mc.d_conv - 1, di)))
    x_c, conv_state = _conv_causal(params, x_in, conv_state)
    x_c = F.silu(x_c)
    proj = x_c @ params["x_proj"]
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
    out = y @ params["out_proj"]
    return out, {"conv": conv_state, "ssm": h}


def mamba_decode(cfg: ModelConfig, params, x, cache):
    """Single-token decode. x (B,1,d)."""
    return mamba_forward(cfg, params, x, cache)


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device) -> dict:
    mc = cfg.mamba
    di = mc.d_inner(cfg.d_model)
    return {
        "conv": torch.zeros((batch, mc.d_conv - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, di, mc.d_state), dtype=torch.float32,
                           device=device),
    }
