"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory) (PyTorch
port of ``repro.models.xlstm``).

Both use the stabilised exponential-gating recurrence of the xLSTM paper
(a log-domain max-stabiliser m), run as a sequential loop over time; the
same step drives one-token decode. The depthwise causal conv is Mamba's
(``mamba._conv_causal``: the same ``conv_w``/``conv_b`` leaves, the taps
summed in the same order). Every call returns new cache tensors
(nothing is updated in place), so a speculation snapshot of the state
never aliases a later step's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .loops import stack_positions, trips
from .mamba import _conv_causal
from .params import pd


def _group_norm(h, scale):
    """The reference's per-feature norm: f32 rsqrt of the mean square
    (eps 1e-6) times ``scale``, back in ``h.dtype``."""
    hf = h.float()
    hf = hf * torch.rsqrt(hf.square().mean(-1, keepdim=True) + 1e-6)
    return (hf * scale).to(h.dtype)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_defs(cfg: ModelConfig, dtype: str, fan_in: int = 0):
    d = cfg.d_model
    di = int(cfg.xlstm.proj_factor_mlstm * d)
    K = cfg.xlstm.conv1d_kernel
    H = cfg.n_heads
    return {
        "up": pd(d, 2 * di, axes=(None, "ffn"), dtype=dtype, fan_in=fan_in),
        "conv_w": pd(K, di, axes=("conv", "ffn"), dtype=dtype, fan_in=fan_in),
        "conv_b": pd(di, axes=("ffn",), dtype=dtype, init="zeros"),
        "wq": pd(di, di, axes=("ffn", None), dtype=dtype, fan_in=fan_in),
        "wk": pd(di, di, axes=("ffn", None), dtype=dtype, fan_in=fan_in),
        "wv": pd(di, di, axes=("ffn", None), dtype=dtype, fan_in=fan_in),
        "w_i": pd(di, H, axes=("ffn", None), dtype="float32", fan_in=fan_in),
        "w_f": pd(di, H, axes=("ffn", None), dtype="float32", fan_in=fan_in),
        "b_i": pd(H, dtype="float32", init="zeros"),
        "b_f": pd(H, dtype="float32", init="ones"),
        "out_norm": {"scale": pd(di, init="ones")},
        "down": pd(di, d, axes=("ffn", None), dtype=dtype, fan_in=fan_in),
    }


def _mlstm_step(carry, q, k, v, i_raw, f_raw, dh):
    """Stabilised mLSTM recurrence. carry = (C (B,H,dh,dh), n (B,H,dh),
    m (B,H)); q/k/v (B,H,dh); i_raw/f_raw (B,H)."""
    C, n, m = carry
    f_log = F.logsigmoid(f_raw)
    m_new = torch.maximum(f_log + m, i_raw)
    i_p = torch.exp(i_raw - m_new)
    f_p = torch.exp(f_log + m - m_new)
    k_s = k / math.sqrt(dh)
    C = f_p[..., None, None] * C + i_p[..., None, None] * (
        v[..., :, None] * k_s[..., None, :])
    n = f_p[..., None] * n + i_p[..., None] * k_s
    denom = torch.maximum(torch.einsum("bhd,bhd->bh", n, q).abs(),
                          torch.exp(-m_new))
    h = torch.einsum("bhij,bhj->bhi", C, q) / denom[..., None]
    return (C, n, m_new), h


def mlstm_forward(cfg: ModelConfig, params, x, cache=None):
    B, S, d = x.shape
    H = cfg.n_heads
    di = int(cfg.xlstm.proj_factor_mlstm * d)
    dh = di // H
    K = cfg.xlstm.conv1d_kernel
    xz = x @ params["up"]
    xm, z = xz[..., :di], xz[..., di:]
    conv_state = (cache["conv"] if cache is not None else
                  x.new_zeros((B, K - 1, di)))
    xc, conv_state = _conv_causal(params, xm, conv_state)
    xc = F.silu(xc)
    q = (xc @ params["wq"]).reshape(B, S, H, dh).float()
    k = (xc @ params["wk"]).reshape(B, S, H, dh).float()
    v = (xm @ params["wv"]).reshape(B, S, H, dh).float()
    i_raw = xc.float() @ params["w_i"] + params["b_i"]
    f_raw = xc.float() @ params["w_f"] + params["b_f"]

    if cache is not None:
        st = (cache["C"], cache["n"], cache["m"])
    else:
        f32 = dict(dtype=torch.float32, device=x.device)
        st = (torch.zeros((B, H, dh, dh), **f32),
              torch.zeros((B, H, dh), **f32), torch.zeros((B, H), **f32))
    hs = []
    for t in trips(0, S, q):
        st, h = _mlstm_step(st, q[:, t], k[:, t], v[:, t], i_raw[:, t],
                            f_raw[:, t], dh)
        hs.append(h)
    h = stack_positions(hs, S, dim=1).reshape(B, S, di).to(x.dtype)
    # per-feature norm (out_norm), then the z gate
    h = _group_norm(h, params["out_norm"]["scale"])
    out = (h * F.silu(z)) @ params["down"]
    return out, {"conv": conv_state, "C": st[0], "n": st[1], "m": st[2]}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_defs(cfg: ModelConfig, dtype: str, fan_in: int = 0):
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    f = int(cfg.xlstm.proj_factor_slstm * d)
    return {
        "conv_w": pd(cfg.xlstm.conv1d_kernel, d, axes=("conv", None),
                     dtype=dtype, fan_in=fan_in),
        "conv_b": pd(d, dtype=dtype, init="zeros"),
        "w": pd(d, 4 * d, axes=(None, "ffn"),
                dtype=dtype, fan_in=fan_in),  # i,f,z,o
        "r": pd(H, dh, 4 * dh, axes=(None, None, None),
                dtype=dtype, fan_in=fan_in),
        "b": pd(4 * d, dtype="float32", init="zeros"),
        "norm": {"scale": pd(d, init="ones")},
        "ff_up": pd(d, 2 * f, axes=(None, "ffn"), dtype=dtype, fan_in=fan_in),
        "ff_down": pd(f, d, axes=("ffn", None), dtype=dtype, fan_in=fan_in),
    }


def _slstm_step(params, carry, x_t, H, dh):
    """carry = (c, n, h, m): c/n/h (B,H,dh), m (B,H). x_t (B,4d), the
    input projection. ``h`` is cast to ``x_t``'s dtype before the
    recurrent product; the gates are f32, and the scalar input and forget
    gates are the mean over each head's slice."""
    c, n, h, m = carry
    B = x_t.shape[0]
    rec = torch.einsum("bhd,hdk->bhk", h.to(x_t.dtype), params["r"])
    gates = x_t.reshape(B, H, 4 * dh) + rec + \
        params["b"].reshape(H, 4 * dh).to(x_t.dtype)
    i_raw, f_raw, z_raw, o_raw = gates.float().split(dh, dim=-1)
    i_raw, f_raw = i_raw.mean(-1), f_raw.mean(-1)
    f_log = F.logsigmoid(f_raw)
    m_new = torch.maximum(f_log + m, i_raw)
    i_p = torch.exp(i_raw - m_new)[..., None]
    f_p = torch.exp(f_log + m - m_new)[..., None]
    z = torch.tanh(z_raw)
    o = torch.sigmoid(o_raw)
    c = f_p * c + i_p * z
    n = f_p * n + i_p
    h_new = o * (c / torch.clamp(n, min=1.0))
    return (c, n, h_new, m_new), h_new


def slstm_forward(cfg: ModelConfig, params, x, cache=None):
    B, S, d = x.shape
    H = cfg.n_heads
    dh = d // H
    K = cfg.xlstm.conv1d_kernel
    conv_state = (cache["conv"] if cache is not None else
                  x.new_zeros((B, K - 1, d)))
    xc, conv_state = _conv_causal(params, x, conv_state)
    xc = F.silu(xc)
    xg = xc @ params["w"]                              # (B,S,4d)

    if cache is not None:
        st = (cache["c"], cache["n"], cache["h"], cache["m"])
    else:
        zero = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
        st = (zero, zero, zero,
              torch.zeros((B, H), dtype=torch.float32, device=x.device))
    hs = []
    for t in trips(0, S, xg):
        st, h = _slstm_step(params, st, xg[:, t], H, dh)
        hs.append(h)
    h = stack_positions(hs, S, dim=1).reshape(B, S, d).to(x.dtype)
    h = _group_norm(h, params["norm"]["scale"])
    # post up/down GeGLU feed-forward (proj_factor 4/3)
    f = params["ff_down"].shape[0]
    gu = h @ params["ff_up"]
    g, u = gu[..., :f], gu[..., f:]
    out = (F.gelu(g, approximate="tanh") * u) @ params["ff_down"]
    return out, {"conv": conv_state, "c": st[0], "n": st[1], "h": st[2],
                 "m": st[3]}


def init_xlstm_cache(cfg: ModelConfig, kind: str, batch: int,
                     dtype: torch.dtype, device) -> dict:
    H, d, K = cfg.n_heads, cfg.d_model, cfg.xlstm.conv1d_kernel
    f32 = dict(dtype=torch.float32, device=device)
    if kind == "mlstm":
        di = int(cfg.xlstm.proj_factor_mlstm * d)
        dh = di // H
        return {
            "conv": torch.zeros((batch, K - 1, di), dtype=dtype,
                                device=device),
            "C": torch.zeros((batch, H, dh, dh), **f32),
            "n": torch.zeros((batch, H, dh), **f32),
            "m": torch.zeros((batch, H), **f32),
        }
    dh = d // H
    return {"conv": torch.zeros((batch, K - 1, d), dtype=dtype, device=device),
            "c": torch.zeros((batch, H, dh), **f32),
            "n": torch.zeros((batch, H, dh), **f32),
            "h": torch.zeros((batch, H, dh), **f32),
            "m": torch.zeros((batch, H), **f32)}
