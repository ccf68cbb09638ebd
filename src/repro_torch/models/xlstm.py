"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory) (PyTorch
port of ``repro.models.xlstm``).

Both use the stabilised exponential-gating recurrence of the xLSTM paper
(a log-domain max-stabiliser m), run as a sequential loop over time; the
same step drives one-token decode. The depthwise causal conv is Mamba's
(``mamba._conv_causal``: the same ``conv_w``/``conv_b`` leaves, the taps
summed in the same order). Every call returns new cache tensors
(nothing is updated in place), so a speculation snapshot of the state
never aliases a later step's.

Under a sharding context both blocks run on the rank's features, laid
out as the reference lays them out:

  mLSTM  ``up`` by parts (the rank's channels of x and z), the conv per
         channel, ``wq``/``wk``/``wv``/``w_i``/``w_f`` row-parallel into a
         ``psum`` (q, k, v and the gates whole), the recurrence on the
         heads of the rank's state block (split over "heads"), the
         per-feature norm over the whole width (a ``psum`` of the
         squares), ``down`` row-parallel on the rank's channels of the
         cell output;
  sLSTM  the conv whole (its state gathered over "ffn" and the rank's
         block kept), ``w`` column-parallel (its columns are head-major:
         each head's i, f, z, o), the recurrence on the heads of the rank's
         state block (``r`` whole, sliced), the norm as mLSTM's, the
         output gathered whole for ``ff_up`` (column-parallel, by parts)
         and ``ff_down`` (row-parallel, a ``psum``).

A projection whose block does not fall on a head's boundary is gathered
first (``layers.tp_cols``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..sharding import collectives as coll
from ..sharding.rules import current_ctx
from .layers import mesh_blocks, row_psum, tp_cols
from .loops import stack_positions, trips
from .mamba import _conv_causal
from .params import pd


def _group_norm(h, scale, width: int | None = None, axes: tuple = ()):
    """The reference's per-feature norm: f32 rsqrt of the mean square
    (eps 1e-6) times ``scale``, back in ``h.dtype``. ``axes``: ``h`` is
    the rank's block of the ``width`` features, ``scale`` that block's;
    the squares are summed over the axes."""
    hf = h.float()
    if axes:
        ms = coll.psum(hf.square().sum(-1, keepdim=True), axes) / width
    else:
        ms = hf.square().mean(-1, keepdim=True)
    hf = hf * torch.rsqrt(ms + 1e-6)
    return (hf * scale).to(h.dtype)


def _state_heads(H: int) -> tuple:
    """(s0, s1, axes): the heads of a rank's recurrent state block (the
    reference's state layout, split over "heads" where it divides
    them)."""
    ctx = current_ctx()
    if ctx is None:
        return 0, H, ()
    start, size, axes = ctx.dim_block((H,), ("heads",), 0)
    return start, start + size, axes


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_defs(cfg: ModelConfig, dtype: str, fan_in: int = 0):
    d = cfg.d_model
    di = int(cfg.xlstm.proj_factor_mlstm * d)
    K = cfg.xlstm.conv1d_kernel
    H = cfg.n_heads
    return {
        "up": pd(d, 2 * di, axes=(None, "ffn"), dtype=dtype, fan_in=fan_in,
                 parts=2),
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
    """x (B,S,d) -> (out, new_cache); cache None => zeros. Under a sharding
    context the rank's features (module docstring)."""
    B, S, d = x.shape
    H = cfg.n_heads
    di = int(cfg.xlstm.proj_factor_mlstm * d)
    dh = di // H
    K = cfg.xlstm.conv1d_kernel
    rows = (0, di, ())
    if current_ctx() is not None:
        params, split = mesh_blocks(params, mlstm_defs(cfg, "float32"))
        rows = split("down", 0)
    s0, s1, s_axes = _state_heads(H)
    dl = params["conv_b"].shape[0]            # the rank's channels
    xz = x @ params["up"]
    xm, z = xz[..., :dl], xz[..., dl:]
    conv_state = (cache["conv"] if cache is not None else
                  x.new_zeros((B, K - 1, dl)))
    xc, conv_state = _conv_causal(params, xm, conv_state)
    xc = F.silu(xc)
    ax = rows[2]
    heads = slice(s0, s1)
    q, k = (row_psum(xc @ params[w], ax).reshape(B, S, H, dh)[:, :, heads]
            .float() for w in ("wq", "wk"))
    v = row_psum(xm @ params["wv"], ax).reshape(B, S, H, dh)[:, :, heads] \
        .float()
    i_raw = (row_psum(xc.float() @ params["w_i"], ax) + params["b_i"])[
        ..., heads]
    f_raw = (row_psum(xc.float() @ params["w_f"], ax) + params["b_f"])[
        ..., heads]

    hl = s1 - s0
    if cache is not None:
        st = (cache["C"], cache["n"], cache["m"])
    else:
        f32 = dict(dtype=torch.float32, device=x.device)
        st = (torch.zeros((B, hl, dh, dh), **f32),
              torch.zeros((B, hl, dh), **f32), torch.zeros((B, hl), **f32))
    # each input unbound into its positions once (one backward stacks
    # their gradients; a slice per position would write a whole-input
    # zero gradient per position)
    qs, ks, vs, i_s, f_s = (t.unbind(1) for t in (q, k, v, i_raw, f_raw))
    hs = []
    for t in trips(0, S, q):
        st, h = _mlstm_step(st, qs[t], ks[t], vs[t], i_s[t], f_s[t], dh)
        hs.append(h)
    h = stack_positions(hs, S, dim=1).reshape(B, S, hl * dh).to(x.dtype)
    # per-feature norm (out_norm) over the whole width, then the z gate on
    # the rank's channels
    a = s0 * dh
    h = _group_norm(h, params["out_norm"]["scale"][a:s1 * dh], di, s_axes)
    h = h.narrow(-1, rows[0] - a, rows[1])
    out = row_psum((h * F.silu(z)) @ params["down"], ax)
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
        "ff_up": pd(d, 2 * f, axes=(None, "ffn"), dtype=dtype, fan_in=fan_in,
                    parts=2),
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
    """x (B,S,d) -> (out, new_cache); cache None => zeros. Under a sharding
    context the rank's heads and features (module docstring)."""
    B, S, d = x.shape
    H = cfg.n_heads
    dh = d // H
    K = cfg.xlstm.conv1d_kernel
    ff_rows, conv = (), (0, d, ())
    cols = (0, 4 * d, ())
    if current_ctx() is not None:
        params, split = mesh_blocks(params, slstm_defs(cfg, "float32"))
        ff_rows, cols = split("ff_down", 0)[2], split("w", 1)
        conv = current_ctx().dim_block((d,), ("ffn",), 0)
    s0, s1, s_axes = _state_heads(H)
    if cache is not None:
        conv_state = tp_cols(cache["conv"], conv, 0, d)
    else:
        conv_state = x.new_zeros((B, K - 1, d))
    xc, conv_state = _conv_causal(params, x, conv_state)
    conv_state = conv_state.narrow(-1, conv[0], conv[1])
    xc = F.silu(xc)
    # the gate pre-activations of the state block's heads, head-major
    xg = tp_cols(xc @ params["w"], cols, s0 * 4 * dh, s1 * 4 * dh)
    hl = s1 - s0
    mine = {"r": params["r"][s0:s1],
            "b": params["b"][s0 * 4 * dh:s1 * 4 * dh]}

    if cache is not None:
        st = (cache["c"], cache["n"], cache["h"], cache["m"])
    else:
        zero = torch.zeros((B, hl, dh), dtype=torch.float32, device=x.device)
        st = (zero, zero, zero,
              torch.zeros((B, hl), dtype=torch.float32, device=x.device))
    xgs = xg.unbind(1)              # once: see mlstm_forward
    hs = []
    for t in trips(0, S, xg):
        st, h = _slstm_step(mine, st, xgs[t], hl, dh)
        hs.append(h)
    h = stack_positions(hs, S, dim=1).reshape(B, S, hl * dh).to(x.dtype)
    h = _group_norm(h, params["norm"]["scale"][s0 * dh:s1 * dh], d, s_axes)
    if s_axes:
        h = coll.gather_dim(h, s_axes, 2)
    # post up/down GeGLU feed-forward (proj_factor 4/3)
    f = params["ff_down"].shape[0]
    gu = h @ params["ff_up"]
    g, u = gu[..., :f], gu[..., f:]
    out = row_psum((F.gelu(g, approximate="tanh") * u) @ params["ff_down"],
                   ff_rows)
    return out, {"conv": conv_state, "c": st[0], "n": st[1], "h": st[2],
                 "m": st[3]}


def init_xlstm_cache(cfg: ModelConfig, kind: str, batch: int,
                     dtype: torch.dtype, device) -> dict:
    """Zero states: under a sharding context the rank's block of the conv
    channels (over "ffn") and of the heads (over "heads")."""
    H, d, K = cfg.n_heads, cfg.d_model, cfg.xlstm.conv1d_kernel
    f32 = dict(dtype=torch.float32, device=device)
    s0, s1, _ = _state_heads(H)
    hl = s1 - s0
    width = int(cfg.xlstm.proj_factor_mlstm * d) if kind == "mlstm" else d
    dh = width // H
    ctx = current_ctx()
    if ctx is not None:
        width = ctx.dim_block((width,), ("ffn",), 0)[1]
    conv = torch.zeros((batch, K - 1, width), dtype=dtype, device=device)
    if kind == "mlstm":
        return {"conv": conv,
                "C": torch.zeros((batch, hl, dh, dh), **f32),
                "n": torch.zeros((batch, hl, dh), **f32),
                "m": torch.zeros((batch, hl), **f32)}
    return {"conv": conv,
            "c": torch.zeros((batch, hl, dh), **f32),
            "n": torch.zeros((batch, hl, dh), **f32),
            "h": torch.zeros((batch, hl, dh), **f32),
            "m": torch.zeros((batch, hl), **f32)}
