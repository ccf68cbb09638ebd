"""The plain reference forward: dense GQA with Engram (engram-27b's family)
and MLA with MoE and Engram as the port's mirror of the JAX reference
computes it (routed experts without an up projection, ROADMAP.md F10; a
renormalised softmax top-k router; plain RoPE), which is not the published
DeepSeek-V2: a configuration that states another model brings its own
reference in its family (``harness/family.py``). In float32, one layer at a
time over a handful of whole sequences, with no cache and no batching.
This is the harness's own reference, a family's default.

It reads a configuration's JSON object (``portbench/configs/``) and the
weights the benchmark drew, in the parameter tree the port is handed:
``embed/w`` (V, d); per layer ``ln1/scale``, ``mixer`` (GQA ``wq wk wv wo``
or MLA ``wdq q_ln wuq wdkv kv_ln wuk wuv wo``, every matrix stored (in,
out)), ``ln2/scale``, ``ffn`` (SwiGLU ``gate up down``, or MoE ``router``
(d, E) f32, ``w_gu`` (E, d, 2f) whose first f columns are the gate,
``w_down`` (E, f, d) and a SwiGLU ``shared``); ``final_norm/scale``;
``head/w`` (d, V); per Engram layer ``tables`` (T, rows, row), ``norm``,
``gate`` (d, d) and ``proj`` (T * row, d). The layers sit in
``segments``, one list per stretch between Engram layers.

The model, as the configuration states it:

- Before each Engram layer l (``engram.layers``) the hidden state h takes
  h + sigmoid(h Wg) * (RMSNorm(rows) Wp), rows the concatenated table rows
  of the token's n-grams (``common.engram_indices``).
- Each layer: h += Attn(RMSNorm(h)); h += FFN(RMSNorm(h)). RoPE on q and k
  (MLA: on the rope part of q and the shared rope key).
- MLA: q = RMSNorm(x Wdq) Wuq split into nope and rope parts; c = RMSNorm
  of the first kv_lora_rank columns of x Wdkv, the rest the rope key;
  k_nope = c Wuk, v = c Wuv; scores over [nope | rope] at 1/sqrt(nope +
  rope).
- MoE: softmax router over all experts, the top k renormalised to sum to
  one and scaled by ``routed_scaling_factor``; a routed expert computes
  silu(x W_gate) W_down (the port's expert, which has no up projection:
  ROADMAP.md, F10), the shared experts a SwiGLU of n_shared x f.
- Output: RMSNorm, then the head, in f32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .common import (Linear, causal_attention, engram_indices, engram_rows,
                     f32_matmuls, rmsnorm, rope)


def engram_layers(c: dict) -> list:
    L = c["num_hidden_layers"]
    return sorted(x for x in c["engram"]["layers"] if 0 < x < L)


def layer_params(params) -> list:
    """The blocks in layer order (the segments' lists joined)."""
    return [b for seg in params["segments"] for b in seg]


class Reference:
    """``logits(seqs, want)``: for each token list, the f32 logits that
    predict the token after each position in ``want``."""

    def __init__(self, c: dict, params, device, linear: Linear = None):
        self.c = c
        self.p = params
        self.device = torch.device(device)
        self.lin = linear or Linear()
        self.eps = c["rms_norm_eps"]

    # ------------------------------------------------------------ blocks

    def _gqa(self, p, x):
        c, lin = self.c, self.lin
        S, H, Hkv = x.shape[0], c["num_attention_heads"], \
            c["num_key_value_heads"]
        D = c.get("head_dim") or c["hidden_size"] // H
        q = rope(lin(x, p["wq"]).view(S, H, D), c["rope_theta"])
        k = rope(lin(x, p["wk"]).view(S, Hkv, D), c["rope_theta"])
        v = lin(x, p["wv"]).view(S, Hkv, D)
        return lin(causal_attention(q, k, v).reshape(S, H * D), p["wo"])

    def _mla(self, p, x):
        c, lin = self.c, self.lin
        S, H = x.shape[0], c["num_attention_heads"]
        nope, r = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
        R, vd = c["kv_lora_rank"], c["v_head_dim"]
        cq = rmsnorm(lin(x, p["wdq"]), p["q_ln"]["scale"], self.eps)
        q = lin(cq, p["wuq"]).view(S, H, nope + r)
        q = torch.cat([q[..., :nope], rope(q[..., nope:], c["rope_theta"])],
                      dim=-1)
        ckv = lin(x, p["wdkv"])
        lat = rmsnorm(ckv[:, :R], p["kv_ln"]["scale"], self.eps)
        kr = rope(ckv[:, R:].reshape(S, 1, r), c["rope_theta"])
        kn = lin(lat, p["wuk"]).view(S, H, nope)
        v = lin(lat, p["wuv"]).view(S, H, vd)
        k = torch.cat([kn, kr.expand(S, H, r)], dim=-1)
        return lin(causal_attention(q, k, v).reshape(S, H * vd), p["wo"])

    def _swiglu(self, p, x):
        lin = self.lin
        return lin(F.silu(lin(x, p["gate"])) * lin(x, p["up"]), p["down"])

    def _moe(self, p, x):
        c, lin = self.c, self.lin
        k, f = c["num_experts_per_tok"], c["moe_intermediate_size"]
        probs = torch.softmax(lin(x, p["router"]), dim=-1)
        top_p, eids = probs.topk(k, dim=-1)
        w = top_p / top_p.sum(-1, keepdim=True) * c["routed_scaling_factor"]
        out = torch.zeros_like(x)
        flat = eids.reshape(-1)
        order = torch.argsort(flat, stable=True)
        experts, counts = torch.unique_consecutive(flat[order],
                                                   return_counts=True)
        start = 0
        for e, n in zip(experts.tolist(), counts.tolist()):
            sel = order[start:start + n]
            start += n
            tok = sel // k
            y = lin(F.silu(lin(x[tok], p["w_gu"][e][:, :f])),
                    p["w_down"][e])
            out.index_add_(0, tok, y * w.reshape(-1)[sel][:, None])
        return out + self._swiglu(p["shared"], x)

    def _fuse(self, ep, h, rows):
        rows = rmsnorm(rows, ep["norm"]["scale"], self.eps)
        gate = torch.sigmoid(self.lin(h, ep["gate"]))
        return h + gate * self.lin(rows, ep["proj"])

    # ------------------------------------------------------------ forward

    @torch.no_grad()
    def logits(self, seqs: list, want: list) -> list:
        c, dev = self.c, self.device
        moe = bool(c.get("n_routed_experts"))
        first_moe = c.get("first_k_dense_replace", 0)
        eng = engram_layers(c)
        with f32_matmuls():
            hs = [self.p["embed"]["w"][torch.as_tensor(s, device=dev)]
                  .float() for s in seqs]
            idx = [engram_indices(c["engram"], s) for s in seqs]
            lens = [h.shape[0] for h in hs]
            for i, blk in enumerate(layer_params(self.p)):
                if i in eng:
                    ep = self.p["engram"]["layers"][eng.index(i)]
                    hs = [self._fuse(ep, h, engram_rows(ep["tables"], ix,
                                                        dev))
                          for h, ix in zip(hs, idx)]
                mix = self._mla if c.get("kv_lora_rank") else self._gqa
                hs = [h + mix(blk["mixer"], rmsnorm(h, blk["ln1"]["scale"],
                                                    self.eps)) for h in hs]
                x = torch.cat(hs)
                ffn = self._moe if moe and i >= first_moe else self._swiglu
                x = x + ffn(blk["ffn"], rmsnorm(x, blk["ln2"]["scale"],
                                                self.eps))
                hs = list(torch.split(x, lens))
            last = torch.cat([h[torch.as_tensor(np.asarray(w), device=dev)]
                              for h, w in zip(hs, want)])
            last = rmsnorm(last, self.p["final_norm"]["scale"], self.eps)
            out = self.lin(last, self.p["head"]["w"])
        return list(torch.split(out, [len(w) for w in want]))
