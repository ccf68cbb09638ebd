"""The system under test built from a configuration's JSON object: the
port's ``ModelConfig``, the weights drawn from the seed, the Engram tables
placed where the configuration says, and the serving engine.

The weights are the benchmark's inputs, not the program's: the harness
draws them itself, on the device, from one ``torch.Generator`` seeded with
``--seed``, into one flat buffer per dtype (a few large ``normal_``
calls), and hands the same tensors to the engine and, after the window,
to the reference. Only the tree's shape comes from the port
(``model_defs``). Every matrix is drawn at unit gain, N(0, 1/fan_in) with
fan_in its contraction dim (an expert stack (E, in, out): ``in``); the
embedding and the Engram tables N(0, 1); norm scales 1. (The port's own
initialiser draws a layer stack's leaves at 1/sqrt(stack depth), a gain at
which one bf16 rounding moves the logits by about their size.)

Tables with ``placement: "host"`` go into pinned, device-mapped host
memory through the port's ``host_empty`` (the ``pooled_host`` strategy's
placement, K1 reading them over the host link), drawn on the card a chunk
at a time and copied down.
"""
from __future__ import annotations

import time

import torch

_ALIGN = 256                 # elements: every leaf starts 512 B aligned
_CHUNK = 1 << 28             # elements drawn per normal_ call


def model_config(c: dict):
    """The port's ``ModelConfig`` for configuration ``c``. Refuses settings
    the port cannot run as stated (it would serve another model)."""
    from repro_torch.configs.base import (EngramConfig, MLAConfig,
                                          ModelConfig, MoEConfig)
    if c.get("hidden_act", "silu") != "silu":
        raise ValueError(f"hidden_act {c['hidden_act']!r}: the port's "
                         "FFNs are SiLU-gated")
    if c.get("rope_scaling") is not None:
        raise ValueError("rope_scaling: the port applies plain RoPE")
    L = c["num_hidden_layers"]
    e = c["engram"]
    kw = dict(name=c["name"], family="dense", n_layers=L,
              d_model=c["hidden_size"], vocab_size=c["vocab_size"],
              n_heads=c["num_attention_heads"],
              n_kv_heads=c["num_key_value_heads"],
              head_dim=c.get("head_dim") or c["hidden_size"]
              // c["num_attention_heads"],
              d_ff=c["intermediate_size"], rope_theta=float(c["rope_theta"]),
              norm_eps=float(c["rms_norm_eps"]), dtype=c["dtype"],
              engram=EngramConfig(
                  layers=tuple(e["layers"]), table_vocab=e["table_vocab"],
                  emb_dim=e["emb_dim"], n_heads=e["n_heads"],
                  orders=tuple(e["orders"]), strategy=e["strategy"],
                  seed=e["hash_seed"], pad_token=e["pad_token"]))
    if c.get("kv_lora_rank"):
        kw.update(attn_impl="mla", head_dim=c["v_head_dim"],
                  mla=MLAConfig(q_lora_rank=c["q_lora_rank"],
                                kv_lora_rank=c["kv_lora_rank"],
                                qk_nope_head_dim=c["qk_nope_head_dim"],
                                qk_rope_head_dim=c["qk_rope_head_dim"],
                                v_head_dim=c["v_head_dim"]))
    if c.get("n_routed_experts"):
        if not c["norm_topk_prob"] or c["scoring_func"] != "softmax" or \
                c["topk_method"] != "greedy":
            raise ValueError("the port routes by softmax, a plain top-k and "
                             "renormalised weights (norm_topk_prob true, "
                             "scoring_func softmax, topk_method greedy)")
        k = c.get("first_k_dense_replace", 0)
        kw.update(family="moe",
                  moe=MoEConfig(n_experts=c["n_routed_experts"],
                                top_k=c["num_experts_per_tok"],
                                n_shared=c["n_shared_experts"],
                                d_ff_expert=c["moe_intermediate_size"],
                                router_scale=float(
                                    c["routed_scaling_factor"])),
                  ffn_types=tuple("dense" if i < k else "moe"
                                  for i in range(L)))
    return ModelConfig(**kw)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], f"{path}/{k}" if path else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _set(tree, path: str, value) -> None:
    keys = path.split("/")
    for k in keys[:-1]:
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    last = keys[-1]
    if isinstance(tree, list):
        tree[int(last)] = value
    else:
        tree[last] = value


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_skeleton(v) for v in tree]
    return None


def _std(path: str, shape) -> float:
    if path == "embed/w" or path.endswith("/tables"):
        return 1.0
    return float(shape[-2]) ** -0.5 if len(shape) >= 2 else 1.0


class Weights:
    """The parameter tree of ``cfg`` on ``device``: storage made once
    (``host_tables_s`` times the host tables' mapping and registration),
    values drawn by ``draw(seed)``, again in place for another seed."""

    def __init__(self, cfg, device, host_tables: bool):
        from repro_torch.models.model import model_defs
        from repro_torch.models.params import DTYPES
        self.device = torch.device(device)
        defs = model_defs(cfg)
        self.tree = _skeleton(defs)
        self.flat = {}            # dtype -> buffer
        self.views = []           # (path, tensor, init, std)
        self.tables = []          # (tensor, std)
        sizes = {}
        plan = []
        for path, d in _leaves(defs):
            dt = DTYPES[d.dtype]
            if path.endswith("/tables"):
                plan.append((path, d, dt, None))
                continue
            off = sizes.get(dt, 0)
            n = 1
            for s in d.shape:
                n *= s
            plan.append((path, d, dt, off))
            sizes[dt] = off + -(-n // _ALIGN) * _ALIGN
        for dt, n in sizes.items():
            self.flat[dt] = torch.empty(n, dtype=dt, device=self.device)
        t0 = time.perf_counter()
        for path, d, dt, off in plan:
            if off is None:
                if host_tables and self.device.type == "cuda":
                    from repro_torch.kernels.engram_gather.host import \
                        host_empty
                    t = host_empty(d.shape, dt)
                else:
                    t = torch.empty(d.shape, dtype=dt, device=self.device)
                self.tables.append(t)
                _set(self.tree, path, t)
                continue
            n = 1
            for s in d.shape:
                n *= s
            t = self.flat[dt][off:off + n].view(d.shape)
            self.views.append((path, t, d.init, _std(path, d.shape)))
            _set(self.tree, path, t)
        self.host_tables_s = time.perf_counter() - t0 \
            if host_tables and self.device.type == "cuda" else None

    def draw(self, seed: int) -> float:
        """Draw every value from ``seed``; returns the seconds the tables
        took (their draw and, for host tables, the copy down)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed) % (1 << 63))
        for buf in self.flat.values():
            for i in range(0, buf.numel(), _CHUNK):
                buf[i:i + _CHUNK].normal_(0.0, 1.0, generator=gen)
        for _, t, init, std in self.views:
            if init == "ones":
                t.fill_(1.0)
            elif init == "zeros":
                t.zero_()
            elif std != 1.0:
                t.mul_(std)
        t0 = time.perf_counter()
        for t in self.tables:
            flat = t.view(-1)
            if t.device == self.device:
                for i in range(0, flat.numel(), _CHUNK):
                    flat[i:i + _CHUNK].normal_(0.0, 1.0, generator=gen)
                continue
            chunk = torch.empty(min(_CHUNK, flat.numel()), dtype=t.dtype,
                                device=self.device)
            for i in range(0, flat.numel(), _CHUNK):
                part = chunk[:min(_CHUNK, flat.numel() - i)]
                part.normal_(0.0, 1.0, generator=gen)
                flat[i:i + part.numel()].copy_(part, non_blocking=True)
            del chunk
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0


def run_flags(c: dict):
    """The engine's ``RunFlags``: the configuration's retrieval strategy."""
    from repro_torch.models.transformer import RunFlags
    return RunFlags(engram_strategy=c["engram"]["strategy"])


def engine(cfg, flags, c: dict, weights: Weights, device):
    """The serving engine the window drives: monolithic admission, greedy
    decode waves, no pool tier (``pool=None``: no modelled stall is slept),
    the family's ``flags`` and the configuration's sizes."""
    from repro_torch.serving import Engine
    s = c["serving"]
    return Engine(cfg, params=weights.tree, flags=flags,
                  max_batch=s["max_batch"], max_len=s["max_len"],
                  prompt_bucket=s["prompt_bucket"], pool=None,
                  device=device)
