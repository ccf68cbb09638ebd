"""Config system: model/engram dataclasses + the architecture registry.

A copy of ``repro.configs.base`` (the JAX package's configs), kept here so
the PyTorch port imports nothing of the JAX package. Values and defaults
are identical; the parity tests compare the two field by field. The
registry holds every arch the reference registers.

Layer structure is encoded positionally:
  * ``layer_types[i]``  in {"attn", "mamba", "slstm", "mlstm"}
  * ``attn_kinds[i]``   in {"global", "local", "-"}  (windowed vs full)
  * ``ffn_types[i]``    in {"dense", "moe", "none"}
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional


# ---------------------------------------------------------------------------
# Engram (the paper's technique)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StoreConfig:
    """Tiered-store knobs (pool/store.py): the cache/prefetch front-end the
    paper's §6 discussion proposes in front of a slow backing tier.

    ``cache_rows=0`` disables the hot-row cache. ``admission`` selects the
    cache admission policy: ``"lru"`` (default, admit everything) or
    ``"tinylfu"`` (frequency-aware: a new row displaces the LRU victim only
    if a count-min sketch estimates it hotter — scan-resistant).

    ``prefetch_depth`` is the scheduler pipeline depth: 0 = synchronous
    fetch at the Engram layer (window 0), 1 = the paper's prefetch (issue
    at step start, window = k·t_exec). Deeper lookahead is no longer a
    config knob: windows beyond one step come from *real* speculative
    decoding (``SpecConfig``), where the scheduler derives per-position
    credit from the actually proposed (and later verified) tokens.
    """
    cache_rows: int = 0                    # LRU hot-row cache capacity (rows)
    cache_tier: str = "DRAM"               # tier serving cache hits
    prefetch_depth: int = 1                # scheduler pipeline depth (0 | 1)
    admission: str = "lru"                 # cache admission: lru | tinylfu
    # three-level chain knobs (pool/tierchain.py, pool="CXL+SSD" specs):
    # warm_rows caps the middle (CXL-resident) partition; rows beyond it
    # live on the cold tier. aging_half_life_s > 0 turns on virtual-clock
    # decay of the promotion sketch (0 = frequency ranking never forgets).
    warm_rows: int = 0                     # chain warm-tier capacity (rows)
    aging_half_life_s: float = 0.0         # sketch decay half-life (clock s)


@dataclass(frozen=True)
class SpecConfig:
    """Speculative decoding (spec/): turns the Engram prefetch window into
    real multi-step lookahead. Each decode wave proposes ``max_draft``
    tokens per live slot, prefetches the whole speculated window through
    the store, verifies the block in one batched pass, and rolls back the
    rejected tail (serving/slots.py state surgery).

    ``proposer``: ``"ngram"`` (suffix-cache proposer, no extra weights) or
    ``"draft"`` (small draft model reusing ``build_decode_step`` on a
    shrunken config). ``verify_overhead`` is the emulated extra cost per
    speculated token of the fused verify pass relative to a single decode
    step (decode is memory-bound, so a k-token verify costs ~one step plus
    a small compute term).

    ``pipeline``: run the proposer for wave N+1 *during* wave N's verify
    pass (host work genuinely overlaps the dispatched verify). When the
    optimistic proposal survives verification — full acceptance and a
    correctly guessed bonus token — the next block's prefetch was known a
    whole verify pass before wave start and the scheduler credits its
    window accordingly (``early_issue_s``), widening the measured
    ``stats().spec_window_steps``. Emitted tokens are identical either
    way; only prefetch timing/accounting moves.
    """
    enabled: bool = True
    proposer: str = "ngram"                # ngram | draft
    max_draft: int = 3                     # speculated tokens per wave (k)
    ngram_order: int = 4                   # max suffix length + 1 for ngram
    draft_layers: int = 1                  # layers kept by the draft model
    draft_context: int = 16                # draft prefill context (bucketed)
    verify_overhead: float = 0.05          # emulated verify cost / extra token
    pipeline: bool = False                 # propose wave N+1 during N's verify


@dataclass(frozen=True)
class EngramConfig:
    """Engram conditional memory (DeepSeek) + pooling strategy (this paper).

    Defaults reproduce the paper's Engram-27B numbers: 8 hash heads per
    n-gram order, emb_dim 1280 => 160-dim (320 B bf16) segments; with
    orders (2, 3) a token fetches 16 segments = 5 KB per Engram layer.
    """
    enabled: bool = True
    orders: tuple[int, ...] = (2, 3)
    n_heads: int = 8                       # hash heads per order
    emb_dim: int = 1280                    # total fused dim per order
    table_vocab: int = 2_262_400           # rows per (order, head) table
    layers: tuple[int, ...] = (2, 15)      # transformer layers hosting Engram
    # retrieval strategy: local | pooled | pooled_host   (see DESIGN.md §4)
    strategy: str = "pooled"
    seed: int = 0x5EED
    pad_token: int = 0                     # BOS padding for left edge
    store: StoreConfig = field(default_factory=StoreConfig)

    @property
    def head_dim(self) -> int:
        assert self.emb_dim % self.n_heads == 0
        return self.emb_dim // self.n_heads

    @property
    def n_tables(self) -> int:
        return len(self.orders) * self.n_heads

    @property
    def bytes_per_token_layer(self) -> int:
        """S_layer of the paper: bytes fetched per token per Engram layer."""
        return self.n_tables * self.head_dim * 2  # bf16

    def table_bytes(self) -> int:
        return self.n_tables * self.table_vocab * self.head_dim * 2

    def table_params(self) -> int:
        return self.n_tables * self.table_vocab * self.head_dim


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek Multi-head Latent Attention."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 64                 # routed experts
    top_k: int = 2
    n_shared: int = 0                   # shared (always-on) experts
    d_ff_expert: int = 1408             # intermediate per expert
    router_scale: float = 1.0           # scaling of routed output
    capacity_factor: float = 1.25       # EP dispatch capacity slack
    router_noise: float = 0.0
    aux_loss_coef: float = 0.001


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model


@dataclass(frozen=True)
class XLSTMConfig:
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 4.0 / 3.0
    conv1d_kernel: int = 4


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                          # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    vocab_size: int

    # attention
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 64
    attn_impl: str = "gqa"               # gqa | mla
    mla: Optional[MLAConfig] = None
    window_size: int = 0                 # sliding-window width for "local" layers
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    rope_theta: float = 10_000.0
    rope_local_theta: float = 0.0        # 0 => same as rope_theta
    qk_norm: bool = False
    post_block_norm: bool = False        # gemma2-style post norms

    # ffn
    d_ff: int = 2048
    moe: Optional[MoEConfig] = None
    ffn_act: str = "silu"                # silu | gelu (geglu uses gelu gate)

    # per-layer structure (len == n_layers); built by helpers below
    layer_types: tuple[str, ...] = ()
    attn_kinds: tuple[str, ...] = ()
    ffn_types: tuple[str, ...] = ()

    # ssm / hybrid
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None

    # structure
    is_encoder: bool = False             # bidirectional, no decode step
    scale_embeddings: bool = False       # gemma-style sqrt(d) embed scaling
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    frontend: Optional[str] = None       # None | audio | vision (stub frontends)
    frontend_dim: int = 0                # raw feature dim entering the stub
    n_patch_tokens: int = 0              # vlm: image tokens per sequence

    # the paper's technique
    engram: Optional[EngramConfig] = None

    # speculative decoding (spec/): drives real multi-step Engram lookahead
    spec: Optional[SpecConfig] = None

    # numerics
    dtype: str = "bfloat16"              # activation/param dtype for dry-run

    # ----- derived ---------------------------------------------------------
    def __post_init__(self):
        if not self.layer_types:
            object.__setattr__(self, "layer_types", ("attn",) * self.n_layers)
        if not self.attn_kinds:
            object.__setattr__(self, "attn_kinds", ("global",) * self.n_layers)
        if not self.ffn_types:
            object.__setattr__(self, "ffn_types", ("dense",) * self.n_layers)
        assert len(self.layer_types) == self.n_layers, self.name
        assert len(self.attn_kinds) == self.n_layers, self.name
        assert len(self.ffn_types) == self.n_layers, self.name

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def engram_layers(self) -> tuple[int, ...]:
        if self.engram is None or not self.engram.enabled:
            return ()
        return tuple(sorted(l for l in self.engram.layers
                            if 0 < l < self.n_layers))

    # ----- analytic parameter counts (for roofline & docs) ----------------
    def param_count(self) -> int:
        n = self.vocab_size * self.d_model          # embed
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model     # lm head
        for i in range(self.n_layers):
            n += self._mixer_params(i) + self._ffn_params(i)
            n += 2 * self.d_model                   # norms
        if self.engram is not None and self.engram.enabled:
            e = self.engram
            per_layer = e.table_params()                            # own table
            per_layer += (len(e.orders) * e.emb_dim) * self.d_model  # proj
            per_layer += self.d_model * self.d_model                # gate
            n += per_layer * len(self.engram_layers())
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE top-k + shared only; engram rows)."""
        n = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        for i in range(self.n_layers):
            n += self._mixer_params(i)
            if self.ffn_types[i] == "moe":
                m = self.moe
                n += 3 * self.d_model * m.d_ff_expert * (m.top_k + m.n_shared)
                n += self.d_model * m.n_experts     # router
            elif self.ffn_types[i] == "dense":
                n += 3 * self.d_model * self.d_ff
            n += 2 * self.d_model
        if self.engram is not None and self.engram.enabled:
            e = self.engram
            for _ in self.engram_layers():
                n += e.n_tables * e.head_dim        # rows fetched
                n += (len(e.orders) * e.emb_dim) * self.d_model
                n += self.d_model * self.d_model
        return n

    def _mixer_params(self, i: int) -> int:
        t, d = self.layer_types[i], self.d_model
        if t == "attn":
            if self.attn_impl == "mla":
                m = self.mla
                qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
                n = d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk_head
                n += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                n += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                n += self.n_heads * m.v_head_dim * d
                return n
            return d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        if t == "mamba":
            mc = self.mamba
            di = mc.d_inner(d)
            n = d * 2 * di                          # in_proj
            n += di * mc.d_conv                     # conv
            n += di * (mc.d_state * 2 + 1)          # x_proj-ish (B, C, dt)
            n += di * mc.d_state                    # A
            n += di * d                             # out_proj
            return n
        if t in ("mlstm", "slstm"):
            xc = self.xlstm
            pf = xc.proj_factor_mlstm if t == "mlstm" else xc.proj_factor_slstm
            di = int(pf * d)
            # up/down proj + qkv + gates (approximate, matches models/xlstm.py)
            return d * di * 2 + 3 * di * di // max(self.n_heads, 1) + 4 * di * d
        raise ValueError(t)

    def _ffn_params(self, i: int) -> int:
        t, d = self.ffn_types[i], self.d_model
        if t == "none":
            return 0
        if t == "moe":
            m = self.moe
            n = m.n_experts * 3 * d * m.d_ff_expert
            n += m.n_shared * 3 * d * m.d_ff_expert
            n += d * m.n_experts
            return n
        return 3 * d * self.d_ff                    # gate/up/down (swiglu)


# ---------------------------------------------------------------------------
# Shapes (assigned input-shape set)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """Shape applicability per the assignment rules."""
    shapes = ["train_4k", "prefill_32k"]
    if not cfg.is_encoder:
        shapes.append("decode_32k")
        # long_500k only for sub-quadratic (SSM / hybrid) archs
        if cfg.family in ("ssm", "hybrid"):
            shapes.append("long_500k")
    return shapes


def skipped_shapes(cfg: ModelConfig) -> dict[str, str]:
    out = {}
    if cfg.is_encoder:
        out["decode_32k"] = "encoder-only arch has no decode step"
        out["long_500k"] = "encoder-only arch has no decode step"
    elif cfg.family not in ("ssm", "hybrid"):
        out["long_500k"] = "pure full-attention arch (long_500k needs sub-quadratic)"
    return out


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


_LOADED = False


def _load_all():
    global _LOADED
    if _LOADED:
        return
    from . import (deepseek_7b, deepseek_coder_33b,  # noqa: F401
                   deepseek_v2_236b, deepseek_v3_671b, engram_27b,
                   engram_40b, gemma2_27b, gemma3_1b, hubert_xlarge,
                   internvl2_1b, jamba_1_5_large_398b, xlstm_125m)
    _LOADED = True


# Engram table presets (paper §5.2)
ENGRAM_27B = dict(table_vocab=2_262_400, emb_dim=1280, n_heads=8, orders=(2, 3))
ENGRAM_40B = dict(table_vocab=7_239_680, emb_dim=1280, n_heads=8, orders=(2, 3))


def engram_for(depth: int, preset: dict, **kw) -> EngramConfig:
    """Engram layers (2, 15) for 36L in the paper; scale ~(2, 0.4L) with depth."""
    l2 = max(3, min(depth - 1, round(0.42 * depth)))
    return EngramConfig(layers=(2, l2), **preset, **kw)
