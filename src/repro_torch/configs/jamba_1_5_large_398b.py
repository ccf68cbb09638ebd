"""Jamba-1.5-Large 398B: Mamba+attention 1:7, MoE 16e top-2 [arXiv:2403.19887].

Period-8 layout with attention at offset 3; MoE at every other layer.
"""
from .base import (ENGRAM_40B, MambaConfig, ModelConfig, MoEConfig,
                   engram_for, register)

_L = 72
_TYPES = tuple("attn" if i % 8 == 3 else "mamba" for i in range(_L))
_FFN = tuple("moe" if i % 2 == 1 else "dense" for i in range(_L))


@register("jamba-1.5-large-398b")
def full() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        n_layers=_L,
        d_model=8192,
        vocab_size=65_536,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        layer_types=_TYPES,
        attn_kinds=tuple("global" if t == "attn" else "-" for t in _TYPES),
        ffn_types=_FFN,
        moe=MoEConfig(n_experts=16, top_k=2, n_shared=0, d_ff_expert=24576),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
        engram=engram_for(_L, ENGRAM_40B),
        rope_theta=10_000.0,
    )


def reduced() -> ModelConfig:
    from .base import EngramConfig
    L = 8  # one full period
    types = tuple("attn" if i % 8 == 3 else "mamba" for i in range(L))
    return ModelConfig(
        name="jamba-1.5-large-398b-reduced",
        family="hybrid",
        n_layers=L,
        d_model=64,
        vocab_size=491,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        layer_types=types,
        attn_kinds=tuple("global" if t == "attn" else "-" for t in types),
        ffn_types=tuple("moe" if i % 2 == 1 else "dense" for i in range(L)),
        moe=MoEConfig(n_experts=4, top_k=2, n_shared=0, d_ff_expert=64),
        mamba=MambaConfig(d_state=8, d_conv=4, expand=2),
        engram=EngramConfig(table_vocab=2048, emb_dim=32, n_heads=4,
                            orders=(2, 3), layers=(1, 4), strategy="local"),
        dtype="float32",
    )
