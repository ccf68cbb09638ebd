"""Gemma3-1B: 5:1 local:global, qk-norm, dual rope bases [hf:google/gemma-3-1b-pt]."""
from .base import ENGRAM_27B, ModelConfig, engram_for, register

_L = 26


@register("gemma3-1b")
def full() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b",
        family="dense",
        n_layers=_L,
        d_model=1152,
        vocab_size=262_144,
        n_heads=4,
        n_kv_heads=1,
        head_dim=256,
        d_ff=6912,
        ffn_act="gelu",
        window_size=512,
        attn_kinds=tuple("global" if (i + 1) % 6 == 0 else "local"
                         for i in range(_L)),
        qk_norm=True,
        post_block_norm=True,
        tie_embeddings=True,
        scale_embeddings=True,
        engram=engram_for(_L, ENGRAM_27B),
        rope_theta=1_000_000.0,       # global layers
        rope_local_theta=10_000.0,    # local layers
    )


def reduced() -> ModelConfig:
    from .base import EngramConfig
    L = 6
    return ModelConfig(
        name="gemma3-1b-reduced",
        family="dense",
        n_layers=L,
        d_model=64,
        vocab_size=997,
        n_heads=4,
        n_kv_heads=1,
        head_dim=16,
        d_ff=128,
        ffn_act="gelu",
        window_size=16,
        attn_kinds=tuple("global" if (i + 1) % 6 == 0 else "local" for i in range(L)),
        qk_norm=True,
        post_block_norm=True,
        tie_embeddings=True,
        scale_embeddings=True,
        engram=EngramConfig(table_vocab=2048, emb_dim=32, n_heads=4,
                            orders=(2, 3), layers=(1, 3), strategy="local"),
        rope_theta=1_000_000.0,
        rope_local_theta=10_000.0,
        dtype="float32",
    )
