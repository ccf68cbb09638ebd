"""Gemma2-27B: local/global alternating, logit softcaps [arXiv:2408.00118]."""
from .base import ENGRAM_27B, ModelConfig, engram_for, register

_L = 46


@register("gemma2-27b")
def full() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b",
        family="dense",
        n_layers=_L,
        d_model=4608,
        vocab_size=256_000,
        n_heads=32,
        n_kv_heads=16,
        head_dim=128,
        d_ff=36864,
        ffn_act="gelu",
        window_size=4096,
        attn_kinds=tuple("local" if i % 2 == 0 else "global"
                         for i in range(_L)),
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        post_block_norm=True,
        tie_embeddings=True,
        scale_embeddings=True,
        engram=engram_for(_L, ENGRAM_27B),
        rope_theta=10_000.0,
    )


def reduced() -> ModelConfig:
    from .base import EngramConfig
    L = 4
    return ModelConfig(
        name="gemma2-27b-reduced",
        family="dense",
        n_layers=L,
        d_model=64,
        vocab_size=499,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        ffn_act="gelu",
        window_size=16,
        attn_kinds=tuple("local" if i % 2 == 0 else "global" for i in range(L)),
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        post_block_norm=True,
        tie_embeddings=True,
        scale_embeddings=True,
        engram=EngramConfig(table_vocab=2048, emb_dim=32, n_heads=4,
                            orders=(2, 3), layers=(1, 2), strategy="local"),
        dtype="float32",
    )
