"""Engram-40B: the paper's larger evaluation config (§5.2).

vocab_size = 7,239,680; emb_dim = 1,280.
"""
from .base import ENGRAM_40B, EngramConfig, ModelConfig, register


@register("engram-40b")
def full() -> ModelConfig:
    return ModelConfig(
        name="engram-40b",
        family="dense",
        n_layers=40,
        d_model=6144,
        vocab_size=129_280,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        engram=EngramConfig(layers=(2, 17), **ENGRAM_40B),
        rope_theta=10_000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="engram-40b-reduced",
        family="dense",
        n_layers=6,
        d_model=64,
        vocab_size=569,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=160,
        engram=EngramConfig(table_vocab=4096, emb_dim=32, n_heads=4,
                            orders=(2, 3), layers=(2, 4), strategy="local"),
        dtype="float32",
    )
