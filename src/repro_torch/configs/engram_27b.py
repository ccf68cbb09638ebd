"""Engram-27B: the paper's own evaluation config (§5.2).

vocab_size = 2,262,400; emb_dim = 1,280. Host model: a 36-layer dense LM
(the paper's Fig. 1 example places Engram at layers 2 and 15 of 36).
"""
from .base import ENGRAM_27B, EngramConfig, ModelConfig, register


@register("engram-27b")
def full() -> ModelConfig:
    return ModelConfig(
        name="engram-27b",
        family="dense",
        n_layers=36,
        d_model=5120,
        vocab_size=129_280,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=13824,
        engram=EngramConfig(layers=(2, 15), **ENGRAM_27B),
        rope_theta=10_000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="engram-27b-reduced",
        family="dense",
        n_layers=6,
        d_model=64,
        vocab_size=563,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=160,
        engram=EngramConfig(table_vocab=2048, emb_dim=32, n_heads=4,
                            orders=(2, 3), layers=(2, 4), strategy="local"),
        dtype="float32",
    )
