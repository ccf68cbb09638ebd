"""DeepSeek-7B: dense llama-arch [arXiv:2401.02954]."""
from .base import ENGRAM_27B, ModelConfig, engram_for, register


@register("deepseek-7b")
def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b",
        family="dense",
        n_layers=30,
        d_model=4096,
        vocab_size=102_400,
        n_heads=32,
        n_kv_heads=32,
        head_dim=128,
        d_ff=11008,
        engram=engram_for(30, ENGRAM_27B),
        rope_theta=10_000.0,
    )


def reduced() -> ModelConfig:
    from .base import EngramConfig
    return ModelConfig(
        name="deepseek-7b-reduced",
        family="dense",
        n_layers=4,
        d_model=64,
        vocab_size=521,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=160,
        engram=EngramConfig(table_vocab=2048, emb_dim=32, n_heads=4,
                            orders=(2, 3), layers=(1, 2), strategy="local"),
        dtype="float32",
    )
