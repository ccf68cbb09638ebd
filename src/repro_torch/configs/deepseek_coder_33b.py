"""DeepSeek-Coder-33B: dense llama-arch, GQA kv=8 [arXiv:2401.14196]."""
from .base import ENGRAM_27B, ModelConfig, engram_for, register


@register("deepseek-coder-33b")
def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b",
        family="dense",
        n_layers=62,
        d_model=7168,
        vocab_size=32_256,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=19200,
        engram=engram_for(62, ENGRAM_27B),
        rope_theta=100_000.0,
    )


def reduced() -> ModelConfig:
    from .base import EngramConfig
    return ModelConfig(
        name="deepseek-coder-33b-reduced",
        family="dense",
        n_layers=4,
        d_model=64,
        vocab_size=487,
        n_heads=8,
        n_kv_heads=2,
        head_dim=8,
        d_ff=160,
        engram=EngramConfig(table_vocab=2048, emb_dim=32, n_heads=4,
                            orders=(2, 3), layers=(1, 2), strategy="local"),
        dtype="float32",
    )
