"""HuBERT-XLarge: 48L encoder-only audio transformer [arXiv:2106.07447].

Engram inapplicable: input is continuous frame embeddings (no discrete
token IDs to n-gram-hash). A copy of ``repro.configs.hubert_xlarge``.
"""
from .base import ModelConfig, register


@register("hubert-xlarge")
def full() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        family="audio",
        n_layers=48,
        d_model=1280,
        vocab_size=504,
        n_heads=16,
        n_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        ffn_act="gelu",
        is_encoder=True,
        frontend="audio",
        frontend_dim=512,       # conv feature-extractor output (stubbed)
        engram=None,            # inapplicable (continuous input)
        rope_theta=10_000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge-reduced",
        family="audio",
        n_layers=4,
        d_model=64,
        vocab_size=59,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        ffn_act="gelu",
        is_encoder=True,
        frontend="audio",
        frontend_dim=24,
        engram=None,
        dtype="float32",
    )
