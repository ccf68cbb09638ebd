"""InternVL2-1B: InternViT(stub) + Qwen2-0.5B LM backbone [arXiv:2404.16821].

The vision frontend is a stub: the batch carries precomputed patch
embeddings (``patches``), which a learned projection writes over the first
``n_patch_tokens`` positions of the LM embedding sequence. Engram applies
to text positions (vision positions use sentinel id 0 whose gate learns
to close). A copy of ``repro.configs.internvl2_1b``.
"""
from .base import ENGRAM_27B, ModelConfig, engram_for, register


@register("internvl2-1b")
def full() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b",
        family="vlm",
        n_layers=24,
        d_model=896,
        vocab_size=151_655,
        n_heads=14,
        n_kv_heads=2,
        head_dim=64,
        d_ff=4864,
        frontend="vision",
        frontend_dim=1024,       # InternViT-300M patch embedding dim
        n_patch_tokens=256,
        engram=engram_for(24, ENGRAM_27B),
        rope_theta=1_000_000.0,
    )


def reduced() -> ModelConfig:
    from .base import EngramConfig
    return ModelConfig(
        name="internvl2-1b-reduced",
        family="vlm",
        n_layers=4,
        d_model=64,
        vocab_size=541,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        frontend="vision",
        frontend_dim=48,
        n_patch_tokens=8,
        engram=EngramConfig(table_vocab=2048, emb_dim=32, n_heads=4,
                            orders=(2, 3), layers=(1, 2), strategy="local"),
        dtype="float32",
    )
