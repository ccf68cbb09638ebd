"""DeepSeek-V2 236B: MLA + MoE(160e top-6, 2 shared) [arXiv:2405.04434]."""
from .base import (ENGRAM_40B, MLAConfig, ModelConfig, MoEConfig, engram_for,
                   register)

_L = 60
_FIRST_DENSE = 1


@register("deepseek-v2-236b")
def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        n_layers=_L,
        d_model=5120,
        vocab_size=102_400,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        attn_impl="mla",
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        d_ff=12288,  # dense layers (first_k)
        moe=MoEConfig(n_experts=160, top_k=6, n_shared=2, d_ff_expert=1536),
        ffn_types=tuple("dense" if i < _FIRST_DENSE else "moe"
                        for i in range(_L)),
        engram=engram_for(_L, ENGRAM_40B),
        rope_theta=10_000.0,
    )


def reduced() -> ModelConfig:
    from .base import EngramConfig
    L = 4
    return ModelConfig(
        name="deepseek-v2-236b-reduced",
        family="moe",
        n_layers=L,
        d_model=64,
        vocab_size=503,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        attn_impl="mla",
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
        d_ff=128,
        moe=MoEConfig(n_experts=8, top_k=2, n_shared=2, d_ff_expert=32),
        ffn_types=("dense",) + ("moe",) * (L - 1),
        engram=EngramConfig(table_vocab=2048, emb_dim=32, n_heads=4,
                            orders=(2, 3), layers=(1, 2), strategy="local"),
        dtype="float32",
    )
