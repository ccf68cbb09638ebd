"""DeepSeek-V3 671B: MLA + MoE(256e top-8, 1 shared) [arXiv:2412.19437].

MTP head: represented as an optional auxiliary head (n_mtp=1) used only in
training smoke; not part of the serve path.
"""
from .base import (ENGRAM_40B, MLAConfig, ModelConfig, MoEConfig, engram_for,
                   register)

_L = 61
_FIRST_DENSE = 3


@register("deepseek-v3-671b")
def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        family="moe",
        n_layers=_L,
        d_model=7168,
        vocab_size=129_280,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        attn_impl="mla",
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        d_ff=18432,
        moe=MoEConfig(n_experts=256, top_k=8, n_shared=1, d_ff_expert=2048),
        ffn_types=tuple("dense" if i < _FIRST_DENSE else "moe"
                        for i in range(_L)),
        engram=engram_for(_L, ENGRAM_40B),
        rope_theta=10_000.0,
    )


def reduced() -> ModelConfig:
    from .base import EngramConfig
    L = 4
    return ModelConfig(
        name="deepseek-v3-671b-reduced",
        family="moe",
        n_layers=L,
        d_model=64,
        vocab_size=509,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        attn_impl="mla",
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
        d_ff=128,
        moe=MoEConfig(n_experts=8, top_k=3, n_shared=1, d_ff_expert=32),
        ffn_types=("dense",) + ("moe",) * (L - 1),
        engram=EngramConfig(table_vocab=2048, emb_dim=32, n_heads=4,
                            orders=(2, 3), layers=(1, 3), strategy="local"),
        dtype="float32",
    )
