"""xLSTM-125M: mLSTM + sLSTM blocks, ratio ~7:1 [arXiv:2405.04517]."""
from .base import ENGRAM_27B, ModelConfig, XLSTMConfig, register

_L = 12
_TYPES = tuple("slstm" if i % 8 == 7 else "mlstm" for i in range(_L))


@register("xlstm-125m")
def full() -> ModelConfig:
    from .base import EngramConfig
    return ModelConfig(
        name="xlstm-125m",
        family="ssm",
        n_layers=_L,
        d_model=768,
        vocab_size=50_304,
        n_heads=4,
        n_kv_heads=4,
        head_dim=192,
        d_ff=0,
        layer_types=_TYPES,
        attn_kinds=("-",) * _L,
        ffn_types=("none",) * _L,
        xlstm=XLSTMConfig(),
        tie_embeddings=True,
        # small-model Engram: emb_dim matched to d_model scale
        engram=EngramConfig(table_vocab=ENGRAM_27B["table_vocab"],
                            emb_dim=768, n_heads=8, orders=(2, 3),
                            layers=(2, 6)),
    )


def reduced() -> ModelConfig:
    from .base import EngramConfig
    L = 8  # preserves the i%8==7 slstm slot
    return ModelConfig(
        name="xlstm-125m-reduced",
        family="ssm",
        n_layers=L,
        d_model=64,
        vocab_size=467,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=0,
        layer_types=tuple("slstm" if i % 8 == 7 else "mlstm" for i in range(L)),
        attn_kinds=("-",) * L,
        ffn_types=("none",) * L,
        xlstm=XLSTMConfig(),
        tie_embeddings=True,
        engram=EngramConfig(table_vocab=2048, emb_dim=32, n_heads=4,
                            orders=(2, 3), layers=(1, 4), strategy="local"),
        dtype="float32",
    )
