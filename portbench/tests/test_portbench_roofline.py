"""The yardstick's FLOP and byte formulas: by hand, and against the port's
own operation counter (``roofline.counting.CountingMode``) over a prefill
of the reduced families on the CPU."""
import pytest
import torch

from portbench.harness import model
from portbench.roofline import flops, peaks

from . import tiny


def test_dense_counts_by_hand():
    c = tiny.DENSE
    d, f, H, kv, hd, V = 64, 160, 4, 2, 16, 563
    per_layer = d * H * hd + 2 * d * kv * hd + H * hd * d + 3 * d * f
    fuse = d * d + 64 * d                        # gate, and 2 orders x 32
    assert flops.token_linear(c) == 2.0 * (4 * per_layer + 2 * fuse)
    assert flops.head(c) == 2.0 * d * V
    assert flops.attention(c, 10) == 2.0 * (H * 2 * hd) * 10 * 4
    assert flops.prefill(c, 3) == 3 * flops.token_linear(c) + \
        flops.attention(c, 6) + flops.head(c)
    assert flops.decode(c, 5) == flops.token_linear(c) + \
        flops.attention(c, 6) + flops.head(c)


def test_mla_moe_counts_by_hand():
    c = tiny.MLA_MOE
    d, H = 64, 4
    mla = (d * 32 + 32 * H * 24 + d * (16 + 8) + 16 * H * (16 + 16)
           + H * 16 * d)
    moe = d * 8 + 2 * 2 * d * 32 + 3 * d * 2 * 32
    dense = 3 * d * 128
    assert flops.mixer_linear(c) == mla
    assert flops.ffn_linear(c, 0) == dense
    assert flops.ffn_linear(c, 1) == moe
    assert flops.attn_pair(c) == H * (16 + 8 + 16)


def test_kernel_costs_by_hand():
    f, b = flops.k2_cost((8, 1, 5120), (8, 1, 2560))
    assert f == 2.0 * 8 * 5120 * (5120 + 2560)
    assert b == 2 * (2 * 8 * 5120 + 8 * 2560 + 5120 * 5120 + 2560 * 5120)
    assert flops.k2_least_s((8, 1, 5120), (8, 1, 2560)) == \
        pytest.approx(b / peaks.HBM_BYTES_PER_S)
    # 2 x 128 rows of 320 B: 81,920 B over 64 GB/s
    assert flops.k1_host_least_s(256, 320) == pytest.approx(256 * 320 / 64e9)


@pytest.mark.parametrize("c", [tiny.DENSE, tiny.MLA_MOE],
                         ids=lambda c: c["name"])
def test_prefill_against_the_ports_counter(c):
    """The port computes every (query, key) pair of a short prompt (a
    masked S x S score and value product, not the causal half) and the
    whole fused gate-and-up expert product (it uses the gate half): the
    counter reads exactly the model FLOPs plus those two."""
    from repro_torch.models.model import build_prefill_step
    from repro_torch.models.transformer import RunFlags
    from repro_torch.roofline.counting import CountingMode
    c = tiny.f32(c)
    cfg = model.model_config(c)
    w = model.Weights(cfg, "cpu", host_tables=True)
    w.draw(5)
    S = 16
    step = build_prefill_step(cfg, RunFlags(engram_strategy="pooled_host"),
                              max_len=S)
    toks = torch.randint(0, c["vocab_size"], (1, S))
    mode = CountingMode()
    with mode:
        step(w.tree, {"tokens": toks})
    counted = mode.stats()["flops_dot"]
    full_attention = flops.attention(c, S * S)
    waste = 0.0
    if c.get("n_routed_experts"):
        n_moe = c["num_hidden_layers"] - c["first_k_dense_replace"]
        waste = n_moe * 2.0 * S * c["num_experts_per_tok"] * \
            c["hidden_size"] * c["moe_intermediate_size"]
    want = flops.prefill(c, S) - flops.attention(c, S * (S + 1) / 2) \
        + full_attention + waste
    assert counted == pytest.approx(want, rel=1e-12)
