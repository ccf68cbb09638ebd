"""Configurations and a mix at a size a CPU test holds: the same families
as the cells (dense GQA with Engram; MLA, MoE and Engram), every width
cut."""
import copy

DENSE = {
    "name": "tiny-dense", "num_hidden_layers": 4, "hidden_size": 64,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
    "intermediate_size": 160, "vocab_size": 563, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-6, "hidden_act": "silu", "dtype": "bfloat16",
    "engram": {"layers": [1, 3], "table_vocab": 2048, "emb_dim": 32,
               "n_heads": 4, "orders": [2, 3], "hash_seed": 24301,
               "pad_token": 0, "strategy": "pooled_host",
               "placement": "host"},
    "serving": {"max_batch": 4, "max_len": 96, "prompt_bucket": 16},
    # program's widest gap 0.012 to 0.026 over 5 seeds, the control's 0.17
    # to 0.33 (6 s windows, about 300 tokens checked)
    "check": {"number": "widest_gap", "gap_limit": 0.1, "sample_tokens": 400,
              "max_requests": 40},
}

MLA_MOE = dict(copy.deepcopy(DENSE), **{
    "name": "tiny-mla-moe", "num_key_value_heads": 4, "kv_lora_rank": 16,
    "q_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
    "v_head_dim": 16, "n_routed_experts": 8, "num_experts_per_tok": 2,
    "n_shared_experts": 2, "moe_intermediate_size": 32,
    "first_k_dense_replace": 1, "norm_topk_prob": True,
    "scoring_func": "softmax", "topk_method": "greedy",
    "routed_scaling_factor": 1.0, "intermediate_size": 128,
    "vocab_size": 503,
    # routing near-ties put the widest gap of bf16 and float8 alike near
    # the same size; the mean separates them: the program's 0.0001 to
    # 0.003 over 5 seeds, the control's 0.022 to 0.033
    "check": {"number": "mean_gap", "gap_limit": 0.01, "sample_tokens": 400,
              "max_requests": 40}})

MIX = {"clients": 4, "per_client": 400,
       "prompt": {"median": 24, "sigma": 0.5, "min": 8, "max": 64},
       "output": {"median": 8, "sigma": 0.5, "min": 4, "max": 24}}


def f32(c: dict) -> dict:
    c = copy.deepcopy(c)
    c["dtype"] = "float32"
    return c
