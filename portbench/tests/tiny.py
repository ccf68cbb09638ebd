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


# A family file (``harness/family.py``) for MLA_MOE under the model_type
# ``tiny_mla_moe``. Its configuration states a YaRN ``rope_scaling`` of
# factor 1, which is plain RoPE: the harness's own mapping refuses any
# ``rope_scaling``, the family maps it. Each call of a member is noted, one
# line each, in ``<file>.log`` beside it. ``fault`` plants one in its
# reference: the shared experts left out.
FAMILY = '''
from pathlib import Path

from portbench.harness import model
from portbench.reference.model import Reference as _Reference

LOG = Path(__file__).with_suffix(".log")


def _note(what):
    with open(LOG, "a") as f:
        f.write(what + "\\n")


def _plain(c):
    rs = c.get("rope_scaling")
    if rs is not None and rs.get("factor") != 1.0:
        raise ValueError("only YaRN of factor 1 (plain RoPE)")
    return {k: v for k, v in c.items() if k != "rope_scaling"}


def model_config(c):
    _note("model_config")
    return model.model_config(_plain(c))


def run_flags(c):
    _note("run_flags")
    return model.run_flags(c)


class Reference(_Reference):
    def __init__(self, c, params, device, linear=None):
        _note("Reference " + type(linear).__name__)
        super().__init__(_plain(c), params, device, linear)
{fault}

def prefill(c, n):
    _note("prefill")
    return {prefill}


def decode(c, pos):
    _note("decode")
    return {decode}
'''
PREFILL_FLOPS, DECODE_FLOPS = 3.0e9, 1.0e9

FAULT = '''
    def _moe(self, p, x):
        return super()._moe(p, x) - self._swiglu(p["shared"], x)
'''

FAMILY_CONFIG = dict(copy.deepcopy(MLA_MOE), model_type="tiny_mla_moe",
                     rope_scaling={"type": "yarn", "factor": 1.0})


def write_family(root, fault: bool = False):
    """``FAMILY`` as ``<root>/portbench/families/tiny_mla_moe.py``; returns
    the path of its log."""
    d = root / "portbench" / "families"
    d.mkdir(parents=True, exist_ok=True)
    (d / "tiny_mla_moe.py").write_text(
        FAMILY.replace("{fault}", FAULT if fault else "")
        .replace("{prefill}", repr(PREFILL_FLOPS))
        .replace("{decode}", repr(DECODE_FLOPS)))
    return d / "tiny_mla_moe.log"
