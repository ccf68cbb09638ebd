"""Three-term roofline of one rank's step (PyTorch port of
``repro.roofline.analysis``).

    compute    = FLOPs / peak_FLOP/s
    memory     = bytes / HBM_bw
    collective = collective wire bytes / link_bw

The FLOPs, bytes and collective calls come from ``roofline.counting``
(an operation counter over the eager program, the counterpart of the
reference's ``compiled.cost_analysis()`` and HLO text), per rank. Ring-
model wire-cost factors convert payloads to per-link bytes, as in the
reference:

    all-reduce      2·(n-1)/n · size
    all-gather      (n-1)/n · size_out
    reduce-scatter  (n-1)/n · size_in      (= out · n · (n-1)/n)
    all-to-all      (n-1)/n · size
    collective-permute  1 · size           (the port sends none)

Hardware model: one NVIDIA H100 SXM5 80GB (``HW``). One peak FLOP rate,
bf16 dense on the tensor cores, as the reference keeps one: the f32 head
and f32 attention scores run on the CUDA cores at 67 TFLOP/s, so the
compute term is a lower bound where they matter. The collective term
charges one NVLink direction of one card (450 GB/s), the reference's one-
link bound.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

# NVIDIA H100 SXM5 80GB data sheet: 989 TFLOP/s dense bf16 (tensor
# cores, no sparsity), 3.35 TB/s HBM3, NVLink 4 900 GB/s per card, i.e.
# 450 GB/s each way. dcn_bw: one 400 Gb/s NIC per card, as a DGX H100
# wires its eight cards (a model figure across pods, not a measurement)
HW = {
    "peak_flops": 989e12,       # bf16 dense per card
    "hbm_bw": 3.35e12,          # bytes/s per card
    "link_bw": 450e9,           # bytes/s, NVLink 4, one direction
    "dcn_bw": 50e9,             # bytes/s per card cross-pod (pod axis)
    "hbm_per_chip": 80e9,
}

_RING_FACTOR = {
    "all-reduce": lambda n: 2.0 * (n - 1) / max(n, 1),
    "all-gather": lambda n: (n - 1) / max(n, 1),
    "reduce-scatter": lambda n: float(n - 1),   # applied to OUT bytes (=in/n)
    "all-to-all": lambda n: (n - 1) / max(n, 1),
    "collective-permute": lambda n: 1.0,
}


def collective_stats(calls) -> dict:
    """Per-rank collective payloads (wire bytes, ring model) by op kind,
    from recorded calls: (kind, payload bytes, group size) each, the kind
    one of ``_RING_FACTOR``'s (``roofline.counting`` records them from the
    c10d operations, the payload as the reference charges it: the result
    of an all-gather or reduce-scatter, the buffer of the others)."""
    by_op = defaultdict(float)
    raw_by_op = defaultdict(float)
    counts = defaultdict(int)
    for op, size, n in calls:
        by_op[op] += _RING_FACTOR[op](n) * size
        raw_by_op[op] += size
        counts[op] += 1
    return {
        "wire_bytes_per_device": dict(by_op),
        "payload_bytes_per_device": dict(raw_by_op),
        "counts": dict(counts),
        "total_wire_bytes_per_device": float(sum(by_op.values())),
    }


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        # optimistic perfect-overlap model: max of the three engines
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """useful-compute fraction of the modeled step time."""
        if self.step_time_s == 0:
            return 0.0
        return self.compute_s / self.step_time_s


def roofline(flops_per_device: float, bytes_per_device: float,
             coll_wire_bytes_per_device: float, hw: dict = HW) -> Roofline:
    return Roofline(
        compute_s=flops_per_device / hw["peak_flops"],
        memory_s=bytes_per_device / hw["hbm_bw"],
        collective_s=coll_wire_bytes_per_device / hw["link_bw"],
        flops_per_device=flops_per_device,
        bytes_per_device=bytes_per_device,
        coll_bytes_per_device=coll_wire_bytes_per_device,
    )


# ---------------------------------------------------------------------------
# analytic model FLOPs (6·N·D dense / 6·N_active·D MoE; serve: 2·N·D + attn)
# ---------------------------------------------------------------------------

def model_flops(cfg, shape) -> float:
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    n_active = cfg.active_param_count()
    # exclude embedding table from the per-token matmul count
    n_active_mm = n_active - cfg.vocab_size * cfg.d_model
    if shape.kind == "train":
        base = 6.0 * n_active_mm * tokens
    else:
        base = 2.0 * n_active_mm * tokens
    # attention scores/values flops
    attn = 0.0
    ctx_len = shape.seq_len
    for i in range(cfg.n_layers):
        if cfg.layer_types[i] != "attn":
            continue
        if cfg.attn_impl == "mla":
            hd_k = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
            hd_v = cfg.mla.v_head_dim
            heads = cfg.n_heads
        else:
            hd_k = hd_v = cfg.head_dim
            heads = cfg.n_heads
        kind = cfg.attn_kinds[i]
        if shape.kind == "decode":
            span = ctx_len if kind != "local" or not cfg.window_size else min(
                ctx_len, cfg.window_size)
            per_tok = 2.0 * heads * span * (hd_k + hd_v)
        else:
            if kind == "local" and cfg.window_size:
                span = min(cfg.window_size, ctx_len)
                per_tok = 2.0 * heads * span * (hd_k + hd_v)
            else:
                per_tok = 2.0 * heads * (ctx_len / 2.0) * (hd_k + hd_v)
        mult = 3.0 if shape.kind == "train" else 1.0
        attn += per_tok * tokens * mult
    return base + attn
