"""§3.2 feasibility model: bandwidth + latency constraints for Engram pools.

  Bandwidth:  B_pool > T * S_layer * N_eng
  Latency:    L_pool(N_token, S_layer) < sum_{i<k} t_exec(i)   (prefetch window)

A verbatim copy of ``repro.pool.feasibility``: the PyTorch port imports
nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses

from ..configs.base import EngramConfig, ModelConfig
from .tiers import TierSpec, TIERS


@dataclasses.dataclass(frozen=True)
class ServingPoint:
    """Operating point of the serving system (the paper's Table 1)."""
    throughput_tok_s: float          # T
    step_latency_s: float            # t_step (decode step)
    n_layers: int                    # total transformer layers
    batch_tokens: int                # N_token per decode step


@dataclasses.dataclass(frozen=True)
class Feasibility:
    tier: str
    bandwidth_required_Bps: float
    bandwidth_available_Bps: float
    bandwidth_ok: bool
    prefetch_window_s: float
    retrieval_latency_s: float
    latency_ok: bool

    @property
    def ok(self) -> bool:
        return self.bandwidth_ok and self.latency_ok


def paper_case_study() -> ServingPoint:
    """Qwen3-32B on 4xH200 via SGLang (Table 1)."""
    return ServingPoint(throughput_tok_s=70_000.0, step_latency_s=3.6e-3,
                        n_layers=64, batch_tokens=256)


def check(ecfg: EngramConfig, point: ServingPoint, tier: TierSpec,
          engram_layer_k: int | None = None) -> Feasibility:
    """``engram_layer_k`` follows the paper's 1-indexed convention:
    the window is sum_{i=1}^{k-1} t_exec(i) = (k-1)·t_exec — layer 2 of the
    case study gets one layer's compute (~56 us), reproducing Table 1."""
    s_layer = ecfg.bytes_per_token_layer                      # S_layer
    n_eng = len(ecfg.layers)
    b_req = point.throughput_tok_s * s_layer * n_eng          # B_pool bound
    k = engram_layer_k if engram_layer_k is not None else min(ecfg.layers)
    t_exec = point.step_latency_s / point.n_layers
    window = max(k - 1, 0) * t_exec                           # sum_{i<k}
    n_segments = point.batch_tokens * ecfg.n_tables
    seg_bytes = ecfg.head_dim * 2
    lat = tier.read_latency_s(n_segments, seg_bytes)
    bw_avail = tier.read_bandwidth_Bps(n_segments, seg_bytes)
    return Feasibility(
        tier=tier.name,
        bandwidth_required_Bps=b_req,
        bandwidth_available_Bps=bw_avail,
        bandwidth_ok=bw_avail > b_req,
        prefetch_window_s=window,
        retrieval_latency_s=lat,
        latency_ok=lat < window,
    )


def check_all_tiers(ecfg: EngramConfig, point: ServingPoint) -> dict:
    return {name: check(ecfg, point, tier) for name, tier in TIERS.items()}


def required_bandwidth_Bps(ecfg: EngramConfig, throughput_tok_s: float) -> float:
    return throughput_tok_s * ecfg.bytes_per_token_layer * len(ecfg.layers)


def prefetch_window_s(point: ServingPoint, k: int) -> float:
    """1-indexed layer k -> (k-1) preceding layers of compute."""
    return max(k - 1, 0) * point.step_latency_s / point.n_layers
