"""Memory-tier models for Engram storage (the paper's §2.2-§3.3 fabric).

Latency/bandwidth parameters follow the paper's measurements and public
datasheets: local DDR5 DRAM, CXL 2.0 switch pool (XConn XC50256 + Montage
M88MX5851), and RDMA pooling (Mooncake-style get over 100GbE/CX-7).

A retrieval of B tokens fetches B * n_segments discrete segments of
``segment_bytes`` each (Engram-27B: 16 x 320 B). The models capture the
paper's qualitative findings:
  * DRAM: ~100 ns loads, effectively unlimited concurrency at this scale.
  * CXL: adds switch+controller hop (~350-450 ns) but keeps load/store
    semantics -> per-segment cost stays sub-microsecond and pipelines well.
  * RDMA: per-message software/NIC overhead (~1.5-10 us) dominates small
    segments; batching amortizes poorly for discrete addresses (the get
    path of a store adds indexing RTTs), matching Fig. 3's orders-of-
    magnitude gap.

A verbatim copy of ``repro.pool.tiers``: the PyTorch port imports
nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TierSpec:
    name: str
    base_latency_s: float          # fixed per-batch software setup
    segment_latency_s: float       # per-segment device latency (unpipelined)
    bandwidth_Bps: float           # sustained transfer bandwidth
    concurrency: int               # segments in flight (pipelining factor)
    per_message_s: float = 0.0     # per-segment software/NIC cost (RDMA)
    aggregate: bool = False        # one scatter-gather payload per wave

    def software_s(self, n_segments: int) -> float:
        """Host/NIC software cost: runs on the *requesting* node, so it
        never serializes on the shared link. An aggregating tier sends ONE
        scatter-gather message per wave regardless of segment count."""
        if self.aggregate:
            return self.base_latency_s + self.per_message_s
        return self.base_latency_s + self.per_message_s * n_segments

    def service_s(self, n_segments: int, segment_bytes: int) -> float:
        """Occupancy of the tier's shared medium for one wave — the part a
        ``serving/clock.py`` ``Link`` serializes across concurrent
        readers (the bandwidth-split contention model).

        Non-aggregating tiers pipeline discrete segments: first-access
        latency + streamed remainder, floored by the wire time. An
        aggregating tier (``RDMA-agg``) moves the whole wave as one
        batched payload: a single first-access, then pure wire — the
        per-row markup the analytic model used to charge is gone."""
        if n_segments <= 0:
            return 0.0
        wire = n_segments * segment_bytes / self.bandwidth_Bps
        if self.aggregate:
            return max(self.segment_latency_s, wire)
        device = self.segment_latency_s * (
            1.0 + (n_segments - 1) / max(self.concurrency, 1))
        return max(device, wire)

    def read_latency_s(self, n_segments: int, segment_bytes: int) -> float:
        """Uncontended latency to fetch n_segments discrete segments:
        software setup + medium occupancy (``service_s``)."""
        return self.software_s(n_segments) + self.service_s(n_segments,
                                                            segment_bytes)

    def read_bandwidth_Bps(self, n_segments: int, segment_bytes: int) -> float:
        t = self.read_latency_s(n_segments, segment_bytes)
        return n_segments * segment_bytes / t


# Calibrated so the simulator reproduces the paper's Fig. 3/5/6 shape:
# DRAM and CXL within ~1.2-2x of each other across batch sizes; RDMA
# 20-100x worse on small discrete reads.
DRAM = TierSpec("DRAM", base_latency_s=2e-6, segment_latency_s=100e-9,
                bandwidth_Bps=200e9, concurrency=64)

CXL = TierSpec("CXL", base_latency_s=3e-6, segment_latency_s=420e-9,
               bandwidth_Bps=56e9,   # PCIe5 x16 adapter, practical
               concurrency=48)

RDMA = TierSpec("RDMA", base_latency_s=15e-6, segment_latency_s=2.2e-6,
                bandwidth_Bps=12.5e9,  # 100 GbE
                concurrency=32, per_message_s=1.6e-6)

# On-device HBM (for the '+Engram (HBM)' beyond-paper tier)
HBM = TierSpec("HBM", base_latency_s=0.5e-6, segment_latency_s=40e-9,
               bandwidth_Bps=819e9, concurrency=128)

# Paper §6: "aggregate small data payloads prior to RDMA transmission" —
# one scatter-gather message for the whole batch kills the per-message
# software cost; the price is an indexing round-trip in the base latency.
# ``aggregate=True``: the wave is charged as ONE batched payload through
# ``TierStore`` (single first-access + wire), not a per-row markup.
RDMA_AGG = TierSpec("RDMA-agg", base_latency_s=18e-6,
                    segment_latency_s=2.2e-6, bandwidth_Bps=12.5e9,
                    concurrency=4096, per_message_s=0.0, aggregate=True)

# Cold tier: datacenter NVMe (PCIe4 x4 class — Samsung PM9A3 / Intel
# P5510 datasheets: ~80 us random 4K read, ~6.5 GB/s sequential). Block
# access makes per-row reads ruinous, so the spec is aggregate-only: a
# wave's cold misses go out as ONE scatter-gather payload (TF-Engram's
# batched-read discipline), single device latency + wire time.
SSD = TierSpec("SSD", base_latency_s=20e-6, segment_latency_s=80e-6,
               bandwidth_Bps=6.5e9, concurrency=256, aggregate=True)

TIERS = {t.name: t for t in (DRAM, CXL, RDMA, HBM, RDMA_AGG, SSD)}


def chain_levels(pool: str) -> list[str]:
    """Level names of a ``"CXL+SSD"``-style chain spec, warm-to-cold.
    A plain tier name yields a single-element list."""
    names = [p.strip() for p in pool.split("+") if p.strip()]
    assert names, f"empty pool spec {pool!r}"
    for n in names:
        assert n in TIERS, f"unknown tier {n!r} in pool spec {pool!r}"
    return names


def is_chain(pool) -> bool:
    """True when ``pool`` is a multi-level chain spec ("CXL+SSD")."""
    return isinstance(pool, str) and "+" in pool


def pool_tier(pool: str) -> TierSpec:
    """The warm (first) ``TierSpec`` of a pool spec — what engine-side
    gating (`_pool_mode`, TableFetcher) sees for a chain."""
    return TIERS[chain_levels(pool)[0]]
