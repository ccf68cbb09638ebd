"""§5.4 capital-expenditure model (Tables 4/5) + fleet bandwidth budgets.

Local-DRAM provisioning: every node holds the full Engram table.
CXL pool: one shared copy + switch + per-node adapters + controllers.

This module also owns the *provisioned-bandwidth* side of the contention
model (serving/clock.py charges time against it): a pooled fleet reads
through per-node adapters into one shared switch, so the effective
bandwidth a replica sees is the budget split — the same arithmetic Table 3
measures and ``pool/simulator.scalability_table`` evaluates analytically.

A verbatim copy of ``repro.pool.cost``: the PyTorch port imports nothing
of the JAX package.
"""
from __future__ import annotations

import dataclasses

# XConn XC50256-class switch: the pool-side aggregate budget every DP
# replica's reads ultimately share (paper §2.2 / Table 3 setup).
CXL_SWITCH_BW_Bps = 512e9


def contended_bandwidth_Bps(adapter_Bps: float, readers: int,
                            nnodes: int = 1,
                            switch_Bps: float = CXL_SWITCH_BW_Bps,
                            pool_nodes=None) -> float:
    """Effective per-reader bandwidth for ``readers`` replicas spread over
    ``nnodes`` hosts: replicas on one host split that host's adapter,
    every replica splits the shared switch, and the *pool* side supplies
    at most ``pool_nodes`` adapters' worth of aggregate bandwidth (the
    sharded fabric's M nodes — ``pool/fabric.py`` is the charged twin of
    this budget). ``pool_nodes=None`` assumes a pool node per reader host
    (symmetric provisioning; the pool side then never binds, which is the
    historical behaviour). The min of the three budgets is what a
    reader's wire time is priced against."""
    readers = max(1, int(readers))
    nnodes = max(1, int(nnodes))
    per_node = max(1, -(-readers // nnodes))
    pool = nnodes if pool_nodes is None else max(1, int(pool_nodes))
    return min(adapter_Bps / per_node,
               adapter_Bps * pool / readers,
               switch_Bps / readers)


def contended_tier(tier, readers: int, nnodes: int = 1,
                   switch_Bps: float = CXL_SWITCH_BW_Bps,
                   pool_nodes=None):
    """``TierSpec`` with its bandwidth replaced by the contended budget —
    the analytic twin of the clock's measured link queueing."""
    return dataclasses.replace(
        tier, bandwidth_Bps=contended_bandwidth_Bps(
            tier.bandwidth_Bps, readers, nnodes, switch_Bps, pool_nodes))


DEFAULT_PRICES = {
    "dram_per_gb": 15.00,
    "cxl_switch": 5800.00,
    "cxl_adapter": 210.00,       # per host node
    "cxl_controller": 300.00,    # per host node (paired in the pool)
    "ssd_per_gb": 0.08,          # datacenter NVMe (PM9A3/P5510 street)
}


@dataclasses.dataclass(frozen=True)
class CostRow:
    engram_gb: float
    nodes: int
    local_usd: float
    pool_usd: float

    @property
    def savings_usd(self) -> float:
        return self.local_usd - self.pool_usd


def local_cost(engram_gb: float, nodes: int, prices=DEFAULT_PRICES) -> float:
    return prices["dram_per_gb"] * engram_gb * nodes


def pool_cost(engram_gb: float, nodes: int, prices=DEFAULT_PRICES) -> float:
    return (prices["cxl_switch"]
            + nodes * (prices["cxl_adapter"] + prices["cxl_controller"])
            + prices["dram_per_gb"] * engram_gb)


def cost_table(engram_gbs=(200.0, 800.0), node_counts=(2, 4, 8, 16),
               prices=DEFAULT_PRICES) -> list[CostRow]:
    """Paper Table 5: 100B table = 200 GB, 400B table = 800 GB."""
    rows = []
    for gb in engram_gbs:
        for n in node_counts:
            rows.append(CostRow(gb, n, local_cost(gb, n, prices),
                                pool_cost(gb, n, prices)))
    return rows


def chain_cost(dram_gb: float, cxl_gb: float, ssd_gb: float,
               nodes: int = 1, prices=DEFAULT_PRICES) -> float:
    """Capital cost of a three-level placement (pool/tierchain.py): a
    private DRAM front per host node, one pooled CXL partition behind the
    switch (fixed fabric + pooled DRAM, the ``pool_cost`` structure), and
    SSD cold capacity at flash $/GB. The placement solver's objective."""
    return (prices["dram_per_gb"] * dram_gb * nodes
            + prices["cxl_switch"]
            + nodes * (prices["cxl_adapter"] + prices["cxl_controller"])
            + prices["dram_per_gb"] * cxl_gb
            + prices["ssd_per_gb"] * ssd_gb)


def breakeven_nodes(engram_gb: float, prices=DEFAULT_PRICES) -> float:
    """Nodes beyond which the pool is cheaper."""
    fixed = prices["cxl_switch"] + prices["dram_per_gb"] * engram_gb
    per_node_pool = prices["cxl_adapter"] + prices["cxl_controller"]
    per_node_local = prices["dram_per_gb"] * engram_gb
    if per_node_local <= per_node_pool:
        return float("inf")
    return fixed / (per_node_local - per_node_pool)
