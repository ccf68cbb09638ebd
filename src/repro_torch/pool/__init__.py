from .tiers import TIERS, TierSpec, DRAM, CXL, RDMA, HBM, pool_tier
from .feasibility import (Feasibility, ServingPoint, check, check_all_tiers,
                          paper_case_study, prefetch_window_s,
                          required_bandwidth_Bps)
from .simulator import (cached_read_latency_s, latency_sweep,
                        measured_scalability, read_latency_s,
                        rdma_rescue_sweep, scalability_table,
                        throughput_table)
from .cost import CostRow, breakeven_nodes, cost_table, local_cost, pool_cost
from .store import (CachedStore, LocalStore, PrefetchHandle, Segments,
                    StoreStats, TableFetcher, TierStore, fetch_layers,
                    keys_to_gid, make_store, segment_bytes, segment_count,
                    segment_keys)
from .cache import (FrequencySketch, LRUHotRowCache, PrefixCacheStats,
                    PrefixKVCache, SharedCache, SharedCacheStats,
                    TinyLFUAdmission, WaveAccess, zipf_keys)
from .kvpool import KVPagePool, KVPoolStats, PoolArbiter, kv_page_keys
from .scheduler import PrefetchScheduler, SpecWaveReport, WaveReport

__all__ = [
    "CXL", "CachedStore", "CostRow", "DRAM", "Feasibility", "FrequencySketch",
    "HBM", "KVPagePool", "KVPoolStats", "LRUHotRowCache", "LocalStore",
    "PoolArbiter", "PrefetchHandle", "PrefetchScheduler", "PrefixCacheStats",
    "PrefixKVCache", "RDMA", "Segments", "ServingPoint", "SharedCache",
    "SharedCacheStats", "SpecWaveReport", "StoreStats", "TIERS",
    "TableFetcher", "TierSpec", "TierStore", "TinyLFUAdmission",
    "WaveAccess", "WaveReport", "breakeven_nodes", "cached_read_latency_s",
    "check", "check_all_tiers", "cost_table", "fetch_layers", "keys_to_gid",
    "kv_page_keys", "latency_sweep", "local_cost", "make_store",
    "measured_scalability", "paper_case_study", "pool_cost", "pool_tier",
    "prefetch_window_s", "rdma_rescue_sweep", "read_latency_s",
    "required_bandwidth_Bps", "scalability_table", "segment_bytes",
    "segment_count", "segment_keys", "throughput_table",
]
