from .cache import (FrequencySketch, LRUHotRowCache, PrefixCacheStats,
                    PrefixKVCache, TinyLFUAdmission, WaveAccess)
from .cost import CostRow, breakeven_nodes, cost_table, local_cost, pool_cost
from .kvpool import KVPagePool, KVPoolStats, PoolArbiter, kv_page_keys
from .scheduler import PrefetchScheduler, WaveReport
from .store import (CachedStore, LocalStore, PrefetchHandle, Segments,
                    StoreStats, TableFetcher, TierStore, fetch_layers,
                    keys_to_gid, make_store, segment_bytes, segment_count,
                    segment_keys)
from .tiers import TIERS, TierSpec, pool_tier

__all__ = [
    "CachedStore", "CostRow", "FrequencySketch", "KVPagePool", "KVPoolStats",
    "LRUHotRowCache", "LocalStore", "PoolArbiter", "PrefetchHandle",
    "PrefetchScheduler", "PrefixCacheStats", "PrefixKVCache", "Segments",
    "StoreStats", "TIERS", "TableFetcher", "TierSpec", "TierStore",
    "TinyLFUAdmission", "WaveAccess", "WaveReport", "breakeven_nodes",
    "cost_table", "fetch_layers", "keys_to_gid", "kv_page_keys",
    "local_cost", "make_store", "pool_cost", "pool_tier", "segment_bytes",
    "segment_count", "segment_keys",
]
