from .cache import (FrequencySketch, LRUHotRowCache, PrefixCacheStats,
                    PrefixKVCache, TinyLFUAdmission, WaveAccess)
from .scheduler import PrefetchScheduler, WaveReport
from .store import (CachedStore, LocalStore, PrefetchHandle, Segments,
                    StoreStats, TableFetcher, TierStore, fetch_layers,
                    keys_to_gid, make_store, segment_bytes, segment_count,
                    segment_keys)
from .tiers import TIERS, TierSpec, pool_tier

__all__ = [
    "CachedStore", "FrequencySketch", "LRUHotRowCache", "LocalStore",
    "PrefetchHandle", "PrefetchScheduler", "PrefixCacheStats",
    "PrefixKVCache", "Segments", "StoreStats", "TIERS", "TableFetcher",
    "TierSpec", "TierStore", "TinyLFUAdmission", "WaveAccess", "WaveReport",
    "fetch_layers", "keys_to_gid", "make_store", "pool_tier",
    "segment_bytes", "segment_count", "segment_keys",
]
