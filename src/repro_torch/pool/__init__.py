from .scheduler import PrefetchScheduler, WaveReport
from .store import (LocalStore, PrefetchHandle, Segments, StoreStats,
                    TableFetcher, TierStore, keys_to_gid, make_store,
                    segment_bytes, segment_count, segment_keys)
from .tiers import TIERS, TierSpec, pool_tier

__all__ = [
    "LocalStore", "PrefetchHandle", "PrefetchScheduler", "Segments",
    "StoreStats", "TIERS", "TableFetcher", "TierSpec", "TierStore",
    "WaveReport", "keys_to_gid", "make_store", "pool_tier", "segment_bytes",
    "segment_count", "segment_keys",
]
