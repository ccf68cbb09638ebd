"""Double-buffered prefetch scheduler for Engram waves (PyTorch port of
``repro.pool.scheduler``; host code, copied).

The paper's §3.2 window: Engram indices depend only on token IDs, so a
decode wave's retrieval can be issued the moment the previous wave's tokens
are sampled. Per Engram layer k the fetch has ``k`` layers of compute to
hide in; only the overshoot beyond that window stalls the step. Pipeline
depth (``StoreConfig.prefetch_depth``): 0 = synchronous (window 0), 1 = the
paper's prefetch (window = k·t_exec).

One wave = one handle per Engram layer. The speculative-wave methods
(``speculative_wave``/``charge_spec``) belong to the speculation slice
(ROADMAP queue 1, item 4).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Optional, Sequence

from ..configs.base import EngramConfig
from .store import PrefetchHandle


class _SharedFetch:
    """Memoize a fused fetch (one call materializing every layer's rows)
    so each per-layer handle can gather its own slice exactly once."""

    def __init__(self, fetch: Callable[[], Any]):
        self._fetch = fetch
        self._rows = None
        self._done = False

    def layer(self, i: int) -> Callable[[], Any]:
        def get():
            if not self._done:
                self._rows = self._fetch()
                self._done = True
            return self._rows[i]
        return get


def _per_layer_fetches(fetch, n_layers: int):
    """Normalize ``fetch`` into one callable per Engram layer. Accepts a
    list of per-layer callables, or a single fused callable returning the
    per-layer rows list."""
    if fetch is None:
        return [None] * n_layers
    if isinstance(fetch, (list, tuple)):
        assert len(fetch) == n_layers, (len(fetch), n_layers)
        return list(fetch)
    shared = _SharedFetch(fetch)
    return [shared.layer(i) for i in range(n_layers)]


def _split_entry(h: PrefetchHandle) -> tuple:
    """Trace entry for one per-layer handle: ``(hits, misses)``."""
    if h.shards is None:
        return (h.hits, h.misses)
    return (h.hits, h.misses, h.shards)


@dataclasses.dataclass(frozen=True)
class TraceWave:
    """One charged wave on the virtual timeline: its issue time, step
    latency and measured per-layer (hits, misses) split."""
    issued_at_s: float
    step_s: float
    split: tuple                       # ((hits, misses[, shards]), ...)


@dataclasses.dataclass
class WaveReport:
    """Outcome of scheduling one retrieval wave."""
    stall_s: float                     # total overshoot across Engram layers
    latency_s: float                   # slowest per-layer fetch this wave
    hidden: bool                       # every fetch fit its window
    handles: list[PrefetchHandle]
    issued_at_s: float = 0.0           # virtual issue time (clock-bound)

    def gather(self, store) -> list:
        """Materialize the wave's rows through the store — one gather per
        Engram layer (every handle, not just the first)."""
        return [store.gather(h) for h in self.handles]


class PrefetchScheduler:
    """Issues per-layer prefetches through a store and charges window
    overshoot. ``layers`` are the (0-indexed) transformer layers hosting
    Engram; ``n_layers`` the total depth (defines t_exec)."""

    def __init__(self, store, ecfg: EngramConfig, layers: Sequence[int],
                 n_layers: int, prefetch_depth: Optional[int] = None):
        self.store = store
        self.ecfg = ecfg
        self.layers = tuple(layers)
        self.n_layers = max(int(n_layers), 1)
        depth = ecfg.store.prefetch_depth if prefetch_depth is None \
            else prefetch_depth
        assert depth in (0, 1), \
            f"prefetch_depth must be 0 or 1 (got {depth}); windows beyond " \
            "one step come from real speculation, not a config knob"
        self.depth = depth
        # every charged wave, bounded to the most recent window
        self.trace: "deque[TraceWave]" = deque(maxlen=65536)

    def window_s(self, layer_k: int, step_latency_s: float) -> float:
        """Prefetch window for Engram layer ``layer_k`` at the given step
        latency: the compute of layers 0..k-1 the fetch can hide in."""
        if self.depth == 0:
            return 0.0
        return layer_k * step_latency_s / self.n_layers

    def step(self, keys_per_layer, step_latency_s: float,
             fetch=None) -> WaveReport:
        """Schedule one wave.

        ``keys_per_layer``: one packed-key array per Engram layer (measured
        mode), or a bare token count applied to every layer (analytic
        mode). ``fetch`` materializes the wave's rows on ``gather`` —
        either one callable per layer or a single fused callable returning
        the per-layer rows list."""
        if not isinstance(keys_per_layer, (list, tuple)):
            keys_per_layer = [keys_per_layer] * len(self.layers)
        assert len(keys_per_layer) == len(self.layers), \
            (len(keys_per_layer), self.layers)
        fetches = _per_layer_fetches(fetch, len(self.layers))
        stall = 0.0
        lat_max = 0.0
        handles = []
        for i, (k, keys) in enumerate(zip(self.layers, keys_per_layer)):
            h = self.store.prefetch(keys, fetch=fetches[i])
            handles.append(h)
            stall += max(0.0, h.latency_s - self.window_s(k, step_latency_s))
            lat_max = max(lat_max, h.latency_s)
        hidden = stall == 0.0
        self.store.note_wave(stall, hidden)
        issued = handles[0].issued_at_s if handles else 0.0
        self.trace.append(TraceWave(
            issued_at_s=issued, step_s=step_latency_s,
            split=tuple(_split_entry(h) for h in handles)))
        return WaveReport(stall_s=stall, latency_s=lat_max, hidden=hidden,
                          handles=handles, issued_at_s=issued)
