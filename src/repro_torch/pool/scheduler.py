"""Double-buffered prefetch scheduler for Engram waves (PyTorch port of
``repro.pool.scheduler``; host code, copied).

The paper's §3.2 window: Engram indices depend only on token IDs, so a
decode wave's retrieval can be issued the moment the previous wave's tokens
are sampled. Per Engram layer k the fetch has ``k`` layers of compute to
hide in; only the overshoot beyond that window stalls the step. Pipeline
depth (``StoreConfig.prefetch_depth``): 0 = synchronous (window 0), 1 = the
paper's prefetch (window = k·t_exec).

Deeper windows are not a knob: they come from real speculative decoding
(``speculative_wave``). A speculated wave knows the token IDs of every
position of its block at wave start, so position j's fetch is issued j
token slots before it is consumed: its window is ``k·t_exec + j·t_tok``
(``t_tok`` = the verify pass's per-position slice). After verification
``charge_spec`` settles the wave: only the positions that executed and
survived (the accepted prefix plus the correction token) can stall; the
rejected tail's segments count as wasted prefetch. These windows price
the pool tier on the emulated clock; on the device the engine gathers a
wave's block in one launch at wave start.

One wave = one handle per Engram layer.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Optional, Sequence

import numpy as np

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


@dataclasses.dataclass(frozen=True)
class SpecTraceWave:
    """One charged *speculative* wave: the per-position, per-layer splits
    the block prefetched, the surviving-position count verification
    settled on, and the pipelined early-issue credit."""
    issued_at_s: float
    step_s: float
    splits: tuple                      # [position][layer] split entries
    n_keep: int
    early_issue_s: float


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


@dataclasses.dataclass
class SpecWaveReport:
    """An issued (not yet charged) speculative wave: per-position,
    per-layer prefetches for the whole proposed block. ``charge_spec``
    settles it once verification has decided the accepted prefix."""
    handles: list[list[PrefetchHandle]]    # [position][layer]
    overshoot_s: list[float]               # per position, summed over layers
    n_segments: list[int]                  # per position
    latency_s: float                       # slowest single fetch
    step_s: float                          # verify-pass latency estimate
    layer_frac: float                      # first Engram layer / n_layers
    charged: bool = False
    # optional packed per-slot streams: row-sorted (n_slots, m, K) keys
    # (all layers concatenated; layer offsets keep them distinct),
    # per-(slot, position) unique counts and the slot ids along axis 0
    slot_sorted: Optional[np.ndarray] = None
    slot_uniq: Optional[np.ndarray] = None
    slot_ids: Optional[list] = None
    # extra window credit in the cost model: the block's fetch is priced
    # as issued this long before wave start (pipelined proposals book it
    # on the clock link during the previous verify)
    early_issue_s: float = 0.0

    @property
    def n_positions(self) -> int:
        return len(self.handles)


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
        self.trace: "deque[TraceWave | SpecTraceWave]" = deque(maxlen=65536)

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

    # ------------------------------------------------------- speculation

    def speculative_wave(self, keys_by_pos, step_latency_s: float,
                         slot_keys=None, slot_ids=None,
                         early_issue_s: float = 0.0) -> SpecWaveReport:
        """Issue the prefetch for a whole speculated block.

        ``keys_by_pos``: per block position (position 0 = the pending
        token, 1..k = the drafts) a list of one packed-key array per Engram
        layer. Position j's fetch is priced as issued at wave start but
        consumed j positions into the verify pass, so its window gains
        ``j · t_tok`` on top of the per-layer window. Only the cost is scheduled: the engine
        materialises the block's rows itself, in one fused gather (the
        reference's ``fetch`` argument, which no caller passes, is not
        ported).

        Per-slot attribution for ``charge_spec`` (counting only; the fused
        ``keys_by_pos`` stream is what is fetched and priced): ``slot_keys``
        + ``slot_ids``, one ``(n_slots, m, K)`` int64 array of every live
        slot's per-position keys (all layers concatenated) and the slot ids
        along axis 0, settled by one sort. Without them ``charge_spec``
        splits by the batch-max surviving count.

        ``early_issue_s``: price the block's fetches as issued this long
        before wave start (``SpecConfig.pipeline``), a credit to every
        position. The credit is the cost model's: it prices the booking the
        pipelined proposals made on the clock link, not a device transfer.

        Stats are NOT charged here: call ``charge_spec`` after
        verification."""
        m = len(keys_by_pos)
        assert m >= 1, "speculative wave needs at least the pending token"
        t_tok = step_latency_s / m
        handles: list[list[PrefetchHandle]] = []
        overshoot: list[float] = []
        n_segments: list[int] = []
        lat_max = 0.0
        for j, keys_per_layer in enumerate(keys_by_pos):
            assert len(keys_per_layer) == len(self.layers)
            per_layer = []
            over = 0.0
            nseg = 0
            for k, keys in zip(self.layers, keys_per_layer):
                h = self.store.prefetch(keys)
                per_layer.append(h)
                window = (self.window_s(k, step_latency_s) + j * t_tok
                          + early_issue_s)
                over += max(0.0, h.latency_s - window)
                lat_max = max(lat_max, h.latency_s)
                nseg += h.n_segments
            handles.append(per_layer)
            overshoot.append(over)
            n_segments.append(nseg)
        slot_sorted = uniq_counts = ids = None
        if slot_keys is not None:
            sk = np.asarray(slot_keys, np.int64)
            assert sk.ndim == 3 and sk.shape[1] == m, (sk.shape, m)
            assert slot_ids is not None and len(slot_ids) == sk.shape[0]
            # one sort over the (slot, position) grid; unique counts come
            # from the sorted-neighbour diff
            slot_sorted = np.sort(sk, axis=-1)
            uniq_counts = 1 + (slot_sorted[..., 1:]
                               != slot_sorted[..., :-1]).sum(axis=-1)
            ids = list(slot_ids)
        return SpecWaveReport(handles=handles, overshoot_s=overshoot,
                              n_segments=n_segments, latency_s=lat_max,
                              step_s=step_latency_s,
                              layer_frac=min(self.layers) / self.n_layers,
                              slot_sorted=slot_sorted,
                              slot_uniq=uniq_counts, slot_ids=ids,
                              early_issue_s=early_issue_s)

    def charge_spec(self, report: SpecWaveReport, n_keep: int,
                    tokens_emitted: int,
                    n_keep_by_slot: Optional[dict] = None) -> float:
        """Settle a speculative wave after verification.

        ``n_keep``: positions that executed and survived (accepted drafts
        + 1, the batch max). Only those can stall the wave; the rejected
        tail's rows are charged as wasted prefetch. All positions' fetches
        were issued together at wave start with staggered consumption, so
        the wave's extra wait is the *worst* surviving overshoot.

        ``tokens_emitted``: the wave's emitted tokens summed over slots.
        ``n_keep_by_slot``: per-slot surviving position counts; with the
        report's per-slot keys, position j's accepted keys are the union
        over slots still alive there, and the rest of the position's fused
        stream is wasted (``StoreStats.slot_accepted``/``slot_wasted`` keep
        the per-slot attribution, which double-counts keys two slots
        share). The stall stays the batch-max formula.

        Returns the stall and records the wave's window depth in
        emitted-token steps, as the cost model prices it: the deepest
        accepted position's lead time (from the step estimate ``step_s``
        and ``early_issue_s``) over the per-token step time
        (``step_s / n_keep``)."""
        assert not report.charged, "speculative wave charged twice"
        report.charged = True
        m = report.n_positions
        n_keep = max(1, min(int(n_keep), m))
        stall = max(report.overshoot_s[:n_keep])
        issued = report.handles[0][0].issued_at_s if report.handles[0] \
            else 0.0
        self.trace.append(SpecTraceWave(
            issued_at_s=issued, step_s=report.step_s,
            splits=tuple(tuple(_split_entry(h) for h in per_layer)
                         for per_layer in report.handles),
            n_keep=n_keep, early_issue_s=report.early_issue_s))
        per_slot = None
        if n_keep_by_slot is not None and report.slot_sorted is not None:
            keeps = np.asarray([max(1, min(int(n_keep_by_slot[s]), m))
                                for s in report.slot_ids])
            acc = np.asarray([report.slot_uniq[a, :kp].sum()
                              for a, kp in enumerate(keeps)])
            tot = report.slot_uniq.sum(axis=1)
            per_slot = {s: (int(acc[a]), int(tot[a] - acc[a]))
                        for a, s in enumerate(report.slot_ids)}
            accepted_seg = 0
            for j in range(m):
                alive = keeps > j
                if alive.any():
                    accepted_seg += int(np.unique(
                        report.slot_sorted[alive, j, :]).size)
            wasted_seg = sum(report.n_segments) - accepted_seg
        else:
            accepted_seg = sum(report.n_segments[:n_keep])
            wasted_seg = sum(report.n_segments[n_keep:])
        # window depth in emitted-token steps; a pipelined block is
        # credited a verify pass of lead time (its clock-link booking)
        window_wall = (report.layer_frac * report.step_s
                       + (n_keep - 1) * report.step_s / m
                       + report.early_issue_s)
        t_emit = report.step_s / n_keep
        depth_steps = window_wall / t_emit if t_emit > 0 else 0.0
        self.store.note_spec_wave(stall, stall == 0.0,
                                  tokens=int(tokens_emitted),
                                  depth_steps=depth_steps,
                                  accepted_segments=accepted_seg,
                                  wasted_segments=wasted_seg,
                                  per_slot=per_slot)
        return stall
