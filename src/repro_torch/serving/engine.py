"""Continuous-batching serving engine with Engram prefetch (PyTorch port of
``repro.serving.engine``).

The port has these of the reference engine's serving paths:

* monolithic batched admission (one multi-slot prefill per prompt bucket);
* chunked admission (``prefill_chunk``): a request claims a slot as a
  ``_PrefillJob`` and its prompt enters the KV cache ``prefill_chunk``
  tokens per ``_chunk_wave`` (C unrolled, gated decode steps), between
  the running slots' decode waves, which then run gated so the jobs'
  positions do not advance under them; with a ``PrefixKVCache``
  (``prefix_cache``), completed chunk boundaries are spilled to the host
  and later prompts sharing the prefix restore them instead of computing;
* greedy continuous-batched decode waves over ``max_batch`` slots;
* speculation (``spec``, a ``SpecConfig``): each wave a proposer drafts k
  tokens per live slot, the Engram prefetch covers the whole speculated
  window (in pool mode one K1 launch over every (slot, position, table)
  row of every Engram layer), a batched verifier scores the block in one
  pass of m = k + 1 unrolled decode steps, and rejected tails are rolled
  back per slot (``slots.rollback_state``). With ``SpecConfig.pipeline``
  the proposer drafts wave N+1's block while wave N's verify runs on the
  device (the host is not blocked until the verdict is read), packs its
  keys on the host and books its prefetch on the pool's clock link, so
  the cost model prices a surviving prediction's fetch as issued a whole
  verify pass early. The block's K1 gather itself still runs at the start
  of the wave that verifies it.

The pool tier's cost is charged through the ``PrefetchScheduler`` and the
store (a ``CachedStore`` when the config asks for a hot-row cache); prefix
snapshots are booked as byte transfers on the pool tier's clock link. With
a pool tier (``pool="CXL"``...) every decode wave, gated or not,
materialises every Engram layer's rows in one engram_gather (K1) launch
(``fetch_layers``), as does every speculative wave for its whole block;
chunk waves and prefill groups retrieve by plain indexing. Every forward
fuses the rows through the gated_fuse kernel (K2).

Table placement: with ``RunFlags(engram_strategy="pooled_host")`` (or a
config whose strategy it is) on the card the Engram tables live in pinned,
device-mapped host memory (``models.params.table_memory_for`` decides;
``init_params(table_memory=table_memory_for(cfg, flags))`` draws them
there, ``tables_to_host`` moves them), and every retrieval, pool-mode
waves, prefill groups, chunk waves and ``pool=None`` decode alike, is a K1
launch that reads its rows in place over the host link; the weights and
KV stay on the card. The engine checks that placement and strategy agree
and raises otherwise.

Single-sync waves, as in the reference: the host reads the device through
``_host`` only, once per admission group (first tokens | the group's
packed prompt keys), once per chunk wave (sampled tokens | the chunk's
packed keys), once per steady decode wave (sampled tokens | the next
wave's packed keys) and twice per speculative wave (the packed (B, m, L,
T) block keys, then the fused (B, m+1) verdict [preds | n_accept]); a
speculative wave whose every live slot's pipelined prediction survived
packed its keys on the host (``hashing.host_block_keys``, bit-equal) and
reads only the verdict. A prefix spill's snapshot and a preemption's KV
snapshot are one more counted read each, and the first decode wave after
a restore reads its keys separately, as after an admission.
``stats.d2h_pulls`` counts those reads. Nothing else on a wave
synchronises (a draft-model proposer's one read per proposal is counted
in its own ``reads``): host arrays go up through pinned, non-blocking
copies (``device.upload``). The reads suspend PyTorch's CUDA sync debug
mode (``device.sync_allowed``), so a caller can run waves under
``torch.cuda.set_sync_debug_mode`` and see any other sync.

Overload (``slo_policy``, an ``OverloadPolicy``): admission runs
priority-first and deadline-ordered over the SLO classes, and a queued
request may preempt a strictly lower-priority running slot. The victim's
KV is copied to the host (``slots.extract_prefix``), parked in a
``KVPagePool`` and booked on the pool link; a later admission pass claims
a free slot for it and books the fetch, and the pass after that uploads
the snapshot (``slots.restore_prefix``), writes it into the slot and
resumes decode, bit-identically: a slot's decode row depends neither on
the other rows nor on its index. ``idle_spill_tokens`` parks long-running
slots the same way when the queue outgrows the free slots, with no SLO
policy. A ``PoolArbiter`` meters that KV traffic against the Engram rows
on the link and in the hot-row cache.

Storage: ``pool="CXL+SSD"`` serves over a ``TierChain`` and
``fabric``/``fabric_nodes`` over a ``PoolFabric``; both change only what
a wave costs on the clock, not how its rows are gathered.

Fleet options (``serving.router.Router``): ``store`` mounts a store built
outside (a ``CachedStore`` over a ``SharedCache`` view), ``clock`` a fleet
``VirtualClock``, ``name`` labels the replica, ``rid_start`` offsets its
request ids and ``step_latency_hint_s`` seeds the step estimate.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from .. import trace
from ..configs.base import ModelConfig, SpecConfig
from ..core.engram import retrieve
from ..core.hashing import (block_engram_indices, block_engram_keys,
                            decode_engram_indices, decode_engram_keys,
                            engram_indices, host_block_keys,
                            pack_segment_keys, prefix_chain_keys)
from ..device import resolve_device, sync_allowed, upload
from ..kernels.engram_gather.host import is_mapped
from ..models.layers import with_f32_head
from ..models.model import (build_chunk_prefill, build_decode_step,
                            build_prefill_step, init_decode_state,
                            init_params)
from ..models.params import table_memory_for, tree_map
from ..models.transformer import RunFlags
from ..pool.kvpool import KVPagePool, PoolArbiter
from ..pool.scheduler import PrefetchScheduler
from ..pool.store import (TableFetcher, fetch_layers, make_store,
                          segment_bytes)
from ..pool.tiers import pool_tier
from .clock import VirtualClock
from .slo import OverloadPolicy
from .slots import (extract_prefix, gate_state, reset_slot, restore_prefix,
                    select_slots, update_slots)

@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    submitted_s: float = 0.0
    first_token_s: float = 0.0
    done_s: float = 0.0
    status: str = "queued"     # queued | running | preempted | done |
    #                            cancelled | deferred | shed
    klass: str = "uniform"           # workload traffic class
    slo: str = "batch"               # SLO class (serving/slo.py)
    preemptions: int = 0             # times this request was preempted
    # decoded-token count at the last idle spill: a restored slot must
    # decode another ``idle_spill_tokens`` past it before it may park again
    spill_mark: int = 0
    # virtual-clock lifecycle stamps (serving/clock.py)
    submitted_v: float = 0.0
    first_token_v: float = 0.0
    done_v: float = 0.0
    stamps: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _PrefillJob:
    """One request's chunked-prefill progress: a slot is held from
    admission, and each chunk wave advances ``pos`` by up to
    ``prefill_chunk`` prompt tokens until the prompt is in the KV cache
    and the slot goes live. ``restore`` is a pending prefix-cache snapshot
    (consumed at the job's first chunk wave); ``resv`` holds the clock-link
    bookings outstanding between waves (the prefix fetch, the next chunk's
    Engram prefetch), refunded newest-first at the next wave or on a
    mid-prefill ``cancel()``."""
    req: Request
    slot: int
    pos: int = 0                     # prompt tokens already in the KV cache
    restore: object = None           # pending prefix snapshot (host tree)
    restore_bytes: int = 0           # snapshot bytes (the tier-fetch charge)
    chain: list = dataclasses.field(default_factory=list)  # block chain keys
    resv: list = dataclasses.field(default_factory=list)   # queued bookings
    started: bool = False


@dataclasses.dataclass
class _SpilledReq:
    """One preempted request's engine-side record (the snapshot is parked
    in the ``KVPagePool`` too). ``phase="spilled"``: the request holds no
    slot and its spill's write-behind bookings sit in ``resv`` (refunded
    newest-first on cancel); a restore claims a free slot
    (``phase="restoring"``, the fetch booked into ``resv``) and the next
    admission pass completes it: refund and re-price at that wave's
    position, write the snapshot into the slot, go live."""
    req: Request
    nbytes: int                      # snapshot bytes (the spill transfer)
    pages: tuple                     # kv_page_keys over the decoded stream
    n_tokens: int                    # KV positions the snapshot carries
    last_token: int                  # the next decode input
    snapshot: object = None          # extract_prefix tree of CPU tensors
    slot: int = -1                   # claimed slot (phase "restoring")
    phase: str = "spilled"           # spilled | restoring
    resv: list = dataclasses.field(default_factory=list)   # queued bookings


def _rate(num: float, den: float) -> float:
    """Division-safe rate: 0.0 for a zero, NaN or negative denominator."""
    den = float(den)
    if not (den > 0.0):
        return 0.0
    return float(num) / den


@dataclasses.dataclass
class EngineStats:
    decode_steps: int = 0
    prefills: int = 0
    generated_tokens: int = 0
    wall_s: float = 0.0
    stall_s: float = 0.0
    emu_time_s: float = 0.0          # accumulated emulated step + stall time
    v_time_s: float = 0.0            # replica cursor position (clock time)
    ttft_v_sum: float = 0.0          # summed virtual submit -> first token
    requests_completed: int = 0
    requests_cancelled: int = 0
    ttft_s_sum: float = 0.0          # summed submit -> first-token latency
    d2h_pulls: int = 0               # device->host reads through _host()
    prefill_waves: int = 0           # admission groups and chunk waves
    prefill_tokens: int = 0          # useful prompt tokens computed
    prefill_pad_tokens: int = 0      # executed right-pad / chunk-tail steps
    prefill_tokens_restored: int = 0 # prompt tokens restored from the cache
    prefix_lookup_blocks: int = 0    # whole prompt blocks eligible for reuse
    prefix_hit_blocks: int = 0       # blocks served by the prefix cache
    spec_waves: int = 0              # verify waves run
    proposed_tokens: int = 0         # drafts proposed (k per live slot-wave)
    accepted_tokens: int = 0         # drafts that survived verification
    pipelined_hits: int = 0          # slot-waves served by a pipelined block
    pipelined_misses: int = 0        # predictions invalidated by verification
    # proposer quality per workload class: {klass: {proposed, accepted}}
    spec_by_class: dict = dataclasses.field(default_factory=dict)
    preemptions: int = 0             # running slots preempted under pressure
    resumes: int = 0                 # preempted requests restored + resumed
    kv_spill_bytes: int = 0          # KV bytes paged out to the pool tier
    kv_restore_bytes: int = 0        # KV bytes fetched back on resume
    kv_spill_pages: int = 0          # fixed-size pages spilled
    idle_spills: int = 0             # long-context spills (no preemption)

    @property
    def tokens_per_s(self) -> float:
        return _rate(self.generated_tokens, self.wall_s)

    @property
    def tokens_per_s_emulated(self) -> float:
        """Throughput at the emulated operating point (paper-scale steps)."""
        return _rate(self.generated_tokens, self.emu_time_s)

    @property
    def acceptance_rate(self) -> float:
        return _rate(self.accepted_tokens, self.proposed_tokens)

    @property
    def pipeline_hit_rate(self) -> float:
        """How often the proposer's during-verify draft for wave N+1
        survived wave N's verification (``SpecConfig.pipeline``)."""
        return _rate(self.pipelined_hits,
                     self.pipelined_hits + self.pipelined_misses)

    @property
    def tokens_per_step(self) -> float:
        return _rate(self.generated_tokens, self.decode_steps)

    @property
    def pad_row_fraction(self) -> float:
        """Fraction of executed prefill token positions that were padding
        (right-pad positions of admission groups, chunk-tail steps)."""
        return _rate(self.prefill_pad_tokens,
                     self.prefill_pad_tokens + self.prefill_tokens)

    @property
    def prefix_hit_rate(self) -> float:
        """Block-granular prefix-cache hit rate over admitted prompts."""
        return _rate(self.prefix_hit_blocks, self.prefix_lookup_blocks)

    @property
    def prefill_waves_per_request(self) -> float:
        return _rate(self.prefill_waves, self.prefills)

    @property
    def prefill_compute_tokens(self) -> float:
        """Executed prefill token positions (useful + pad); restored prefix
        tokens cost a tier fetch, not a forward pass, so are not in it."""
        return float(self.prefill_tokens + self.prefill_pad_tokens)

    @property
    def requests_per_s(self) -> float:
        return _rate(self.requests_completed, self.wall_s)

    @property
    def mean_ttft_s(self) -> float:
        """Mean submit -> first-token latency over admitted requests."""
        return _rate(self.ttft_s_sum, self.prefills)

    @property
    def mean_ttft_v(self) -> float:
        return _rate(self.ttft_v_sum, self.prefills)

    def merge(self, other: "EngineStats") -> "EngineStats":
        """Aggregate another replica's counters into this one (the router's
        fleet view). Counters add; the clock quantities ``wall_s``,
        ``emu_time_s`` and ``v_time_s`` take the max, since replicas model
        parallel hardware sharing one clock, not a serial loop (on one card
        the router runs their waves one after another, so a merged
        ``tokens_per_s`` is the model's number, not the card's). Dict
        fields (per-class speculation) merge key by key."""
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            if f.name in ("wall_s", "emu_time_s", "v_time_s"):
                setattr(self, f.name, max(a, b))
            elif isinstance(a, dict):
                for k, sub in b.items():
                    tgt = a.setdefault(k, {})
                    for kk, vv in sub.items():
                        tgt[kk] = tgt.get(kk, 0) + vv
            else:
                setattr(self, f.name, a + b)
        return self


def _bucket(n: int, bucket: int) -> int:
    return max(bucket, -(-n // bucket) * bucket)


class Engine:
    def __init__(self, cfg: ModelConfig, *, params=None,
                 flags: RunFlags = RunFlags(), max_batch: int = 8,
                 max_len: int = 512, prompt_bucket: int = 32,
                 pool: Optional[str] = None, seed: int = 0,
                 step_latency_hint_s: Optional[float] = None,
                 emulate_step_s: Optional[float] = None,
                 emu_prefill_scaled: bool = False,
                 prefill_chunk: Optional[int] = None, prefix_cache=None,
                 spec: Optional[SpecConfig] = None, proposer=None,
                 fabric=None, fabric_nodes: Optional[int] = None,
                 slo_policy: Optional[OverloadPolicy] = None,
                 kv_pool: Optional[KVPagePool] = None,
                 arbiter: Optional[PoolArbiter] = None,
                 idle_spill_tokens: Optional[int] = None,
                 store=None, name: Optional[str] = None,
                 rid_start: int = 0, clock: Optional[VirtualClock] = None,
                 device=None):
        """``device``: where the model runs — the CUDA device unless the
        caller passes ``device="cpu"``; with no CUDA device and no
        ``device`` this raises. ``params``: a parameter tree on that device
        (default: ``init_params`` with ``table_memory_for(cfg, flags)``, the
        Engram tables where the strategy puts them).

        ``emulate_step_s``: evaluate pool stalls at a production operating
        point instead of this host's step times (stalls are accounted in
        ``emu_time_s`` rather than slept), as in the reference.
        ``step_latency_hint_s`` seeds the step-time estimate the prefetch
        windows use before the first wave is timed.

        Fleet options (the router passes them): ``store``, a store built
        outside (a ``CachedStore`` over a ``SharedCache`` view) instead of
        the config's; ``clock``, the fleet ``VirtualClock`` on which every
        replica's waves and transfers interleave (a lone engine gets a
        private one); ``name``, the replica label of the router's stats;
        ``rid_start``, the base of this engine's request ids (the router
        gives each replica a disjoint range).

        ``prefill_chunk``: chunked admission (see the module docstring);
        None keeps monolithic admission. ``prefix_cache``: a
        ``pool.cache.PrefixKVCache`` whose ``block_tokens`` equal
        ``prefill_chunk`` (snapshots exist only at chunk boundaries).

        ``spec``: speculative decoding (default ``cfg.spec``; see the
        module docstring); it refuses ``prefill_chunk``, since the verify
        pass is not gated. ``proposer``: a draft proposer to use instead of
        the one ``spec.proposer`` names (tests and benches).

        ``fabric``/``fabric_nodes``: back the pool with a sharded
        ``pool.fabric.PoolFabric``, a built one or a node count for the
        engine to build on its clock (needs a pool tier; a chain spec
        shards its warm level).

        ``slo_policy``: an ``OverloadPolicy`` (see the module docstring);
        with ``policy.preempt`` the KV of preempted slots parks in
        ``kv_pool`` (default: a ``KVPagePool`` of the policy's budget).
        ``idle_spill_tokens``: park a running slot once it has decoded
        this many tokens since admission or its last spill, whenever the
        queue outgrows the free slots (default pool 1 GiB, 8-token pages).
        Neither composes with ``spec``, and idle spill needs monolithic
        admission. ``arbiter``: a ``PoolArbiter`` that books KV transfers
        page by page and caps their hot-row cache occupancy."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.name = name
        self.flags = flags
        self.max_batch = max_batch
        self.max_len = max_len
        self.prompt_bucket = prompt_bucket
        self.pool = pool_tier(pool) if pool else None
        self.emulate_step_s = emulate_step_s
        self.emu_prefill_scaled = bool(emu_prefill_scaled)
        self.clock = clock if clock is not None else VirtualClock()
        self.cursor = self.clock.cursor(name if name else "engine")
        if params is None:
            params = init_params(cfg, seed, self.device,
                                 table_memory=table_memory_for(cfg, flags))
        if params["embed"]["w"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed']['w'].device}, "
                             f"the engine runs on {self.device}")
        # the engine never differentiates: leaves a trainer holds with
        # requires_grad are read through detached views of their storage,
        # so the trainer's in-place updates are what it serves
        params = tree_map(lambda t: t.detach() if t.requires_grad else t,
                          params)
        self.params = with_f32_head(params)
        self.has_engram = bool(cfg.engram_layers()) and "engram" in params
        self._n_eng = len(cfg.engram_layers())
        if self.has_engram:
            self._check_tables()

        self.store = None
        self.scheduler = None
        self._fetchers = None
        self.fabric = fabric
        if self.has_engram:
            # link contention only at the emulated operating point (see the
            # reference engine: real-mode cursors mirror host wall time)
            link_clock = self.clock if emulate_step_s is not None else None
            if store is None and fabric is None and fabric_nodes:
                if pool is None:
                    raise ValueError("fabric_nodes needs a pooled tier")
                from ..pool.fabric import PoolFabric
                # a chain spec shards its warm level over the fabric
                self.fabric = PoolFabric(cfg.engram, int(fabric_nodes),
                                         tier=self.pool, clock=link_clock)
            self.store = store if store is not None \
                else make_store(cfg.engram, pool, clock=link_clock,
                                fabric=self.fabric)
            self.store.bind_cursor(self.cursor)
            self.scheduler = PrefetchScheduler(self.store, cfg.engram,
                                               layers=cfg.engram_layers(),
                                               n_layers=cfg.n_layers)
            if self.pool is not None:
                # decode rows are materialised by the engram_gather kernel
                self._fetchers = [
                    TableFetcher(cfg.engram,
                                 self.params["engram"]["layers"][j]["tables"],
                                 device=self.device)
                    for j in range(self._n_eng)]
        self._pool_mode = self.pool is not None and self.has_engram
        self._prefill_fn = build_prefill_step(cfg, flags, max_len=max_len)
        self._decode_fn = build_decode_step(cfg, flags)
        self._decode_ext_fn = build_decode_step(cfg, flags,
                                                external_rows=True) \
            if self.has_engram else None
        # chunked admission (None: monolithic groups)
        self.prefill_chunk = int(prefill_chunk) if prefill_chunk else None
        self.prefix_cache = prefix_cache
        self._prefill_jobs: dict[int, _PrefillJob] = {}
        if prefix_cache is not None:
            if self.prefill_chunk is None:
                raise ValueError("prefix_cache needs prefill_chunk "
                                 "(snapshots live at chunk boundaries)")
            if prefix_cache.block_tokens != self.prefill_chunk:
                raise ValueError(
                    f"prefix_cache.block_tokens {prefix_cache.block_tokens}"
                    f" != prefill_chunk {self.prefill_chunk}")
        if self.prefill_chunk is not None:
            self._chunk_core = build_chunk_prefill(cfg, flags)

        spec_cfg = spec if spec is not None else cfg.spec
        self.spec = spec_cfg if (spec_cfg is not None and spec_cfg.enabled) \
            else None
        self.proposer = None
        # slot -> (base_len, expected_tail, next_drafts, host_keys, resv):
        # the pipelined prediction for the slot's next wave, (pool mode)
        # its host-packed keys and the clock-link booking of its prefetch
        self._pipelined: dict[int, tuple] = {}
        if self.spec is not None:
            if self.prefill_chunk is not None:
                raise ValueError("chunked prefill does not compose with "
                                 "speculative decoding (the verify pass is "
                                 "not gated)")
            from ..spec import build_verifier, make_proposer
            self.proposer = proposer if proposer is not None else \
                make_proposer(cfg, self.spec, flags=flags, seed=seed,
                              device=self.device)
            # with Engram the wave hands the verifier the block's rows
            self._verify = self._fuse_verdict(build_verifier(
                cfg, flags, external_rows=self.has_engram))

        self.state = init_decode_state(cfg, flags, max_batch, max_len,
                                       self.device)
        self.slots: list[Optional[Request]] = [None] * max_batch
        self.tokens = torch.zeros((max_batch,), dtype=torch.int64,
                                  device=self.device)
        self.queue: deque[Request] = deque()
        self.done: dict[int, Request] = {}
        self.cancelled: dict[int, Request] = {}
        self.stats = EngineStats()
        self._rid = int(rid_start)
        self._runtime = None
        self._step_times: list[float] = []
        if step_latency_hint_s:
            self._step_times.append(step_latency_hint_s)
        self._free: deque[int] = deque(range(max_batch))   # free slot ids
        self._tokens_host = np.zeros((max_batch,), np.int64)  # self.tokens
        self._next_keys: Optional[np.ndarray] = None  # (B,1,L,T) prefetched
        self._prompt_buf = np.zeros((max_batch, prompt_bucket), np.int64)

        # overload: SLO admission and preemption (serving/slo.py)
        self.slo_policy = slo_policy
        self.arbiter = arbiter
        self.kv_pool = kv_pool
        if slo_policy is not None and slo_policy.preempt:
            if self.spec is not None:
                raise ValueError("preemption does not compose with "
                                 "speculative decoding (a preempted slot's "
                                 "pipelined drafts have no rollback)")
            if self.kv_pool is None:
                self.kv_pool = KVPagePool(slo_policy.spill_pool_bytes,
                                          slo_policy.spill_page_tokens)
        # long-context idle spill (no preemption)
        self.idle_spill_tokens = int(idle_spill_tokens) \
            if idle_spill_tokens else None
        if self.idle_spill_tokens is not None:
            if self.spec is not None:
                raise ValueError("idle spill does not compose with "
                                 "speculative decoding (a parked slot's "
                                 "pipelined drafts have no rollback)")
            if self.prefill_chunk is not None:
                raise ValueError("idle spill rides the monolithic admission "
                                 "wave")
            if self.kv_pool is None:
                self.kv_pool = KVPagePool(1 << 30, 8)
        # rid -> _SpilledReq: preempted requests parked in the KV pool
        self._spilled: dict[int, _SpilledReq] = {}

    def _check_tables(self) -> None:
        """The Engram tables' placement must be ``table_memory_for``'s: on
        the card, ``pooled_host`` reads tables in pinned, mapped host
        memory and every other strategy tables on the card; on the CPU
        everything is on the CPU. Anything else raises (nothing is copied
        to make it fit)."""
        strategy = self.flags.engram_strategy or self.cfg.engram.strategy
        host = table_memory_for(self.cfg, self.flags) == "pinned_host"
        dev = self.device
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        for j, layer in enumerate(self.params["engram"]["layers"]):
            t = layer["tables"]
            if dev.type == "cpu":
                ok = t.device.type == "cpu"
            elif host:
                ok = is_mapped(t)
            else:
                ok = t.device == dev
            if not ok:
                where = "host memory" if t.device.type == "cpu" \
                    else str(t.device)
                raise ValueError(
                    f"Engram layer {j}'s tables live in {where}, the engine "
                    f"runs on {self.device} with strategy {strategy!r}: on "
                    f"the card, pooled_host reads tables in pinned, mapped "
                    f"host memory (init_params(table_memory='pinned_host') or "
                    f"tables_to_host) and every other strategy tables on "
                    f"the card")

    # ------------------------------------------------------------ public API

    def submit(self, prompt: list, max_new: int = 16,
               arrival_s: Optional[float] = None,
               klass: str = "uniform", slo: str = "batch") -> int:
        """Queue a request; returns its id. ``arrival_s``: its arrival on
        the virtual clock (an idle replica fast-forwards to it, a busy one
        queues it from then). ``klass``: its workload class; ``slo``: its
        SLO class, which drives admission and preemption under an
        ``OverloadPolicy``."""
        self._rid += 1
        if arrival_s is not None:
            self.cursor.advance_to(arrival_s)
        req = Request(self._rid, list(prompt), max_new,
                      submitted_s=time.perf_counter(),
                      klass=klass or "uniform", slo=slo or "batch",
                      submitted_v=arrival_s if arrival_s is not None
                      else self.cursor.now_s)
        self.queue.append(req)
        return self._rid

    @property
    def busy(self) -> bool:
        """Anything queued, mid-flight or parked?"""
        return (bool(self.queue) or bool(self._prefill_jobs)
                or bool(self._spilled)
                or any(s is not None for s in self.slots))

    def runtime(self) -> "EngramRuntime":
        """The engine's request-lifecycle front-end (serving/runtime.py)."""
        if self._runtime is None:
            from .runtime import EngramRuntime
            self._runtime = EngramRuntime(engine=self)
        return self._runtime

    def run(self) -> EngineStats:
        """Process until the queue is empty and all slots idle."""
        return self.runtime().drain()

    def cancel(self, rid: int) -> bool:
        """Drop a queued request, a prefill job, a running slot (the next
        admission's scatter-write over the slot is the rollback) or a
        parked request, mid-spill or mid-restore. False if the rid already
        finished or was never submitted."""
        for req in self.queue:
            if req.rid == rid:
                self.queue.remove(req)
                self._mark_cancelled(req)
                return True
        for job in list(self._prefill_jobs.values()):
            if job.req.rid == rid:
                # the partial KV needs no surgery: the next job's
                # _start_job writes a fresh or restored state over it
                self._drop_job(job)
                self._mark_cancelled(job.req)
                return True
        for slot, req in enumerate(self.slots):
            if req is not None and req.rid == rid:
                self.slots[slot] = None
                self._free.append(slot)
                self._drop_pipelined(slot)
                if self.proposer is not None:
                    self.proposer.end(slot)
                self._mark_cancelled(req)
                return True
        entry = self._spilled.get(rid)
        if entry is not None:
            # mid-spill: refund the write-behind spill bookings; mid-restore:
            # refund the fetch and release the claimed slot. Newest-first
            # either way (Link.refund rolls back only a link's tail)
            for tr in entry.resv[::-1]:
                self.clock.refund(tr)
            entry.resv.clear()
            if entry.phase == "restoring":
                self._free.append(entry.slot)
            self.kv_pool.free(rid)
            del self._spilled[rid]
            self._mark_cancelled(entry.req)
            return True
        return False

    def _drop_pipelined(self, slot: int) -> None:
        """Discard a slot's pipelined prediction and refund the clock-link
        booking of its prefetch: a finished or cancelled request's
        transfer no longer delays anyone."""
        pipe = self._pipelined.pop(slot, None)
        if pipe is not None and pipe[4] is not None:
            self.clock.refund(pipe[4])

    def _drop_job(self, job: _PrefillJob) -> None:
        """Retire a prefill job: refund its outstanding clock-link bookings
        newest-first (``Link.refund`` rolls back only a link's tail, and
        the job booked in issue order) and release the slot."""
        for tr in job.resv[::-1]:
            self.clock.refund(tr)
        job.resv.clear()
        self._prefill_jobs.pop(job.slot, None)
        self._free.append(job.slot)

    def _mark_cancelled(self, req: Request) -> None:
        req.status = "cancelled"
        req.done_s = time.perf_counter()
        req.done_v = self.cursor.now_s
        self.cancelled[req.rid] = req
        self.stats.requests_cancelled += 1

    def warmup(self, prompts: Optional[list] = None) -> None:
        """One admission group and one decode wave outside the measured
        run (first cuBLAS calls at these shapes, allocator growth).
        ``prompts``: the group, to warm up at a measured run's own prefill
        shape; default one 3-token prompt."""
        rids = [self.submit(p, max_new=2) for p in (prompts or [[1, 2, 3]])]
        self.run()
        for rid in rids:
            self.done.pop(rid, None)
        self.reset_stats()

    def reset_stats(self) -> None:
        self.stats = EngineStats()

    # -------------------------------------------------------- host syncing

    def _host(self, t: torch.Tensor) -> np.ndarray:
        """The wave's device->host read. Every host materialisation on the
        serving path goes through here (or, for a prefix spill's snapshot,
        through ``device.sync_allowed`` beside it), so ``d2h_pulls`` counts
        them."""
        self.stats.d2h_pulls += 1
        with trace.span("engine.host_read",
                        bytes=t.numel() * t.element_size()):
            if t.device.type != "cuda":
                return t.numpy().copy()
            with sync_allowed(self.device):
                return t.cpu().numpy()

    # ---------------------------------------------------------- prefill path

    def _admit_wave_fn(self, params, state, tokens, batch, slots):
        """One admission group: multi-slot prefill + argmax + slot scatter
        + (pool mode) prompt-key packing. Returns the new engine state plus
        ONE packed int64 vector [first tokens | keys] for the group's single
        host read."""
        logits, pstate = self._prefill_fn(params, batch)
        tok = torch.argmax(logits, dim=-1)                       # (n,)
        state = update_slots(state, pstate, slots)
        tokens = update_slots(tokens, tok, slots)
        packed = tok
        if self._pool_mode:
            e = self.cfg.engram
            idx = engram_indices(e, batch["tokens"])             # (n,S,T)
            pk = pack_segment_keys(e, idx, self._n_eng)          # (n,S,L,T)
            packed = torch.cat([tok, pk.reshape(-1)])
        return state, tokens, packed

    def _prompt_view(self, n: int, S: int) -> np.ndarray:
        """Zeroed (n, S) view of the preallocated prompt buffer."""
        if self._prompt_buf.shape[1] < S or self._prompt_buf.shape[0] < n:
            self._prompt_buf = np.zeros(
                (max(n, self._prompt_buf.shape[0]),
                 max(S, self._prompt_buf.shape[1])), np.int64)
        view = self._prompt_buf[:n, :S]
        view[:] = 0
        return view

    def _admit(self) -> list:
        """Admit queued requests into free slots: one multi-slot prefill
        per prompt bucket and ONE fused store charge for the admission
        wave. Returns ``(request, emitted_tokens, finished, index)`` tuples.

        Unlike the reference, a group is not padded to a power-of-two row
        count: that bounds JAX recompiles and costs compute here."""
        if self.prefill_chunk is not None:
            return self._admit_chunked()
        with trace.span("engine.admit"):
            return self._admit_monolithic()

    def _admit_monolithic(self) -> list:
        """``_admit`` without ``prefill_chunk``."""
        events = []
        fills = []
        if self.slo_policy is not None:
            # restores complete and preemption may free slots even with an
            # empty queue, so this runs every pass
            for req in self._overload_admit():
                self.queue.remove(req)
                fills.append((self._free.popleft(), req))
            if not fills:
                return events
        elif self.idle_spill_tokens is not None:
            # complete last pass's restores, park eligible long-running
            # slots when the queue outgrows the free slots, fill fresh
            # admits first, and let parked requests claim only the slots
            # left (else park and resume would ping-pong one slot)
            self._complete_restores()
            self._idle_spill_for_queue()
            while self._free and self.queue:
                fills.append((self._free.popleft(), self.queue.popleft()))
            parked = sorted((e for e in self._spilled.values()
                             if e.phase == "spilled"),
                            key=lambda e: e.req.rid)
            for entry in parked:
                if not self._free:
                    break
                self._begin_restore(entry, self._free.popleft())
            if not fills:
                return events
        else:
            if not (self._free and self.queue):
                return events
            while self._free and self.queue:
                fills.append((self._free.popleft(), self.queue.popleft()))
        groups: dict[int, list] = {}
        for slot, req in fills:
            S = _bucket(len(req.prompt), self.prompt_bucket)
            groups.setdefault(S, []).append((slot, req))
        charge = [[] for _ in range(self._n_eng)] if self._pool_mode else None
        for S, group in sorted(groups.items()):
            n = len(group)
            with trace.span("engine.prefill_group", n=n, S=S,
                            rids=[req.rid for _, req in group]) as attrs:
                self.cursor.next_wave()
                t_g = time.perf_counter()
                buf = self._prompt_view(n, S)
                lens = np.ones((n,), np.int64)
                for r, (_, req) in enumerate(group):
                    buf[r, :len(req.prompt)] = req.prompt
                    lens[r] = len(req.prompt)
                useful = int(lens.sum())
                attrs["tokens"], attrs["pad"] = useful, n * S - useful
                self.stats.prefill_waves += 1
                self.stats.prefill_tokens += useful
                self.stats.prefill_pad_tokens += n * S - useful
                emu_s = None
                if self.emulate_step_s is not None:
                    emu_s = self._prefill_step_s(n * S)
                    self.stats.emu_time_s += emu_s
                batch = {"tokens": upload(buf, self.device),
                         "lengths": upload(lens, self.device)}
                self.state, self.tokens, packed = self._admit_wave_fn(
                    self.params, self.state, self.tokens, batch,
                    [s for s, _ in group])
                packed = self._host(packed)          # ONE read per group
                toks = packed[:n]
                if self._pool_mode:
                    pk = packed[n:].reshape(n, S, self._n_eng, -1)
                    for r, (_, req) in enumerate(group):
                        live = pk[r, :lens[r]]   # drop right-pad positions
                        for j in range(self._n_eng):
                            charge[j].append(live[:, j, :].reshape(-1))
                t_now = time.perf_counter()
                self.cursor.advance(emu_s if emu_s is not None
                                    else t_now - t_g)
                for r, (slot, req) in enumerate(group):
                    tok = int(toks[r])
                    req.out.append(tok)
                    req.first_token_s = t_now
                    req.status = "running"
                    self.slots[slot] = req
                    self._tokens_host[slot] = tok
                    self.stats.prefills += 1
                    self.stats.generated_tokens += 1
                    self.stats.ttft_s_sum += t_now - req.submitted_s
                    if self.proposer is not None:
                        self.proposer.begin(slot, req.prompt + req.out)
                    events.append((req, [tok], self._finish_if_done(slot),
                                   len(req.out) - 1))
        if self._pool_mode:
            # one fused charge: the admission wave's prompt-key stream
            self._charge_wave([np.concatenate(c) for c in charge])
        # virtual first-token stamps after the charge: the prompt
        # retrieval's stall is part of every admitted request's TTFT_v
        t_v = self.cursor.now_s
        for req, _, finished, _ in events:
            req.first_token_v = t_v
            self.stats.ttft_v_sum += t_v - req.submitted_v
            if finished:
                req.done_v = t_v
        self._next_keys = None      # decode keys were computed pre-admit
        return events

    # ------------------------------------------------- chunked prefill path

    def _admit_chunked(self) -> list:
        """Chunked admission: each queued request claims a free slot as a
        ``_PrefillJob``; no compute happens here. A job's first token is
        emitted by the chunk wave that finishes its prompt, so this returns
        no events. Under an ``OverloadPolicy`` the jobs are the requests
        ``_overload_admit`` chose."""
        if self.slo_policy is not None:
            for req in self._overload_admit():
                self.queue.remove(req)
                self._claim_job(req, self._free.popleft())
            return []
        while self._free and self.queue:
            self._claim_job(self.queue.popleft(), self._free.popleft())
        return []

    def _claim_job(self, req: Request, slot: int) -> None:
        """Claim one slot as a ``_PrefillJob``. With a prefix cache, look
        up the prompt's chained block keys and schedule the deepest cached
        boundary state for restore; its bytes are booked on the pool link
        now and stay refundable until the job's first chunk wave."""
        C = self.prefill_chunk
        job = _PrefillJob(req=req, slot=slot)
        if self.prefix_cache is not None:
            job.chain = prefix_chain_keys(req.prompt, C)
            # at least one prompt token must remain to compute: snapshots
            # carry KV state, not the logits of the first token
            usable = job.chain[:(len(req.prompt) - 1) // C]
            self.stats.prefix_lookup_blocks += len(usable)
            if usable:
                n_hit, snap, nbytes = self.prefix_cache.lookup(usable)
                if n_hit:
                    job.restore = snap
                    job.restore_bytes = int(nbytes)
                    job.pos = n_hit * C
                    self.stats.prefix_hit_blocks += n_hit
                    self.stats.prefill_tokens_restored += n_hit * C
                    tr = self._reserve_bytes(nbytes)
                    if tr is not None:
                        job.resv.append(tr)
        req.status = "running"
        self._prefill_jobs[slot] = job

    def _start_job(self, job: _PrefillJob) -> None:
        """First-wave start: write the restored prefix (KV padded back to
        ``max_len``) over the job's slot, or, for a fresh prompt, reset the
        slot's position, last tokens and recurrent state
        (``slots.reset_slot``). The previous occupant's KV needs no
        clearing: attention masks it past the row's position, and each
        step writes its own position before it attends there."""
        if job.restore is not None:
            update_slots(self.state, restore_prefix(
                job.restore, self.max_len, self.device), [job.slot])
            job.restore = None
        else:
            e = self.cfg.engram
            reset_slot(self.state, job.slot, e.pad_token if e else 0)
        job.started = True

    def _chunk_wave_fn(self, params, state, tokens, chunk, lens, slots):
        """One chunk wave over the jobs' host slot ids ``slots``: gather
        their sub-state, unroll ``prefill_chunk`` gated decode steps over
        the ragged chunk, write back, and sample each row's last valid
        logits. Returns the state, the tokens and ONE packed int64 vector
        [sampled tokens | (pool mode) the chunk's packed keys] for the
        wave's single host read."""
        sub = select_slots(state, slots)
        pk = None
        if self._pool_mode:
            e = self.cfg.engram
            kidx = block_engram_indices(e, sub["last_tokens"], chunk)
            pk = pack_segment_keys(e, kidx, self._n_eng)   # (n, C, L, T)
        logits, new_sub = self._chunk_core(params, sub, chunk, lens)
        state = update_slots(state, new_sub, slots)
        tok = torch.argmax(logits, dim=-1)
        tokens = update_slots(tokens, tok, slots)
        packed = tok if pk is None else torch.cat([tok, pk.reshape(-1)])
        return state, tokens, packed

    def _chunk_wave(self) -> list:
        """Advance every prefill job by one chunk, with ONE host read. Jobs
        that consume their last prompt token emit their first token and go
        live. Completed chunk boundaries are spilled into the prefix cache
        (a counted snapshot read plus a write booked on the pool link).
        Returns ``(request, emitted_tokens, finished, index)`` tuples.

        Unlike the reference, the jobs are not padded to a power-of-two
        row count (as in ``_admit``), so ``prefill_pad_tokens`` counts only
        the chunks' ragged tails."""
        if not self._prefill_jobs:
            return []
        jobs = [self._prefill_jobs[s] for s in sorted(self._prefill_jobs)]
        C = self.prefill_chunk
        t0 = time.perf_counter()
        self.cursor.next_wave()
        # settle the inter-wave bookings newest-first (they were issued in
        # job order); the wave re-charges through the normal path below
        for job in jobs[::-1]:
            for tr in job.resv[::-1]:
                self.clock.refund(tr)
            job.resv.clear()
        for job in jobs:
            if not job.started:
                if job.restore is not None and job.restore_bytes:
                    # the prefix hit's fetch, re-priced at this wave's
                    # position: the snapshot must be on the device before
                    # the chunk computes, so its completion is a stall
                    tr = self._reserve_bytes(job.restore_bytes)
                    if tr is not None and tr.end_s > self.cursor.now_s:
                        stall = tr.end_s - self.cursor.now_s
                        self.stats.stall_s += stall
                        self.stats.emu_time_s += stall
                        self.cursor.advance(stall)
                self._start_job(job)
        n = len(jobs)
        buf = self._prompt_view(n, C)
        lens = np.zeros((n,), np.int64)
        for r, job in enumerate(jobs):
            take = min(C, len(job.req.prompt) - job.pos)
            buf[r, :take] = job.req.prompt[job.pos:job.pos + take]
            lens[r] = take
        self.state, self.tokens, packed = self._chunk_wave_fn(
            self.params, self.state, self.tokens, upload(buf, self.device),
            upload(lens, self.device), [j.slot for j in jobs])
        packed = self._host(packed)            # ONE read per chunk wave
        toks = packed[:n]
        useful = int(lens.sum())
        self.stats.prefill_waves += 1
        self.stats.prefill_tokens += useful
        self.stats.prefill_pad_tokens += n * C - useful
        emu_s = None
        if self.emulate_step_s is not None:
            emu_s = self._prefill_step_s(n * C)
            self.stats.emu_time_s += emu_s
        if self._pool_mode:
            pk = packed[n:].reshape(n, C, self._n_eng, -1)
            charge = [[] for _ in range(self._n_eng)]
            for r in range(n):
                live = pk[r, :lens[r]]         # drop ragged-tail positions
                for j in range(self._n_eng):
                    charge[j].append(live[:, j, :].reshape(-1))
            self._charge_wave([np.concatenate(c) for c in charge],
                              step_s=emu_s)
        t_now = time.perf_counter()
        self.cursor.advance(emu_s if emu_s is not None else t_now - t0)
        self._step_times.append(time.perf_counter() - t0)
        events = []
        t_v = self.cursor.now_s
        for r, job in enumerate(jobs):
            job.pos += int(lens[r])
            req = job.req
            # spill a completed block boundary: the state at job.pos is the
            # boundary state (a finishing full block lands on one too)
            bi = job.pos // C - 1
            if (self.prefix_cache is not None and job.pos % C == 0
                    and 0 <= bi < len(job.chain)
                    and job.chain[bi] not in self.prefix_cache):
                with sync_allowed(self.device):
                    snap, nbytes = extract_prefix(self.state, job.slot,
                                                  job.pos)
                self.stats.d2h_pulls += 1      # the spill's host snapshot
                if self.prefix_cache.insert(job.chain[bi], snap, job.pos,
                                            nbytes):
                    self._reserve_bytes(nbytes)   # write-behind spill
            if job.pos >= len(req.prompt):
                tok = int(toks[r])
                req.out.append(tok)
                req.first_token_s = t_now
                req.first_token_v = t_v
                self.slots[job.slot] = req
                self._tokens_host[job.slot] = tok
                self._prefill_jobs.pop(job.slot)
                self.stats.prefills += 1
                self.stats.generated_tokens += 1
                self.stats.ttft_s_sum += t_now - req.submitted_s
                self.stats.ttft_v_sum += t_v - req.submitted_v
                events.append((req, [tok], self._finish_if_done(job.slot),
                               len(req.out) - 1))
                # the prefetched decode keys predate this slot going live
                self._next_keys = None
            elif self._pool_mode:
                # book the next chunk's Engram prefetch now: in flight
                # between waves, refunded and re-priced at the next wave
                # or refunded by a mid-prefill cancel
                nxt = min(C, len(req.prompt) - job.pos)
                tr = self.store.reserve_prefetch(
                    nxt * self.cfg.engram.n_tables * self._n_eng)
                if tr is not None:
                    job.resv.append(tr)
        return events

    # ----------------------------------------------------------- decode path

    def _prefetch_fn(self, params, last_tokens, token):
        """pool=None retrieval: every Engram layer's rows, plain gather."""
        e = self.cfg.engram
        idx = decode_engram_indices(e, last_tokens, token)
        return [retrieve(e, layer["tables"], idx, self.flags.engram_strategy)
                for layer in params["engram"]["layers"]]

    def _wave_sync_fn(self, last_tokens, new_tok):
        """[this wave's sampled tokens | next wave's packed (B·1·L·T)
        decode keys] in ONE int64 vector — the wave's single read."""
        keys = decode_engram_keys(self.cfg.engram, last_tokens, new_tok,
                                  self._n_eng)
        return torch.cat([new_tok.to(torch.int64), keys.reshape(-1)])

    def _miss_fetches(self, keys: np.ndarray):
        """ONE fused fetch gathering every Engram layer's rows of a wave in
        one engram_gather (K1) launch; the scheduler splits it into the
        per-layer handles. ``keys`` is the FULL batch's (B, S, L, T)
        packed-key block: decode consumes rows for every slot, while the
        store is charged with live keys only."""
        B, S = keys.shape[:2]
        gids = [f.gid_for(keys[:, :, j, :])
                for j, f in enumerate(self._fetchers)]

        def fetch():
            rows = fetch_layers(self._fetchers, gids)
            return [r.reshape(B, S, -1) for r in rows]

        return fetch

    def _decode_wave(self) -> list:
        """One batched greedy-decode wave over the live slots — exactly one
        device->host read in steady state. Returns ``(request,
        emitted_tokens, finished, index)`` tuples."""
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return []
        with trace.span("engine.decode_wave", live=len(active)):
            return self._decode_live(active)

    def _decode_live(self, active: list) -> list:
        """``_decode_wave`` over the ``active`` slots."""
        t0 = time.perf_counter()
        self.cursor.next_wave()
        B = self.max_batch
        if self.emulate_step_s is not None:
            self.stats.emu_time_s += self.emulate_step_s
        rows = None
        if self._pool_mode:
            # steady state reuses the keys read with the previous wave's
            # tokens; only post-admission waves read them separately
            keys = self._next_keys
            if keys is None:
                keys = self._host(decode_engram_keys(
                    self.cfg.engram, self.state["last_tokens"], self.tokens,
                    self._n_eng))
            self._next_keys = None
            act = keys[np.asarray(active)]               # (A, 1, L, T)
            per_layer = [act[:, :, j, :].reshape(-1)
                         for j in range(self._n_eng)]
            rows = self._charge_wave(per_layer,
                                     fetch=self._miss_fetches(keys))
        elif self._decode_ext_fn is not None:
            # the paper's prefetch: retrieval issued as its own call,
            # materialised through the store (prefetch -> gather)
            fetch = lambda: self._prefetch_fn(                 # noqa: E731
                self.params, self.state["last_tokens"], self.tokens)
            rows = self.store.gather(
                self.store.prefetch(len(active), fetch=fetch))
        old_state = self.state
        if self._decode_ext_fn is not None:
            logits, self.state = self._decode_ext_fn(
                self.params, self.state, self.tokens, rows)
        else:
            logits, self.state = self._decode_fn(self.params, self.state,
                                                 self.tokens)
        if self._prefill_jobs:
            # prefill jobs in flight: their positions must not advance
            live = np.zeros((B,), np.bool_)
            live[np.asarray(active)] = True
            self.state = gate_state(upload(live, self.device), self.state,
                                    old_state)
        new_tok = torch.argmax(logits, dim=-1)
        self.tokens = new_tok
        if self._pool_mode:
            # the wave's ONE read: sampled tokens + next wave's keys fused
            sync = self._host(self._wave_sync_fn(self.state["last_tokens"],
                                                 new_tok))
            toks = sync[:B]
            self._next_keys = sync[B:].reshape(B, 1, self._n_eng, -1)
        else:
            toks = self._host(new_tok)
        self._tokens_host[:] = toks
        dt = time.perf_counter() - t0
        self._step_times.append(dt)
        self.cursor.advance(self.emulate_step_s
                            if self.emulate_step_s is not None else dt)
        self.stats.decode_steps += 1
        events = []
        for i in active:
            req = self.slots[i]
            req.out.append(int(toks[i]))
            self.stats.generated_tokens += 1
            events.append((req, [int(toks[i])], self._finish_if_done(i),
                           len(req.out) - 1))
        return events

    # ------------------------------------------------------ speculate path

    def _block_keys(self, last_tokens, block):
        """The block's packed (B, m, L, T) segment keys on the device."""
        return block_engram_keys(self.cfg.engram, last_tokens, block,
                                 self._n_eng)

    def _block_prefetch_fn(self, params, last_tokens, block):
        """pool=None block retrieval (LocalStore): every Engram layer's rows
        for the whole block, plain gather."""
        e = self.cfg.engram
        idx = block_engram_indices(e, last_tokens, block)
        return [retrieve(e, layer["tables"], idx, self.flags.engram_strategy)
                for layer in params["engram"]["layers"]]

    @staticmethod
    def _fuse_verdict(verify):
        """Wrap a verifier so that its host-bound outputs, preds (B, m) and
        n_accept (B,), come back as ONE (B, m+1) int64 verdict tensor: the
        speculative wave's single post-verify read."""
        def fused(params, state, block, rows=None):
            preds, n_accept, next_tok, new_state = (
                verify(params, state, block, rows) if rows is not None
                else verify(params, state, block))
            verdict = torch.cat([preds, n_accept[:, None]], dim=1)
            return verdict, next_tok, new_state
        return fused

    def _propose_block(self, active, k: int) -> tuple:
        """The wave's (B, m) block on the host: pending tokens from the host
        mirror (no device read), drafts from surviving pipelined
        predictions where there are any, else fresh proposals. Returns the
        block, the hit set and the surviving host-packed keys
        ``{slot: (m, L, T)}``."""
        block = np.zeros((self.max_batch, k + 1), np.int64)
        block[:, 0] = self._tokens_host
        hits = set()
        pipe_keys: dict[int, np.ndarray] = {}
        pipes = {i: self._pipelined.pop(i, None) for i in active}
        # settle the queued prefetch bookings NEWEST-FIRST: Link.refund
        # rolls back only a link's tail and the bookings were made in slot
        # order, so LIFO unwinds them all (ascending order would leak every
        # booking but the last). The wave re-charges through the normal
        # path either way.
        for pipe in [p for p in pipes.values() if p is not None][::-1]:
            if pipe[4] is not None:
                self.clock.refund(pipe[4])
        for i in active:
            req = self.slots[i]
            stream = req.prompt + req.out
            drafts = None
            pipe = pipes[i]
            if pipe is not None:
                base_len, expected_tail, next_drafts, pkeys, _ = pipe
                if (len(stream) == base_len + len(expected_tail)
                        and stream[base_len:] == expected_tail):
                    drafts = next_drafts
                    hits.add(i)
                    if pkeys is not None:
                        pipe_keys[i] = pkeys
                    self.stats.pipelined_hits += 1
                else:
                    self.stats.pipelined_misses += 1
            if drafts is None:
                drafts = self.proposer.propose(i, stream, k)
            block[i, 1:] = drafts
        return block, hits, pipe_keys

    def _pipeline_proposals(self, active, block: np.ndarray, k: int) -> None:
        """Draft wave N+1's blocks while wave N's verify runs on the
        device. The optimistic context assumes full acceptance; the
        prediction is used next wave only if the emitted tail (accepted
        drafts plus the bonus token) matches it exactly.

        Pool mode also packs the predicted block's keys on the host
        (``host_block_keys``, bit-equal to the device path) and books its
        prefetch on the pool's clock link now. If every live slot's
        prediction survives, the next wave reads no keys from the device;
        the booking is refunded when the prediction is consumed or its
        request ends."""
        e = self.cfg.engram
        o = max(e.orders) if self.has_engram else 1
        for i in active:
            req = self.slots[i]
            stream = req.prompt + req.out
            drafts = [int(t) for t in block[i, 1:]]
            ahead = [int(t) for t in
                     self.proposer.propose(i, stream + drafts, k + 1)]
            pkeys = resv = None
            if self._pool_mode and len(stream) + len(drafts) >= o - 1:
                pkeys = host_block_keys(e, stream + drafts, ahead,
                                        self._n_eng)
                resv = self.store.reserve_prefetch(int(np.unique(pkeys).size))
            # surviving tail = this wave's drafts + the predicted bonus
            self._pipelined[i] = (len(stream), drafts + [ahead[0]],
                                  ahead[1:], pkeys, resv)

    def _spec_wave(self) -> list:
        """One speculative wave: propose k drafts per live slot, prefetch
        the whole block's Engram window (pool mode: one K1 launch), verify
        in one batched pass, roll back rejected tails, charge stalls for
        surviving positions only. Two device->host reads (the packed block
        keys, the fused verdict), one when every live slot's pipelined
        prediction survived. Returns ``(request, emitted_tokens, finished,
        index)`` tuples."""
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return []
        t0 = time.perf_counter()
        self.cursor.next_wave()
        k = self.spec.max_draft
        m = k + 1
        B = self.max_batch

        block, pipe_hits, pipe_keys = self._propose_block(active, k)
        block_t = upload(block, self.device)

        # the verify pass costs about one decode step (memory-bound) plus a
        # small per-extra-token compute term
        step_s = self._step_estimate_s()
        verify_s = step_s * (1.0 + self.spec.verify_overhead * (m - 1))
        if self.emulate_step_s is not None:
            self.stats.emu_time_s += verify_s

        spec_report = None
        rows = None
        if self._pool_mode:
            if all(i in pipe_keys for i in active):
                # every live slot's block was predicted last wave and its
                # keys packed on the host: no key read this wave
                keys = np.zeros((B, m, self._n_eng,
                                 self.cfg.engram.n_tables), np.int64)
                for i in active:
                    keys[i] = pipe_keys[i]
            else:
                keys = self._host(self._block_keys(self.state["last_tokens"],
                                                   block_t))   # (B,m,L,T)
            act = np.asarray(active)
            ka = keys[act]                                     # (A,m,L,T)
            keys_by_pos = [[ka[:, s, j, :].reshape(-1)
                            for j in range(self._n_eng)] for s in range(m)]
            # a fully pipelined block was booked a verify pass early (the
            # cost model's credit; the gather below runs now); one
            # straggler drags the fused fetch back to wave start
            early = verify_s if all(i in pipe_hits for i in active) else 0.0
            spec_report = self.scheduler.speculative_wave(
                keys_by_pos, verify_s,
                slot_keys=ka.reshape(len(active), m, -1), slot_ids=active,
                early_issue_s=early)
            rows = self._miss_fetches(keys)()      # ONE K1 launch
        elif self.has_engram:
            fetch = lambda: self._block_prefetch_fn(           # noqa: E731
                self.params, self.state["last_tokens"], block_t)
            rows = self.store.gather(
                self.store.prefetch(len(active) * m, fetch=fetch))

        verdict, self.tokens, self.state = self._verify(
            self.params, self.state, block_t, rows)

        if self.spec.pipeline:
            # wave N+1's proposals, drafted while the verify runs
            self._pipeline_proposals(active, block, k)

        verdict = self._host(verdict)                  # (B, m+1)
        preds = verdict[:, :m]
        n_acc = verdict[:, m]
        # host mirror of next_tok: preds[b, n_accept[b]] by construction
        self._tokens_host[:] = preds[np.arange(B), n_acc]
        if spec_report is not None:
            acc_active = n_acc[np.asarray(active)]
            stall = self.scheduler.charge_spec(
                spec_report, int(acc_active.max()) + 1,
                tokens_emitted=int((acc_active + 1).sum()),
                n_keep_by_slot={i: int(n_acc[i]) + 1 for i in active})
            self.stats.stall_s += stall
            if self.emulate_step_s is None:
                if stall > 0:
                    time.sleep(stall)
            else:
                self.stats.emu_time_s += stall
                self.cursor.advance(stall)

        dt = time.perf_counter() - t0
        self._step_times.append(dt)
        self.cursor.advance(verify_s if self.emulate_step_s is not None
                            else dt)
        self.stats.decode_steps += 1
        self.stats.spec_waves += 1
        events = []
        for i in active:
            req = self.slots[i]
            a = int(n_acc[i])
            emit = [int(t) for t in preds[i, :a + 1][:req.max_new
                                                     - len(req.out)]]
            req.out.extend(emit)
            self.stats.generated_tokens += len(emit)
            self.stats.proposed_tokens += k
            self.stats.accepted_tokens += a
            by = self.stats.spec_by_class.setdefault(
                req.klass or "uniform", {"proposed": 0, "accepted": 0})
            by["proposed"] += k
            by["accepted"] += a
            self.proposer.observe(i, req.prompt + req.out)
            events.append((req, emit, self._finish_if_done(i),
                           len(req.out) - len(emit)))
        return events

    def _finish_if_done(self, slot: int) -> bool:
        req = self.slots[slot]
        if req is not None and len(req.out) >= req.max_new:
            req.done_s = time.perf_counter()
            req.done_v = self.cursor.now_s
            req.status = "done"
            self.done[req.rid] = req
            self.slots[slot] = None
            self._free.append(slot)
            self._drop_pipelined(slot)
            self.stats.requests_completed += 1
            if self.proposer is not None:
                self.proposer.end(slot)
            return True
        return False

    # ------------------------------------- preemption + KV spill (slo.py)

    def preempt(self, slot: int) -> bool:
        """Preempt a running slot: copy its KV at the decoded position to
        the host (``slots.extract_prefix``, the spill's one counted read),
        park the snapshot in the KV pool, book the spill write-behind on
        the pool link (refunded newest-first by a mid-spill ``cancel``)
        and free the slot. Returns False, and leaves the victim running,
        when the pool refuses the spill at capacity (backpressure)."""
        req = self.slots[slot]
        if (req is None or req.status != "running"
                or self.kv_pool is None or not req.out):
            return False
        # KV-valid length: the prompt plus one position per decode wave,
        # except the newest token (out[-1]), the next wave's input
        pos = len(req.prompt) + len(req.out) - 1
        with sync_allowed(self.device):
            snap, nbytes = extract_prefix(self.state, slot, pos)
        self.stats.d2h_pulls += 1          # the spill's host snapshot
        stream = (req.prompt + req.out)[:pos]
        pages = self.kv_pool.spill(req.rid, stream, snap, pos, int(nbytes))
        if pages is None:
            return False
        entry = _SpilledReq(req=req, nbytes=int(nbytes), pages=pages,
                            n_tokens=pos, last_token=int(req.out[-1]),
                            snapshot=snap)
        entry.resv = self._book_kv(entry.nbytes, len(pages), req.rid)
        self._occupy_kv_cache(entry.nbytes, pages)
        self._note_kv(entry.nbytes)
        self.slots[slot] = None
        self._free.append(slot)
        self._drop_pipelined(slot)
        if self.proposer is not None:
            self.proposer.end(slot)
        req.status = "preempted"
        req.preemptions += 1
        self._spilled[req.rid] = entry
        self.stats.preemptions += 1
        self.stats.kv_spill_bytes += entry.nbytes
        self.stats.kv_spill_pages += len(pages)
        return True

    def _book_kv(self, nbytes: int, n_pages: int, rid: int) -> list:
        """Book one KV spill or restore transfer on the pool link: with a
        page-granular arbiter one reservation per page under the shared
        ``"kv"`` flow owner (Engram waves fair-share past the spill),
        else one untagged booking (serial FIFO). Returns the transfers
        (refundable newest-first); [] when clock-unbound."""
        link = self._pool_link()
        if link is None or not nbytes or not link.bandwidth_Bps:
            return []
        resv = []
        if self.arbiter is not None and self.arbiter.paged_link and n_pages:
            base, rem = divmod(int(nbytes), n_pages)
            for p in range(n_pages):
                nb = base + (rem if p == n_pages - 1 else 0)
                if nb <= 0:
                    continue
                _, tr = link.reserve(self.cursor.now_s,
                                     float(nb) / link.bandwidth_Bps,
                                     nbytes=nb, wave=("kv", rid, p),
                                     klass="kv")
                resv.append(tr)
        else:
            _, tr = link.reserve(self.cursor.now_s,
                                 float(nbytes) / link.bandwidth_Bps,
                                 nbytes=int(nbytes), klass="kv")
            resv.append(tr)
        return resv

    def _note_kv(self, nbytes: int) -> None:
        """Charge one logical KV transfer (a spill, or a completed restore)
        to the store's per-class ledger, so ``class_bytes["kv"] ==
        kv_spill_bytes + kv_restore_bytes`` (claim-time bookings are on
        the link only)."""
        if self.store is None:
            return
        link = self._pool_link()
        busy = (float(nbytes) / link.bandwidth_Bps
                if link is not None and link.bandwidth_Bps else 0.0)
        self.store.note_class("kv", int(nbytes), busy)

    def _occupy_kv_cache(self, nbytes: int, pages: tuple) -> None:
        """Landed KV pages pressure the hot-row cache: without an arbiter
        they may take its whole capacity, with one at most
        ``kv_cache_share`` of it. Their synthetic keys carry bit 62, so
        they never collide with packed segment keys."""
        cache = getattr(self.store, "cache", None)
        if cache is None or not pages:
            return
        rows = max(1, int(nbytes) // max(1, segment_bytes(self.cfg.engram)))
        cap = int(cache.capacity_rows)
        if self.arbiter is not None:
            rows = self.arbiter.cache_occupancy_rows(rows, cap)
        else:
            rows = min(rows, cap)
        if rows <= 0:
            return
        base = (int(pages[0]) & 0x3FFFFFFF) << 30
        keys = (np.arange(rows, dtype=np.int64) + base) | np.int64(1 << 62)
        cache.occupy(keys)

    def _overload_admit(self) -> list:
        """SLO admission: complete last pass's restores, preempt strictly
        lower-priority running slots for the queue, then fill the free
        slots priority-first and deadline-ordered from the parked and the
        queued requests (a resume outranks a fresh admit of the same
        priority: it holds pooled capacity and has paid its prefill).
        Returns the queued requests to admit (still in ``self.queue``)."""
        pol = self.slo_policy
        self._complete_restores()
        if pol.preempt and self.kv_pool is not None:
            self._preempt_for_queue()
        cands = []
        for req in self.queue:
            cands.append((-pol.priority(req.slo), 1, pol.deadline_v(req),
                          req.rid, req))
        for e in self._spilled.values():
            if e.phase == "spilled":
                cands.append((-pol.priority(e.req.slo), 0,
                              pol.deadline_v(e.req), e.req.rid, e))
        cands.sort(key=lambda c: c[:4])
        chosen = []
        budget = len(self._free)
        for c in cands:
            if budget <= 0:
                break
            if isinstance(c[4], _SpilledReq):
                self._begin_restore(c[4], self._free.popleft())
            else:
                chosen.append(c[4])
            budget -= 1
        return chosen

    def _idle_spill_for_queue(self) -> None:
        """Long-context spill without priority preemption: when the queue
        outgrows the free slots, park running slots that have decoded
        ``idle_spill_tokens`` since admission or their last spill, longest
        resident context first, sparing near-done requests.
        ``spill_mark`` ratchets at each park."""
        need = len(self.queue) - len(self._free)
        if need <= 0:
            return
        cands = []
        for slot, req in enumerate(self.slots):
            if req is None or req.status != "running":
                continue
            if len(req.out) - req.spill_mark < self.idle_spill_tokens:
                continue
            if req.max_new - len(req.out) <= 1:      # about to finish
                continue
            cands.append((-(len(req.prompt) + len(req.out)), slot, req))
        cands.sort()
        for _, slot, req in cands[:need]:
            mark = len(req.out)
            if self.preempt(slot):                   # may refuse (pool full)
                req.spill_mark = mark
                self.stats.idle_spills += 1

    def _preempt_for_queue(self) -> None:
        """Free slots for queued requests that strictly outrank a running
        victim: lowest priority first, then most remaining decode work,
        then the lowest slot. A freed slot is earmarked for the request
        that forced it, so the spare count is unchanged by a success."""
        pol = self.slo_policy
        waiting = sorted(self.queue,
                         key=lambda r: (-pol.priority(r.slo),
                                        pol.deadline_v(r), r.rid))
        spare = len(self._free)
        for req in waiting:
            if spare > 0:
                spare -= 1
                continue
            prio = pol.priority(req.slo)
            victim, vkey = -1, None
            for slot, run in enumerate(self.slots):
                if run is None or run.status != "running":
                    continue
                vprio = pol.priority(run.slo)
                if vprio >= prio:
                    continue
                key = (vprio, -(run.max_new - len(run.out)), slot)
                if vkey is None or key < vkey:
                    victim, vkey = slot, key
            if victim < 0 or not self.preempt(victim):
                break               # no eligible victim / pool refused

    def _begin_restore(self, entry: _SpilledReq, slot: int) -> None:
        """Restore phase 1: claim the free slot and book the KV fetch (the
        spill's bookings are committed: only the fetch stays refundable).
        The next admission pass completes it."""
        entry.slot = slot
        entry.phase = "restoring"
        entry.resv = self._book_kv(entry.nbytes, len(entry.pages),
                                   entry.req.rid)

    def _complete_restores(self) -> None:
        """Restore phase 2, for each slot claimed last pass: refund the
        claim-time fetch newest-first and re-price it at this wave's
        position, stall to its completion, upload the snapshot and write
        it into the slot (``restore_prefix`` + ``update_slots``, no host
        sync), set the slot's next input token and resume decode."""
        entries = [e for e in self._spilled.values()
                   if e.phase == "restoring"]
        if not entries:
            return
        entries.sort(key=lambda e: e.req.rid)
        for entry in entries[::-1]:
            for tr in entry.resv[::-1]:
                self.clock.refund(tr)
            entry.resv.clear()
        for entry in entries:
            resv = self._book_kv(entry.nbytes, len(entry.pages),
                                 entry.req.rid)
            end = max((tr.end_s for tr in resv), default=self.cursor.now_s)
            if end > self.cursor.now_s:
                stall = end - self.cursor.now_s
                self.stats.stall_s += stall
                if self.emulate_step_s is not None:
                    self.stats.emu_time_s += stall
                self.cursor.advance(stall)
            req = entry.req
            update_slots(self.state, restore_prefix(
                entry.snapshot, self.max_len, self.device), [entry.slot])
            # fill_, not item assignment (which copies from the host, a sync)
            self.tokens[entry.slot].fill_(entry.last_token)
            self._tokens_host[entry.slot] = entry.last_token
            self.slots[entry.slot] = req
            req.status = "running"
            if self.proposer is not None:
                self.proposer.begin(entry.slot, req.prompt + req.out)
            self._note_kv(entry.nbytes)
            self.kv_pool.free(req.rid, restored=True)
            del self._spilled[req.rid]
            self.stats.resumes += 1
            self.stats.kv_restore_bytes += entry.nbytes
        # the prefetched decode keys predate the restored slots going live
        self._next_keys = None

    # ------------------------------------------------------- pool emulation

    def _step_estimate_s(self) -> float:
        if self.emulate_step_s is not None:
            return self.emulate_step_s
        if not self._step_times:
            return 1e-3
        return float(np.median(self._step_times[-32:]))

    def _prefill_step_s(self, executed_tokens: int) -> float:
        """Emulated cost of one prefill wave: one flat decode step, or
        (``emu_prefill_scaled``) ``executed_tokens / max_batch`` steps."""
        if not self.emu_prefill_scaled:
            return self.emulate_step_s
        return self.emulate_step_s * max(1.0,
                                         executed_tokens / self.max_batch)

    def _pool_link(self):
        """The pool tier's clock link (prefix snapshots travel over the
        medium the Engram rows do); None when clock-unbound."""
        if self.store is None:
            return None
        link = getattr(self.store, "_link", None)
        if link is None:
            backing = getattr(self.store, "backing", None)
            if backing is not None:
                link = getattr(backing, "_link", None)
        return link

    def _reserve_bytes(self, nbytes: int):
        """Book a prefix-snapshot transfer (fetch or spill) of ``nbytes`` on
        the pool link at the tier's bandwidth, from this replica's timeline
        position. Returns the ``Transfer`` (None when clock-unbound)."""
        link = self._pool_link()
        if link is None or not nbytes or not link.bandwidth_Bps:
            return None
        _, tr = link.reserve(self.cursor.now_s,
                             float(nbytes) / link.bandwidth_Bps,
                             nbytes=int(nbytes))
        return tr

    def _charge_wave(self, keys_per_layer: list, fetch=None, step_s=None):
        """Issue one retrieval wave through the store and charge its stall:
        slept at the real operating point, accounted at the emulated one.
        Returns the per-layer gathered rows when ``fetch`` is given."""
        report = self.scheduler.step(
            keys_per_layer,
            self._step_estimate_s() if step_s is None else step_s,
            fetch=fetch)
        self.stats.stall_s += report.stall_s
        if self.emulate_step_s is None:
            if report.stall_s > 0:
                time.sleep(report.stall_s)
        else:
            self.stats.emu_time_s += report.stall_s
            self.cursor.advance(report.stall_s)
        return report.gather(self.store) if fetch is not None else None
