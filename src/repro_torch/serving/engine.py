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

Single-sync waves, as in the reference: the host reads the device through
``_host`` only, once per admission group (first tokens | the group's
packed prompt keys), once per chunk wave (sampled tokens | the chunk's
packed keys), once per steady decode wave (sampled tokens | the next
wave's packed keys) and twice per speculative wave (the packed (B, m, L,
T) block keys, then the fused (B, m+1) verdict [preds | n_accept]); a
speculative wave whose every live slot's pipelined prediction survived
packed its keys on the host (``hashing.host_block_keys``, bit-equal) and
reads only the verdict. A prefix spill's snapshot is one more counted
read. ``stats.d2h_pulls`` counts those reads. Nothing else on a wave
synchronises (a draft-model proposer's one read per proposal is counted
in its own ``reads``): host arrays go up through pinned, non-blocking
copies (``device.upload``). The reads suspend PyTorch's CUDA sync debug
mode (``device.sync_allowed``), so a caller can run waves under
``torch.cuda.set_sync_debug_mode`` and see any other sync.

Not ported in this slice (each raises NotImplementedError naming its
ROADMAP queue 1 item): SLO admission/preemption and KV spill, fabrics and
tier chains, the fleet options of the router.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..configs.base import ModelConfig, SpecConfig
from ..core.engram import retrieve
from ..core.hashing import (block_engram_indices, block_engram_keys,
                            decode_engram_indices, decode_engram_keys,
                            engram_indices, host_block_keys,
                            pack_segment_keys, prefix_chain_keys)
from ..device import resolve_device, sync_allowed, upload
from ..models.layers import with_f32_head
from ..models.model import (build_chunk_prefill, build_decode_step,
                            build_prefill_step, init_decode_state,
                            init_params)
from ..models.transformer import RunFlags, check_supported
from ..pool.scheduler import PrefetchScheduler
from ..pool.store import TableFetcher, fetch_layers, make_store
from ..pool.tiers import pool_tier
from .clock import VirtualClock
from .slots import (extract_prefix, gate_state, restore_prefix,
                    select_slots, update_slots)

# Engine options of the reference that later slices port.
_UNPORTED = {
    "slo_policy": "5 (overload and KV spill)",
    "kv_pool": "5 (overload and KV spill)",
    "arbiter": "5 (overload and KV spill)",
    "idle_spill_tokens": "5 (overload and KV spill)",
    "fabric": "6 (tierchain.py and fabric.py)",
    "fabric_nodes": "6 (tierchain.py and fabric.py)",
    "store": "7 (router, api and workload)",
    "clock": "7 (router, api and workload)",
    "name": "7 (router, api and workload)",
    "rid_start": "7 (router, api and workload)",
    "step_latency_hint_s": "7 (router, api and workload)",
}


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    submitted_s: float = 0.0
    first_token_s: float = 0.0
    done_s: float = 0.0
    status: str = "queued"     # queued | running | done | cancelled
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
    # proposer quality per workload class: {klass: {proposed, accepted}};
    # the port has no request classes yet, so every slot is "uniform"
    spec_by_class: dict = dataclasses.field(default_factory=dict)

    @property
    def tokens_per_s(self) -> float:
        return _rate(self.generated_tokens, self.wall_s)

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
    def mean_ttft_s(self) -> float:
        """Mean submit -> first-token latency over admitted requests."""
        return _rate(self.ttft_s_sum, self.prefills)

    @property
    def mean_ttft_v(self) -> float:
        return _rate(self.ttft_v_sum, self.prefills)


def _bucket(n: int, bucket: int) -> int:
    return max(bucket, -(-n // bucket) * bucket)


class Engine:
    def __init__(self, cfg: ModelConfig, *, params=None,
                 flags: RunFlags = RunFlags(), max_batch: int = 8,
                 max_len: int = 512, prompt_bucket: int = 32,
                 pool: Optional[str] = None, seed: int = 0,
                 emulate_step_s: Optional[float] = None,
                 emu_prefill_scaled: bool = False,
                 prefill_chunk: Optional[int] = None, prefix_cache=None,
                 spec: Optional[SpecConfig] = None, proposer=None,
                 device=None, **unported):
        """``device``: where the model runs — the CUDA device unless the
        caller passes ``device="cpu"``; with no CUDA device and no
        ``device`` this raises. ``params``: a parameter tree on that device
        (default: ``init_params(cfg, seed, device)``).

        ``emulate_step_s``: evaluate pool stalls at a production operating
        point instead of this host's step times (stalls are accounted in
        ``emu_time_s`` rather than slept), as in the reference. The
        reference's fleet options (``store``, ``clock``, ``name``,
        ``rid_start``, ``step_latency_hint_s``) raise until the router is
        ported.

        ``prefill_chunk``: chunked admission (see the module docstring);
        None keeps monolithic admission. ``prefix_cache``: a
        ``pool.cache.PrefixKVCache`` whose ``block_tokens`` equal
        ``prefill_chunk`` (snapshots exist only at chunk boundaries).

        ``spec``: speculative decoding (default ``cfg.spec``; see the
        module docstring); it refuses ``prefill_chunk``, since the verify
        pass is not gated. ``proposer``: a draft proposer to use instead of
        the one ``spec.proposer`` names (tests and benches)."""
        for key, val in unported.items():
            if key not in _UNPORTED:
                raise TypeError(f"Engine() got an unexpected keyword "
                                f"argument {key!r}")
            if val:
                raise NotImplementedError(
                    f"Engine({key}=...) is ROADMAP queue 1, item "
                    f"{_UNPORTED[key]}")
        check_supported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.flags = flags
        self.max_batch = max_batch
        self.max_len = max_len
        self.prompt_bucket = prompt_bucket
        self.pool = pool_tier(pool) if pool else None
        self.emulate_step_s = emulate_step_s
        self.emu_prefill_scaled = bool(emu_prefill_scaled)
        self.clock = VirtualClock()
        self.cursor = self.clock.cursor("engine")
        if params is None:
            params = init_params(cfg, seed, self.device)
        if params["embed"]["w"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed']['w'].device}, "
                             f"the engine runs on {self.device}")
        self.params = with_f32_head(params)
        self.has_engram = bool(cfg.engram_layers()) and "engram" in params
        self._n_eng = len(cfg.engram_layers())

        self.store = None
        self.scheduler = None
        self._fetchers = None
        if self.has_engram:
            # link contention only at the emulated operating point (see the
            # reference engine: real-mode cursors mirror host wall time)
            link_clock = self.clock if emulate_step_s is not None else None
            self.store = make_store(cfg.engram, pool, clock=link_clock)
            self.store.bind_cursor(self.cursor)
            self.scheduler = PrefetchScheduler(self.store, cfg.engram,
                                               layers=cfg.engram_layers(),
                                               n_layers=cfg.n_layers)
            if self.pool is not None:
                # decode rows are materialised by the engram_gather kernel
                self._fetchers = [
                    TableFetcher(cfg.engram,
                                 self.params["engram"]["layers"][j]["tables"])
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
        self._rid = 0
        self._runtime = None
        self._step_times: list[float] = []
        self._free: deque[int] = deque(range(max_batch))   # free slot ids
        self._tokens_host = np.zeros((max_batch,), np.int64)  # self.tokens
        self._next_keys: Optional[np.ndarray] = None  # (B,1,L,T) prefetched
        self._prompt_buf = np.zeros((max_batch, prompt_bucket), np.int64)

    # ------------------------------------------------------------ public API

    def submit(self, prompt: list, max_new: int = 16) -> int:
        """Queue a request; returns its id."""
        self._rid += 1
        req = Request(self._rid, list(prompt), max_new,
                      submitted_s=time.perf_counter(),
                      submitted_v=self.cursor.now_s)
        self.queue.append(req)
        return self._rid

    @property
    def busy(self) -> bool:
        """Anything queued or mid-flight?"""
        return (bool(self.queue) or bool(self._prefill_jobs)
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
        """Drop a queued request, a prefill job or a running slot (the next
        admission's scatter-write over the slot is the rollback). False if
        the rid already finished or was never submitted."""
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
        events = []
        if not (self._free and self.queue):
            return events
        fills = []
        while self._free and self.queue:
            fills.append((self._free.popleft(), self.queue.popleft()))
        groups: dict[int, list] = {}
        for slot, req in fills:
            S = _bucket(len(req.prompt), self.prompt_bucket)
            groups.setdefault(S, []).append((slot, req))
        charge = [[] for _ in range(self._n_eng)] if self._pool_mode else None
        for S, group in sorted(groups.items()):
            n = len(group)
            self.cursor.next_wave()
            t_g = time.perf_counter()
            buf = self._prompt_view(n, S)
            lens = np.ones((n,), np.int64)
            for r, (_, req) in enumerate(group):
                buf[r, :len(req.prompt)] = req.prompt
                lens[r] = len(req.prompt)
            useful = int(lens.sum())
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
                    live = pk[r, :lens[r]]       # drop right-pad positions
                    for j in range(self._n_eng):
                        charge[j].append(live[:, j, :].reshape(-1))
            t_now = time.perf_counter()
            self.cursor.advance(emu_s if emu_s is not None else t_now - t_g)
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
        no events."""
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
        ``max_len``) over the job's slot, or, for a fresh prompt, reset
        only the slot's position and last tokens. The previous occupant's
        KV needs no clearing: attention masks it past the row's position,
        and each step writes its own position before it attends there."""
        if job.restore is not None:
            update_slots(self.state, restore_prefix(
                job.restore, self.max_len, self.device), [job.slot])
            job.restore = None
        else:
            # fill_, not item assignment: assigning a Python number to a
            # CUDA tensor's element copies it from the host and syncs
            e = self.cfg.engram
            self.state["positions"][job.slot].fill_(0)
            self.state["last_tokens"][job.slot].fill_(e.pad_token if e else 0)
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
                "uniform", {"proposed": 0, "accepted": 0})
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
