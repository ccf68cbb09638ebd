"""Continuous-batching serving engine with Engram prefetch (PyTorch port of
``repro.serving.engine``).

This slice ports the engine's main path: monolithic batched admission (one
multi-slot prefill per prompt bucket) and greedy continuous-batched decode
waves over ``max_batch`` slots, with the pool tier's cost charged through
the ``PrefetchScheduler`` and the store. With a pool tier
(``pool="CXL"``...) every decode wave materialises its Engram rows through
``TableFetcher``, i.e. the engram_gather kernel (K1); every forward fuses
them through the gated_fuse kernel (K2).

Single-sync waves, as in the reference: the host reads the device through
``_host`` only, once per admission group (first tokens | the group's
packed prompt keys) and once per steady decode wave (sampled tokens | the
next wave's packed keys); ``stats.d2h_pulls`` counts those reads. Nothing
else on a wave synchronises: host arrays go up through pinned,
non-blocking copies (``device.upload``). ``_host`` suspends PyTorch's CUDA
sync debug mode for its own read, so a caller can run waves under
``torch.cuda.set_sync_debug_mode`` and see any other sync.

Not ported in this slice (each raises NotImplementedError naming its
ROADMAP queue 1 item): chunked prefill and the prefix cache, speculation,
SLO admission/preemption and KV spill, fabrics and tier chains, the
hot-row cache.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.engram import retrieve
from ..core.hashing import (decode_engram_indices, decode_engram_keys,
                            engram_indices, pack_segment_keys)
from ..device import resolve_device, upload
from ..models.layers import with_f32_head
from ..models.model import (build_decode_step, build_prefill_step,
                            init_decode_state, init_params)
from ..models.transformer import RunFlags, check_supported
from ..pool.scheduler import PrefetchScheduler
from ..pool.store import TableFetcher, make_store
from ..pool.tiers import pool_tier
from .clock import VirtualClock
from .slots import update_slots

# Engine options of the reference that later slices port.
_UNPORTED = {
    "prefill_chunk": "2 (chunked prefill and the prefix cache)",
    "prefix_cache": "2 (chunked prefill and the prefix cache)",
    "spec": "4 (speculation)",
    "proposer": "4 (speculation)",
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
    prefill_waves: int = 0           # admission groups
    prefill_tokens: int = 0          # useful prompt tokens computed
    prefill_pad_tokens: int = 0      # executed right-pad positions

    @property
    def tokens_per_s(self) -> float:
        return _rate(self.generated_tokens, self.wall_s)

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
                 emu_prefill_scaled: bool = False, device=None,
                 **unported):
        """``device``: where the model runs — the CUDA device unless the
        caller passes ``device="cpu"``; with no CUDA device and no
        ``device`` this raises. ``params``: a parameter tree on that device
        (default: ``init_params(cfg, seed, device)``).

        ``emulate_step_s``: evaluate pool stalls at a production operating
        point instead of this host's step times (stalls are accounted in
        ``emu_time_s`` rather than slept), as in the reference. The
        reference's fleet options (``store``, ``clock``, ``name``,
        ``rid_start``, ``step_latency_hint_s``) raise until the router is
        ported."""
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
        return bool(self.queue) or any(s is not None for s in self.slots)

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
        """Drop a queued request or free its running slot (the next
        admission's scatter-write over the slot is the rollback). False if
        the rid already finished or was never submitted."""
        for req in self.queue:
            if req.rid == rid:
                self.queue.remove(req)
                self._mark_cancelled(req)
                return True
        for slot, req in enumerate(self.slots):
            if req is not None and req.rid == rid:
                self.slots[slot] = None
                self._free.append(slot)
                self._mark_cancelled(req)
                return True
        return False

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
        serving path goes through here, so ``d2h_pulls`` counts them; it is
        exempt from PyTorch's CUDA sync debug mode, so waves run under that
        mode flag any other sync."""
        self.stats.d2h_pulls += 1
        if t.device.type != "cuda":
            return t.numpy().copy()
        mode = torch.cuda.get_sync_debug_mode()
        if mode == 0:
            return t.cpu().numpy()
        torch.cuda.set_sync_debug_mode(0)
        try:
            return t.cpu().numpy()
        finally:
            torch.cuda.set_sync_debug_mode(mode)

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
        """Per-layer fetch closures gathering a wave's rows through
        ``TableFetcher`` (K1). ``keys`` is the FULL batch's (B, S, L, T)
        packed-key block: decode consumes rows for every slot, while the
        store is charged with live keys only."""
        B, S = keys.shape[:2]

        def layer_fetch(j):
            gid = self._fetchers[j].gid_for(keys[:, :, j, :])
            return lambda: self._fetchers[j](gid=gid).reshape(B, S, -1)

        return [layer_fetch(j) for j in range(len(self._fetchers))]

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
        if self._decode_ext_fn is not None:
            logits, self.state = self._decode_ext_fn(
                self.params, self.state, self.tokens, rows)
        else:
            logits, self.state = self._decode_fn(self.params, self.state,
                                                 self.tokens)
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

    def _finish_if_done(self, slot: int) -> bool:
        req = self.slots[slot]
        if req is not None and len(req.out) >= req.max_new:
            req.done_s = time.perf_counter()
            req.done_v = self.cursor.now_s
            req.status = "done"
            self.done[req.rid] = req
            self.slots[slot] = None
            self._free.append(slot)
            self.stats.requests_completed += 1
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
