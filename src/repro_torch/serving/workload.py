"""Workload spec: one way to construct serving traffic everywhere.

Before this, each entry point rolled its own traffic — `launch/serve.py`
had inline RNG prompt synthesis, `benchmarks/bench_*.py` duplicated it
with different knobs, and `bench_speculation` hand-fed literal prompts —
so "the same workload" across a benchmark, an example, and a test was a
hope, not a property. A `Workload` pins it down:

  * arrival process — `"batch"` (everything at t=0, the offline harness
    shape), `"paced"` (one request every `arrival_every` serving steps:
    admission happens *under load*), or `"poisson"` (an offered-load
    arrival process at `qps` requests per *virtual* second on the fleet's
    `VirtualClock` — the regime where TTFT/p99 curves plot against
    utilization, serving/clock.py), `"mmpp"` (two-state Markov-modulated
    Poisson: calm `qps` punctuated by `burst_factor`x bursts with
    exponential dwells — the overload drill's arrival shape), or
    `"trace"` (replay explicit arrival seconds — recorded traffic);
  * SLO class mix — `interactive_fraction` tags that fraction of requests
    `slo="interactive"` (the rest `"batch"`), the classes an
    `OverloadPolicy` (serving/slo.py) prioritizes, sheds, and preempts
    for;
  * prompt-pool reuse — `prompt_pool=N` draws prompts from N hot prompts
    (repeat traffic: the hot-row cache's and the n-gram proposer's
    steady state); `prompts=(...)` pins explicit token lists;
  * Zipf skew — `zipf_alpha` makes prompt *tokens* Zipf-distributed (the
    paper's n-gram reuse model); `zipf_fraction` mixes classes — that
    fraction of requests is Zipf traffic, the rest uniform — and every
    request carries its `klass` tag so proposer/cache quality can be
    broken down per class (RouterStats.speculation);
  * per-request `max_new` — fixed, or varied per request with
    `max_new_jitter` (staggered completions exercise slot churn);
  * shared prefixes — `prefix_pool=N, prefix_len=L` prepends each prompt
    with one of N hot L-token prefixes (`prefix_zipf_alpha` skews which),
    the fleet prefix-KV-cache's traffic shape: many requests sharing long
    identical prompt heads with private tails.

The token streams are bit-compatible with the legacy `run_once` synthesis
(same per-request RNG seeding), so `--compare` output is preserved; the
prefix fields are additive (``prefix_pool=0`` leaves every legacy stream
untouched) and seed their own RNGs through ``_crc_seed`` — crc32-chained,
so two replicas (or two processes: no ``hash()`` salting) synthesizing
the same workload produce bit-identical prompts, which is what makes
cross-replica prefix-chain keys collide and the fleet cache shareable.

A verbatim copy of ``repro.serving.workload``: the PyTorch port imports
nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import numpy as np


def _crc_seed(*parts: int) -> int:
    """Process-deterministic 31-bit RNG seed from integer parts (crc32-
    chained; ``hash()`` would be salted per process by PYTHONHASHSEED)."""
    h = 0
    for p in parts:
        h = zlib.crc32(np.int64(int(p)).tobytes(), h)
    return h & 0x7FFFFFFF


@dataclasses.dataclass(frozen=True)
class RequestSpec:
    """One request of a built workload."""
    prompt: tuple
    max_new: int
    arrival_step: int            # serving step at which the request arrives
    arrival_s: Optional[float] = None   # virtual arrival time (poisson)
    klass: str = "uniform"       # traffic class: uniform | zipf
    slo: str = "batch"           # SLO class: interactive | batch (slo.py)


def _mmpp_arrivals(n: int, qps: float, burst_factor: float, calm_s: float,
                   burst_s: float, seed: int) -> np.ndarray:
    """Two-state MMPP arrival times: a Poisson process whose rate is
    modulated by a two-state Markov chain — ``qps`` in the calm state,
    ``qps * burst_factor`` in the burst state, with exponential dwell
    times (mean ``calm_s`` / ``burst_s``). One sequential stream from one
    crc-seeded RNG, so the arrival times are bit-identical across
    processes and independent of replica count. The partial gap discarded
    at each state flip is exact thinning: exponential inter-arrivals are
    memoryless, so restarting the draw at the flip preserves the
    piecewise-Poisson law."""
    rng = np.random.RandomState(_crc_seed(seed, 5))
    out = np.empty(n, np.float64)
    t, i = 0.0, 0
    burst = False
    switch = t + rng.exponential(calm_s)
    while i < n:
        gap = rng.exponential(
            1.0 / (qps * (burst_factor if burst else 1.0)))
        if t + gap < switch:
            t += gap
            out[i] = t
            i += 1
        else:
            t = switch
            burst = not burst
            switch = t + rng.exponential(burst_s if burst else calm_s)
    return out


@dataclasses.dataclass(frozen=True)
class Workload:
    requests: int = 16
    max_new: int = 16
    max_new_jitter: int = 0      # request r gets max_new + (r % (jitter+1))
    prompt_pool: int = 0         # draw from N hot prompts (0 = all unique)
    prompts: tuple = ()          # explicit prompt pool (overrides synthesis)
    zipf_alpha: float = 0.0      # Zipf-skewed prompt tokens (0 = uniform)
    zipf_fraction: float = 1.0   # fraction of requests that are Zipf class
    prefix_pool: int = 0         # shared prompt prefixes (0 = none)
    prefix_len: int = 0          # tokens per shared prefix
    prefix_zipf_alpha: float = 0.0  # prefix-id skew (0 = round-robin)
    arrival: str = "batch"       # batch | paced | poisson | mmpp | trace
    arrival_every: int = 1       # paced: one new request every N steps
    qps: float = 0.0             # poisson/mmpp: offered load (virtual req/s)
    # mmpp (two-state Markov-modulated Poisson): calm rate = qps, burst
    # rate = qps * burst_factor, exponential dwell times per state
    burst_factor: float = 8.0
    calm_s: float = 0.1          # mean calm-state dwell (virtual s)
    burst_s: float = 0.02        # mean burst-state dwell (virtual s)
    trace: tuple = ()            # trace arrivals: explicit virtual seconds
    # SLO class mix: that fraction of requests is "interactive", the rest
    # "batch" (serving/slo.py); 0.0 leaves every request batch-class
    interactive_fraction: float = 0.0
    seed: int = 0

    def __post_init__(self):
        assert self.arrival in ("batch", "paced", "poisson", "mmpp",
                                "trace"), self.arrival
        assert self.requests >= 0 and self.max_new >= 1
        assert 0.0 <= self.zipf_fraction <= 1.0, self.zipf_fraction
        assert 0.0 <= self.interactive_fraction <= 1.0, \
            self.interactive_fraction
        if self.arrival in ("poisson", "mmpp"):
            assert self.qps > 0.0, f"{self.arrival} arrivals need qps > 0"
        if self.arrival == "mmpp":
            assert self.burst_factor >= 1.0, self.burst_factor
            assert self.calm_s > 0.0 and self.burst_s > 0.0, \
                (self.calm_s, self.burst_s)
        if self.arrival == "trace":
            assert len(self.trace) >= self.requests, \
                (len(self.trace), self.requests)
            ts = [float(t) for t in self.trace[:self.requests]]
            assert all(b >= a for a, b in zip(ts, ts[1:])), \
                "trace arrivals must be non-decreasing"
        if self.prefix_pool or self.prefix_len:
            assert self.prefix_pool > 0 and self.prefix_len > 0, \
                (self.prefix_pool, self.prefix_len)

    def build(self, vocab_size: int) -> list[RequestSpec]:
        """Materialize the request list (deterministic in `seed`)."""
        rng = np.random.RandomState(self.seed)
        # one exponential-gap draw per request: t_r = sum of Exp(1/qps)
        arrivals_s = None
        if self.arrival == "poisson":
            gaps = np.random.RandomState(self.seed ^ 0x5EED).exponential(
                1.0 / self.qps, size=self.requests)
            arrivals_s = np.cumsum(gaps)
        elif self.arrival == "mmpp":
            arrivals_s = _mmpp_arrivals(self.requests, self.qps,
                                        self.burst_factor, self.calm_s,
                                        self.burst_s, self.seed)
        elif self.arrival == "trace":
            arrivals_s = np.asarray(self.trace[:self.requests], np.float64)
        out = []
        for r in range(self.requests):
            pr = int(rng.randint(self.prompt_pool)) if self.prompt_pool else r
            # golden-ratio scatter: class mixing is equidistributed even
            # over tiny request counts (a plain prefix split would make
            # small workloads single-class)
            zipf = bool(self.zipf_alpha) and \
                ((pr * 0x9E3779B9) & 0xFFFFFFFF) / 2**32 < self.zipf_fraction
            if self.prompts:
                prompt = tuple(int(t) for t in
                               self.prompts[pr % len(self.prompts)])
            else:
                plen = 4 + (pr * 7) % 20
                if zipf:
                    from ..pool.cache import zipf_keys
                    toks = 1 + zipf_keys(plen, vocab_size - 1,
                                         alpha=self.zipf_alpha,
                                         seed=self.seed * 1000 + pr)
                    prompt = tuple(int(t) for t in toks)
                else:
                    prng = np.random.RandomState(self.seed * 1000 + pr)
                    prompt = tuple(int(t) for t in
                                   prng.randint(1, vocab_size, size=plen))
            if self.prefix_pool:
                # shared prefix: pid's token stream is keyed by (seed,
                # pid) alone, so every request — on any replica, in any
                # process — regenerates the identical prefix and their
                # chain keys collide in the fleet prefix cache
                if self.prefix_zipf_alpha:
                    from ..pool.cache import zipf_keys
                    pid = int(zipf_keys(1, self.prefix_pool,
                                        alpha=self.prefix_zipf_alpha,
                                        seed=_crc_seed(self.seed, 1, r))[0])
                else:
                    pid = r % self.prefix_pool
                xrng = np.random.RandomState(_crc_seed(self.seed, 2, pid))
                prompt = tuple(int(t) for t in
                               xrng.randint(1, vocab_size,
                                            size=self.prefix_len)) + prompt
            max_new = self.max_new
            if self.max_new_jitter:
                max_new += r % (self.max_new_jitter + 1)
            arrival = 0 if self.arrival != "paced" \
                else r * max(1, self.arrival_every)
            # SLO class by golden-ratio scatter on the REQUEST index (the
            # prompt-class scatter above runs on the pool index pr): the
            # mix is equidistributed over tiny workloads and independent
            # of prompt reuse, and — being derived from r alone — the
            # class labels are identical across processes/replica counts
            interactive = self.interactive_fraction > 0.0 and \
                (((r * 0x9E3779B9 + 0x7F4A7C15) & 0xFFFFFFFF) / 2**32
                 < self.interactive_fraction)
            out.append(RequestSpec(
                prompt=prompt, max_new=max_new, arrival_step=arrival,
                arrival_s=float(arrivals_s[r]) if arrivals_s is not None
                else None,
                klass="zipf" if zipf else "uniform",
                slo="interactive" if interactive else "batch"))
        return out
