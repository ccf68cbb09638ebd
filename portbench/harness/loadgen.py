"""The traffic: a closed loop of N clients, each sending its next request
as soon as its previous one finishes (callers that each wait for a reply).

A mix (``portbench/traffic/<mix>.json``) gives the client count, the
prompt and output length distributions (lognormal: median, sigma, clipped
to [min, max]) and how many requests each client holds. The work is the
same for every seed: ``clients x per_client`` stratified quantiles of
each distribution, dealt into ``per_client`` rounds of one request per
client, each round a stratified sample of both (every ``per_client``-th
quantile from its own offset), paired and dealt to the clients' queues by
permutations fixed by the mix's name (crc32, the port's
``serving.workload._crc_seed`` idiom). The seed draws the token ids,
uniform over the vocabulary, and the weights (``model.Weights``). Where
the seed also dealt the queues, the order in which they started moved the
admissions that the tail of the inter-token gaps sits on from one seed to
the next (PERF.md §6).
"""
from __future__ import annotations

import dataclasses
import math
import statistics
import zlib

import numpy as np


def _crc_seed(name: str) -> int:
    """Process-deterministic 31-bit seed of a name (crc32, never salted)."""
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


def quantile_lengths(spec: dict, n: int) -> np.ndarray:
    """n stratified quantiles of a lognormal (median, sigma), clipped to
    [min, max], as whole numbers, ascending."""
    z = statistics.NormalDist()
    mu = math.log(spec["median"])
    vals = [math.exp(mu + spec["sigma"] * z.inv_cdf((i + 0.5) / n))
            for i in range(n)]
    return np.clip(np.rint(vals), spec["min"], spec["max"]).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class Spec:
    prompt_len: int
    max_new: int
    key: int                 # index of the pair: the request's id stream


def plan(mix: dict, name: str) -> list:
    """Each client's list of request specs."""
    N, R = mix["clients"], mix["per_client"]
    prompts = quantile_lengths(mix["prompt"], N * R)
    outs = quantile_lengths(mix["output"], N * R)
    fixed = np.random.RandomState(_crc_seed(name))
    queues = [[] for _ in range(N)]
    for r in range(R):
        p, o = prompts[r::R], outs[r::R][fixed.permutation(N)]
        for q, j in enumerate(fixed.permutation(N)):
            queues[q].append(Spec(int(p[j]), int(o[j]), r * N + int(j)))
    return queues


def prompt_ids(spec: Spec, seed: int, vocab: int) -> list:
    """The request's prompt, uniform ids over the vocabulary."""
    rng = np.random.default_rng([int(seed), 2, spec.key])
    return rng.integers(0, vocab, size=spec.prompt_len).tolist()
