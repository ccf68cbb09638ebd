"""PyTorch port vs the JAX reference: speculative decoding on the CPU.

On tests/test_spec.py's 3-layer deepseek-7b (Engram at layer 1) and the
reduced engram-27b (Engram at layers 2 and 4), in float32 with weights
bridged from the reference, the port's speculation must match the
reference's bit for bit in every integer output (packed block keys,
accepted lengths, proposals, token streams), with `allclose` verify
logits, equal ``EngineStats`` speculation fields and ``d2h_pulls``, and
``StoreStats`` equal field by field, under every proposer, at mixed
acceptance, with and without pipelined proposals, and for a slot whose
verify writes run into the last rows of ``max_len``. Inputs come from
numpy seeds."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import deepseek_7b as ref_deepseek_7b  # noqa: E402
from repro.configs import engram_27b as ref_engram_27b  # noqa: E402
from repro.configs.base import ENGRAM_27B as REF_ENGRAM_27B  # noqa: E402
from repro.configs.base import EngramConfig as RefEngramConfig  # noqa: E402
from repro.configs.base import SpecConfig as RefSpecConfig  # noqa: E402
from repro.core import hashing as ref_hashing  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models.transformer import RunFlags as RefRunFlags  # noqa: E402
from repro.pool import scheduler as ref_scheduler  # noqa: E402
from repro.pool import store as ref_store  # noqa: E402
from repro.serving import Engine as RefEngine  # noqa: E402
from repro import spec as ref_spec  # noqa: E402
from repro_torch import spec  # noqa: E402
from repro_torch.configs import ENGRAM_27B, EngramConfig  # noqa: E402
from repro_torch.configs import SpecConfig, deepseek_7b  # noqa: E402
from repro_torch.configs import engram_27b  # noqa: E402
from repro_torch.core import hashing  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402
from repro_torch.models.transformer import RunFlags  # noqa: E402
from repro_torch.pool import scheduler  # noqa: E402
from repro_torch.pool import store  # noqa: E402
from repro_torch.serving import Engine  # noqa: E402

torch.set_num_threads(2)

E27 = EngramConfig(**ENGRAM_27B)
REF_E27 = RefEngramConfig(**REF_ENGRAM_27B)
PROMPTS = [[5, 17, 42], [7, 8, 9, 10], [3, 1, 4, 1, 5]]
# the EngineStats fields speculation touches, and the read count
SPEC_FIELDS = ("spec_waves", "proposed_tokens", "accepted_tokens",
               "pipelined_hits", "pipelined_misses", "spec_by_class",
               "d2h_pulls", "decode_steps", "generated_tokens")
# the timeline: deterministic only at the emulated operating point
TIME_FIELDS = ("stall_s", "emu_time_s", "v_time_s")
# logits: f32 sums in another order (XLA vs PyTorch's CPU kernels)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _tiny(mod):
    """tests/test_spec.py's config: 3 layers, Engram at layer 1."""
    cfg = mod.reduced()
    return dataclasses.replace(cfg, n_layers=3, layer_types=("attn",) * 3,
                               attn_kinds=("global",) * 3,
                               ffn_types=("dense",) * 3,
                               engram=dataclasses.replace(cfg.engram,
                                                          layers=(1,)))


CONFIGS = {"tiny": (lambda: _tiny(deepseek_7b),
                    lambda: _tiny(ref_deepseek_7b)),
           "e27": (engram_27b.reduced, ref_engram_27b.reduced)}


@pytest.fixture(scope="module")
def models():
    """Per config: (port cfg, reference cfg, reference params, port
    params bridged from them)."""
    out = {}
    for name, (mk, ref_mk) in CONFIGS.items():
        cfg, rcfg = mk(), ref_mk()
        rparams = ref_model.init_params(rcfg, 0)
        params = from_jax(jax.tree.map(np.asarray, rparams), cfg,
                          device="cpu")
        out[name] = (cfg, rcfg, rparams, params)
    return out


# ------------------------------------------------------------ unit pieces

def test_accept_lengths_edges():
    block = np.asarray([[10, 1, 2, 3]] * 4)
    preds = np.asarray([
        [1, 2, 3, 99],        # all drafts accepted
        [9, 2, 3, 99],        # first draft wrong -> 0
        [1, 2, 9, 99],        # last draft wrong -> 2
        [1, 9, 3, 99],        # middle wrong: a later match must not count
    ])
    got = spec.accept_lengths(torch.from_numpy(preds), torch.from_numpy(block))
    ref = ref_spec.accept_lengths(jnp.asarray(preds, jnp.int32),
                                  jnp.asarray(block, jnp.int32))
    assert got.tolist() == np.asarray(ref).tolist() == [3, 0, 2, 1]
    # no drafts at all
    got = spec.accept_lengths(torch.from_numpy(preds[:, :1]),
                              torch.from_numpy(block[:, :1]))
    assert got.tolist() == [0] * 4


def _streams(seed: int, n: int = 6):
    """Repetitive token streams: random phrases from a small alphabet."""
    rng = np.random.RandomState(seed)
    phrases = [list(rng.randint(0, 12, size=rng.randint(2, 6)))
               for _ in range(5)]
    return [[int(t) for _ in range(8) for t in
             phrases[rng.randint(len(phrases))]] for _ in range(n)]


@pytest.mark.parametrize("max_entries", [1_000_000, 40])
def test_ngram_proposer_matches_reference(max_entries):
    """The same streams ingested slot by slot: the same proposals at every
    prefix and depth, and (a bound of 40 entries) the same pruning."""
    port = spec.NGramProposer(order=4)
    ref = ref_spec.NGramProposer(order=4)
    assert port.MAX_ENTRIES == ref.max_entries == 1_000_000
    port.MAX_ENTRIES = max_entries
    ref.max_entries = max_entries
    streams = _streams(0)
    for slot, s in enumerate(streams):
        for p in (port, ref):
            p.begin(slot, s[:5])
            p.observe(slot, s[:len(s) // 2])
            p.observe(slot, s)
        for cut in range(0, len(s), 3):
            for k in (1, 3):
                assert port.propose(slot, s[:cut], k) == \
                    ref.propose(slot, s[:cut], k)
        for p in (port, ref):
            p.end(slot)
    assert port._tables == ref._tables
    assert port.pruned == ref.pruned
    if max_entries == 40:
        assert port.pruned > 0
    assert port.propose(0, [99, 98], 2) == [98, 98]   # repeat-last fallback


def test_draft_config_matches_reference(models):
    for name in CONFIGS:
        cfg, rcfg, _, _ = models[name]
        for layers in (1, 2):
            d = spec.draft_config(cfg, SpecConfig(draft_layers=layers))
            r = ref_spec.draft_config(rcfg, RefSpecConfig(draft_layers=layers))
            assert dataclasses.asdict(d) == dataclasses.asdict(r)
            assert d.n_layers == layers and d.engram is None and d.spec is None


def _bridged_draft(cfg, rcfg, sp: SpecConfig, rsp: RefSpecConfig, seed=1):
    """The reference's draft proposer and the port's on its weights."""
    ref = ref_spec.DraftModelProposer(rcfg, rsp, seed=seed)
    params = from_jax(jax.tree.map(np.asarray, ref.params),
                      spec.draft_config(cfg, sp), device="cpu")
    return spec.DraftModelProposer(cfg, sp, params=params, device="cpu"), ref


def test_draft_proposer_matches_reference(models):
    """Bridged draft weights: the reference's proposals, bit for bit, at
    contexts shorter and longer than the draft window, one read each."""
    cfg, rcfg, _, _ = models["e27"]
    port, ref = _bridged_draft(cfg, rcfg, SpecConfig(max_draft=3),
                               RefSpecConfig(max_draft=3))
    rng = np.random.RandomState(3)
    ctxs = [[int(t) for t in rng.randint(1, cfg.vocab_size, size=n)]
            for n in (1, 5, 16, 23)]
    for ctx in ctxs:
        assert port.propose(0, ctx, 3) == ref.propose(0, ctx, 3)
    assert port.reads == len(ctxs)
    assert port.propose(0, [], 3) == [0, 0, 0] and port.reads == len(ctxs)
    with pytest.raises(ValueError, match="draft params"):
        spec.DraftModelProposer(cfg, SpecConfig(), params=port.params,
                                device="meta")


def _prefilled(name, models, B: int, max_len: int = 32):
    """A prefilled (B,)-slot state in both packages, the same prompts."""
    cfg, rcfg, rparams, params = models[name]
    rng = np.random.RandomState(11)
    lens = np.asarray([3, 6, 5, 2][:B])
    toks = np.zeros((B, 8), np.int64)
    for b, n in enumerate(lens):
        toks[b, :n] = rng.randint(1, cfg.vocab_size, size=n)
    rlogits, rstate = ref_model.build_prefill_step(
        rcfg, RefRunFlags(), max_len=max_len)(
        rparams, {"tokens": jnp.asarray(toks, jnp.int32),
                  "lengths": jnp.asarray(lens, jnp.int32)})
    logits, state = model.build_prefill_step(cfg, RunFlags(),
                                             max_len=max_len)(
        params, {"tokens": torch.from_numpy(toks),
                 "lengths": torch.from_numpy(lens)})
    t0 = np.asarray(jnp.argmax(rlogits, axis=-1))
    assert t0.tolist() == torch.argmax(logits, dim=-1).tolist()
    return rstate, state, t0


def test_multitoken_decode_matches_reference(models):
    """m unrolled steps over a random block: allclose logits, and a
    snapshot after every step with the reference's positions and last
    tokens (KV leaves are not snapshotted); the in-place KV writes of
    the m positions land where the reference's do."""
    cfg, rcfg, rparams, params = models["e27"]
    B, m = 3, 4
    rstate, state, t0 = _prefilled("e27", models, B)
    rng = np.random.RandomState(12)
    block = np.concatenate([t0[:, None], rng.randint(1, cfg.vocab_size,
                                                     size=(B, m - 1))], 1)
    rlogits, rfinal, rsnaps = jax.jit(ref_model.build_multitoken_decode(
        rcfg, RefRunFlags()))(rparams, rstate, jnp.asarray(block, jnp.int32))
    logits, final, snaps = model.build_multitoken_decode(cfg, RunFlags())(
        params, state, torch.from_numpy(block))
    assert tuple(logits.shape) == (B, m, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits),
                               **LOGIT_TOL)
    assert len(snaps) == len(rsnaps) == m + 1
    for snap, rsnap in zip(snaps, rsnaps):
        for key in ("positions", "last_tokens"):
            np.testing.assert_array_equal(snap[key].numpy(),
                                          np.asarray(rsnap[key]))
        assert all(kv["k"] is None and kv["v"] is None
                   for seg in snap["caches"] for kv in seg)
    # the first layer's keys: the reference scans layers 0 and 1 as one
    # period-1 stack, so its leaf is (2, B, S, H, D)
    rk = np.asarray(rfinal["caches"][0]["stack"][0]["k"])[0]
    np.testing.assert_allclose(final["caches"][0][0]["k"].numpy(), rk,
                               **LOGIT_TOL)


def _greedy_block(verify, params, state_fn, t0, m):
    """Each slot's greedy continuation of length m - 1, found with the
    verifier itself (drafts filled in one accepted position per call)."""
    B = len(t0)
    block = np.full((B, m), -1, np.int64)
    block[:, 0] = t0
    for j in range(1, m):
        preds = verify(params, state_fn(), block)[0]
        block[:, j] = np.asarray(preds)[:, j - 1]
    return block


def test_verifier_matches_reference_mixed_acceptance(models):
    """Three slots accepting 3, 1 and 0 of 3 drafts in one verify: the
    reference's preds, n_accept and next tokens bit for bit, and the
    rolled-back positions and last tokens (each slot at its own kept
    step)."""
    cfg, rcfg, rparams, params = models["tiny"]
    m = 4
    rstate, _, t0 = _prefilled("tiny", models, 3)
    rverify = jax.jit(ref_spec.build_verifier(rcfg, RefRunFlags()))
    greedy = _greedy_block(
        lambda p, s, b: rverify(p, s, jnp.asarray(b, jnp.int32)), rparams,
        lambda: rstate, t0, m)
    block = greedy.copy()
    block[1, 2:] = -1                      # slot 1 keeps 1 draft
    block[2, 1:] = -1                      # slot 2 keeps none
    rpreds, racc, rnext, rnew = rverify(rparams, rstate,
                                        jnp.asarray(block, jnp.int32))
    _, state, _ = _prefilled("tiny", models, 3)
    preds, acc, nxt, new = spec.build_verifier(cfg, RunFlags())(
        params, state, torch.from_numpy(block))
    assert acc.tolist() == np.asarray(racc).tolist() == [3, 1, 0]
    assert preds.tolist() == np.asarray(rpreds).tolist()
    assert nxt.tolist() == np.asarray(rnext).tolist()
    for key in ("positions", "last_tokens"):
        np.testing.assert_array_equal(new[key].numpy(), np.asarray(rnew[key]))
    np.testing.assert_array_equal(
        new["positions"].numpy(),
        np.asarray(rstate["positions"]) + np.asarray([4, 2, 1]))


def test_block_keys_match_reference_and_host_twin(models):
    """Packed (B, m, L, T) block keys: the port's device path equals the
    reference's, and the host twin equals both, slot by slot, for streams
    shorter than the n-gram history too; drafts of -1 (a rejecting
    proposer) hash as the reference's uint32 0xFFFFFFFF."""
    cfg, rcfg, _, _ = models["e27"]
    e, re = cfg.engram, rcfg.engram
    L = len(cfg.engram_layers())
    rng = np.random.RandomState(21)
    o = max(e.orders)
    for m in (1, 4):
        streams = [[int(t) for t in rng.randint(1, cfg.vocab_size, size=n)]
                   for n in (0, 1, 7)]
        block = rng.randint(0, cfg.vocab_size, size=(3, m))
        block[0, -1] = -1
        last = np.asarray([([e.pad_token] * (o - 1) + s)[-(o - 1):]
                           for s in streams], np.int32)
        got = hashing.block_engram_keys(e, torch.from_numpy(last),
                                        torch.from_numpy(block), L)
        ref = np.asarray(ref_hashing.block_engram_keys(
            re, jnp.asarray(last), jnp.asarray(block, jnp.int32), L))
        assert got.dtype == torch.int64 and tuple(got.shape) == \
            (3, m, L, e.n_tables)
        np.testing.assert_array_equal(got.numpy(), ref)
        for b, s in enumerate(streams):
            host = hashing.host_block_keys(e, s, block[b], L)
            np.testing.assert_array_equal(host, got[b].numpy())
            np.testing.assert_array_equal(
                host, ref_hashing.host_block_keys(re, s, block[b], L))
    np.testing.assert_array_equal(
        hashing.host_engram_indices(e, np.asarray([[3, -1, 7, 0]])),
        ref_hashing.host_engram_indices(re, np.asarray([[3, -1, 7, 0]])))


@pytest.mark.parametrize("split,keep", [
    ("packed", {0: 3, 2: 2, 5: 1}),
    ("packed", {0: 4, 2: 4, 5: 4}),
    ("batch_max", {0: 3, 2: 2, 5: 1}),
], ids=["packed", "packed_full", "batch_max"])
def test_speculative_wave_matches_reference(split, keep):
    """One speculated block at engram-27b's layers on a clock-bound CXL
    store and an unbound RDMA store, over each per-slot split path (the
    packed one also at full acceptance): the reference's per-position
    overshoot, stall, StoreStats field by field and trace; a second charge
    raises."""
    layers = [k - 1 for k in E27.layers]
    rng = np.random.RandomState(31)
    A, m, T = 3, 4, E27.n_tables
    keys = rng.randint(0, 600, size=(A, m, len(layers), T)) \
        + (np.arange(len(layers) * T).reshape(len(layers), T)
           * E27.table_vocab)
    keys_by_pos = [[keys[:, j, i, :].reshape(-1) for i in range(len(layers))]
                   for j in range(m)]
    slots = [0, 2, 5]
    kw = {}
    if split == "packed":
        kw = dict(slot_keys=keys.reshape(A, m, -1), slot_ids=slots)
    for tier, early in (("CXL", 5e-5), ("RDMA", 0.0)):
        out = []
        for pkg, spkg, e in ((store, scheduler, E27),
                             (ref_store, ref_scheduler, REF_E27)):
            st = pkg.TierStore(e, tier)
            sched = spkg.PrefetchScheduler(st, e, layers, n_layers=36)
            rep = sched.speculative_wave(keys_by_pos, 5e-5,
                                         early_issue_s=early, **kw)
            stall = sched.charge_spec(rep, max(keep.values()),
                                      tokens_emitted=sum(keep.values()),
                                      n_keep_by_slot=keep)
            with pytest.raises(AssertionError, match="twice"):
                sched.charge_spec(rep, 1, 1)
            out.append((rep.overshoot_s, rep.n_segments, stall,
                        dataclasses.asdict(st.stats()),
                        st.stats().spec_window_steps,
                        [dataclasses.asdict(w) for w in sched.trace]))
        assert out[0] == out[1]
        s = out[0][3]
        assert s["spec_waves"] == 1
        assert s["spec_tokens"] == sum(keep.values())
        assert s["accepted_segments"] > 0
        assert (s["wasted_segments"] > 0) == (min(keep.values()) < m)
        assert bool(s["slot_accepted"]) == (split != "batch_max")


# --------------------------------------------------- engine end to end

class _Half(ref_spec.ScriptedProposer):
    """Scripted for every slot but slot 1, whose drafts are all rejected
    (the same class serves both packages: it only returns lists)."""

    def propose(self, slot, context, k):
        if slot == 1:
            return [-1] * k
        return super().propose(slot, context, k)


# name: (config, pool, spec kwargs, proposer, prompts, max_new, engine kw)
CASES = {
    "zero_accept": ("tiny", None, {}, "constant", PROMPTS, 8, {}),
    "full_accept": ("tiny", None, {}, "scripted", PROMPTS, 8, {}),
    "ngram_cxl": ("tiny", "CXL", {}, "ngram", PROMPTS, 8,
                  dict(emulate_step_s=5e-5)),
    "draft_cxl": ("e27", "CXL", dict(max_draft=2, proposer="draft"),
                  "draft", PROMPTS, 6, dict(emulate_step_s=5e-5)),
    "mixed_cxl_pipeline": ("e27", "CXL", dict(pipeline=True), "half",
                           PROMPTS, 10, dict(emulate_step_s=5e-5)),
    "ngram_cxl_pipeline": ("e27", "CXL", dict(pipeline=True), "ngram",
                           PROMPTS * 2, 12, dict(emulate_step_s=5e-5)),
    # prompt + max_new = 15 and 16 with max_len 16: the last verify waves
    # write past the end (clamped to the last row, as the reference's)
    "near_max_len": ("e27", "CXL", dict(pipeline=True), "scripted",
                     [[5, 17, 42, 9, 3], [7, 8, 9, 10, 11, 12]], 10,
                     dict(emulate_step_s=5e-5, max_len=16)),
}


def _plain_streams(cfg, params, prompts, max_new, kw):
    """The port's greedy streams without speculation (the port's plain
    engine is held to the reference in tests/test_torch_engine.py)."""
    kw = dict(kw)
    eng = Engine(cfg, params=params, max_batch=2, prompt_bucket=8,
                 device="cpu", max_len=kw.pop("max_len", 64), **kw)
    rids = [eng.submit(list(p), max_new=max_new) for p in prompts]
    eng.run()
    return [eng.done[r].out for r in rids]


def _run(ref: bool, cfg, params, pool, sp, proposer, prompts, max_new, kw):
    kw = dict(kw)
    common = dict(params=params, max_batch=2, prompt_bucket=8, pool=pool,
                  spec=sp, proposer=proposer, max_len=kw.pop("max_len", 64),
                  **kw)
    eng = RefEngine(cfg, **common) if ref else \
        Engine(cfg, device="cpu", **common)
    rids = [eng.submit(list(p), max_new=max_new) for p in prompts]
    eng.run()
    return eng, [eng.done[r].out for r in rids]


@pytest.fixture(scope="module")
def engine_runs(models):
    """Each case run once on both engines (the reference's runs are the
    slow part): ``{case: (reference engine, port engine, reference
    streams, port streams, plain streams)}``, filled on first use."""
    cache = {}

    def get(case):
        if case in cache:
            return cache[case]
        name, pool, skw, kind, prompts, max_new, kw = CASES[case]
        cfg, rcfg, rparams, params = models[name]
        plain = _plain_streams(cfg, params, prompts, max_new, kw)
        script = [list(p) + o for p, o in zip(prompts, plain)]
        sp, rsp = SpecConfig(**skw), RefSpecConfig(**skw)
        if kind == "draft":
            port_prop, ref_prop = _bridged_draft(cfg, rcfg, sp, rsp)
        else:
            make = {"constant": lambda pkg: pkg.ConstantProposer(-1),
                    "scripted": lambda pkg: pkg.ScriptedProposer(script),
                    "half": lambda pkg: _Half(script),
                    "ngram": lambda pkg: None}[kind]
            port_prop, ref_prop = make(spec), make(ref_spec)
        reng, rout = _run(True, rcfg, rparams, pool, rsp, ref_prop, prompts,
                          max_new, kw)
        eng, out = _run(False, cfg, params, pool, sp, port_prop, prompts,
                        max_new, kw)
        cache[case] = (reng, eng, rout, out, plain)
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_spec_engine_matches_reference(engine_runs, case):
    """The reference's token streams (which are the plain greedy ones),
    speculation fields of EngineStats including the read count, and
    StoreStats field by field; at the emulated point also the virtual
    clock."""
    reng, eng, rout, out, plain = engine_runs(case)
    assert out == rout == plain
    for f in SPEC_FIELDS:
        assert getattr(eng.stats, f) == getattr(reng.stats, f), f
    for f in ("acceptance_rate", "pipeline_hit_rate", "tokens_per_step"):
        assert getattr(eng.stats, f) == getattr(reng.stats, f), f
    assert dataclasses.asdict(eng.store.stats()) == \
        dataclasses.asdict(reng.store.stats())
    assert eng.store.stats().spec_window_steps == \
        reng.store.stats().spec_window_steps
    if eng.emulate_step_s is not None:
        for f in TIME_FIELDS:
            assert getattr(eng.stats, f) == getattr(reng.stats, f), f
        assert eng.clock.stats() == reng.clock.stats()
    assert eng.stats.spec_waves == eng.stats.decode_steps > 0
    assert not eng._pipelined              # every booking settled


def test_spec_engine_acceptance_regimes(engine_runs):
    """The cases cover what they claim: no draft accepted, every draft
    accepted, one slot rejecting while the other accepts, pipelined
    predictions that survive (single-read waves) and that miss."""
    zero = engine_runs("zero_accept")[1].stats
    assert zero.acceptance_rate == 0.0
    full = engine_runs("full_accept")[1].stats
    assert full.acceptance_rate == 1.0
    assert full.decode_steps < zero.decode_steps
    mixed = engine_runs("mixed_cxl_pipeline")[1].stats
    assert 0.0 < mixed.acceptance_rate < 1.0
    assert mixed.pipelined_hits > 0 and mixed.pipelined_misses > 0
    near = engine_runs("near_max_len")[1]
    assert near.stats.pipelined_hits > 0 and near.stats.pipeline_hit_rate > 0.5
    ngram = engine_runs("ngram_cxl_pipeline")[1]
    assert ngram.stats.accepted_tokens > 0
    assert ngram.store.stats().spec_window_steps > 1.0


def test_pipelined_wave_reads_once(models):
    """Scripted (full acceptance) and pipelined, pool mode: once a slot's
    prediction has survived, a wave reads the device once (the verdict);
    the wave after admission reads twice (keys, verdict)."""
    cfg, _, _, params = models["e27"]
    plain = _plain_streams(cfg, params, PROMPTS[:1], 13, {})
    eng = Engine(cfg, params=params, max_batch=2, max_len=64, prompt_bucket=8,
                 pool="CXL", emulate_step_s=5e-5, device="cpu",
                 spec=SpecConfig(pipeline=True),
                 proposer=spec.ScriptedProposer([PROMPTS[0] + plain[0]]))
    rt = eng.runtime()
    h = rt.submit(PROMPTS[0], max_new=13)
    reads = []
    while eng.busy:
        before = eng.stats.d2h_pulls
        rt.step()
        reads.append(eng.stats.d2h_pulls - before)
    assert h.result() == plain[0]
    assert reads == [1 + 2, 1, 1]         # admission + 2, then 1 per wave
    assert eng.stats.pipelined_hits == 2


def test_cancel_refunds_pipelined_booking(models):
    """A running request's pipelined prefetch booking is refunded on
    cancel, leaving the link's ledger as the reference's."""
    cfg, rcfg, rparams, params = models["tiny"]
    out = []
    for ref, c, p, pkg, sp in ((False, cfg, params, spec, SpecConfig),
                               (True, rcfg, rparams, ref_spec,
                                RefSpecConfig)):
        kw = dict(params=p, max_batch=2, max_len=64, prompt_bucket=8,
                  pool="CXL", emulate_step_s=5e-5, spec=sp(pipeline=True),
                  proposer=pkg.ConstantProposer(3))
        eng = RefEngine(c, **kw) if ref else Engine(c, device="cpu", **kw)
        rt = eng.runtime()
        a = rt.submit(PROMPTS[0], max_new=8)
        rt.submit(PROMPTS[1], max_new=8)
        rt.step()
        rt.step()
        assert eng._pipelined and rt.cancel(a)
        out.append((len(eng._pipelined), eng.clock.stats()))
        eng.run()
    assert out[0] == out[1]


def test_spec_refuses_chunked_prefill(models):
    cfg, _, _, params = models["tiny"]
    with pytest.raises(ValueError, match="not gated"):
        Engine(cfg, params=params, device="cpu", spec=SpecConfig(),
               prefill_chunk=4)
    # spec from the config, and a disabled one
    on = dataclasses.replace(cfg, spec=SpecConfig(max_draft=2))
    assert Engine(on, params=params, device="cpu").spec.max_draft == 2
    assert Engine(cfg, params=params, device="cpu",
                  spec=SpecConfig(enabled=False)).spec is None


def test_spec_engine_without_engram(models):
    """A model without Engram layers verifies without external rows and
    emits its greedy streams under a rejecting and a scripted proposer."""
    bare = dataclasses.replace(models["tiny"][0], engram=None)
    weights = model.init_params(bare, 0, "cpu")
    plain = _plain_streams(bare, weights, PROMPTS, 6, {})
    script = [list(p) + o for p, o in zip(PROMPTS, plain)]
    for proposer in (spec.ConstantProposer(-1),
                     spec.ScriptedProposer(script)):
        eng = Engine(bare, params=weights, max_batch=2, max_len=64,
                     prompt_bucket=8, device="cpu", spec=SpecConfig(),
                     proposer=proposer)
        rids = [eng.submit(list(p), max_new=6) for p in PROMPTS]
        eng.run()
        assert [eng.done[r].out for r in rids] == plain
        assert eng.stats.spec_waves > 0
