"""PyTorch port vs the JAX reference: serving the recurrent mixers on the
CPU, and the decode-state surgery their state needs.

Reduced jamba-1.5-large-398b (Mamba with one attention layer and MoE
FFNs, Engram at layers 1 and 4) and reduced xlstm-125m (mLSTM and sLSTM,
no FFN, a tied head), in float32 with weights bridged from the reference,
through the reference's ``Engine`` and the port's at the emulated
operating point (``pool="CXL"``): identical greedy streams and equal
``StoreStats`` under monolithic admission, chunked admission with a
``PrefixKVCache`` (equal ``PrefixCacheStats``) and speculation with an
always-wrong and an n-gram proposer (the twin of
tests/test_spec.py::test_rollback_recurrent_state).

F11 (ROADMAP §3): the reference's monolithic admission runs the recurrent
mixers over a prompt bucket's right-pad tokens, so a padded bucket gives
other streams than an unpadded one, while chunked admission gives the
unpadded streams; the port mirrors it in all three.

The surgery: ``gate_state`` gates recurrent leaves per row,
``reset_slot`` clears them, ``_pad_caches_to`` pads only KV leaves,
speculation snapshots hold each step's own recurrent tensors, and
``rollback_state`` re-selects ``ssm``/``C`` at each slot's kept step.
Overload: a preempted slot's snapshot carries its recurrent leaves whole
(``extract_prefix`` slices only KV leaves), so it resumes where it was.
Integers bit for bit."""
import copy
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import jamba_1_5_large_398b as ref_jamba  # noqa: E402
from repro.configs import xlstm_125m as ref_xlstm  # noqa: E402
from repro.configs.base import SpecConfig as RefSpecConfig  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.pool.cache import PrefixKVCache as RefPrefixKVCache  # noqa: E402
from repro.serving import Engine as RefEngine  # noqa: E402
from repro.serving import EngramRuntime as RefRuntime  # noqa: E402
from repro.serving import slo as ref_slo  # noqa: E402
from repro import spec as ref_spec  # noqa: E402
from repro_torch import spec  # noqa: E402
from repro_torch.configs import SpecConfig  # noqa: E402
from repro_torch.configs import jamba_1_5_large_398b, xlstm_125m  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models.params import from_jax, tree_leaves  # noqa: E402
from repro_torch.models.transformer import RunFlags  # noqa: E402
from repro_torch.pool.cache import PrefixKVCache  # noqa: E402
from repro_torch.serving import Engine, EngramRuntime, slo  # noqa: E402
from repro_torch.serving import slots  # noqa: E402

torch.set_num_threads(2)

MODULES = {"jamba-1.5-large-398b": (jamba_1_5_large_398b, ref_jamba),
           "xlstm-125m": (xlstm_125m, ref_xlstm)}
# tests/test_spec.py::test_rollback_recurrent_state's prompts
PROMPTS = [[5, 17, 42], [9, 8, 7]]
ENGINE_KW = dict(pool="CXL", max_batch=2, max_len=64, emulate_step_s=5e-5)
# the admissions of F11: (keyword arguments, whether the prompts are padded)
ADMISSIONS = {"bucket8": (dict(prompt_bucket=8), True),
              "bucket3": (dict(prompt_bucket=3), False),
              "chunk8": (dict(prompt_bucket=8, prefill_chunk=8), False)}


@pytest.fixture(scope="module")
def bridged():
    """Per name: (port cfg, ref cfg, ref params, port params bridged)."""
    out = {}
    for name, (mod, ref_mod) in MODULES.items():
        cfg, rcfg = mod.reduced(), ref_mod.reduced()
        rparams = ref_model.init_params(rcfg, 0)
        out[name] = (cfg, rcfg, rparams,
                     from_jax(jax.tree.map(np.asarray, rparams), cfg,
                              device="cpu"))
    return out


def _shared_head(cfg):
    """Three prompts sharing a 16-token head (two prefix-cache blocks)."""
    rng = np.random.RandomState(4)
    head = [int(t) for t in rng.randint(1, cfg.vocab_size, size=16)]
    return [head + [int(t) for t in rng.randint(1, cfg.vocab_size, size=n)]
            for n in (3, 7, 12)]


def _serve(engine, prompts, max_new):
    rids = [engine.submit(list(p), max_new=max_new) for p in prompts]
    engine.run()
    return [engine.done[r].out for r in rids]


def _serve_chunked(engine, cfg, max_new):
    """PROMPTS[0], with the longest shared-head prompt (four chunk waves)
    submitted after its first step (a chunk wave and a decode wave), so
    the decode waves run over a slot mid-prefill (``gate_state`` must
    keep that slot's recurrent state);
    then PROMPTS[1] and the other two shared-head prompts one at a time,
    restoring the head the long prompt spilled to the prefix cache. Every
    chunk wave has one row: the reference compiles one wave shape.
    Returns the streams of PROMPTS, then of the shared-head prompts."""
    shared = _shared_head(cfg)
    rt = engine.runtime()
    first = rt.submit(PROMPTS[0], max_new)
    rt.step()
    assert first.request.status == "running" and \
        0 < len(first.tokens) < max_new
    long = rt.submit(shared[2], max_new)
    rt.drain()
    rest = [_serve(engine, [p], max_new)[0]
            for p in (PROMPTS[1], shared[0], shared[1])]
    return [first.tokens, rest[0], rest[1], rest[2], long.tokens]


@pytest.fixture(scope="module")
def engine_runs(bridged):
    """Each (config, mode) run once on both engines, filled on first use:
    {(name, mode): (reference engine, port engine, reference streams,
    port streams)}. Modes are ADMISSIONS' names and the two proposers'.
    The chunked engines (``chunk8``) carry a PrefixKVCache and serve
    ``_serve_chunked``'s sequence."""
    cache = {}

    def get(name, mode):
        if (name, mode) in cache:
            return cache[(name, mode)]
        cfg, rcfg, rparams, params = bridged[name]
        kw, rkw = dict(ENGINE_KW), dict(ENGINE_KW)
        if mode in ADMISSIONS:
            kw.update(ADMISSIONS[mode][0])
            rkw.update(ADMISSIONS[mode][0])
        else:
            kw.update(prompt_bucket=8, spec=SpecConfig(max_draft=3),
                      proposer=spec.ConstantProposer(-1) if mode == "wrong"
                      else spec.NGramProposer(4))
            rkw.update(prompt_bucket=8, spec=RefSpecConfig(max_draft=3),
                       proposer=ref_spec.ConstantProposer(-1)
                       if mode == "wrong" else ref_spec.NGramProposer(4))
        if mode == "chunk8":
            kw.update(prefix_cache=PrefixKVCache(64 << 20, 8))
            rkw.update(prefix_cache=RefPrefixKVCache(64 << 20, 8))
        runs = []
        for eng in (RefEngine(rcfg, params=rparams, **rkw),
                    Engine(cfg, params=params, device="cpu", **kw)):
            runs.append((eng, _serve_chunked(eng, cfg, 6) if mode == "chunk8"
                         else _serve(eng, PROMPTS, 6)))
        (reng, want), (eng, got) = runs
        cache[(name, mode)] = (reng, eng, want, got)
        return cache[(name, mode)]

    return get


@pytest.mark.parametrize("mode", ["bucket8", "chunk8", "wrong", "ngram"])
@pytest.mark.parametrize("name", sorted(MODULES))
def test_engine_streams_match_reference(engine_runs, name, mode):
    """Six new tokens per prompt: the reference Engine's streams bit for
    bit, StoreStats field by field and the virtual clock. Monolithic
    admission pads the prompts to 8 (F11 mirrored); chunked admission
    decodes one row while another is mid-prefill, and restores a shared
    head from the prefix cache with the reference's PrefixCacheStats (its
    snapshots carry every recurrent leaf whole);
    speculation with an always-wrong proposer (every draft rejected, the
    recurrent state rolled back each wave) and the n-gram proposer emits
    the monolithic streams."""
    reng, eng, want, got = engine_runs(name, mode)
    assert got == want
    assert all(len(s) == 6 for s in got)
    assert dataclasses.asdict(eng.store.stats()) == \
        dataclasses.asdict(reng.store.stats())
    assert eng.clock.stats() == reng.clock.stats()
    if mode == "chunk8":
        assert eng.stats.prefix_hit_blocks == \
            reng.stats.prefix_hit_blocks > 0
        assert dataclasses.asdict(eng.prefix_cache.stats()) == \
            dataclasses.asdict(reng.prefix_cache.stats())
    if mode in ("wrong", "ngram"):
        assert got == engine_runs(name, "bucket8")[3]
        assert eng.stats.accepted_tokens == reng.stats.accepted_tokens
        assert eng.stats.proposed_tokens == reng.stats.proposed_tokens > 0
    if mode == "wrong":
        assert eng.stats.accepted_tokens == 0


@pytest.mark.parametrize("name", sorted(MODULES))
def test_f11_pad_tokens_reach_the_recurrent_state(engine_runs, name):
    """F11 in both packages: the unpadded bucket (3) and chunked admission
    give one pair of streams, the bucket of 8 (5 right-pad tokens scanned
    by every recurrent mixer) another; the port's streams are the
    reference's in all three."""
    streams = {}
    for mode, (_, padded) in ADMISSIONS.items():
        _, _, want, got = engine_runs(name, mode)
        assert got[:2] == want[:2], mode
        streams[mode] = got[:2]
    assert streams["bucket3"] == streams["chunk8"]
    assert streams["bucket8"] != streams["bucket3"]
    # the first token comes from the prefill logits at the last real
    # token, which the pads (to its right) do not reach
    assert [s[0] for s in streams["bucket8"]] == \
        [s[0] for s in streams["bucket3"]]


@pytest.mark.parametrize("name", sorted(MODULES))
def test_f11_padded_prefill_moves_the_decode_state(bridged, name):
    """F11 at the model: a 3-token prompt prefilled alone and in a bucket
    of 8 (five zero pad tokens to its right, ``lengths`` 3, as the
    engine's prompt buffer holds it) gives the same first-token logits,
    but the state the pads leave moves the next decode step's logits by
    more than 1 % of their largest magnitude (attention alone would
    leave them within f32 rounding: its pad positions are masked)."""
    cfg, _, _, params = bridged[name]
    prefill = port_model.build_prefill_step(cfg, RunFlags(), max_len=16)
    dec = port_model.build_decode_step(cfg, RunFlags())
    runs = []
    for toks in ([5, 17, 42], [5, 17, 42, 0, 0, 0, 0, 0]):
        first, state = prefill(params, {"tokens": torch.tensor([toks]),
                                        "lengths": torch.tensor([3])})
        runs.append((first, dec(params, state, first.argmax(-1))[0]))
    (first_a, next_a), (first_b, next_b) = runs
    torch.testing.assert_close(first_a, first_b, rtol=1e-5, atol=1e-5)
    moved = (next_a - next_b).abs().max().item()
    assert moved > 1e-2 * next_a.abs().max().item(), moved


# ------------------------------------------------------ state surgery

def _state(bridged, name, n=3, S=6):
    """A prefilled batch-``n`` state of the reduced ``name`` config."""
    cfg, _, _, params = bridged[name]
    toks = torch.from_numpy(np.random.RandomState(8).randint(
        1, cfg.vocab_size, size=(n, S)))
    _, state = port_model.build_prefill_step(cfg, RunFlags(), max_len=16)(
        params, {"tokens": toks})
    return cfg, params, state


def _named(tree, name=None):
    """(leaf name, leaf) pairs of a state tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, k)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _named(v, name)
    else:
        yield name, tree


def test_gate_state_gates_recurrent_leaves(bridged):
    """Rows with ``valid`` false keep the old positions, last tokens and
    every recurrent leaf (conv, ssm); KV leaves are the new state's
    tensors, untouched."""
    cfg, params, old = _state(bridged, "jamba-1.5-large-398b")
    _, new = port_model.build_decode_step(cfg, RunFlags())(
        params, copy.deepcopy(old), torch.tensor([3, 4, 5]))
    valid = torch.tensor([True, False, True])
    gated = slots.gate_state(valid, new, old)
    names = set()
    for (name, g), (_, n), (_, o) in zip(_named(gated), _named(new),
                                          _named(old)):
        names.add(name)
        if name in slots.KV_KEYS:
            assert g is n
            continue
        assert torch.equal(g[0], n[0]) and torch.equal(g[2], n[2])
        assert torch.equal(g[1], o[1]), name
        assert not torch.equal(n[1], o[1]), name
    assert {"conv", "ssm", "k", "v", "positions", "last_tokens"} <= names


def test_reset_slot_clears_recurrent_leaves(bridged):
    """A fresh prompt's slot: position 0, the pad tokens, every recurrent
    leaf zero; the other slots and the KV leaves are untouched."""
    cfg, _, state = _state(bridged, "xlstm-125m")
    before = copy.deepcopy(state)
    slots.reset_slot(state, 1, cfg.engram.pad_token)
    for (name, a), (_, b) in zip(_named(state), _named(before)):
        assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
        if name in slots.KV_KEYS:
            assert torch.equal(a, b)
        elif name == "last_tokens":
            assert a[1].eq(cfg.engram.pad_token).all()
        else:
            assert not a[1].any(), name


def test_pad_caches_pads_only_kv_leaves():
    """``_pad_caches_to`` pads k/v along the sequence axis and leaves
    Mamba's conv (B, K-1, di) and ssm alone (the reference's seq_axis
    map has no entry for them)."""
    caches = [[{"conv": torch.ones(2, 3, 8), "ssm": torch.ones(2, 8, 4)},
               {"k": torch.ones(2, 5, 2, 4), "v": torch.ones(2, 5, 2, 4)}]]
    out = port_model._pad_caches_to(caches, 9)[0]
    assert {n: tuple(t.shape) for c in out for n, t in c.items()} == \
        {"conv": (2, 3, 8), "ssm": (2, 8, 4), "k": (2, 9, 2, 4),
         "v": (2, 9, 2, 4)}
    assert out[0]["conv"] is caches[0][0]["conv"]


@pytest.mark.parametrize("name", sorted(MODULES))
def test_speculation_snapshots_and_rollback(bridged, name):
    """A 3-token verify pass over a prefilled batch of 3: snapshot s
    holds the recurrent state after s sequential decode steps (no
    snapshot aliases a later step's, the pre-verify one the state's
    values before the pass), and ``rollback_state`` with kept steps
    [0, 2, 3] gives each slot its own step's ``ssm``/``C`` and positions."""
    cfg, params, state = _state(bridged, name)
    block = torch.from_numpy(np.random.RandomState(9).randint(
        1, cfg.vocab_size, size=(3, 3)))
    dec = port_model.build_decode_step(cfg, RunFlags())
    seq = [copy.deepcopy(state)]
    for s in range(3):
        seq.append(dec(params, copy.deepcopy(seq[-1]), block[:, s])[1])
    _, final, snaps = port_model.build_multitoken_decode(cfg, RunFlags())(
        params, state, block)
    key = "ssm" if name.startswith("jamba") else "C"
    for s, snap in enumerate(snaps):
        for (n, a), (_, b) in zip(_named(snap), _named(seq[s])):
            if n not in slots.KV_KEYS:
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    keep = torch.tensor([0, 2, 3])
    back = slots.rollback_state(final, snaps, keep)
    checked = 0
    for (n, a), *per_step in zip(_named(back), *map(_named, seq)):
        if n in (key, "positions"):
            for row, k in enumerate(keep.tolist()):
                torch.testing.assert_close(a[row], per_step[k][1][row],
                                           rtol=1e-5, atol=1e-5)
            checked += 1
    assert checked > 1
    assert back["positions"].tolist() == [6, 8, 9]
    assert all(t.shape[0] == 3 for t in tree_leaves(back["caches"]))


@pytest.mark.parametrize("name", sorted(MODULES))
def test_preempt_and_restore_match_reference(bridged, name):
    """The twin of tests/test_torch_deepseek.py's: two batch requests fill
    both slots; after three steps two interactive ones preempt them,
    parking their state (the attention layers' KV and every recurrent
    leaf) in the pool, and they are restored later: the reference's
    streams, preemption counts, spill and restore bytes and
    ``KVPoolStats``."""
    cfg, rcfg, rparams, params = bridged[name]
    rng = np.random.RandomState(7)
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab_size, size=n)]
               for n in (9, 6, 5, 4)]
    kw = dict(ENGINE_KW, prompt_bucket=8, emulate_step_s=2e-4)
    runs = []
    for rt in (RefRuntime(rcfg, params=rparams, slo_policy=ref_slo.
                          OverloadPolicy(spill_pool_bytes=8 << 20,
                                         spill_page_tokens=4), **kw),
               EngramRuntime(cfg, params=params, device="cpu",
                             slo_policy=slo.OverloadPolicy(
                                 spill_pool_bytes=8 << 20,
                                 spill_page_tokens=4), **kw)):
        hs = [rt.submit(prompts[0], 14, slo="batch"),
              rt.submit(prompts[1], 14, slo="batch")]
        for _ in range(3):
            rt.step()
        hs += [rt.submit(prompts[2], 5, slo="interactive"),
               rt.submit(prompts[3], 5, slo="interactive")]
        rt.drain()
        runs.append((rt.engine, [h.request.out for h in hs]))
    (ref, want), (eng, got) = runs
    assert got == want
    st = eng.stats
    assert st.preemptions == st.resumes == ref.stats.preemptions > 0
    assert st.kv_spill_bytes == st.kv_restore_bytes == \
        ref.stats.kv_spill_bytes > 0
    assert dataclasses.asdict(eng.kv_pool.stats()) == \
        dataclasses.asdict(ref.kv_pool.stats())
