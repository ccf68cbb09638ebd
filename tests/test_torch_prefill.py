"""PyTorch port vs the JAX reference: long-prompt attention, chunked prefill
and the prefix KV cache, on the CPU.

``_chunk_attn`` (flash-style chunking with an online softmax), a prompt
longer than the 2048-token chunk threshold, ``build_chunk_prefill`` over
ragged chunks, ``gate_state``/``extract_prefix``/``restore_prefix``, and
the engine's chunked admission with and without a ``PrefixKVCache``
(token streams, ``PrefixCacheStats``, the ``EngineStats`` prefill fields,
mid-prefill cancel with newest-first refunds, the emulated virtual clock)
against the reference on the same inputs, drawn with numpy from a seed.
Weights come from the reference's ``init_params``, bridged with
``from_jax``. Integer results are bit-equal; f32 results match to 1e-5
(one op) or 1e-4 (logits after several layers), as in
tests/test_torch_model.py.

The engine cases run ``max_batch=2``: the reference pads a chunk wave's
jobs to a power-of-two row count and the port does not, and with at most
two jobs the two agree on ``prefill_pad_tokens`` too."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import deepseek_7b as ref_deepseek_7b  # noqa: E402
from repro.configs import engram_27b as ref_engram_27b  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models.transformer import RunFlags as RefFlags  # noqa: E402
from repro.pool.cache import PrefixKVCache as RefPrefixKVCache  # noqa: E402
from repro.serving import EngramRuntime as RefRuntime  # noqa: E402
from repro.serving import slots as ref_slots  # noqa: E402
from repro_torch.configs import deepseek_7b, engram_27b  # noqa: E402
from repro_torch.models import attention as port_attn  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models.params import from_jax, tree_leaves  # noqa: E402
from repro_torch.models.transformer import (RunFlags,  # noqa: E402
                                            segment_plan)
from repro_torch.pool.cache import PrefixKVCache  # noqa: E402
from repro_torch.serving import EngramRuntime  # noqa: E402
from repro_torch.serving import slots as port_slots  # noqa: E402

torch.set_num_threads(2)

F32 = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)
PREFILL_FIELDS = ("prefills", "prefill_waves", "prefill_tokens",
                  "prefill_pad_tokens", "prefill_tokens_restored",
                  "prefix_lookup_blocks", "prefix_hit_blocks",
                  "generated_tokens", "decode_steps", "d2h_pulls")


def _tiny(mod):
    """tests/test_prefill.py's config: 3 layers, Engram at layer 1."""
    cfg = mod.reduced()
    return dataclasses.replace(cfg, n_layers=3, layer_types=("attn",) * 3,
                               attn_kinds=("global",) * 3,
                               ffn_types=("dense",) * 3,
                               engram=dataclasses.replace(cfg.engram,
                                                          layers=(1,)))


def _bridge(cfg, rcfg):
    rparams = ref_model.init_params(rcfg, 0)
    params = from_jax(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    return cfg, rcfg, rparams, params


@pytest.fixture(scope="module")
def tiny():
    return _bridge(_tiny(deepseek_7b), _tiny(ref_deepseek_7b))


@pytest.fixture(scope="module")
def e27():
    """Reduced engram-27b: GQA (4 query heads over 2 KV heads), Engram at
    layers 2 and 4."""
    return _bridge(engram_27b.reduced(), ref_engram_27b.reduced())


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _prompts(n, length, seed=0):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(1, 500, size=length)]
            for _ in range(n)]


def _drain(rt, prompts, max_new=4):
    handles = [rt.submit(list(p), max_new) for p in prompts]
    rt.drain()
    assert all(h.finished for h in handles)
    return [h.tokens for h in handles]


def _pair(tiny, **kw):
    """The reference's and the port's runtime over the same weights."""
    cfg, rcfg, rparams, params = tiny
    ref = RefRuntime(rcfg, params=rparams, **kw)
    for k, v in kw.items():
        if isinstance(v, RefPrefixKVCache):
            kw[k] = PrefixKVCache(v.capacity_bytes, v.block_tokens)
    return ref, EngramRuntime(cfg, params=params, device="cpu", **kw)


def _assert_prefill_stats_equal(eng, ref):
    for f in PREFILL_FIELDS:
        assert getattr(eng.stats, f) == getattr(ref.stats, f), f


def _ref_layer_caches(cfg, rcaches):
    """The reference's per-segment ``prefix``/``stack`` caches as one
    {k, v} dict per layer, in the port's layer order."""
    out = []
    for seg, sc in zip(segment_plan(cfg), rcaches):
        layers = [dict(c) for c in sc["prefix"]]
        for r in range(seg.n_periods):
            for pos in range(seg.period):
                layers.append({n: np.asarray(a)[r]
                               for n, a in sc["stack"][pos].items()})
        out.append(layers)
    return out


# ---------------------------------------------------------------- attention

def _mixers(bridged):
    cfg, rcfg, rparams, params = bridged
    rseg = rparams["segments"][0]
    rm = rseg["prefix"][0]["mixer"] if rseg["prefix"] else \
        jax.tree.map(lambda a: a[0], rseg["stack"][0]["mixer"])
    return params["segments"][0][0]["mixer"], rm


@pytest.mark.parametrize("q_chunk,kv_chunk", [(8, 8), (4, 8), (8, 4)])
def test_chunk_attn_matches_reference(e27, q_chunk, kv_chunk):
    """S = 21 leaves ragged q and kv padding in every chunking; the causal
    frontier differs when the two chunk sizes differ."""
    cfg, rcfg, _, _ = e27
    rng = np.random.RandomState(11)
    S = 21
    q = rng.randn(2, S, cfg.n_heads, cfg.head_dim).astype(np.float32)
    k, v = (rng.randn(2, S, cfg.n_kv_heads, cfg.head_dim).astype(np.float32)
            for _ in range(2))
    pos = np.arange(S)
    want = ref_attn._chunk_attn(rcfg, *map(jnp.asarray, (q, k, v, pos, pos)),
                                causal=True, window=0, q_chunk=q_chunk,
                                kv_chunk=kv_chunk)
    got = port_attn._chunk_attn(cfg, *map(_t, (q, k, v, pos, pos)),
                                q_chunk=q_chunk, kv_chunk=kv_chunk)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # and equal to the dense path the short prompts take
    dense = port_attn._sdpa(cfg, *map(_t, (q, k, v)),
                            port_attn._mask(_t(pos), _t(pos),
                                            causal=True)[None])
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **F32)


def test_attention_over_threshold_matches_reference(e27):
    cfg, rcfg, _, _ = e27
    pm, rm = _mixers(e27)
    x = np.random.RandomState(12).randn(2, 21, cfg.d_model).astype(
        np.float32)
    pos = np.arange(21)
    want, wkv = ref_attn.attention(rcfg, rm, jnp.asarray(x), jnp.asarray(pos),
                                   "global", chunk_threshold=4, q_chunk=8,
                                   kv_chunk=8)
    got, kv = port_attn.attention(cfg, pm, _t(x), _t(pos),
                                  chunk_threshold=4, q_chunk=8, kv_chunk=8)
    # outputs reach ~100 after two projections of depth 64, so f32
    # rounding is relative to that scale: the reference's own chunked and
    # dense paths differ by 1.7e-4 on these inputs
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(kv["v"].numpy(), np.asarray(wkv["v"]), **F32)


def test_prompt_over_2048_tokens_matches_reference(e27):
    """Default flags: a 2100-token prompt (ragged over 1024-token chunks)
    takes the chunked path in every layer; its prefill logits and the
    greedy tokens after it match the reference."""
    cfg, rcfg, rparams, params = e27
    rng = np.random.RandomState(13)
    S, max_len = 2100, 2112
    toks = rng.randint(1, cfg.vocab_size, size=(1, S))
    rpre, rdec = (jax.jit(ref_model.build_prefill_step(rcfg, RefFlags(),
                                                       max_len=max_len)),
                  jax.jit(ref_model.build_decode_step(rcfg, RefFlags())))
    want, rstate = rpre(rparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    got, state = port_model.build_prefill_step(cfg, RunFlags(),
                                               max_len=max_len)(
        params, {"tokens": _t(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    dec = port_model.build_decode_step(cfg, RunFlags())
    for _ in range(3):
        tok = torch.argmax(got, dim=-1)
        rtok = jnp.argmax(want, axis=-1).astype(jnp.int32)
        assert tok.tolist() == np.asarray(rtok).tolist()
        want, rstate = rdec(rparams, rstate, rtok)
        got, state = dec(params, state, tok)
        # a decode step sums over 2101 cached positions in another order
        # than XLA: 4e-4 apart on logits of ~3, the same after a dense
        # prefill (chunk_threshold=4096) as after the chunked one
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-3, atol=1e-3)


# ------------------------------------------------------------ chunk prefill

def test_chunk_prefill_matches_reference(e27):
    """Ragged lens (a full chunk, a short one, an empty row) from per-row
    prefill offsets: the last valid logits, positions, last tokens and
    every layer's KV cache."""
    cfg, rcfg, rparams, params = e27
    rng = np.random.RandomState(14)
    toks = rng.randint(1, cfg.vocab_size, size=(3, 6))
    lens0 = np.array([6, 2, 4])
    max_len, C = 24, 5
    rstate = jax.jit(ref_model.build_prefill_step(rcfg, RefFlags(),
                                                  max_len=max_len))(
        rparams, {"tokens": jnp.asarray(toks, jnp.int32),
                  "lengths": jnp.asarray(lens0, jnp.int32)})[1]
    state = port_model.build_prefill_step(cfg, RunFlags(), max_len=max_len)(
        params, {"tokens": _t(toks), "lengths": _t(lens0)})[1]
    chunk = rng.randint(1, cfg.vocab_size, size=(3, C))
    lens = np.array([C, 2, 0])
    want, rnew = jax.jit(ref_model.build_chunk_prefill(rcfg, RefFlags()))(
        rparams, rstate, jnp.asarray(chunk, jnp.int32),
        jnp.asarray(lens, jnp.int32))
    got, new = port_model.build_chunk_prefill(cfg, RunFlags())(
        params, state, _t(chunk), _t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    for key in ("positions", "last_tokens"):
        assert new[key].dtype == torch.int32
        np.testing.assert_array_equal(new[key].numpy(), np.asarray(rnew[key]))
    np.testing.assert_array_equal(new["positions"].numpy(), lens0 + lens)
    for seg, rseg in zip(new["caches"],
                         _ref_layer_caches(cfg, rnew["caches"])):
        for c, rc in zip(seg, rseg):
            for n in ("k", "v"):
                np.testing.assert_allclose(c[n].numpy(), np.asarray(rc[n]),
                                           **LOGITS)


def test_gate_state_matches_reference():
    rng = np.random.RandomState(15)
    old = {"positions": rng.randint(0, 9, 4).astype(np.int32),
           "last_tokens": rng.randint(0, 99, (4, 2)).astype(np.int32),
           "caches": [[{"k": rng.randn(4, 6, 2, 3).astype(np.float32)}]]}
    new = {"positions": old["positions"] + 1,
           "last_tokens": rng.randint(0, 99, (4, 2)).astype(np.int32),
           "caches": [[{"k": rng.randn(4, 6, 2, 3).astype(np.float32)}]]}
    valid = np.array([True, False, True, False])
    want = ref_slots.gate_state(jnp.asarray(valid),
                                jax.tree.map(jnp.asarray, new),
                                jax.tree.map(jnp.asarray, old))
    tnew = {"positions": _t(new["positions"]),
            "last_tokens": _t(new["last_tokens"]),
            "caches": [[{"k": _t(new["caches"][0][0]["k"])}]]}
    got = port_slots.gate_state(_t(valid), tnew, {
        "positions": _t(old["positions"]),
        "last_tokens": _t(old["last_tokens"])})
    for key in ("positions", "last_tokens"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    # the caches are the new step's, not a copy
    assert got["caches"][0][0]["k"] is tnew["caches"][0][0]["k"]
    np.testing.assert_array_equal(got["caches"][0][0]["k"].numpy(),
                                  np.asarray(want["caches"][0][0]["k"]))


def test_extract_restore_prefix_matches_reference(e27):
    """F6: the snapshot's byte count (what the pool link is charged) is the
    reference's, int32 positions and last tokens included; the restored
    slot is the extracted one, zero-padded to max_len."""
    cfg, rcfg, rparams, params = e27
    rng = np.random.RandomState(16)
    toks = rng.randint(1, cfg.vocab_size, size=(3, 12))
    lens = np.array([12, 9, 5])
    max_len, slot, length = 32, 1, 8
    rstate = jax.jit(ref_model.build_prefill_step(rcfg, RefFlags(),
                                                  max_len=max_len))(
        rparams, {"tokens": jnp.asarray(toks, jnp.int32),
                  "lengths": jnp.asarray(lens, jnp.int32)})[1]
    state = port_model.build_prefill_step(cfg, RunFlags(), max_len=max_len)(
        params, {"tokens": _t(toks), "lengths": _t(lens)})[1]
    rsnap, rbytes = ref_slots.extract_prefix(rstate, slot, length)
    snap, nbytes = port_slots.extract_prefix(state, slot, length)
    assert nbytes == rbytes
    assert all(t.device.type == "cpu" for t in tree_leaves(snap))
    for key in ("positions", "last_tokens"):
        assert snap[key].dtype == torch.int32
        np.testing.assert_array_equal(snap[key].numpy(), rsnap[key])
    for seg, rseg in zip(snap["caches"],
                         _ref_layer_caches(cfg, rsnap["caches"])):
        for c, rc in zip(seg, rseg):
            assert tuple(c["k"].shape) == (1, length, cfg.n_kv_heads,
                                           cfg.head_dim)
            for n in ("k", "v"):
                np.testing.assert_allclose(c[n].numpy(), rc[n], **LOGITS)
    back = port_slots.restore_prefix(snap, max_len, torch.device("cpu"))
    for c, orig in zip(tree_leaves(back["caches"]),
                       tree_leaves(state["caches"])):
        assert c.shape[1] == max_len
        np.testing.assert_array_equal(c[0, :length].numpy(),
                                      orig[slot, :length].numpy())
        assert not c[0, length:].any()
    fresh = port_model.init_decode_state(cfg, RunFlags(), 2, max_len, "cpu")
    port_slots.update_slots(fresh, back, [0])
    assert int(fresh["positions"][0]) == int(lens[slot])


# ------------------------------------------------------------------ engine

@pytest.mark.parametrize("pool", [None, "CXL"])
def test_chunked_matches_monolithic_and_reference(tiny, pool):
    """Chunked prefill is a schedule change: the same streams as the
    monolithic group prefill and as the reference's chunked engine,
    including the decode waves that run gated while later admissions are
    mid-prefill, with equal StoreStats and prefill counters."""
    prompts = _prompts(5, 21)                  # 5 chunks of 4 and a tail
    kw = dict(pool=pool, max_batch=2, max_len=64, prompt_bucket=8)
    cfg, _, _, params = tiny
    mono = EngramRuntime(cfg, params=params, device="cpu", **kw)
    want = _drain(mono, prompts)
    ref, rt = _pair(tiny, prefill_chunk=4, **kw)
    assert _drain(ref, prompts) == want
    assert _drain(rt, prompts) == want
    eng = rt.engine
    _assert_prefill_stats_equal(eng, ref.engine)
    assert eng.stats.prefill_waves > mono.engine.stats.prefill_waves
    assert dataclasses.asdict(eng.store.stats()) == \
        dataclasses.asdict(ref.engine.store.stats())


def _shared_head_prompts():
    """Two prompts sharing a 16-token head (two 8-token blocks), then two
    sharing a 24-token head."""
    head = _prompts(1, 16, seed=1)[0]
    long_head = _prompts(1, 24, seed=4)[0]
    return ([head + p for p in _prompts(2, 7, seed=2)],
            [long_head + p for p in _prompts(2, 9, seed=5)])


PREFIX_KW = dict(pool="CXL", max_batch=2, max_len=64, prompt_bucket=8,
                 prefill_chunk=8, emulate_step_s=2e-4)


@pytest.fixture(scope="module")
def prefix_ref(tiny):
    """The reference's chunked engine with a prefix cache at the emulated
    operating point: the first pair served one at a time (the first
    request's spilled blocks are in the cache when the second is
    admitted), then the second pair together. Returns (streams, runtime)."""
    cfg, rcfg, rparams, _ = tiny
    ref = RefRuntime(rcfg, params=rparams,
                     prefix_cache=RefPrefixKVCache(64 << 20, 8), **PREFIX_KW)
    first, second = _shared_head_prompts()
    return [_drain(ref, [p])[0] for p in first] + _drain(ref, second), ref


def _serve_prefix(tiny):
    cfg, _, _, params = tiny
    rt = EngramRuntime(cfg, params=params, device="cpu",
                       prefix_cache=PrefixKVCache(64 << 20, 8), **PREFIX_KW)
    first, second = _shared_head_prompts()
    return [_drain(rt, [p])[0] for p in first] + _drain(rt, second), rt


def test_prefix_cache_restore_matches_reference(tiny, prefix_ref):
    """A request restores a shared head's blocks from the prefix cache and
    still emits the streams of an engine with no cache; cache and engine
    counters equal the reference's."""
    want, ref = prefix_ref
    first, second = _shared_head_prompts()
    cfg, _, _, params = tiny
    plain = EngramRuntime(cfg, params=params, device="cpu", **PREFIX_KW)
    assert _drain(plain, first + second) == want
    got, rt = _serve_prefix(tiny)
    assert got == want
    eng, reng = rt.engine, ref.engine
    # the first pair's second request restores both head blocks; the
    # second pair is admitted together, before either spilled a block
    assert eng.stats.prefix_hit_blocks == 2
    assert eng.stats.prefill_tokens_restored == 16
    assert eng.stats.prefix_hit_rate == reng.stats.prefix_hit_rate
    assert eng.stats.prefill_compute_tokens == \
        reng.stats.prefill_compute_tokens
    assert eng.stats.prefill_compute_tokens < \
        plain.engine.stats.prefill_compute_tokens
    _assert_prefill_stats_equal(eng, reng)
    assert dataclasses.asdict(eng.prefix_cache.stats()) == \
        dataclasses.asdict(reng.prefix_cache.stats())
    assert dataclasses.asdict(eng.store.stats()) == \
        dataclasses.asdict(reng.store.stats())


def test_emulated_clock_with_prefix_cache_matches_reference(tiny,
                                                            prefix_ref):
    """At the emulated operating point the prefix fetches and spills are
    byte transfers on the CXL link: the virtual clock, every link's
    ledger and the stall totals land on the reference's numbers to the
    bit."""
    want, ref = prefix_ref
    got, rt = _serve_prefix(tiny)
    assert got == want
    eng, reng = rt.engine, ref.engine
    for f in ("emu_time_s", "v_time_s", "ttft_v_sum", "stall_s"):
        assert getattr(eng.stats, f) == getattr(reng.stats, f), f
    assert eng.clock.stats() == reng.clock.stats()
    # the CXL link carried the snapshots beside the Engram rows
    link = eng.clock.stats()["links"]["tier:CXL"]
    assert link["bytes"] > link["bytes_by_class"]["engram"] > 0


def test_cancel_mid_prefill_refunds_lifo(tiny):
    """Cancelling a request mid-prefill frees its slot and refunds every
    outstanding booking newest-first (the same refunds as the reference's
    engine makes), and the engine serves on cleanly."""
    kw = dict(pool="CXL", max_batch=2, max_len=96, prompt_bucket=8,
              emulate_step_s=2e-4, prefill_chunk=4)
    ref, rt = _pair(tiny, **kw)
    p1, p2 = _prompts(2, 40, seed=3)
    for runtime in (ref, rt):
        eng = runtime.engine
        h1 = runtime.submit(p1, max_new=3)
        h2 = runtime.submit(p2, max_new=3)
        runtime.step()                         # admit + first chunk wave
        job = next(j for j in eng._prefill_jobs.values()
                   if j.req is h1.request)
        assert 0 < job.pos < len(p1) and job.resv
        free0, r0 = len(eng._free), eng.clock.refunded_s
        assert runtime.cancel(h1)
        assert h1.cancelled and not h1.tokens
        assert job.slot not in eng._prefill_jobs and not job.resv
        assert len(eng._free) == free0 + 1
        assert eng.clock.refunded_s > r0 and eng.clock.refunded_bytes > 0
        runtime.drain()
        assert h2.finished and len(h2.tokens) == 3
        assert not eng._prefill_jobs and not eng.busy
        h3 = runtime.submit(p1, max_new=3)     # the freed slot is reusable
        runtime.drain()
        assert h3.finished and len(h3.tokens) == 3
    assert h2.tokens == ref.engine.done[2].out
    assert h3.tokens == ref.engine.done[3].out
    assert rt.engine.clock.stats() == ref.engine.clock.stats()
    assert rt.engine.stats.emu_time_s == ref.engine.stats.emu_time_s


def test_chunk_wave_single_read(tiny):
    """A chunk wave reads the device once (tokens | the chunk's keys); a
    prefix spill is one more counted read; a steady decode wave one."""
    cfg, _, _, params = tiny
    rt = EngramRuntime(cfg, params=params, pool="CXL", max_batch=2,
                       max_len=64, prompt_bucket=8, prefill_chunk=8,
                       prefix_cache=PrefixKVCache(64 << 20, 8), device="cpu")
    eng = rt.engine
    h = rt.submit(_prompts(1, 20, seed=6)[0], max_new=6)
    reads = []
    while eng.busy:
        before = eng.stats.d2h_pulls
        rt.step()
        reads.append(eng.stats.d2h_pulls - before)
    assert h.finished and len(h.tokens) == 6
    # chunk waves of 8, 8 (each spilling a block) and 4 tokens; the last
    # admits the request, so the first decode wave reads its keys too
    assert reads == [2, 2, 1 + 1 + 1, 1, 1, 1, 1]
    assert eng.prefix_cache.stats().inserts == 2


def test_prefix_cache_options_checked(tiny):
    cfg, _, _, params = tiny
    kw = dict(params=params, device="cpu", max_len=64, prompt_bucket=8)
    with pytest.raises(ValueError, match="prefill_chunk"):
        EngramRuntime(cfg, prefix_cache=PrefixKVCache(1 << 20, 8), **kw)
    with pytest.raises(ValueError, match="block_tokens"):
        EngramRuntime(cfg, prefill_chunk=4,
                      prefix_cache=PrefixKVCache(1 << 20, 8), **kw)
    # fleet views (ported with the router) share one cache's blocks
    shared = PrefixKVCache(1 << 20, 8)
    v0, v1 = shared.view("r0"), shared.view("r1")
    assert v0.block_tokens == v1.block_tokens == 8
    assert v0.insert(11, "snap", 8, 100) and 11 in v1
    assert v1.lookup([11, 12]) == (1, "snap", 100)
    st = shared.stats()
    assert st.per_view["r0"]["inserts"] == 1
    assert st.per_view["r1"]["hit_blocks"] == 1
    assert v1.stats() == st and v1.hit_rate == 0.5
    with pytest.raises(AssertionError, match="duplicate"):
        shared.view("r0")
