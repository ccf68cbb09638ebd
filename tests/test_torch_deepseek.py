"""PyTorch port vs the JAX reference: serving the MLA + MoE family on the
CPU.

Reduced deepseek-v2-236b (MLA with its latent KV cache, 8 experts top-2
plus 2 shared, Engram at layers 1 and 2), in float32 with weights bridged
from the reference, through the reference's ``Engine`` and the port's at
the emulated operating point: identical greedy streams and equal
``StoreStats`` and clock in monolithic admission; chunked admission with a
``PrefixKVCache`` (equal ``PrefixCacheStats``, whose bytes are the
latent snapshots' byte counts); scripted speculation (rollback of the
latents) emitting the monolithic streams; and one preemption and restore
(equal ``KVPoolStats``). Reduced deepseek-v3-671b serves monolithically
too. Integers bit for bit."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import spec as ref_spec  # noqa: E402
from repro.configs import deepseek_v2_236b as ref_v2  # noqa: E402
from repro.configs import deepseek_v3_671b as ref_v3  # noqa: E402
from repro.configs.base import SpecConfig as RefSpecConfig  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.pool.cache import PrefixKVCache as RefPrefixKVCache  # noqa: E402
from repro.serving import Engine as RefEngine  # noqa: E402
from repro.serving import EngramRuntime as RefRuntime  # noqa: E402
from repro.serving import slo as ref_slo  # noqa: E402
from repro_torch import spec  # noqa: E402
from repro_torch.configs import SpecConfig  # noqa: E402
from repro_torch.configs import deepseek_v2_236b, deepseek_v3_671b  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402
from repro_torch.pool.cache import PrefixKVCache  # noqa: E402
from repro_torch.serving import Engine, EngramRuntime, slo  # noqa: E402

torch.set_num_threads(2)

MODULES = {"deepseek-v2-236b": (deepseek_v2_236b, ref_v2),
           "deepseek-v3-671b": (deepseek_v3_671b, ref_v3)}
# the emulated operating point: StoreStats and the clock do not depend on
# host step times
ENGINE_KW = dict(pool="CXL", max_batch=2, max_len=64, prompt_bucket=8,
                 emulate_step_s=5e-5)


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


def _prompts(cfg, seed, lens):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(1, cfg.vocab_size, size=n)]
            for n in lens]


def _run(engine, prompts, max_new, one_at_a_time=False):
    if one_at_a_time:
        out = []
        for p in prompts:
            rid = engine.submit(list(p), max_new=max_new)
            engine.run()
            out.append(engine.done[rid].out)
        return out
    rids = [engine.submit(list(p), max_new=max_new) for p in prompts]
    engine.run()
    return [engine.done[r].out for r in rids]


@pytest.fixture(scope="module")
def engine_runs(bridged):
    """Each (config, mode) run once on both engines: {(name, mode):
    (reference engine, port engine, reference streams, port streams)},
    filled on first use (the reference's runs are the slow part)."""
    cache = {}

    def get(name, mode):
        if (name, mode) in cache:
            return cache[(name, mode)]
        cfg, rcfg, rparams, params = bridged[name]
        kw, rkw, alone = dict(ENGINE_KW), dict(ENGINE_KW), False
        prompts = _prompts(cfg, 6, [11, 17, 23])
        if mode == "chunked":
            head = _prompts(cfg, 4, [16])[0]
            prompts = [head + p for p in _prompts(cfg, 5, [3, 7, 12])]
            alone = True
            kw.update(prefill_chunk=8,
                      prefix_cache=PrefixKVCache(64 << 20, 8))
            rkw.update(prefill_chunk=8,
                       prefix_cache=RefPrefixKVCache(64 << 20, 8))
        elif mode == "spec":
            plain = get(name, "monolithic")[3]
            script = [p + o for p, o in zip(prompts, plain)]
            kw.update(spec=SpecConfig(), proposer=spec.ScriptedProposer(
                script))
            rkw.update(spec=RefSpecConfig(),
                       proposer=ref_spec.ScriptedProposer(script))
        reng = RefEngine(rcfg, params=rparams, **rkw)
        eng = Engine(cfg, params=params, device="cpu", **kw)
        cache[(name, mode)] = (reng, eng, _run(reng, prompts, 10, alone),
                               _run(eng, prompts, 10, alone))
        return cache[(name, mode)]

    return get


@pytest.mark.parametrize("name,mode", [
    ("deepseek-v2-236b", "monolithic"), ("deepseek-v2-236b", "chunked"),
    ("deepseek-v2-236b", "spec"), ("deepseek-v3-671b", "monolithic")])
def test_engine_streams_match_reference(engine_runs, name, mode):
    """Prompts of 11 to 28 tokens and 10 new ones: the reference Engine's
    streams bit for bit, StoreStats field by field and the virtual clock;
    chunked admission restores a shared 16-token head from the prefix
    cache, whose stats (bytes: the snapshots' latents sliced to the
    prefix) are the reference's; the scripted speculation accepts the
    reference's drafts (all but those past a request's last token) and
    emits the monolithic streams."""
    reng, eng, want, got = engine_runs(name, mode)
    assert got == want
    assert all(len(s) == 10 for s in got)
    assert dataclasses.asdict(eng.store.stats()) == \
        dataclasses.asdict(reng.store.stats())
    assert eng.clock.stats() == reng.clock.stats()
    if mode == "chunked":
        assert eng.stats.prefix_hit_blocks == \
            reng.stats.prefix_hit_blocks > 0
        assert dataclasses.asdict(eng.prefix_cache.stats()) == \
            dataclasses.asdict(reng.prefix_cache.stats())
    if mode == "spec":
        assert got == engine_runs(name, "monolithic")[3]
        assert eng.stats.accepted_tokens == reng.stats.accepted_tokens > 0
        assert eng.stats.proposed_tokens == reng.stats.proposed_tokens


def test_preempt_and_restore_match_reference(bridged):
    """Two batch requests fill both slots; after three steps two
    interactive ones preempt them, parking their latent KV in the pool,
    and they are restored later: the reference's streams, preemption
    counts, spill and restore bytes and ``KVPoolStats``."""
    cfg, rcfg, rparams, params = bridged["deepseek-v2-236b"]
    prompts = _prompts(cfg, 7, [9, 6, 5, 4])
    kw = dict(ENGINE_KW, emulate_step_s=2e-4)
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
