"""The port's spans (``repro_torch.trace``) on the CPU, over short serving
runs of the tiny dense config (tests/test_torch_engine.py's): off they
record nothing and cost the shared no-op context; on, each span nests in
its parent, the engine's spans count what ``EngineStats`` counts, every
forward shows each layer's two halves and each Engram layer's fusion,
the emitted tokens do not change, and under a profiler session started
the way ``portbench/harness/trace.py`` starts one every span shows as a
host event of the same name and nesting."""
import dataclasses
import threading

import pytest

torch = pytest.importorskip("torch")

from repro_torch import trace  # noqa: E402
from repro_torch.configs import deepseek_7b  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.serving import Engine  # noqa: E402

torch.set_num_threads(2)

PROMPTS = [[5, 17, 42], [7, 8, 9, 10], [3, 1, 4, 1, 5, 9, 2, 6, 5, 3],
           [11, 12], [20, 30, 40, 50, 60]]
FORWARDS = ("repro_torch.engine.prefill_group",
            "repro_torch.engine.decode_wave")


def _tiny():
    cfg = deepseek_7b.reduced()
    return dataclasses.replace(cfg, n_layers=3, layer_types=("attn",) * 3,
                               attn_kinds=("global",) * 3,
                               ffn_types=("dense",) * 3,
                               engram=dataclasses.replace(cfg.engram,
                                                          layers=(1,)))


@pytest.fixture(scope="module")
def setup():
    cfg = _tiny()
    return cfg, init_params(cfg, 0, "cpu")


@pytest.fixture
def spans_on():
    trace.drain()
    trace.enable(True)
    try:
        yield
    finally:
        trace.enable(False)
        trace.drain()


def _serve(cfg, params, pool=None):
    """5 requests over 3 slots (refills mid-run); the engine and streams."""
    eng = Engine(cfg, params=params, max_batch=3, max_len=64,
                 prompt_bucket=8, pool=pool, device="cpu")
    rt = eng.runtime()
    handles = [rt.submit(list(p), max_new=6) for p in PROMPTS]
    rt.drain()
    return eng, [h.tokens for h in handles]


def _subtree(spans, root: int) -> list:
    """The spans nested (at any depth) under span ``root``."""
    inside = {root}
    out = []
    for i in range(root + 1, len(spans)):
        if spans[i].parent in inside:
            inside.add(i)
            out.append(spans[i])
    return out


def test_off_by_default_records_nothing(setup):
    cfg, params = setup
    assert trace.span("engine.step") is trace.span("block.attn", layer=0)
    with trace.span("engine.step") as attrs:
        attrs["events"] = 3              # goes nowhere
    _serve(cfg, params)
    assert trace.drain() == []


@pytest.mark.parametrize("pool", [None, "CXL"])
def test_spans_count_what_the_engine_counts(setup, spans_on, pool):
    cfg, params = setup
    eng, _ = _serve(cfg, params, pool)
    spans = trace.drain()
    st = eng.stats
    for i, s in enumerate(spans):
        assert s.name.startswith("repro_torch.") and s.t0_ns <= s.t1_ns
        if s.parent is not None:
            p = spans[s.parent]
            assert s.parent < i and p.t0_ns <= s.t0_ns <= s.t1_ns <= p.t1_ns

    def named(n):
        return [s for s in spans if s.name == "repro_torch." + n]

    waves, groups = named("engine.decode_wave"), named("engine.prefill_group")
    assert len(waves) == st.decode_steps
    assert len(groups) == st.prefill_waves
    assert sum(g.attrs["tokens"] for g in groups) == st.prefill_tokens
    assert sum(g.attrs["pad"] for g in groups) == st.prefill_pad_tokens
    assert sum(len(g.attrs["rids"]) for g in groups) == st.prefills
    assert all(g.attrs["n"] == len(g.attrs["rids"]) for g in groups)
    assert len(named("engine.host_read")) == st.d2h_pulls
    assert all(r.attrs["bytes"] > 0 for r in named("engine.host_read"))
    assert sum(s.attrs["events"] for s in named("engine.step")) \
        == st.generated_tokens
    assert all(1 <= w.attrs["live"] <= 3 for w in waves)
    assert len(named("engine.admit")) == len(named("engine.step"))
    tops = {s.name for s in spans if s.parent is None}
    assert tops == {"repro_torch.engine.step"}


@pytest.mark.parametrize("pool", [None, "CXL"])
def test_each_forward_spans_every_layer(setup, spans_on, pool):
    """Each admission group and each decode wave runs one forward: one
    mixer and one FFN half per layer, in order, one fusion per Engram
    layer, one head, and one retrieval per Engram layer, except in a pool
    tier's decode waves, which fetch every layer's rows in one K1 launch
    outside the forward."""
    cfg, params = setup
    _serve(cfg, params, pool)
    spans = trace.drain()
    n_eng = len(cfg.engram_layers())
    roots = [i for i, s in enumerate(spans) if s.name in FORWARDS]
    assert roots
    for i in roots:
        sub = _subtree(spans, i)
        for half in ("attn", "ffn"):
            got = [s.attrs["layer"] for s in sub
                   if s.name == "repro_torch.block." + half]
            assert got == list(range(cfg.n_layers))
        fuse = [s for s in sub if s.name == "repro_torch.engram.fuse"]
        assert len(fuse) == n_eng
        assert [s.name for s in sub].count("repro_torch.model.head") == 1
        reads = [s for s in sub if s.name == "repro_torch.engine.host_read"]
        assert len(reads) >= 1
        rows = [s for s in sub if s.name == "repro_torch.engram.retrieve"]
        fetched = pool is not None and spans[i].name == FORWARDS[1]
        assert len(rows) == (0 if fetched else n_eng)
        assert all(r.attrs["rows"] == fuse[0].attrs["T"]
                   * cfg.engram.n_tables for r in rows)


def test_tokens_bit_equal_with_spans_on_and_off(setup):
    cfg, params = setup
    _, off = _serve(cfg, params)
    trace.enable(True)
    try:
        _, on = _serve(cfg, params)
    finally:
        trace.enable(False)
    assert trace.drain()
    assert on == off


def test_spans_nest_per_thread(spans_on):
    """A span opened on another thread takes no parent from this one."""
    with trace.span("engine.step"):
        worker = []

        def run():
            with trace.span("block.ffn", layer=0):
                worker.append(1)

        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive() and worker == [1]
        with trace.span("block.attn", layer=0):
            pass
    spans = trace.drain()
    by = {s.name: s for s in spans}
    assert by["repro_torch.block.ffn"].parent is None
    assert by["repro_torch.block.attn"].parent == 0


def test_spans_mirror_into_the_profiler(setup, spans_on):
    """A session started through ``torch.autograd._enable_profiler`` (the
    benchmark's path, which ``torch.autograd.profiler``'s Python flag does
    not see) gets one host event per span, same names, same nesting."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd import (ProfilerActivity, ProfilerConfig,
                                ProfilerState, _disable_profiler,
                                _enable_profiler, _prepare_profiler)
    cfg, params = setup
    conf = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                          False, _ExperimentalConfig())
    acts = {ProfilerActivity.CPU}
    _prepare_profiler(conf, acts)
    _enable_profiler(conf, acts)
    try:
        _serve(cfg, params)
    finally:
        res = _disable_profiler()
    spans = trace.drain()
    evs = sorted((e for e in res.events()
                  if e.name().startswith("repro_torch.")),
                 key=lambda e: e.start_ns())
    assert [e.name() for e in evs] == [s.name for s in spans]
    for s, e in zip(spans, evs):
        if s.parent is not None:
            p = evs[s.parent]
            assert p.start_ns() <= e.start_ns()
            assert e.start_ns() + e.duration_ns() \
                <= p.start_ns() + p.duration_ns()
