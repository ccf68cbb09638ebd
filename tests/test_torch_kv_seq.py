"""PyTorch port vs the JAX reference: ``kv_seq``, the reference's
flash-decode split of the KV cache's sequence, on a (2, 4) ("data",
"model") mesh, on the CPU.

The reference runs ``tests/torch_multidev_ref.py``'s part ``kv_seq`` in
three subprocesses side by side, each with 8 fake host devices: each case's prefill and greedy decode
under ``sharding_ctx(mesh, {"kv_seq": axes})`` (GSPMD combines the ranks'
partial softmaxes). The port runs the same on 8 gloo ranks, one process
each (``torch_multidev_ranks.kv_seq_main``), with a ``file://`` rendezvous
under the test's temporary directory, each rank on its blocks of the
reference's layout (``LAYOUT_FLAGS``: pooled tables, alltoall MoE). The
cases (``KV_SEQ_CASES``), each a reduced config with its vocabulary
rounded up to a multiple of 4 and its MoE capacity at 8.0:

  * deepseek-7b, B = 2, over "model": its 4 KV heads fill the model axis,
    so the rule is forced (as ``rule:kv_seq=model`` forces it) and the
    heads fall back whole;
  * gemma3-1b, B = 2, over "model" (``cell_rules --optimized``' choice:
    one KV head), a 20-token prompt so that the local layers' window of
    16 crosses the blocks, with ``decode_window_slice`` off and on;
  * deepseek-v2-236b (MLA's latent cache), B = 2, over "model";
  * jamba, B = 1, over "data" (the long_500k rule: the batch stays whole
    on both data ranks).

Held: the logits within ``LOGITS_TOL`` (jamba: max(``RECURRENT_TOL``, the
largest of three one-ulp witnesses of the reference's own mesh logits),
relative to the largest logit) and the same greedy tokens; every rank's decode
state after the prefill and after decode equal to the reference's
``NamedSharding.shard_shape`` under the same rule (on an ``AbstractMesh``),
each KV block ``max_len / n`` positions; a step at which some rank's block
holds no valid key; and, under the rule, the chunked prefill and a
multi-token verify step against the monolithic prefill and decode. A hung rank fails the test: the process group times
out after 120 s and the ranks and the subprocess are killed after 300 s.
"""
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.launch import specs as ref_specs  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models.transformer import RunFlags as RefFlags  # noqa: E402
from repro.models.transformer import segment_plan as ref_plan  # noqa: E402
from repro.sharding import rules as ref_rules  # noqa: E402
from repro_torch.models.params import from_jax, to_torch  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
from torch_multidev_ranks import (KV_SEQ_CASES, KV_SEQ_CHUNKED,  # noqa: E402
                                  KV_SEQ_STEPS, MESH, kv_seq_main)

WORLD = 8
TIMEOUT_S = 300
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)    # tests/test_torch_multidev.py's
RECURRENT_TOL = {"jamba-1.5-large-398b": 1e-4}
KV_KEYS = ("k", "v", "c_kv", "k_rope")
# the reference's cases in three subprocesses side by side (each case's
# JIT takes 10 to 36 s)
REF_PARTS = (("jamba-1.5-large-398b",), ("deepseek-v2-236b", "deepseek-7b"),
             ("gemma3-1b", "gemma3-1b-slice"))


def _cfg(arch: str, port: bool = True):
    """torch_multidev_ref.layout_cfg's config, the port's or the
    reference's."""
    if port:
        from repro_torch.launch.train import reduced_config
    else:
        from repro.launch.train import reduced_config
    cfg = reduced_config(arch)
    cfg = dataclasses.replace(cfg, vocab_size=-(-cfg.vocab_size // 4) * 4)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    return cfg


def _inputs(d: Path):
    rng = np.random.RandomState(0)
    npz, port = {}, {}
    for name, (arch, B, S, _, _) in KV_SEQ_CASES.items():
        npz[f"kv_seq_toks/{name}"] = rng.randint(1, _cfg(arch).vocab_size,
                                                 (B, S))
        port[f"kv_seq_cfg/{name}"] = _cfg(arch)
        if f"kv_seq_params/{arch}" not in port:
            port[f"kv_seq_params/{arch}"] = from_jax(jax.tree.map(
                np.asarray, ref_model.init_params(_cfg(arch, False), 0)),
                _cfg(arch), "cpu")
    np.savez(d / "inputs.npz", **npz)
    port.update({k: to_torch(v, "cpu") for k, v in npz.items()})
    torch.save(port, d / "inputs.pt")


@pytest.fixture(scope="module")
def kv_runs(tmp_path_factory):
    """(the reference's outputs, every rank's outputs)."""
    assert sorted(sum(REF_PARTS, ())) == sorted(KV_SEQ_CASES)
    d = tmp_path_factory.mktemp("kv_seq")
    _inputs(d)
    deadline = time.monotonic() + TIMEOUT_S
    refs = [subprocess.Popen(
        [sys.executable, str(HERE / "torch_multidev_ref.py"),
         str(d / "inputs.npz"), str(d / f"ref{i}.npz"),
         "kv_seq:" + ",".join(part)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
        for i, part in enumerate(REF_PARTS)]
    ranks = mp.start_processes(
        kv_seq_main, args=(WORLD, f"file://{d / 'rdzv'}",
                           str(d / "inputs.pt"), str(d)),
        nprocs=WORLD, join=False, start_method="spawn")
    try:
        while not ranks.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks not done after {TIMEOUT_S} s")
        for ref in refs:
            _, err = ref.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            assert ref.returncode == 0, err[-4000:]
    finally:
        for p in ranks.processes:
            if p.is_alive():
                p.kill()
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
    out = {}
    for i in range(len(REF_PARTS)):
        out.update(np.load(d / f"ref{i}.npz"))
    return out, [torch.load(d / f"rank{r}.pt") for r in range(WORLD)]


def _whole(ranks, key, batch_split: bool):
    """The whole logits from the ranks': every rank of a data group holds
    the same rows (bit-equal); the data groups' rows are concatenated, or,
    for a batch the data axis does not divide, are the same whole batch."""
    (n_data, _), _ = MESH
    rows = []
    for di in range(n_data):
        mine = [r[key] for r in ranks if int(r["coords"][0]) == di]
        for t in mine[1:]:
            assert torch.equal(t, mine[0]), key
        rows.append(mine[0])
    if not batch_split:
        for t in rows[1:]:
            assert torch.equal(t, rows[0]), key
        return rows[0].numpy()
    return torch.cat(rows).numpy()


@pytest.mark.parametrize("name", list(KV_SEQ_CASES))
def test_kv_seq_decode_matches_reference_mesh(kv_runs, name):
    """Prefill and greedy decode with the KV sequence split over the
    case's axes: logits within the tolerance of the reference's forward
    under the same mesh, rule and flags, the same greedy tokens."""
    ref, ranks = kv_runs
    arch, B = KV_SEQ_CASES[name][:2]
    got = _whole(ranks, f"kv_seq/{name}", batch_split=B % MESH[0][0] == 0)
    want = ref[f"kv_seq/{name}"]
    assert got.shape == want.shape == (B, 1 + KV_SEQ_STEPS,
                                       _cfg(arch).vocab_size)
    top = float(np.abs(want).max())
    tol = LOGITS_TOL
    if arch in RECURRENT_TOL:
        # the reduced jamba's random weights make a B = 1 stream
        # ill-conditioned: one-ulp changes of the reference's own weights
        # moved its mesh logits by up to 1.44e-4 of the largest (seed 1,
        # step 3), about the port's distance; the ROADMAP's recurrent rule
        # or those witnesses, the larger
        lim = max(RECURRENT_TOL[arch],
                  float(ref[f"kv_seq_wit/{name}"].max()))
        tol = dict(rtol=lim, atol=lim * max(1.0, top))
        print(f"{name}: limit {lim:.2e} of the largest logit")
    print(f"{name}: {np.abs(got - want).max() / top:.2e} of the largest "
          "logit")
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_kv_seq_chunked_prefill_and_verify_step(kv_runs):
    """Under the rule the chunked prefill (chunks of 4 from
    ``init_decode_state``'s blocks) and a multi-token verify step take the
    split through the same decode attention: reduced deepseek-7b without
    its Engram layer (pooled's capacity makes its rows depend on how a
    prompt's requests are grouped, ROADMAP F13), the chunked prefill's
    logits and the verify step's, fed the greedy stream, within
    ``LOGITS_TOL`` of the monolithic prefill's and the decode steps' under
    the same rule, the same greedy tokens. (The reference runs neither
    under a mesh.)"""
    _, ranks = kv_runs
    for part in ("monolithic", "chunked"):
        for r in ranks:
            r[f"kv_seq_chunked/{part}"] = r[
                f"kv_seq_chunked/{KV_SEQ_CHUNKED}"][part]
    want = _whole(ranks, "kv_seq_chunked/monolithic", batch_split=True)
    got = _whole(ranks, "kv_seq_chunked/chunked", batch_split=True)
    assert got.shape == (2, 1 + KV_SEQ_STEPS, _cfg(KV_SEQ_CHUNKED).vocab_size)
    np.testing.assert_allclose(got, want, **LOGITS_TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _ref_state_blocks(arch, B, max_len, axes):
    """path -> the reference's shard shape of every decode-state leaf under
    ``{"kv_seq": axes}`` on the (2, 4) mesh, in the port's per-layer
    layout (a stacked leaf once per layer, its layer axis dropped)."""
    rcfg = _cfg(arch, False)
    ctx = ref_rules.ShardCtx(AbstractMesh(*MESH), {
        **ref_rules.DEFAULT_RULES, "kv_seq": axes})
    state = ref_specs.abstract_decode_state(rcfg, RefFlags(), B, max_len)
    shards = jax.tree.map(lambda a, s: s.shard_shape(a.shape), state,
                          ref_specs.state_shardings(state, ctx))
    is_shape = lambda x: isinstance(x, tuple)                # noqa: E731
    out = {"positions": shards["positions"],
           "last_tokens": shards["last_tokens"]}
    for si, (seg, sc) in enumerate(zip(ref_plan(rcfg), shards["caches"])):
        blocks = list(sc["prefix"])
        for _ in range(seg.n_periods):
            blocks += [jax.tree.map(lambda s: s[1:], b, is_leaf=is_shape)
                       for b in sc["stack"]]
        for li, b in enumerate(blocks):
            for k, s in b.items():
                out[f"caches/{si}/{li}/{k}"] = tuple(s)
    return out


@pytest.mark.parametrize("name", list(KV_SEQ_CASES))
def test_kv_seq_state_blocks_are_the_reference_shard_shapes(kv_runs, name):
    """Each rank's decode state after the prefill and after the last step:
    the reference's ``shard_shape`` under the same rule, every KV block
    ``max_len / n`` positions of its sequence (n the rule's ranks)."""
    _, ranks = kv_runs
    arch, B, S, axes, _ = KV_SEQ_CASES[name]
    max_len = S + KV_SEQ_STEPS
    n = int(np.prod([dict(zip(MESH[1], MESH[0]))[a] for a in axes]))
    assert max_len % n == 0
    want = _ref_state_blocks(arch, B, max_len, axes)
    kv = [k for k in want if k.rsplit("/", 1)[-1] in KV_KEYS]
    assert kv and all(want[k][1] == max_len // n for k in kv)
    for r in ranks:
        for when in ("prefill", "decode"):
            assert r[f"kv_seq_state/{name}/{when}"] == want, (name, when)


def _blocks_without_keys(S, max_len, n, window):
    """Decode steps (position p) at which some rank's block of max_len / n
    positions holds no key the query at p may attend (causal, and within
    ``window`` of p when it is set)."""
    size = max_len // n
    steps = []
    for p in range(S, S + KV_SEQ_STEPS):
        lo = p - window + 1 if window else 0
        if any(min(p, b * size + size - 1) < max(lo, b * size)
               for b in range(n)):
            steps.append(p)
    return steps


def test_a_rank_holds_no_valid_key(kv_runs):
    """The cases decode steps where some rank's block holds no valid key
    (its positions all past the query's, or all before its window), and
    those ranks add nothing to the combine: the logits above hold there.
    deepseek-7b's first step at position 8 of 12: the last rank's block
    is positions 9 to 11; gemma3-1b's local layers from position 21 on:
    the first rank's block, positions 0 to 5, lies before the window."""
    hit = {}
    for name, (arch, _, S, axes, _) in KV_SEQ_CASES.items():
        n = int(np.prod([dict(zip(MESH[1], MESH[0]))[a] for a in axes]))
        cfg = _cfg(arch)
        hit[name] = _blocks_without_keys(S, S + KV_SEQ_STEPS, n, 0)
        if cfg.window_size:
            hit[name + "/window"] = _blocks_without_keys(
                S, S + KV_SEQ_STEPS, n, cfg.window_size)
    assert hit["deepseek-7b"] == [8]
    assert hit["gemma3-1b/window"] == [21, 22, 23]
    assert sum(map(len, hit.values())) > 5
