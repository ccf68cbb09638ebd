"""The reference's side of tests/test_torch_multidev.py, run in a
subprocess with 8 fake host devices (the pytest process stays at 1):

    python tests/torch_multidev_ref.py <inputs.npz> <out.npz> [mesh|train]

Runs the reference's mesh strategies on a (2, 4) ("data", "model") mesh
(``retrieve`` tp and pooled, ``retrieve_pooled`` at slack 0.25,
``moe_ffn`` gather and alltoall at two capacity factors,
``embed_lookup_local``), check_compressed_ddp's train step with and
without the int8 wire on an (8,) mesh, and reduced deepseek-v3-671b's
single-device
prefill and greedy decode (local retrieval, ragged MoE), the train steps
(check_tp_train_step's model on one device and under the mesh with tp and
pooled retrieval: loss, gradients, one AdamW step; reduced
deepseek-v2-236b's expert-parallel steps at capacity factor 1.25 under the
mesh, and with the capacity raised and the load-balance loss off on one
device: loss and gradients), the former with their one-ulp witnesses, on
the inputs the test wrote, and saves the outputs; or, as its part
"kv_seq", reduced models' prefill and greedy decode under a ``kv_seq``
rule (tests/test_torch_kv_seq.py)."""
import dataclasses
import os
import sys
from pathlib import Path

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import deepseek_v3_671b  # noqa: E402
from repro.configs.base import (EngramConfig, ModelConfig,  # noqa: E402
                                MoEConfig)
from repro.core.engram import retrieve, retrieve_pooled  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models.layers import embed_lookup_local  # noqa: E402
from repro.models.moe import moe_ffn  # noqa: E402
from repro.models.transformer import RunFlags  # noqa: E402
from repro.sharding.rules import sharding_ctx  # noqa: E402

ECFG = EngramConfig(orders=(2, 3), n_heads=4, emb_dim=64, table_vocab=4096,
                    layers=(1,), strategy="pooled")
MOE_CFG = ModelConfig(
    name="m", family="moe", n_layers=2, d_model=32, vocab_size=97,
    n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, d_ff_expert=48,
                  capacity_factor=8.0),
    ffn_types=("moe", "moe"), dtype="float32")
CAPACITY_FACTORS = (8.0, 1.0)
DECODE_STEPS = 4
# tests/multidev_checks.py's check_compressed_ddp model
DDP_CFG = ModelConfig(
    name="d", family="dense", n_layers=2, d_model=32, vocab_size=101,
    n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
    engram=EngramConfig(orders=(2,), n_heads=2, emb_dim=32, table_vocab=1024,
                        layers=(1,), strategy="local"),
    dtype="float32")


# tests/multidev_checks.py's check_tp_train_step model
TR_CFG = ModelConfig(
    name="t", family="dense", n_layers=3, d_model=64, vocab_size=128,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, engram=ECFG,
    dtype="float32")
TR_LR = 1e-4
EP_CAPACITY = 1.25          # reduced deepseek-v2-236b's own
WITNESS_SEEDS = (1, 2, 3, 4, 5)   # tests/test_torch_train.py's
WITNESS_EPS = 1e-7


def _moved(tree, seed):
    """Each element times (1 + WITNESS_EPS N(0, 1)): about one f32 ulp."""
    leaves, tdef = jax.tree.flatten(tree)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree.unflatten(tdef, [
        x * (1 + WITNESS_EPS * jax.random.normal(k, x.shape, x.dtype))
        for x, k in zip(leaves, keys)])


def _share(got, want) -> float:
    """The largest over leaves of max |got - want| / max |want|."""
    return max(float(np.abs(np.asarray(a) - np.asarray(b)).max()
                     / max(float(np.abs(np.asarray(b)).max()), 1e-30))
               for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)))


def train_case(out, name, cfg, flags, params, batch, mesh, step: bool):
    """The loss and gradients of ``cfg`` under ``mesh`` (None: one
    device) and, with ``step``, one AdamW step at ``TR_LR`` from fresh
    moments and the witnesses: the shares by which the gradients,
    grad_norm and the stepped parameters move when the weights move by
    about one ulp (per ``WITNESS_SEEDS``)."""
    import contextlib
    from repro.train import AdamWConfig
    from repro.train.optimizer import adamw_update, init_opt_state
    vg = jax.jit(jax.value_and_grad(ref_model.build_loss_fn(cfg, flags)))
    oc = AdamWConfig(lr=TR_LR, warmup_steps=1)
    adam = jax.jit(lambda p, g: adamw_update(oc, p, g, init_opt_state(p)))
    wit = {"g": [0.0], "gnorm": [0.0], "p": [0.0]}
    with contextlib.ExitStack() as on_mesh:
        if mesh is not None:
            on_mesh.enter_context(sharding_ctx(mesh))
            on_mesh.enter_context(mesh)
        loss, grads = vg(params, batch)
        moved = [_moved(params, s) for s in (WITNESS_SEEDS if step else ())]
        moved_g = [vg(p, batch)[1] for p in moved]
    out[f"{name}/loss"] = np.asarray(loss)
    for i, leaf in enumerate(jax.tree.leaves(grads)):
        out[f"{name}/g{i}"] = np.asarray(leaf)
    if step:
        p, st, m = adam(params, grads)
        gn = float(m["grad_norm"])
        out[f"{name}/gnorm"] = np.asarray(gn)
        for i, leaf in enumerate(jax.tree.leaves(p)):
            out[f"{name}/p{i}"] = np.asarray(leaf)
        for mom in ("m", "v"):
            for i, leaf in enumerate(jax.tree.leaves(st[mom])):
                out[f"{name}/{mom}{i}"] = np.asarray(leaf)
        for pw, gw in zip(moved, moved_g):
            p_w, _, m_w = adam(pw, gw)
            wit["g"].append(_share(gw, grads))
            wit["gnorm"].append(abs(float(m_w["grad_norm"]) - gn) / gn)
            wit["p"].append(_share(p_w, p))
    for k, v in wit.items():
        out[f"{name}/wit_{k}"] = np.asarray(v)


def ep_cfg(cf: float, aux: bool = True):
    """Reduced deepseek-v2-236b at capacity factor ``cf``, its
    load-balance loss off unless ``aux``."""
    from repro.configs import deepseek_v2_236b
    cfg = deepseek_v2_236b.reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf,
        aux_loss_coef=cfg.moe.aux_loss_coef if aux else 0.0))


def train_steps(out, mesh):
    """check_tp_train_step's twin and the expert-parallel train steps."""
    from repro.data import DataConfig, TokenPipeline

    def batch(cfg):
        return {k: jnp.asarray(v) for k, v in TokenPipeline(DataConfig(
            vocab_size=cfg.vocab_size, batch=4, seq_len=16, seed=0)
        ).batch_at(0).items()}

    params = ref_model.init_params(TR_CFG, 0)
    b = batch(TR_CFG)
    train_case(out, "tr/one", TR_CFG, RunFlags(), params, b, None, True)
    for strat in ("pooled", "tp"):
        train_case(out, f"tr/{strat}", TR_CFG,
                   RunFlags(engram_strategy=strat), params, b, mesh, True)
    cfg = ep_cfg(EP_CAPACITY)
    params, b = ref_model.init_params(cfg, 0), batch(cfg)
    for strat in ("gather", "alltoall"):
        train_case(out, f"ep/{strat}", cfg, RunFlags(moe_strategy=strat),
                   params, b, mesh, False)
    train_case(out, "ep/one", ep_cfg(8.0, aux=False),
               RunFlags(moe_strategy="ragged"), params, b, None, False)


def model_cfg():
    """Reduced deepseek-v3-671b with a capacity factor at which the mesh's
    expert-parallel paths drop no row (the single-device path is
    dropless)."""
    cfg = deepseek_v3_671b.reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))


# the reduced configs of the mesh-layout forwards: dense GQA with its KV
# heads whole on the model axis (engram-27b) and split (deepseek-7b),
# jamba and xLSTM, each vocabulary rounded up to a multiple of 4 so that
# the model axis splits the embedding and the head
LAYOUT_ARCHS = ("engram-27b", "deepseek-7b", "jamba-1.5-large-398b",
                "xlstm-125m")
LAYOUT_FLAGS = dict(engram_strategy="pooled", moe_strategy="alltoall")


def layout_cfg(arch: str):
    """Reduced ``arch`` with its vocabulary rounded up to a multiple of 4
    and, with MoE, a capacity factor at which nothing drops."""
    from repro.launch.train import reduced_config
    cfg = reduced_config(arch)
    cfg = dataclasses.replace(cfg, vocab_size=-(-cfg.vocab_size // 4) * 4)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    return cfg


def layout_forwards(out, inp, mesh):
    """Each ``LAYOUT_ARCHS`` model's prefill and greedy decode under the
    mesh (``LAYOUT_FLAGS``)."""
    with sharding_ctx(mesh), mesh:
        for arch in LAYOUT_ARCHS:
            out[f"layout/{arch}"] = greedy(RunFlags(**LAYOUT_FLAGS),
                                           inp[f"layout_toks/{arch}"],
                                           layout_cfg(arch))


# archs whose kv_seq logits are held with one-ulp witnesses (a recurrent
# stack: tests/test_torch_kv_seq.py)
KV_SEQ_WITNESSED = ("jamba-1.5-large-398b",)


def kv_seq_forwards(out, inp, mesh, names=None):
    """Each ``KV_SEQ_CASES`` model's prefill and greedy decode under the
    mesh with its ``kv_seq`` rule (the flash-decode split of the KV
    sequence; ``LAYOUT_FLAGS``, with ``decode_window_slice`` where the
    case sets it); for ``KV_SEQ_WITNESSED`` also the witnesses: the
    largest share of the largest logit by which the logits move, fed the
    same tokens, when every weight moves by about one ulp (three draws,
    ``WITNESS_SEEDS[:3]``). ``names``: those cases alone."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from torch_multidev_ranks import KV_SEQ_CASES
    for name, (arch, _, _, axes, window_slice) in KV_SEQ_CASES.items():
        if names is not None and name not in names:
            continue
        flags = RunFlags(decode_window_slice=window_slice, **LAYOUT_FLAGS)
        cfg = layout_cfg(arch)
        toks = inp[f"kv_seq_toks/{name}"]
        with sharding_ctx(mesh, {"kv_seq": axes}), mesh:
            steps = _steps(cfg, flags, toks.shape[1] + DECODE_STEPS)
            base = greedy(flags, toks, cfg, steps=steps)
            out[f"kv_seq/{name}"] = base
            if arch in KV_SEQ_WITNESSED:
                params = ref_model.init_params(cfg, 0)
                out[f"kv_seq_wit/{name}"] = np.asarray([
                    np.abs(greedy(flags, toks, cfg, _moved(params, s), base,
                                  steps) - base).max() / np.abs(base).max()
                    for s in WITNESS_SEEDS[:3]])


def main(inputs: str, out_path: str, part: str = "mesh") -> None:
    """``part`` "mesh": every output but the train steps, the layout
    forwards and the ``kv_seq`` forwards; "train": the train steps alone;
    "layout": the layout forwards alone (tests/test_torch_multidev.py runs
    the three at once); "kv_seq" or "kv_seq:<case>,<case>...": the
    ``kv_seq`` forwards alone, of every case or of those named
    (tests/test_torch_kv_seq.py runs a few such parts at once)."""
    mesh = make_mesh((2, 4), ("data", "model"))
    if part in ("train", "layout") or part.startswith("kv_seq"):
        out = {}
        if part == "train":
            train_steps(out, mesh)
        elif part == "layout":
            layout_forwards(out, dict(np.load(inputs)), mesh)
        else:
            names = part.partition(":")[2]
            kv_seq_forwards(out, dict(np.load(inputs)), mesh,
                            names.split(",") if names else None)
        np.savez(out_path, **out)
        return
    inp = dict(np.load(inputs))
    out = {}
    tab = jnp.asarray(inp["tables"])
    with sharding_ctx(mesh), mesh:
        for case in ("idx", "idx1", "idx_hot"):
            idx = jnp.asarray(inp[case])
            for strat in ("local", "tp", "pooled"):
                out[f"{strat}/{case}"] = np.asarray(jax.jit(
                    lambda t, i: retrieve(ECFG, t, i, strat))(tab, idx))
        out["pooled_slack/idx"] = np.asarray(jax.jit(
            lambda t, i: retrieve_pooled(ECFG, t, i, slack=0.25))(
                tab, jnp.asarray(inp["idx"])))
        params = {k[len("moe/"):]: jnp.asarray(v) for k, v in inp.items()
                  if k.startswith("moe/")}
        params["shared"] = {k: params.pop(f"shared/{k}")
                            for k in ("gate", "up", "down")}
        for cf in CAPACITY_FACTORS:
            cfg = dataclasses.replace(MOE_CFG, moe=dataclasses.replace(
                MOE_CFG.moe, capacity_factor=cf))
            for strat in ("dense", "gather", "alltoall"):
                for case in ("x", "x_odd"):
                    o, aux = jax.jit(lambda p, v: moe_ffn(
                        cfg, p, v, strategy=strat))(params,
                                                    jnp.asarray(inp[case]))
                    out[f"moe/{strat}/{cf}/{case}"] = np.asarray(o)
                    out[f"moe_aux/{strat}/{cf}/{case}"] = np.asarray(aux)
        out["embed"] = np.asarray(jax.jit(embed_lookup_local)(
            {"w": jnp.asarray(inp["embed_w"])},
            jnp.asarray(inp["embed_toks"])))
        # reduced deepseek-v3 under the mesh: pooled, alltoall, the
        # vocab-sharded embedding
        out["model/pooled"] = greedy(RunFlags(
            moe_strategy="alltoall", engram_strategy="pooled",
            embed_local_gather=True), inp["model_toks"])
    # check_compressed_ddp's step on an (8,) mesh, int8 wire and exact
    from repro.data import DataConfig, TokenPipeline
    from repro.train import AdamWConfig, build_ddp_train_step
    from repro.train.optimizer import init_opt_state
    dmesh = make_mesh((8,), ("data",))
    params = ref_model.init_params(DDP_CFG, 0)
    batch = {k: jnp.asarray(v) for k, v in TokenPipeline(DataConfig(
        vocab_size=101, batch=8, seq_len=16, seed=0)).batch_at(0).items()}
    oc = AdamWConfig(lr=1e-3, warmup_steps=1, grad_clip=0.0)
    with sharding_ctx(dmesh), dmesh:
        for name, compress in (("compress", True), ("exact", False)):
            p, _, m = jax.jit(build_ddp_train_step(
                DDP_CFG, RunFlags(), oc, dmesh, compress=compress))(
                    params, init_opt_state(params), batch)
            out[f"ddp/{name}/loss"] = np.asarray(m["loss"])
            for i, leaf in enumerate(jax.tree.leaves(p)):
                out[f"ddp/{name}/p{i}"] = np.asarray(leaf)
    # and on one device: local retrieval, ragged MoE
    out["model/local"] = greedy(RunFlags(moe_strategy="ragged",
                                         engram_strategy="local"),
                                inp["model_toks"])
    np.savez(out_path, **out)


def _steps(cfg, flags, max_len: int):
    """The jitted prefill and decode steps (traced under the sharding
    context of their first call)."""
    return (jax.jit(ref_model.build_prefill_step(cfg, flags,
                                                 max_len=max_len)),
            jax.jit(ref_model.build_decode_step(cfg, flags)))


def greedy(flags, toks, cfg=None, params=None, feed=None, steps=None):
    """Reduced deepseek-v3's (or ``cfg``'s) prefill logits, then
    DECODE_STEPS greedy decode steps' (B, 1 + DECODE_STEPS, V); with
    ``feed`` (B, 1 + DECODE_STEPS, V) logits, the steps take their
    argmax tokens (teacher-forced) instead of their own; ``steps``: the
    jitted steps of an earlier call under the same context (``_steps``)."""
    cfg = cfg or model_cfg()
    params = ref_model.init_params(cfg, 0) if params is None else params
    toks = jnp.asarray(toks)
    prefill, decode = steps or _steps(cfg, flags,
                                      toks.shape[1] + DECODE_STEPS)
    logits, state = prefill(params, {"tokens": toks})
    all_logits = [np.asarray(logits)]
    for i in range(DECODE_STEPS):
        src = logits if feed is None else jnp.asarray(feed[:, i])
        logits, state = decode(params, state,
                               jnp.argmax(src, -1).astype(jnp.int32))
        all_logits.append(np.asarray(logits))
    return np.stack(all_logits, axis=1)


if __name__ == "__main__":
    main(*sys.argv[1:])
