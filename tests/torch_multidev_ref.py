"""The reference's side of tests/test_torch_multidev.py, run in a
subprocess with 8 fake host devices (the pytest process stays at 1):

    python tests/torch_multidev_ref.py <inputs.npz> <out.npz>

Runs the reference's mesh strategies on a (2, 4) ("data", "model") mesh
(``retrieve`` tp and pooled, ``retrieve_pooled`` at slack 0.25,
``moe_ffn`` gather and alltoall at two capacity factors,
``embed_lookup_local``), check_compressed_ddp's train step with and
without the int8 wire on an (8,) mesh, and reduced deepseek-v3-671b's
single-device
prefill and greedy decode (local retrieval, ragged MoE), on the inputs the
test wrote, and saves the outputs."""
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


def model_cfg():
    """Reduced deepseek-v3-671b with a capacity factor at which the mesh's
    expert-parallel paths drop no row (the single-device path is
    dropless)."""
    cfg = deepseek_v3_671b.reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))


def main(inputs: str, out_path: str) -> None:
    inp = dict(np.load(inputs))
    out = {}
    mesh = make_mesh((2, 4), ("data", "model"))
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


def greedy(flags, toks):
    """Reduced deepseek-v3's prefill logits, then DECODE_STEPS greedy
    decode steps' (B, 1 + DECODE_STEPS, V)."""
    cfg = model_cfg()
    params = ref_model.init_params(cfg, 0)
    toks = jnp.asarray(toks)
    logits, state = jax.jit(ref_model.build_prefill_step(
        cfg, flags, max_len=toks.shape[1] + DECODE_STEPS))(
            params, {"tokens": toks})
    decode = jax.jit(ref_model.build_decode_step(cfg, flags))
    all_logits = [np.asarray(logits)]
    for _ in range(DECODE_STEPS):
        logits, state = decode(params, state,
                               jnp.argmax(logits, -1).astype(jnp.int32))
        all_logits.append(np.asarray(logits))
    return np.stack(all_logits, axis=1)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
