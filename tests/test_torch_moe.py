"""PyTorch port vs the JAX reference: Mixture-of-Experts on the CPU, in
float32.

On tests/test_moe.py's ``CFG`` (8 experts, top-2, one shared expert) and
the reduced deepseek-v2/v3 MoE layers (8 experts, top-2 and top-3, with
their shared experts), with the reference's parameters bridged: the
router (expert ids bit for bit, weights and aux loss to 1e-5), the dense
and sorted ragged paths and ``moe_ffn`` under every strategy name against
the reference, at tests/test_moe.py's tolerance (rtol 2e-4, atol 2e-5),
and the plain grouped GEMM against a dense product. On the CPU the
grouped GEMM runs its plain loop and counts no launch."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import deepseek_v2_236b as ref_v2  # noqa: E402
from repro.configs import deepseek_v3_671b as ref_v3  # noqa: E402
from repro.configs.base import ModelConfig as RefModelConfig  # noqa: E402
from repro.configs.base import MoEConfig as RefMoEConfig  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models.params import tree_init as ref_tree_init  # noqa: E402
from repro_torch.configs import deepseek_v2_236b, deepseek_v3_671b  # noqa: E402
from repro_torch.configs.base import ModelConfig, MoEConfig  # noqa: E402
from repro_torch.models import moe as port_moe  # noqa: E402
from repro_torch.models.params import to_torch, tree_map  # noqa: E402

torch.set_num_threads(2)

MOE_TOL = dict(rtol=2e-4, atol=2e-5)     # tests/test_moe.py's
F32 = dict(rtol=1e-5, atol=1e-5)


def _test_cfg(config_cls, moe_cls):
    """tests/test_moe.py's ``CFG`` in either package."""
    return config_cls(
        name="moe-test", family="moe", n_layers=2, d_model=32,
        vocab_size=97, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
        moe=moe_cls(n_experts=8, top_k=2, n_shared=1, d_ff_expert=48,
                    capacity_factor=4.0, aux_loss_coef=0.01),
        ffn_types=("moe", "moe"), dtype="float32")


CONFIGS = {
    "moe-test": (_test_cfg(ModelConfig, MoEConfig),
                 _test_cfg(RefModelConfig, RefMoEConfig)),
    "deepseek-v2-236b-reduced": (deepseek_v2_236b.reduced(),
                                 ref_v2.reduced()),
    "deepseek-v3-671b-reduced": (deepseek_v3_671b.reduced(),
                                 ref_v3.reduced()),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def layer(request):
    """(port cfg, ref cfg, ref params, port params, input (2, 8, d))."""
    cfg, rcfg = CONFIGS[request.param]
    rparams = ref_tree_init(ref_moe.moe_defs(rcfg, "float32"), 0)
    params = tree_map(lambda a: to_torch(a, "cpu"),
                      jax.tree.map(np.asarray, rparams))
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, cfg.d_model).astype(np.float32) * 0.3
    return cfg, rcfg, rparams, params, x


def test_route_matches_reference(layer):
    """Equal expert ids (top-k order included), weights summing to
    ``router_scale``, and the load-balance loss."""
    cfg, rcfg, rparams, params, x = layer
    xf = x.reshape(-1, cfg.d_model)
    reids, rw, raux = ref_moe._route(rcfg.moe, rparams, jnp.asarray(xf))
    eids, w, aux = port_moe._route(cfg.moe, params, torch.from_numpy(xf))
    np.testing.assert_array_equal(eids.numpy(), np.asarray(reids))
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), **F32)
    np.testing.assert_allclose(aux.item(), float(raux), **F32)
    assert w.dtype == torch.float32 and eids.shape == (16, cfg.moe.top_k)


@pytest.mark.parametrize("fn", ["moe_dense", "moe_ragged_local"])
def test_routed_paths_match_reference(layer, fn):
    """The routed experts alone, dense and sorted-ragged, against the
    reference's same function: output and aux."""
    cfg, rcfg, rparams, params, x = layer
    want, raux = getattr(ref_moe, fn)(rcfg, rparams, jnp.asarray(x))
    got, aux = getattr(port_moe, fn)(cfg, params, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)
    np.testing.assert_allclose(aux.item(), float(raux), rtol=1e-5)


@pytest.mark.parametrize("strategy", ["dense", "ragged", "gather",
                                      "alltoall"])
def test_moe_ffn_strategies_match_reference(layer, strategy):
    """``moe_ffn`` with the shared experts under every strategy name
    (the reference's ``gather``/``alltoall`` run its ragged path with no
    mesh, as the port's do): against the reference's same strategy and
    its dense one."""
    cfg, rcfg, rparams, params, x = layer
    got, aux = port_moe.moe_ffn(cfg, params, torch.from_numpy(x),
                                strategy=strategy)
    for s in (strategy, "dense"):
        want, raux = ref_moe.moe_ffn(rcfg, rparams, jnp.asarray(x),
                                     strategy=s)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=s, **MOE_TOL)
    np.testing.assert_allclose(aux.item(), float(raux), rtol=1e-5)


def test_plain_grouped_gemm_equals_dense_product():
    """The plain grouped GEMM over ragged groups (two empty, one holding
    every row of a block) equals each row times its group's matrix;
    on the CPU it launches nothing."""
    rng = np.random.RandomState(1)
    sizes = [3, 0, 5, 0, 1, 7]
    rows = torch.from_numpy(rng.randn(sum(sizes), 16).astype(np.float32))
    w = torch.from_numpy(rng.randn(len(sizes), 16, 24).astype(np.float32))
    offs = torch.tensor(np.cumsum(sizes), dtype=torch.int32)
    group = torch.repeat_interleave(torch.arange(len(sizes)),
                                    torch.tensor(sizes))
    want = torch.einsum("rk,rkn->rn", rows, w[group])
    before = port_moe.grouped_mm.launches
    got = port_moe.grouped_mm(rows, w, offs)
    torch.testing.assert_close(got, want, **F32)
    assert port_moe.grouped_mm.launches == before


def test_ragged_path_is_deterministic_and_dropless():
    """Every (token, choice) row reaches its expert: at capacity
    ``T*k`` the ragged path equals the dense one on 256 tokens (top-2 of
    8 experts), and repeats bit for bit."""
    cfg, rcfg = CONFIGS["deepseek-v2-236b-reduced"]
    rparams = ref_tree_init(ref_moe.moe_defs(rcfg, "float32"), 5)
    params = tree_map(lambda a: to_torch(a, "cpu"),
                      jax.tree.map(np.asarray, rparams))
    x = torch.from_numpy(np.random.RandomState(2).randn(
        4, 64, cfg.d_model).astype(np.float32))
    dense, _ = port_moe.moe_dense(cfg, params, x)
    ragged, _ = port_moe.moe_ragged_local(cfg, params, x)
    torch.testing.assert_close(ragged, dense, rtol=2e-4, atol=2e-5)
    assert torch.equal(ragged, port_moe.moe_ragged_local(cfg, params, x)[0])
