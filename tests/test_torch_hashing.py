"""PyTorch port vs the JAX reference: Engram n-gram hashing and segment-key
packing must be BIT-EQUAL (they are integer functions of token IDs).

Inputs are drawn with numpy and fed to both packages."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import deepseek_7b as ref_deepseek_7b  # noqa: E402
from repro.core import hashing as ref  # noqa: E402
from repro.pool.store import segment_keys as ref_segment_keys  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import deepseek_7b  # noqa: E402
from repro_torch.core import hashing as port  # noqa: E402
from repro_torch.pool.store import segment_keys  # noqa: E402

torch.set_num_threads(2)


def _tiny(mod):
    """tests/test_serving.py's tiny config: 3 layers, Engram at layer 1."""
    cfg = mod.reduced()
    return dataclasses.replace(cfg, n_layers=3, layer_types=("attn",) * 3,
                               attn_kinds=("global",) * 3,
                               ffn_types=("dense",) * 3,
                               engram=dataclasses.replace(cfg.engram,
                                                          layers=(1,)))


# (port EngramConfig, reference EngramConfig, max token id)
GEOMETRIES = {
    "tiny": (_tiny(deepseek_7b).engram, _tiny(ref_deepseek_7b).engram, 520),
    # engram-27b's full tables: 16 tables of 2,262,400 rows, vocab 129,280
    "engram-27b": (get_config("engram-27b").engram,
                   ref_get_config("engram-27b").engram, 129_279),
}


def _tokens(seed, shape, hi):
    return np.random.RandomState(seed).randint(0, hi + 1, size=shape)


@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
@pytest.mark.parametrize("shape", [(1, 2), (2, 3), (3, 17), (4, 40)])
def test_engram_indices_bit_equal(geom, shape):
    pe, re_, hi = GEOMETRIES[geom]
    toks = _tokens(sum(shape), shape, hi)
    want = np.asarray(ref.engram_indices(re_, jnp.asarray(toks, jnp.int32)))
    got = port.engram_indices(pe, torch.from_numpy(toks)).numpy()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    # and the reference's own numpy twin
    np.testing.assert_array_equal(got, ref.host_engram_indices(re_, toks))


@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_head_constants_identical(geom):
    pe, re_, _ = GEOMETRIES[geom]
    np.testing.assert_array_equal(port.head_constants(pe),
                                  ref.head_constants(re_))


@pytest.mark.parametrize("order", [1, 2, 3, 5])
def test_ngram_windows_bit_equal(order):
    toks = _tokens(order, (2, 4), 99)
    want = np.asarray(ref.ngram_windows(jnp.asarray(toks, jnp.int32), order,
                                        7))
    got = port.ngram_windows(torch.from_numpy(toks), order, 7).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
@pytest.mark.parametrize("n_slots", [1, 2])
def test_packed_keys_bit_equal(geom, n_slots):
    """pack_segment_keys == the reference's device packing == its host
    ground truth ``pool.store.segment_keys``, slot by slot."""
    pe, re_, _ = GEOMETRIES[geom]
    idx = np.random.RandomState(n_slots).randint(
        0, pe.table_vocab, size=(3, 5, pe.n_tables))
    got = port.pack_segment_keys(pe, torch.from_numpy(idx), n_slots).numpy()
    want = np.asarray(ref.pack_segment_keys(re_, jnp.asarray(idx), n_slots))
    np.testing.assert_array_equal(got, want)
    for j in range(n_slots):
        flat = got[:, :, j, :].reshape(-1)
        np.testing.assert_array_equal(flat, ref_segment_keys(re_, idx, j))
        np.testing.assert_array_equal(flat, segment_keys(pe, idx, j))


@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_decode_keys_bit_equal(geom):
    pe, re_, hi = GEOMETRIES[geom]
    last = _tokens(1, (5, max(pe.orders) - 1), hi)
    new = _tokens(2, (5,), hi)
    want = np.asarray(ref.decode_engram_keys(
        re_, jnp.asarray(last, jnp.int32), jnp.asarray(new, jnp.int32), 2))
    got = port.decode_engram_keys(pe, torch.from_numpy(last),
                                  torch.from_numpy(new), 2).numpy()
    assert got.shape == (5, 1, 2, pe.n_tables)
    np.testing.assert_array_equal(got, want)
    idx = port.decode_engram_indices(pe, torch.from_numpy(last),
                                     torch.from_numpy(new)).numpy()
    np.testing.assert_array_equal(idx, np.asarray(ref.decode_engram_indices(
        re_, jnp.asarray(last, jnp.int32), jnp.asarray(new, jnp.int32))))


def test_update_last_tokens_roll():
    last = _tokens(3, (4, 2), 50)
    new = _tokens(4, (4,), 50)
    want = np.asarray(ref.update_last_tokens(jnp.asarray(last),
                                             jnp.asarray(new)))
    got = port.update_last_tokens(torch.from_numpy(last),
                                  torch.from_numpy(new)).numpy()
    np.testing.assert_array_equal(got, want)


def test_uint32_mix_near_wraparound():
    """F2: the murmur mix and its 32-bit products on int64 tensors equal
    numpy's uint32 wraparound arithmetic on values up to 2**32 - 1."""
    x = np.array([0, 1, 2**16 - 1, 2**16, 2**31 - 1, 2**31, 2**32 - 2,
                  2**32 - 1, 0xDEADBEEF, 0x9E3779B9], np.uint32)
    x = np.concatenate([x, np.random.RandomState(0).randint(
        0, 2**32, size=500, dtype=np.uint64).astype(np.uint32)])
    with np.errstate(over="ignore"):
        want = np.asarray(ref._mix(jnp.asarray(x))).astype(np.int64)
        prod = (x * np.uint32(0x846CA68B)).astype(np.int64)
    xt = torch.from_numpy(x.astype(np.int64))
    np.testing.assert_array_equal(port._mix(xt).numpy(), want)
    got = port._mul32(xt, 0x846CA68B & 0xFFFF, 0x846CA68B >> 16).numpy()
    np.testing.assert_array_equal(got, prod)


def test_tokens_near_int32_max_bit_equal():
    """F2: token ids whose uint32 products wrap many times hash like the
    reference's numpy twin."""
    e = get_config("engram-27b").engram
    toks = np.array([[2**31 - 1, 2**31 - 2, 2**30, 3, 2**31 - 1, 0]],
                    np.int64)
    got = port.engram_indices(e, torch.from_numpy(toks)).numpy()
    want = ref.host_engram_indices(ref_get_config("engram-27b").engram,
                                   toks.astype(np.int32))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
@pytest.mark.parametrize("m", [1, 5, 16])
def test_block_engram_indices_bit_equal(geom, m):
    """A chunk's indices from the rolled history and the chunk's tokens,
    as a chunk-prefill wave packs its keys."""
    pe, re_, hi = GEOMETRIES[geom]
    last = _tokens(5 + m, (3, max(pe.orders) - 1), hi)
    block = _tokens(6 + m, (3, m), hi)
    want = np.asarray(ref.block_engram_indices(
        re_, jnp.asarray(last, jnp.int32), jnp.asarray(block, jnp.int32)))
    got = port.block_engram_indices(pe, torch.from_numpy(last),
                                    torch.from_numpy(block)).numpy()
    assert got.shape == (3, m, pe.n_tables)
    np.testing.assert_array_equal(got, want)
    # int32 history (the decode state's width) hashes the same
    np.testing.assert_array_equal(port.block_engram_indices(
        pe, torch.from_numpy(last.astype(np.int32)),
        torch.from_numpy(block)).numpy(), want)


@pytest.mark.parametrize("block", [1, 4, 8])
def test_prefix_chain_keys_equal(block):
    """Chained block keys: equal to the reference's for whole blocks,
    none for the trailing partial block, and shared exactly as far as two
    prompts share whole blocks."""
    a = [int(t) for t in _tokens(7, (21,), 129_279)]
    b = a[:2 * block] + [t + 1 for t in a[2 * block:]]
    for p in (a, b, [], a[:block - 1]):
        assert port.prefix_chain_keys(p, block) == \
            ref.prefix_chain_keys(p, block)
    ka, kb = port.prefix_chain_keys(a, block), port.prefix_chain_keys(b, block)
    assert len(ka) == 21 // block
    assert ka[:2] == kb[:2] and all(x != y for x, y in zip(ka[2:], kb[2:]))
    with pytest.raises(ValueError):
        port.prefix_chain_keys(a, 0)
