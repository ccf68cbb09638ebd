"""The plain reference against the port's forward on the reduced families
in float32 (every position's logits), and its hash against the port's,
bit for bit."""
import numpy as np
import pytest
import torch

from portbench.harness import model
from portbench.reference.common import engram_indices
from portbench.reference.model import Reference

from . import tiny


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
def test_hash_is_the_ports(seed):
    from repro_torch.core.hashing import engram_indices as port_indices
    cfg = model.model_config(tiny.DENSE)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 2 ** 20, size=(1, 257))
    got = engram_indices(tiny.DENSE["engram"], toks[0])
    want = port_indices(cfg.engram, torch.from_numpy(toks))[0].numpy()
    np.testing.assert_array_equal(got, want)
    # the left edge: a prompt shorter than the longest n-gram
    short = toks[0, :1]
    np.testing.assert_array_equal(
        engram_indices(tiny.DENSE["engram"], short),
        port_indices(cfg.engram, torch.from_numpy(toks[:, :1]))[0].numpy())


@pytest.mark.parametrize("c", [tiny.DENSE, tiny.MLA_MOE],
                         ids=lambda c: c["name"])
def test_reference_is_the_ports_forward_in_f32(c):
    from repro_torch.models.model import _logits, forward
    from repro_torch.models.transformer import RunFlags
    c = tiny.f32(c)
    cfg = model.model_config(c)
    w = model.Weights(cfg, "cpu", host_tables=True)
    w.draw(11)
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, c["vocab_size"], size=n).tolist()
            for n in (5, 23, 40)]
    want = []
    flags = RunFlags(engram_strategy="pooled_host")
    with torch.no_grad():
        for s in seqs:
            h, _, _ = forward(cfg, flags, w.tree,
                              {"tokens": torch.tensor([s])}, "prefill")
            want.append(_logits(cfg, w.tree, h[0]))
    got = Reference(c, w.tree, "cpu").logits(
        seqs, [np.arange(len(s)) for s in seqs])
    for g, x in zip(got, want):
        scale = x.abs().max().item()
        assert (g - x).abs().max().item() <= 1e-5 * scale
