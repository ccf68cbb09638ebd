"""The traffic generator: the queues fixed by the mix, every round a
stratified sample within the mix's clips, the ids drawn from the seed."""
import json
from pathlib import Path

import pytest

from portbench.harness import loadgen

MIXES = sorted((Path(__file__).resolve().parents[1] / "traffic")
               .glob("*.json"))


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_the_plan_is_fixed_by_the_mix(path):
    mix = json.loads(path.read_text())
    a = loadgen.plan(mix, path.stem)
    assert a == loadgen.plan(mix, path.stem)
    assert len(a) == mix["clients"]
    for q in a:
        assert len(q) == mix["per_client"]
        for s in q:
            assert mix["prompt"]["min"] <= s.prompt_len <= mix["prompt"]["max"]
            assert mix["output"]["min"] <= s.max_new <= mix["output"]["max"]
    keys = [s.key for q in a for s in q]
    assert sorted(keys) == list(range(len(keys)))


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_every_round_is_a_stratified_sample(path):
    mix = json.loads(path.read_text())
    N, R = mix["clients"], mix["per_client"]
    a = loadgen.plan(mix, path.stem)
    allp = sorted(s.prompt_len for q in a for s in q)
    for r in range(R):
        got = sorted(q[r].prompt_len for q in a)
        assert got == allp[r::R]


def test_ids_follow_the_seed():
    spec = loadgen.Spec(4096, 8, 3)
    big = 2 ** 31 + 17
    assert loadgen.prompt_ids(spec, big, 1000) == \
        loadgen.prompt_ids(spec, big, 1000)
    a = loadgen.prompt_ids(spec, 7, 50)
    assert set(a) == set(range(50))
    assert a != loadgen.prompt_ids(spec, 8, 50)


def test_quantiles_follow_the_lognormal():
    spec = {"median": 512, "sigma": 0.6, "min": 1, "max": 10 ** 6}
    v = loadgen.quantile_lengths(spec, 1001)
    assert v[500] == 512
    assert list(v) == sorted(v)
