"""The traffic generator: the same seed gives the same requests, and every
seed the same set of sizes in another order."""

import numpy as np
import pytest

from port_bench.drivers import _serve
from port_bench.tests.tiny import tiny_run


@pytest.mark.parametrize("traffic", ["code-saturated"])
def test_prompts_repeat_per_seed_and_keep_their_lengths(traffic):
    a = _serve.make_prompts(tiny_run(traffic, seed=2 ** 31 + 11), 40)
    b = _serve.make_prompts(tiny_run(traffic, seed=2 ** 31 + 11), 40)
    c = _serve.make_prompts(tiny_run(traffic, seed=5), 40)
    assert a == b
    assert a != c
    assert sorted(map(len, a)) == sorted(map(len, c))
    p = tiny_run(traffic).traffic["prompt"]
    assert all(p["lo"] <= len(x) <= p["hi"] for x in a)


@pytest.mark.parametrize("n", [120, 37, 5])
def test_blocks_take_one_of_each_stratum(n):
    values = np.arange(n, dtype=np.float64)
    got = _serve.blocked(np.random.default_rng(9), values)
    assert sorted(got) == list(values)
    strata = np.array_split(np.arange(n), _serve.BLOCK)
    which = {int(v): j for j, s in enumerate(strata) for v in s}
    for b in range(0, n - n % _serve.BLOCK, _serve.BLOCK):
        block = [which[int(v)] for v in got[b:b + _serve.BLOCK]]
        assert len(set(block)) == len(block)


def test_log_normal_lengths_are_its_quantiles():
    tr = dict(prompt=dict(dist="log_normal", median=1500, sigma=0.8,
                          lo=16, hi=8160))
    n = _serve.prompt_lengths(tr, 1000)
    assert n.min() >= 16 and n.max() <= 8160
    assert np.median(n) == pytest.approx(1500, rel=0.01)
    # a tenth of them past the 0.9 quantile, 1500 exp(0.8 * 1.2816)
    assert np.quantile(n, 0.9) == pytest.approx(4179, rel=0.01)
    with pytest.raises(ValueError):
        _serve.prompt_lengths(dict(prompt=dict(tr["prompt"],
                                               dist="uniform")), 10)


def test_train_batches_repeat_per_seed():
    from port_bench.drivers.train import make_data

    a = make_data(tiny_run("train-b1-l8192", seed=2 ** 31 + 3))
    b = make_data(tiny_run("train-b1-l8192", seed=2 ** 31 + 3))
    c = make_data(tiny_run("train-b1-l8192", seed=4))
    assert all((x[0] == y[0]).all() for x, y in zip(a, b))
    assert not (a[0][0] == c[0][0]).all()
    # the labels are the ids shifted by one, and the rows all differ
    ids, labels = a[0]
    assert (ids[:, 1:] == labels[:, :-1]).all()
    rows = [tuple(x[0][r].tolist()) for x in a for r in range(x[0].shape[0])]
    assert len(set(rows)) == len(rows)
