"""The traffic generator: batches drawn from the seed alone."""
from __future__ import annotations

import numpy as np
import pytest

from portbench import harness
from portbench.generator import TokenBatches

MIX = harness.load("traffic", "train.b4x512")


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**40 + 3, -5])
def test_same_seed_same_batches_in_any_order(seed):
    a, b = TokenBatches(MIX, 1000, seed), TokenBatches(MIX, 1000, seed)
    assert all(np.array_equal(a.batch(s)["tokens"], b.batch(s)["tokens"]) for s in (3, 0, 7))
    x = a.batch(0)
    assert x["tokens"].shape == (MIX["batch"], MIX["seq"]) and x["tokens"].dtype == np.int64
    assert np.array_equal(x["tokens"][:, 1:], x["labels"][:, :-1])
    assert x["tokens"].min() >= 0 and x["tokens"].max() < 1000


def test_rows_and_seeds_differ():
    a = TokenBatches(MIX, 49155, 1)
    rows = np.concatenate([a.batch(s)["tokens"] for s in range(4)])
    assert len({r.tobytes() for r in rows}) == len(rows)
    assert not np.array_equal(a.batch(0)["tokens"], TokenBatches(MIX, 49155, 2).batch(0)["tokens"])


def test_zipf_makes_a_few_ids_frequent():
    t = TokenBatches({**MIX, "batch": 64}, 49155, 4).batch(0)["tokens"]
    counts = np.sort(np.bincount(t.ravel(), minlength=49155))[::-1]
    assert counts[0] > 50 * np.median(counts[counts > 0])


@pytest.mark.parametrize("exponent", [-1.0, float("nan")])
def test_a_bad_exponent_is_refused(exponent):
    with pytest.raises(ValueError):
        TokenBatches({**MIX, "zipf_exponent": exponent}, 100, 0)
