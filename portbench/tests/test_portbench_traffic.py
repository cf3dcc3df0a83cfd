"""The traffic generator: the same seed gives the same requests, every
seed the same spread of work."""

import itertools

import numpy as np
import pytest

from portbench import traffic

T = {"params": {"delta": {"integers": [60, 120]},
                "offset": {"grid": [0, 2048, 256]}}}


def take(seed, n, purpose="window"):
    return list(itertools.islice(traffic.requests(T, seed, purpose), n))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 2 ** 40 + 1, -3])
def test_deterministic_and_in_range(seed):
    a, b = take(seed, 40), take(seed, 40)
    assert a == b
    for p in a:
        assert isinstance(p["delta"], int) and 60 <= p["delta"] <= 120
        assert p["offset"] in range(0, 2049, 256)


def test_seeds_and_purposes_differ():
    assert take(1, 5) != take(2, 5)
    assert take(1, 5) != take(1, 5, "warm")


def test_integers_reach_both_ends():
    got = {p["delta"] for p in take(5, 2000)}
    assert got == set(range(60, 121))


def test_grid_is_a_permutation_each_pass():
    got = [p["offset"] for p in take(11, 18)]
    assert sorted(got[:9]) == list(range(0, 2049, 256))
    assert sorted(got[9:]) == list(range(0, 2049, 256))


def test_sample():
    s = traffic.sample(5, 100, 10, "check")
    assert len(set(s.tolist())) == 10 and np.all(np.diff(s) > 0)
    assert traffic.sample(5, 4, 10, "check").tolist() == [0, 1, 2, 3]
