"""Each traffic file's input pool and request order are determined by the
seed (checked at the file's own parameters, with the pool cut to a few
small requests)."""

from __future__ import annotations

import itertools
import json

import numpy as np
import pytest

from benchmark.inputs import request_order
from benchmark.run import load_module
from benchmark.tests.conftest import REPO, tiny_traffic

TRAFFIC = sorted(p.stem for p in (REPO / "benchmark" / "traffic").glob("*.json"))


def small(name: str) -> dict:
    return tiny_traffic(json.loads((REPO / "benchmark" / "traffic" / f"{name}.json").read_text()))


def path_of(t: dict):
    return load_module(REPO / "benchmark" / "paths" / f"{t['path']}.py", "path_" + t["path"])


def arrays(pool):
    return pool if isinstance(pool, tuple) else (pool,)


@pytest.mark.parametrize("name", TRAFFIC)
def test_pool_is_determined_by_the_seed(name):
    t = small(name)
    path = path_of(t)
    a = arrays(path.make_pool(t, 2**31 + 5, "cpu"))
    b = arrays(path.make_pool(t, 2**31 + 5, "cpu"))
    c = arrays(path.make_pool(t, 2**31 + 6, "cpu"))
    for x, y, z in zip(a, b, c):
        assert x.dtype in (np.float32, np.uint16) and x.shape[0] == t["pool"]
        np.testing.assert_array_equal(x, y)
        assert not np.array_equal(x, z)
    assert len({x.shape for x in a}) == 1  # the views of a pair have one shape


@pytest.mark.parametrize("name", TRAFFIC)
def test_request_order_is_determined_by_the_seed(name):
    t = small(name)
    first = list(itertools.islice(request_order(t, 99), 4 * t["pool"]))
    assert first == list(itertools.islice(request_order(t, 99), 4 * t["pool"]))
    assert first != list(itertools.islice(request_order(t, 100), 4 * t["pool"]))
    # every entry equally often in each round of the pool
    for r in range(4):
        assert sorted(first[r * t["pool"]:(r + 1) * t["pool"]]) == list(range(t["pool"]))


def test_serving_pool_is_in_the_sensor_range():
    t = small("thermal-u16-b128")
    pool = path_of(t).make_pool(t, 3, "cpu")
    assert pool.shape == (t["pool"], t["frames"], t["height"], t["width"])
    lo, hi = t["counts"]
    assert pool.dtype == np.uint16 and pool.min() >= lo and pool.max() <= hi
    assert pool.std(axis=(2, 3)).min() > 0  # no flat frame


def test_second_view_is_a_shifted_crop():
    t = small("rgb-pairs-b8")
    t["noise"] = 0.0
    v1, v2 = path_of(t).make_pool(t, 4, "cpu")
    s = t["max_shift"]
    for i in range(t["pool"]):
        for j in range(t["pairs"]):
            n = t["size"]
            found = any(np.array_equal(v1[i, j, dy:, dx:], v2[i, j, :n - dy, :n - dx])
                        for dy in range(s + 1) for dx in range(s + 1))
            assert found
