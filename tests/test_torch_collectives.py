"""The port's collectives (tpudra_torch.workload.collectives) on a world of
4 gloo processes: the twins of tests/test_workload.py::TestCollectives.

The world runs once per module (torch_gloo.run_world, killed past its
timeout); each test asserts on what its ranks returned."""

import math

import pytest

from tpudra.workload import collectives as jc
from tpudra_torch.workload import collectives as tc

import torch_gloo

WORLD = 4
OPS = ["psum", "all_gather", "ppermute_ring", "reduce_scatter", "all_to_all"]


@pytest.fixture(scope="module")
def ranks():
    return torch_gloo.values(torch_gloo.run_world("collectives", WORLD))


def test_all_benches_is_the_reference_set():
    assert list(tc.ALL_BENCHES) == list(jc.ALL_BENCHES) == OPS


@pytest.mark.parametrize("dim", ["flat", "inner dim of a 2-D mesh"])
def test_verify_collectives_covers_every_bench(ranks, dim):
    key = "verified" if dim == "flat" else "verified_inner"
    for r in ranks:
        assert r[key] == OPS


@pytest.mark.parametrize("op", OPS)
def test_bench_times_are_finite_and_positive(ranks, op):
    for r in ranks:
        (res,) = [x for x in r["results"] if x["op"] == op]
        assert res["n_devices"] == WORLD
        for key in ("seconds_per_op", "algo_gbps", "bus_gbps"):
            assert math.isfinite(res[key]) and res[key] > 0, (key, res)


def test_gloo_publishes_no_bandwidth(ranks):
    for r in ranks:
        assert r["lines"] == []


@pytest.mark.parametrize("op", OPS)
def test_result_line_matches_the_reference(op):
    fields = dict(op=op, payload_bytes=1 << 20, n_devices=4, seconds_per_op=1.25e-3,
                  algo_gbps=838.8608, bus_gbps=1258.2912)
    assert tc.BenchResult(**fields).line() == jc.BenchResult(**fields).line()
    assert tc.BenchResult(**fields).line() == f"RESULT bandwidth: 1258.29 GB/s op={op} n=4"
