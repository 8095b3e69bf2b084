"""Collective bandwidth benchmarks and their correctness checks on
``torch.distributed``: the counterpart of ``tpudra/workload/collectives.py``.

The five collectives a granted slice is checked with, each over one named
dim of a ``DeviceMesh``:

- psum:           all-reduce (``all_reduce``), scaled by 1/n
- all_gather:     payload replication (``all_gather_into_tensor``)
- ppermute_ring:  every rank sends its block to the next (``batch_isend_irecv``)
- reduce_scatter: the all-reduce half that ends sharded (``reduce_scatter_tensor``)
- all_to_all:     full shuffle, the MoE dispatch pattern (``all_to_all_single``)

Bus bandwidth follows nccl-tests: all-reduce moves ``2*(n-1)/n * bytes``
per rank, all-gather, reduce-scatter and all-to-all ``(n-1)/n * bytes``, the
ring shift ``bytes``.  A bandwidth is published only from NCCL over two or
more GPUs (``bandwidth_lines``); on gloo, or on one rank, the benches run
and verify but publish nothing.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from tpudra_torch.workload.device import resolve_device
from tpudra_torch.workload.parallel import (
    all_gather_into,
    reduce_scatter_into,
    ring_shift,
    size_and_rank,
)


@dataclass
class BenchResult:
    op: str
    payload_bytes: int
    n_devices: int
    seconds_per_op: float
    algo_gbps: float  # payload / time
    bus_gbps: float  # nccl-tests bus-bandwidth convention

    def line(self) -> str:
        # The e2e suite greps this (the RESULT-bandwidth assertion analog).
        return f"RESULT bandwidth: {self.bus_gbps:.2f} GB/s op={self.op} n={self.n_devices}"


def _device(mesh) -> torch.device:
    dev = resolve_device(mesh.device_type)
    if dev.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# The ops, on this rank's block x [elems]; psum works in place.
def _psum(x, group):
    dist.all_reduce(x, group=group)
    return x.mul_(1.0 / size_and_rank(group)[0])


def _all_gather(x, group):
    out = torch.empty(size_and_rank(group)[0] * x.numel(), dtype=x.dtype, device=x.device)
    all_gather_into(out, x, group)
    return out


def _ppermute_ring(x, group):
    if size_and_rank(group)[0] == 1:  # the ring of one rank: the identity, as ppermute's
        return x.clone()
    return ring_shift(x, group, 1)


def _reduce_scatter(x, group):
    out = torch.empty(x.numel() // size_and_rank(group)[0], dtype=x.dtype, device=x.device)
    reduce_scatter_into(out, x, group)
    return out


def _all_to_all(x, group):
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _operand(group, device, elems: int) -> torch.Tensor:
    """Rank r's row of arange(n * elems) in bf16."""
    _, r = size_and_rank(group)
    return torch.arange(r * elems, (r + 1) * elems, device=device).to(torch.bfloat16)


def _bench(op: str, fn, mesh, axis: str, elems: int, iters: int, payload_per_elem: int,
           bus_factor) -> BenchResult:
    group = mesh.get_group(axis)
    n, _ = size_and_rank(group)
    device = _device(mesh)
    x = _operand(group, device, elems)
    for _ in range(2):
        fn(x, group)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(x, group)
    _sync(device)
    dt = (time.perf_counter() - t0) / iters
    payload = elems * payload_per_elem
    return BenchResult(op=op, payload_bytes=payload, n_devices=n, seconds_per_op=dt,
                       algo_gbps=payload / dt / 1e9, bus_gbps=bus_factor(n) * payload / dt / 1e9)


def _divisible_elems(n: int, mib_per_device: int) -> int:
    return max(n, mib_per_device * 2**20 // 2 // n * n)


def bench_psum(mesh, axis: str = "data", mib_per_device: int = 64, iters: int = 10) -> BenchResult:
    return _bench("psum", _psum, mesh, axis, mib_per_device * 2**20 // 2, iters, 2,
                  lambda n: 2 * (n - 1) / n)


def _axis_size(mesh, axis: str) -> int:
    return size_and_rank(mesh.get_group(axis))[0]


def bench_all_gather(mesh, axis: str = "data", mib_per_device: int = 64, iters: int = 10) -> BenchResult:
    # Each rank materializes the whole array: n blocks.
    n = _axis_size(mesh, axis)
    return _bench("all_gather", _all_gather, mesh, axis, mib_per_device * 2**20 // 2, iters,
                  2 * n, lambda n: (n - 1) / n)


def bench_ppermute_ring(mesh, axis: str = "data", mib_per_device: int = 64, iters: int = 10) -> BenchResult:
    """Every rank sends its whole block to the next rank of the ring: the
    closest analog of a raw point-to-point link measurement."""
    return _bench("ppermute_ring", _ppermute_ring, mesh, axis, mib_per_device * 2**20 // 2,
                  iters, 2, lambda n: 1.0)


def bench_reduce_scatter(mesh, axis: str = "data", mib_per_device: int = 64, iters: int = 10) -> BenchResult:
    """Each rank ends with its 1/n shard of the sum (the gradient and
    optimizer sharding primitive); payload is the input bytes per rank."""
    n = _axis_size(mesh, axis)
    return _bench("reduce_scatter", _reduce_scatter, mesh, axis,
                  _divisible_elems(n, mib_per_device), iters, 2, lambda n: (n - 1) / n)


def bench_all_to_all(mesh, axis: str = "data", mib_per_device: int = 64, iters: int = 10) -> BenchResult:
    """Every rank sends a distinct 1/n chunk to every rank: the MoE
    dispatch and combine wire pattern."""
    n = _axis_size(mesh, axis)
    return _bench("all_to_all", _all_to_all, mesh, axis, _divisible_elems(n, mib_per_device),
                  iters, 2, lambda n: (n - 1) / n)


ALL_BENCHES = {
    "psum": bench_psum,
    "all_gather": bench_all_gather,
    "ppermute_ring": bench_ppermute_ring,
    "reduce_scatter": bench_reduce_scatter,
    "all_to_all": bench_all_to_all,
}


def verify_collectives(mesh, axis: str = "data") -> list[str]:
    """Numerical parity of every collective ALL_BENCHES measures, against a
    numpy reference on small exact-integer f32 operands, on this rank's
    part.  Returns the verified op names in ALL_BENCHES order."""
    group = mesh.get_group(axis)
    n, r = size_and_rank(group)
    device = _device(mesh)
    k = 4
    elems = n * k
    x = np.arange(n * elems, dtype=np.float32).reshape(n, elems)

    def run(fn):
        out = fn(torch.from_numpy(x[r].copy()).to(device), group)
        return out.cpu().numpy()

    verified: list[str] = []
    np.testing.assert_allclose(run(_psum), x.mean(0), rtol=1e-6)
    verified.append("psum")
    np.testing.assert_array_equal(run(_all_gather).reshape(n, elems), x)
    verified.append("all_gather")
    np.testing.assert_array_equal(run(_ppermute_ring), x[(r - 1) % n])
    verified.append("ppermute_ring")
    np.testing.assert_allclose(run(_reduce_scatter), x.sum(0).reshape(n, elems // n)[r], rtol=1e-6)
    verified.append("reduce_scatter")
    # Rank r receives chunk r of every rank j, in rank order.
    np.testing.assert_array_equal(run(_all_to_all).reshape(n, k), x.reshape(n, n, k)[:, r])
    verified.append("all_to_all")

    assert list(ALL_BENCHES) == verified, (list(ALL_BENCHES), verified)
    return verified


def run_all(mesh, axis: str = "data", mib_per_device: int = 8, iters: int = 5) -> list[BenchResult]:
    return [fn(mesh, axis=axis, mib_per_device=mib_per_device, iters=iters)
            for fn in ALL_BENCHES.values()]


def bandwidth_lines(results: list[BenchResult], mesh, axis: str = "data") -> list[str]:
    """The ``RESULT bandwidth:`` lines to publish: only from NCCL over two or
    more GPUs, never from gloo or one rank (whose times measure host copies)."""
    group = mesh.get_group(axis)
    if dist.get_backend(group) != "nccl" or size_and_rank(group)[0] < 2:
        return []
    return [r.line() for r in results]
