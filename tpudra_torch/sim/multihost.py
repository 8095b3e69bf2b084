"""One rank of a gang-reserved ComputeDomain claim: the counterpart of
``tpudra.sim.multihost``'s worker (``_worker_main``, ``_worker_body``).

A claim for an N-host slice grants each host an env (the CD plugin's CDI
spec): the host's index, the host count, the slice's mesh shape and this
host's block in it, the worker-bootstrap keys and the rendezvous address.
From that env alone, one process per granted chip joins the slice-wide
process group (``ClaimEnv.initialize_distributed``: rank
``host_index·local_world + local_rank``), checks that the group is the
granted slice, all-reduces one block per rank over a ("dp",) mesh of the
whole world, checks the sum and prints

    RESULT gang-psum: <sum> host <h> devices <world> mesh <x,y,z>

as the JAX worker does.  Each rank's work is a ``rank.worker`` span parented
on the grant's traceparent, so a traced gang yields one trace from the
controller's reservation down to every rank.

Run as ``python -m tpudra_torch.sim.multihost --worker [--device cpu]``,
with ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` set by the launcher.  It runs
on CUDA (NCCL) unless ``--device cpu`` asks for the CPU (gloo).
``TPUDRA_SIM_COORDINATOR`` overrides the grant's coordinator address where
the daemon's stable DNS name does not resolve (every simulated host on one
machine); the relay through the daemon's proxy stays real.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
from typing import Optional

from tpudra_torch import trace
from tpudra_torch.workload.device import resolve_device
from tpudra_torch.workload.envspec import ClaimEnv, mesh_from_devices

ENV_SIM_COORDINATOR = "TPUDRA_SIM_COORDINATOR"
# Columns of each rank's block, as in the JAX worker.
COLS = 8


def chips_per_host(env: ClaimEnv) -> int:
    """The chips in one host's block of the slice (TPU_CHIPS_PER_HOST_BOUNDS)."""
    return math.prod(int(v) for v in env.chips_per_host_bounds.split(","))


def check_grant(env: ClaimEnv) -> None:
    """The worker-bootstrap contract of a multi-host grant, complete before
    the first device call.  Raises RuntimeError naming the field at fault."""
    if env.num_hosts <= 1:
        raise RuntimeError(f"TPUDRA_NUM_HOSTS={env.num_hosts}: not a multi-host grant")
    if env.worker_id != env.host_index:
        raise RuntimeError(
            f"TPU_WORKER_ID={env.worker_id} is not TPUDRA_HOST_INDEX={env.host_index}")
    if len(env.worker_hostnames) != env.num_hosts:
        raise RuntimeError(
            f"TPU_WORKER_HOSTNAMES names {len(env.worker_hostnames)} hosts of {env.num_hosts}")
    if not env.skip_mds_query:
        raise RuntimeError("the grant did not set TPU_SKIP_MDS_QUERY")
    if not env.host_bounds:
        raise RuntimeError("the grant carried no TPU_HOST_BOUNDS")
    if not env.chips_per_host_bounds:
        raise RuntimeError("the grant carried no TPU_CHIPS_PER_HOST_BOUNDS")
    if not env.mesh_shape:
        raise RuntimeError("the grant carried no TPUDRA_MESH_SHAPE")
    if not env.host_coords:
        raise RuntimeError("the grant carried no TPUDRA_HOST_COORDS")
    if not all(c < m for c, m in zip(env.host_coords, env.mesh_shape)):
        raise RuntimeError(
            f"TPUDRA_HOST_COORDS={env.host_coords} lies outside TPUDRA_MESH_SHAPE={env.mesh_shape}")
    if not env.coordinator:
        raise RuntimeError("the grant injected no TPUDRA_COORDINATOR")


def _worker_main(device=None) -> int:
    """One rank of the gang, driven by the grant env alone."""
    env = ClaimEnv.from_environ()
    check_grant(env)
    env.apply_cuda_env()  # before the first CUDA call
    env.coordinator = os.environ.get(ENV_SIM_COORDINATOR) or env.coordinator
    return run_rank(env, device)


def run_rank(env: ClaimEnv, device=None) -> int:
    """``_worker_body`` inside the ``rank.worker`` span, parented on the
    grant's traceparent: the claim's env alone ties this process to the
    member bind that granted it."""
    attrs = {"host": env.host_index, "num_hosts": env.num_hosts,
             "local_rank": int(os.environ.get("LOCAL_RANK", "0") or "0")}
    with trace.start_span("rank.worker", parent=env.traceparent or None, attrs=attrs):
        return _worker_body(env, device)


def _worker_body(env: ClaimEnv, device=None) -> int:
    """Join the slice's group (a one-rank group when the grant has one
    process), check it is the granted slice, all-reduce, check the sum and
    print the RESULT line.  Works for any world, one rank included."""
    dev = resolve_device(device)
    env.initialize_distributed(dev)
    import torch
    import torch.distributed as dist

    mesh = mesh_from_devices(("dp",), device=dev)
    try:
        world = dist.get_world_size()
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1") or "1")
        block = chips_per_host(env)
        # The runtime sees exactly the granted slice: every chip of the mesh,
        # this host fielding exactly its chip block, one process each.
        if world != env.slice_device_count:
            raise RuntimeError(f"a world of {world} for a slice of {env.slice_device_count} chips")
        if local_world != block:
            raise RuntimeError(f"LOCAL_WORLD_SIZE={local_world} for a host block of {block} chips")
        if dev.type == "cuda" and torch.cuda.device_count() != block:
            raise RuntimeError(
                f"{torch.cuda.device_count()} CUDA devices visible for a host block of {block}")
        x = torch.full((1, COLS), float(env.host_index + 1), device=dev)
        dist.all_reduce(x, group=mesh.get_group("dp"))
        val = float(x.sum())
        expect = COLS * block * sum(h + 1 for h in range(env.num_hosts))
        if val != expect:
            raise RuntimeError(f"gang psum {val}, expected {expect}")
        print(f"RESULT gang-psum: {val} host {env.host_index} devices {world} "
              f"mesh {','.join(map(str, env.mesh_shape))}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="One rank of a gang-reserved ComputeDomain claim: join the slice's "
        "process group from the grant env and all-reduce across it.")
    parser.add_argument("--worker", action="store_true", required=True,
                        help="run as one rank of the gang (the launcher's command)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default=None,
                        help="cpu: gloo on the CPU; default: NCCL on the granted GPUs")
    args = parser.parse_args(argv)
    return _worker_main(args.device)


if __name__ == "__main__":
    sys.exit(main())
