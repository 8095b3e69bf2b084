"""Gang-reserved ComputeDomain claim → one torch process per granted chip →
cross-process all-reduce: the PyTorch port's twin of
``python -m tpudra.sim.multihost``.

The reservation is ``tpudra.sim.multihost.MultiHostGang``'s, unchanged: N
real CD plugin drivers bind one channel claim each, through the gang
reservation state machine.  Only the launch differs.  Each member's grant
env (its CDI spec's env, mounts rewritten to host paths) starts one
``python -m tpudra_torch.sim.multihost --worker --device cpu`` process per
chip of the host's block, with ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``; the
ranks join one gloo group and all-reduce.  Host 0's processes reach global
rank 0's rendezvous store at ``127.0.0.1:<port>``; the other hosts' reach it
through the real ``CoordinatorProxy``, which forwards to the registration
rank 0 writes into the domain dir.  ``--device cpu`` is the one sim shim
beside ``TPUDRA_SIM_COORDINATOR``: the gang runs on the CPU, as the JAX
harness runs ``JAX_PLATFORMS=cpu``.

    python3 tools/torch_multihost.py --hosts 4 [--kill-rank K] [--deadline-s S]

prints the run's summary as JSON and exits 0 when it holds: every rank
printed its RESULT line and release left no bound claim and no CDI spec;
with ``--kill-rank K`` (every process of host K killed mid-gang), the launch
failed and release still left none.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tpudra import trace  # noqa: E402
from tpudra.sim import multihost  # noqa: E402

WORKER = [sys.executable, "-m", "tpudra_torch.sim.multihost", "--worker", "--device", "cpu"]


@dataclass
class TorchRankResult(multihost.RankResult):
    host: int = 0
    local_rank: int = 0


class TorchMultiHostGang(multihost.MultiHostGang):
    """``MultiHostGang`` whose launch starts the port's rank worker, one
    process per granted chip."""

    def launch(
        self,
        kill_rank: Optional[int] = None,
        deadline_s: Optional[float] = None,
    ) -> list[TorchRankResult]:
        """One process per chip of every member's host block; returns the
        processes' results in global rank order.  ``kill_rank`` SIGKILLs
        every process of that host shortly after spawn; the survivors, left
        waiting for the world to form, are killed at the deadline."""
        if self.grant is None:
            raise RuntimeError("reserve() before launch()")
        from tpudra.cddaemon.coordproxy import CoordinatorProxy

        deadline_s = deadline_s or self.config.launch_deadline_s
        host0 = self._members[0]
        domain_dir = self.drivers[host0.node].cd_manager.domain_dir(self.domain_uid)
        coord_port = multihost._free_port()
        self._proxy = CoordinatorProxy(port=0, registration_dir=domain_dir, host="127.0.0.1")
        self._proxy.start()

        self._procs = []
        ranks: list[tuple[int, int, str]] = []  # (host, local rank, log path)
        for host, member in enumerate(self._members):
            grant = self._grant_env(member.node, member.claim_uid)
            block = math.prod(int(v) for v in grant.get("TPU_CHIPS_PER_HOST_BOUNDS", "1").split(","))
            sim_coord = (f"127.0.0.1:{coord_port}" if host == 0
                         else f"127.0.0.1:{self._proxy.bound_port}")
            for local_rank in range(block):
                env = {
                    # The grant is the contract; the process env starts from it.
                    **grant,
                    "TPUDRA_SIM_COORDINATOR": sim_coord,
                    "LOCAL_RANK": str(local_rank),
                    "LOCAL_WORLD_SIZE": str(block),
                    # Process plumbing.
                    "OMP_NUM_THREADS": "1",
                    "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
                    **{k: os.environ[k] for k in ("PATH", "HOME") if k in os.environ},
                    **self.config.extra_env,
                }
                if trace.enabled():
                    # Every rank appends its span to the same log, parented
                    # on the grant env's TPUDRA_TRACEPARENT.
                    env.setdefault(trace.ENV_TRACE, "1")
                    env.setdefault(trace.ENV_TRACE_LOG, os.path.abspath(trace.log_path()))
                log_path = os.path.join(self._tmp.name, f"rank-{host}-{local_rank}.log")
                ranks.append((host, local_rank, log_path))
                with open(log_path, "w") as out:
                    self._procs.append(subprocess.Popen(
                        WORKER, env=env, stdout=out, stderr=subprocess.STDOUT, text=True))
        if kill_rank is not None:
            # The victims die while the gang is forming.
            time.sleep(0.3)
            for (host, _, _), proc in zip(ranks, self._procs):
                if host == kill_rank:
                    proc.send_signal(signal.SIGKILL)

        # One deadline for the whole gang: once it passes, every survivor is
        # killed at once.
        deadline = time.monotonic() + deadline_s
        for proc in self._procs:
            try:
                proc.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
        for proc in self._procs:
            if proc.poll() is None:
                proc.kill()
        results = []
        for rank, ((host, local_rank, log_path), proc) in enumerate(zip(ranks, self._procs)):
            proc.wait(timeout=10)
            with open(log_path) as f:
                output = f.read()
            results.append(TorchRankResult(rank=rank, returncode=proc.returncode, output=output,
                                           host=host, local_rank=local_rank))
        self._procs = []
        self._proxy.stop()
        self._proxy = None
        return results


def run_e2e(num_hosts: int, kill_rank: Optional[int] = None, deadline_s: float = 120.0) -> dict:
    """Reserve, launch, release: ``multihost.run_e2e``'s summary, with one
    ``ranks`` entry per process."""
    cfg = multihost.MultiHostConfig(num_hosts=num_hosts, launch_deadline_s=deadline_s)
    out: dict = {"num_hosts": num_hosts, "kill_rank": kill_rank}
    with TorchMultiHostGang(cfg) as gang:
        t0 = time.perf_counter()
        gang.reserve()
        out["gang_bind_ms"] = round((time.perf_counter() - t0) * 1000.0, 2)
        out["bound_claims"] = gang.bound_claim_count()
        t0 = time.perf_counter()
        results = gang.launch(kill_rank=kill_rank)
        out["launch_s"] = round(time.perf_counter() - t0, 3)
        out["ranks"] = [
            {"rank": r.rank, "host": r.host, "local_rank": r.local_rank, "rc": r.returncode,
             "tail": r.output[-400:]}
            for r in results
        ]
        out["launch_ok"] = all(r.ok for r in results)
        gang.release()
        out["bound_claims_after_release"] = gang.bound_claim_count()
        out["cdi_leaks_after_release"] = gang.cdi_leak_count()
    released = out["bound_claims_after_release"] == 0 and out["cdi_leaks_after_release"] == 0
    if kill_rank is None:
        out["ok"] = out["launch_ok"] and out["bound_claims"] == num_hosts and released
    else:
        out["ok"] = not out["launch_ok"] and released
    return out


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="Multi-host gang harness for the PyTorch port: ComputeDomain claim → "
        "gang reservation → one torch process per granted chip → gloo all-reduce.")
    parser.add_argument("--hosts", type=int, default=4)
    parser.add_argument("--kill-rank", type=int, default=None,
                        help="kill every process of this host mid-gang and check the rollback")
    parser.add_argument("--deadline-s", type=float, default=120.0)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    out = run_e2e(args.hosts, kill_rank=args.kill_rank, deadline_s=args.deadline_s)
    print(json.dumps(out, indent=2))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
