"""Claim environment → process group → device mesh: the counterpart of
``tpudra.workload.envspec``, kept as the port's own copy so that the port
imports nothing of the JAX package.

Parses the env the TPU plugin's CDI spec and the ComputeDomain daemon config
inject (``ClaimEnv.from_environ``), exports the grant's devices to CUDA
(``apply_cuda_env``, the twin of ``apply_libtpu_env``), joins the
slice-wide process group (``initialize_distributed``: one process per GPU,
NCCL on CUDA, gloo only when the caller asks for the CPU), attaches to the
multi-process sharing daemon (``attach_multiprocess``), and builds the
named device mesh a workload runs under (``mesh_from_devices``).  With no
process group up, ``mesh_from_devices`` starts a one-rank group, so a
single-card program gets the same mesh API, as a one-device JAX mesh needs
no ``jax.distributed``.
"""

from __future__ import annotations

import json
import logging
import math
import os
import socket
import threading
import time
import uuid
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

from tpudra_torch.workload.device import resolve_device

logger = logging.getLogger(__name__)

# The compute-domain daemons' stable DNS names (tpudra/cddaemon/dnsnames.py).
DNS_NAME_FORMAT = "compute-domain-daemon-%04d"
# Where global rank 0 publishes its store's ip:port for the daemon's
# coordinator proxy (tpudra/cddaemon/coordproxy.py).
REGISTRATION_FILE = "coordinator"
# The multi-process control daemon's socket in its pipe dir (tpudra/mpdaemon.py).
CONTROL_SOCK = "control.sock"


@dataclass
class ClaimEnv:
    """Everything the driver told this container about its grant."""

    visible_devices: list[int] = field(default_factory=list)
    coords: list[tuple[int, int, int]] = field(default_factory=list)
    clique_id: str = ""
    generation: str = ""
    # "name=profile@core_start,hbm_start" per granted partition.
    partitions: dict[str, str] = field(default_factory=dict)
    # ComputeDomain slice env (set by the CD daemon config, not per-chip).
    domain_uid: str = ""
    channel_ids: list[int] = field(default_factory=list)
    num_hosts: int = 1
    host_index: int = 0
    coordinator: str = ""  # host:port of the distributed rendezvous
    # Per-domain shared dir (host path mounted into both the workload and
    # the daemon pods).
    cd_dir: str = ""
    # Multi-process sharing: the per-claim control daemon's pipe directory.
    mp_pipe_dir: str = ""
    # Trace context of the bind that granted this claim.  "" = untraced.
    traceparent: str = ""
    # Slice geometry from the grant: the full mesh of the slice and this
    # host's block origin within it.  () = not granted.
    mesh_shape: tuple = ()
    host_coords: tuple = ()
    # The worker-bootstrap contract of a multi-host slice.
    worker_id: int = -1  # -1 = not granted (single-host / no CD)
    worker_hostnames: list[str] = field(default_factory=list)
    skip_mds_query: bool = False
    host_bounds: str = ""  # "x,y,z" host grid of the slice
    chips_per_host_bounds: str = ""  # "x,y,z" chip block per host

    @classmethod
    def from_environ(cls, env: Optional[dict] = None) -> "ClaimEnv":
        env = dict(os.environ if env is None else env)
        out = cls()
        vis = env.get("TPU_VISIBLE_DEVICES", "")
        if vis:
            out.visible_devices = [int(x) for x in vis.split(",") if x != ""]
        for xyz in env.get("TPUDRA_CHIP_COORDS", "").split(";"):
            if xyz:
                x, y, z = (int(v) for v in xyz.split(","))
                out.coords.append((x, y, z))
        out.clique_id = env.get("TPUDRA_CLIQUE_ID", "")
        out.generation = env.get("TPUDRA_GENERATION", "")
        for desc in env.get("TPUDRA_PARTITIONS", "").split(";"):
            if desc and "=" in desc:
                name, spec = desc.split("=", 1)
                out.partitions[name] = spec
        out.domain_uid = env.get("TPUDRA_DOMAIN_UID", "")
        chans = env.get("TPUDRA_DOMAIN_CHANNELS", "")
        if chans:
            out.channel_ids = [int(x) for x in chans.split(",") if x != ""]
        out.num_hosts = int(env.get("TPUDRA_NUM_HOSTS", "1") or "1")
        out.host_index = int(env.get("TPUDRA_HOST_INDEX", "0") or "0")
        out.coordinator = env.get("TPUDRA_COORDINATOR", "")
        out.cd_dir = env.get("TPUDRA_CD_DIR", "")
        for attr, key in (
            ("mesh_shape", "TPUDRA_MESH_SHAPE"),
            ("host_coords", "TPUDRA_HOST_COORDS"),
        ):
            raw = env.get(key, "")
            if raw:
                try:
                    setattr(out, attr, tuple(int(v) for v in raw.split(",")))
                except ValueError:
                    pass  # garbled → "not granted", like worker_id below
        out.mp_pipe_dir = env.get("TPUDRA_MP_PIPE_DIRECTORY", "")
        out.traceparent = env.get("TPUDRA_TRACEPARENT", "")
        try:
            out.worker_id = int(env.get("TPU_WORKER_ID", ""))
        except ValueError:
            out.worker_id = -1  # absent or garbled → "not granted"
        hostnames = env.get("TPU_WORKER_HOSTNAMES", "")
        out.worker_hostnames = [h for h in hostnames.split(",") if h]
        out.skip_mds_query = env.get("TPU_SKIP_MDS_QUERY", "").lower() in (
            "true", "1",
        )
        out.host_bounds = env.get("TPU_HOST_BOUNDS", "")
        out.chips_per_host_bounds = env.get("TPU_CHIPS_PER_HOST_BOUNDS", "")
        return out

    @property
    def mesh_bounds(self) -> tuple[int, int, int]:
        """Bounding box of the granted chips in their coordinates — the
        natural physical mesh shape when the grant is a contiguous block."""
        if not self.coords:
            return (0, 0, 0)
        xs, ys, zs = zip(*self.coords)
        return (
            max(xs) - min(xs) + 1,
            max(ys) - min(ys) + 1,
            max(zs) - min(zs) + 1,
        )

    def libtpu_env(self) -> dict[str, str]:
        """The worker-bootstrap env of a multi-host grant.  Empty for grants
        that never carried it (single-host chip claims)."""
        out: dict[str, str] = {}
        if self.worker_id >= 0:
            out["TPU_WORKER_ID"] = str(self.worker_id)
        if self.worker_hostnames:
            out["TPU_WORKER_HOSTNAMES"] = ",".join(self.worker_hostnames)
        if self.skip_mds_query:
            out["TPU_SKIP_MDS_QUERY"] = "true"
        if self.host_bounds:
            out["TPU_HOST_BOUNDS"] = self.host_bounds
        if self.chips_per_host_bounds:
            out["TPU_CHIPS_PER_HOST_BOUNDS"] = self.chips_per_host_bounds
        return out

    def cuda_env(self) -> dict[str, str]:
        """The grant's devices as ``CUDA_VISIBLE_DEVICES``; empty for a
        grant that names none."""
        if not self.visible_devices:
            return {}
        return {"CUDA_VISIBLE_DEVICES": ",".join(str(d) for d in self.visible_devices)}

    def apply_cuda_env(self) -> dict[str, str]:
        """Export ``cuda_env`` into ``os.environ`` and return it.

        Call before the first CUDA call of the process, ``torch.cuda.
        is_available()`` included: the CUDA driver reads the variable once,
        when it starts.  Raises RuntimeError if CUDA is already initialised
        and the export would change the variable (the change would be
        silently ignored).  A value the runtime already injected is a no-op
        re-export."""
        import torch

        env = self.cuda_env()
        changes = {k: v for k, v in env.items() if os.environ.get(k) != v}
        if changes and torch.cuda.is_initialized():
            raise RuntimeError(
                f"CUDA is already initialised in this process, so exporting {changes} "
                "would change nothing; call apply_cuda_env before the first CUDA call"
            )
        os.environ.update(env)
        return env

    def initialize_distributed(self, device=None) -> None:
        """Join the slice-wide process group of a ComputeDomain grant.

        One process per GPU: ``rank = host_index * local_world + local_rank``
        with ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` from the launcher's env
        (default 0 and 1), world ``num_hosts * local_world``.  NCCL when
        ``device`` is CUDA (the default), gloo only when the caller asks for
        the CPU.  A grant with no coordinator or a world of one joins
        nothing.

        TPUDRA_COORDINATOR names the index-0 daemon (a stable DNS name), but
        the rendezvous store is bound by global rank 0 inside its own pod.
        So rank 0 binds on its routable IP, publishes ``ip:port`` into the
        shared per-domain dir (TPUDRA_CD_DIR), and the daemon's proxy
        forwards peers dialing the stable name to it."""
        local_rank = int(os.environ.get("LOCAL_RANK", "0") or "0")
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1") or "1")
        world = self.num_hosts * local_world
        if world <= 1 or not self.coordinator:
            return
        dev = resolve_device(device)
        rank = self.host_index * local_world + local_rank
        address = self.coordinator
        _, _, port = self.coordinator.rpartition(":")
        if rank == 0 and port.isdigit():
            # A portless coordinator passes through verbatim (the store
            # reports the malformed address); only a well-formed grant takes
            # the local-bind and registration path.
            ip = _local_ip()
            if not ip:
                raise RuntimeError(
                    "rank 0 has no routable IPv4 address to bind the "
                    "rendezvous store on — cannot register a loopback address "
                    "(the daemon proxy would forward to itself); IPv6-only "
                    "pod networks need hostNetwork or an explicit "
                    "coordinator service"
                )
            address = f"{ip}:{port}"
            if self.cd_dir:
                try:
                    write_registration(self.cd_dir, ip, int(port))
                except OSError as e:
                    # A silent skip here strands every peer in a connect timeout.
                    raise RuntimeError(
                        "rank 0 could not register its rendezvous store in "
                        f"{self.cd_dir}: {e} — peers dialing "
                        f"{self.coordinator} will hang; check the domain "
                        "dir mount and its permissions"
                    ) from e
            elif _is_daemon_dns_name(self.coordinator):
                # Peers will dial the daemon's proxy, which forwards to a
                # registration this process has nowhere to write: every peer
                # would hang.  A direct-address coordinator needs none.
                raise RuntimeError(
                    "rank 0 has a daemon-proxied coordinator grant "
                    f"({self.coordinator}) but no TPUDRA_CD_DIR to "
                    "register its endpoint in — peers dialing the proxy "
                    "would hang; this grant predates the domain-dir mount "
                    "(re-prepare the claim with a current driver) or the "
                    "env was stripped"
                )
        import torch
        import torch.distributed as dist

        if dev.type == "cuda":
            torch.cuda.set_device(local_rank)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://{address}", rank=rank, world_size=world,
        )

    @contextmanager
    def attach_multiprocess(self):
        """Register with the claim's multi-process control daemon and yield
        the granted limits (chip UUIDs, active-core percentage, pinned
        memory budgets); DETACH on exit.  Yields None when the grant carries
        no multi-process sharing."""
        if not self.mp_pipe_dir:
            yield None
            return
        # Unique per client: consumer containers of one claim live in
        # separate PID namespaces, so a bare pid would collide.
        me = f"{socket.gethostname()}-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        resp = query(self.mp_pipe_dir, f"ATTACH {me}")
        if not resp.startswith("OK "):
            raise RuntimeError(f"mp control daemon refused attach: {resp}")
        try:
            yield json.loads(resp[3:])
        finally:
            try:
                query(self.mp_pipe_dir, f"DETACH {me}")
            except OSError:
                pass  # daemon went away; nothing to release

    @property
    def slice_device_count(self) -> int:
        """Devices in the granted slice, from the mesh-shape grant env.  0
        when the grant carried no slice env."""
        if not self.mesh_shape:
            return 0
        n = 1
        for v in self.mesh_shape:
            n *= v
        return n


def query(pipe_dir: str, line: str, timeout: float = 2.0) -> str:
    """One request line to the multi-process control daemon, its reply line."""
    with socket.socket(socket.AF_UNIX) as s:
        s.settimeout(timeout)
        s.connect(os.path.join(pipe_dir, CONTROL_SOCK))
        s.sendall((line + "\n").encode())
        return s.makefile().readline().strip()


def write_registration(
    dir_path: str,
    host: str,
    port: int,
    replace_wait_s: float = 180.0,
    poll_s: float = 2.0,
) -> str:
    """Atomically publish the live rendezvous endpoint (workload side).

    The temp name is unique per writer: the domain dir is sticky-bit
    shared, so a crashed previous workload's leftover ``.tmp`` owned by
    another uid must not block this one's open.  The sticky bit also means a
    replacement rank 0 under a different uid cannot replace the dead
    previous owner's registration (EPERM) until the daemon's proxy
    probe-and-drops it, so this waits that window out instead of failing."""
    path = os.path.join(dir_path, REGISTRATION_FILE)
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        f.write(f"{host}:{port}\n")
    try:
        os.replace(tmp, path)
        return path
    except PermissionError as e:
        logger.warning(
            "cannot replace existing registration %s (%s) — a dead "
            "previous owner's file under the sticky bit; waiting up to "
            "%.0fs for the daemon proxy to probe-and-drop it",
            path, e, replace_wait_s,
        )
    deadline = time.monotonic() + replace_wait_s
    while True:
        time.sleep(poll_s)
        try:
            os.replace(tmp, path)
            logger.info("registered coordinator after stale-file drop: %s", path)
            return path
        except PermissionError as e:
            if time.monotonic() >= deadline:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise PermissionError(
                    f"registration {path} still owned by a previous workload "
                    f"after {replace_wait_s:.0f}s — the daemon proxy never "
                    "dropped it (is the daemon running and probing?)"
                ) from e


def _is_daemon_dns_name(coordinator: str) -> bool:
    """True when the coordinator names a compute-domain daemon's stable DNS
    name (the proxy-relayed rendezvous) rather than a directly reachable
    host."""
    prefix = DNS_NAME_FORMAT.split("%")[0]
    return coordinator.partition(":")[0].startswith(prefix)


def _local_ip() -> str:
    """This pod's routable IPv4: a connected UDP socket's local address (no
    packet is sent).  "" when no IPv4 route exists — callers must treat that
    as an error, not fall back to loopback, which would point the daemon's
    proxy at itself."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("10.255.255.255", 1))
        return s.getsockname()[0]
    except OSError:
        return ""
    finally:
        s.close()


def mesh_from_devices(
    axis_names: tuple[str, ...] = ("data",),
    axis_shape: Optional[tuple[int, ...]] = None,
    device=None,
    n_ranks: Optional[int] = None,
):
    """A ``DeviceMesh`` with named dims over the process group's first
    ``n_ranks`` ranks (default every rank; one GPU each), on ``device``'s
    type (default CUDA; the CPU only when asked).  Default: one flat dim;
    ``axis_shape`` factors the ranks into named dims (dp/sp/tp/...), the
    last one innermost.  Every rank of the world calls this; a rank past
    ``n_ranks`` gets no coordinate.  With no process group up, a one-rank
    group is started first (NCCL on CUDA, gloo on the CPU)."""
    dev = resolve_device(device)
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_ranks is None else n_ranks
    if axis_shape is None:
        axis_shape = (n,)
        if len(axis_names) != 1:
            raise ValueError("axis_shape required for multi-axis meshes")
    if math.prod(axis_shape) != n or n > world:
        raise ValueError(f"axis_shape {axis_shape} != {n} of {world} devices")
    if not dist.is_initialized():
        if dev.type == "cuda":
            # The device the mesh binds, chosen before it is built (else the
            # mesh guesses it from the rank and warns).
            torch.cuda.set_device(torch.cuda.current_device())
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1,
        )
    return DeviceMesh(dev.type, torch.arange(n).reshape(axis_shape),
                      mesh_dim_names=tuple(axis_names))


def factor_devices(n: int, axes: int = 3) -> tuple[int, ...]:
    """Factor a device count into a balanced shape, largest factor last
    (innermost).  8 → (2, 2, 2); 4 → (1, 2, 2); 1 → (1, 1, 1)."""
    shape = [1] * axes
    i = axes - 1
    remaining = n
    while remaining > 1:
        for f in (2, 3, 5, 7):
            if remaining % f == 0:
                shape[i] = shape[i] * f
                remaining //= f
                break
        else:
            shape[i] *= remaining
            remaining = 1
        i = (i - 1) if i > 0 else axes - 1
    shape.sort()
    return tuple(shape)
