"""Claim environment parsing: the pure-Python part of
``tpudra.workload.envspec`` (``ClaimEnv.from_environ`` and its pure
properties), kept as the port's own copy so that the port imports nothing of
the JAX package.

The process-level steps (joining a distributed group, attaching to the
multi-process sharing daemon, building a device mesh) come with the
collectives slice of the port.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional


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
