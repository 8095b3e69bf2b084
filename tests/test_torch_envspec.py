"""The port's grant path (tpudra_torch.workload.envspec) against the JAX
package's: claim-env parsing, factor_devices, the refusals of
initialize_distributed, the coordinator registration file, a two-process
gloo rendezvous through the grant, and the multi-process daemon client.
And the port's isolation: it imports neither JAX nor the JAX package, and
its entry points do not run on the CPU unless asked."""

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpudra.workload.envspec import ClaimEnv as JaxClaimEnv
from tpudra.workload.envspec import factor_devices as jax_factor_devices
from tpudra_torch.workload import collectives, envspec
from tpudra_torch.workload import model as tm
from tpudra_torch.workload.convert import params_from_numpy
from tpudra_torch.workload.envspec import ClaimEnv, factor_devices, mesh_from_devices

import torch_gloo

REPO = Path(__file__).resolve().parents[1]

# The grant envs of tests/test_workload.py::TestClaimEnv, plus the slice
# geometry keys (well-formed and garbled).
ENVS = {
    "chip": {
        "TPU_VISIBLE_DEVICES": "0,2",
        "TPUDRA_CHIP_COORDS": "0,0,0;1,1,0",
        "TPUDRA_CLIQUE_ID": "slice-1.0",
        "TPUDRA_GENERATION": "v5p",
        "TPUDRA_PARTITIONS": "tpu-0-part-1c.4hbm-0-0=1c.4hbm@0,0",
    },
    "domain": {
        "TPUDRA_DOMAIN_UID": "uid-9",
        "TPUDRA_DOMAIN_CHANNELS": "0,5",
        "TPUDRA_NUM_HOSTS": "4",
        "TPUDRA_HOST_INDEX": "2",
        "TPUDRA_COORDINATOR": "compute-domain-daemon-0000:7175",
    },
    "empty": {},
    "libtpu_contract": {
        "TPU_WORKER_ID": "1",
        "TPU_WORKER_HOSTNAMES": "compute-domain-daemon-0000,compute-domain-daemon-0001",
        "TPU_SKIP_MDS_QUERY": "true",
        "TPU_HOST_BOUNDS": "1,1,2",
        "TPU_CHIPS_PER_HOST_BOUNDS": "2,2,1",
    },
    "worker_id_garbled_1": {"TPU_WORKER_ID": "--1"},
    "worker_id_garbled_2": {"TPU_WORKER_ID": "abc"},
    "worker_id_minus_one": {"TPU_WORKER_ID": "-1"},
    "host0_daemon_coordinator": {
        "TPUDRA_NUM_HOSTS": "2",
        "TPUDRA_HOST_INDEX": "0",
        "TPUDRA_COORDINATOR": "compute-domain-daemon-0000:7175",
    },
    "slice_geometry": {
        "TPUDRA_MESH_SHAPE": "2,2,4",
        "TPUDRA_HOST_COORDS": "0,2,0",
        "TPUDRA_MP_PIPE_DIRECTORY": "/run/mp",
        "TPUDRA_TRACEPARENT": "00-abc-def-01",
        "TPUDRA_CD_DIR": "/var/cd",
    },
    "slice_geometry_garbled": {"TPUDRA_MESH_SHAPE": "2,x", "TPUDRA_HOST_COORDS": ","},
}


@pytest.mark.parametrize("name", sorted(ENVS))
def test_from_environ_matches_jax_field_by_field(name):
    env = ENVS[name]
    got, want = ClaimEnv.from_environ(env), JaxClaimEnv.from_environ(env)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.mesh_bounds == want.mesh_bounds
    assert got.libtpu_env() == want.libtpu_env()
    assert got.slice_device_count == want.slice_device_count


def test_port_imports_neither_jax_nor_the_jax_package():
    """Imports every module of the port (found, not listed), then looks for
    JAX or the JAX package among the loaded modules."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import tpudra_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(tpudra_torch.__path__, 'tpudra_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tpudra')]\n"
        "print(json.dumps([sorted(names), sorted(bad)]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    names, bad = json.loads(out.stdout)
    sources = {"tpudra_torch." + ".".join(p.relative_to(REPO / "tpudra_torch").with_suffix("").parts)
               for p in (REPO / "tpudra_torch").rglob("*.py") if p.name != "__init__.py"}
    assert sources <= set(names), sorted(sources - set(names))
    assert bad == [], bad


def test_no_jax_or_tpudra_import_in_the_port_sources():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|tpudra)(\.|\s|$)", re.M)
    files = sorted((REPO / "tpudra_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert files[-1].exists()
    for f in files:
        hits = pattern.findall(f.read_text())
        assert not hits, (str(f), hits)


def test_entry_points_refuse_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device is valid")
    cfg = tm.ModelConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"w": np.zeros(3, np.float32)})
    # The mesh (and so the collectives and the sharded step, which run on
    # it) and the process group refuse before any group is created.
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_from_devices()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        collectives.verify_collectives(_FakeMesh("cuda"))
    grant = ClaimEnv.from_environ({"TPUDRA_NUM_HOSTS": "2", "TPUDRA_HOST_INDEX": "1",
                                   "TPUDRA_COORDINATOR": "127.0.0.1:1"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        grant.initialize_distributed()
    assert not dist.is_initialized()
    # Asked for explicitly, the CPU is taken.
    assert params_from_numpy({"w": np.zeros(3, np.float32)}, device="cpu")["w"].device.type == "cpu"


class _FakeMesh:
    """What the collectives read of a mesh before they touch a device."""

    def __init__(self, device_type):
        self.device_type = device_type

    def get_group(self, axis):
        return None


# -- the distributed half ------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16, 30])
def test_factor_devices_matches_jax(n):
    assert factor_devices(n) == jax_factor_devices(n)
    assert math.prod(factor_devices(n)) == n


def test_mesh_from_devices_one_rank_group_and_shape_check():
    """With no group up, a one-rank group (gloo, asked for the CPU) backs the
    mesh; a shape that is not the world raises before any group starts."""
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="devices"):
        mesh_from_devices(("a",), (3,), device="cpu")
    with pytest.raises(ValueError, match="axis_shape required"):
        mesh_from_devices(("a", "b"), device="cpu")
    assert not dist.is_initialized()
    try:
        mesh = mesh_from_devices(("dp", "sp", "tp"), (1, 1, 1), device="cpu")
        assert mesh.mesh_dim_names == ("dp", "sp", "tp") and mesh.shape == (1, 1, 1)
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert collectives.verify_collectives(mesh_from_devices(device="cpu"), "data") == list(
            collectives.ALL_BENCHES)
    finally:
        dist.destroy_process_group()


def test_apply_cuda_env_exports_the_grant(monkeypatch):
    if torch.cuda.is_initialized():
        pytest.skip("CUDA is initialised in this process")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "placeholder")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    env = ClaimEnv.from_environ({"TPU_VISIBLE_DEVICES": "0,2"})
    assert env.apply_cuda_env() == {"CUDA_VISIBLE_DEVICES": "0,2"}
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "0,2"
    assert ClaimEnv.from_environ({}).apply_cuda_env() == {}


@pytest.mark.cuda
def test_apply_cuda_env_refuses_after_cuda_init(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA cannot be initialised here")
    torch.zeros(1, device="cuda")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", os.environ.get("CUDA_VISIBLE_DEVICES", "0"))
    with pytest.raises(RuntimeError, match="already initialised"):
        ClaimEnv.from_environ({"TPU_VISIBLE_DEVICES": "0,1,2,3,4,5,6,7,8"}).apply_cuda_env()


HOST0_DAEMON = {"TPUDRA_NUM_HOSTS": "2", "TPUDRA_HOST_INDEX": "0",
                "TPUDRA_COORDINATOR": "compute-domain-daemon-0000:7175"}


def test_rank0_daemon_coordinator_without_cd_dir_raises():
    """The twin of test_workload.py:103, raised before any group exists."""
    with pytest.raises(RuntimeError, match="TPUDRA_CD_DIR"):
        ClaimEnv.from_environ(HOST0_DAEMON).initialize_distributed(device="cpu")
    assert not dist.is_initialized()


def test_rank0_without_routable_ipv4_raises(monkeypatch):
    monkeypatch.setattr(envspec, "_local_ip", lambda: "")
    with pytest.raises(RuntimeError, match="routable IPv4"):
        ClaimEnv.from_environ(dict(HOST0_DAEMON, TPUDRA_CD_DIR="/nonexistent")).initialize_distributed(
            device="cpu")
    assert not dist.is_initialized()


def test_registration_file_matches_the_reference(tmp_path):
    from tpudra.cddaemon import coordproxy

    ours, ref = tmp_path / "ours", tmp_path / "ref"
    ours.mkdir()
    ref.mkdir()
    a = envspec.write_registration(str(ours), "10.1.2.3", 7175)
    b = coordproxy.write_registration(str(ref), "10.1.2.3", 7175)
    assert os.path.basename(a) == os.path.basename(b) == envspec.REGISTRATION_FILE
    assert Path(a).read_bytes() == Path(b).read_bytes()
    assert sorted(os.listdir(ours)) == sorted(os.listdir(ref))
    assert coordproxy.read_registration(str(ours)) == ("10.1.2.3", 7175)
    from tpudra.cddaemon.dnsnames import DNS_NAME_FORMAT

    assert envspec.DNS_NAME_FORMAT == DNS_NAME_FORMAT


def test_two_process_rendezvous_through_the_grant():
    """The twin of TestDistributedRendezvous (test_workload.py:785): two
    processes get the env a ComputeDomain grant injects, join through
    ClaimEnv.initialize_distributed (gloo, asked for the CPU; rank 0 binds
    on its routable IP, rank 1 dials the grant's address) and all-reduce."""
    results = torch_gloo.values(torch_gloo.run_world(
        "rendezvous", 2, env_for_rank=lambda rank, port: {
            "TPUDRA_COORDINATOR": f"127.0.0.1:{port}", "TPUDRA_NUM_HOSTS": "2",
            "TPUDRA_HOST_INDEX": str(rank)}))
    for rank, r in enumerate(results):
        assert r == {"world": 2, "rank": rank, "backend": "gloo", "sum": (1 + 2) * 4}, r


def test_attach_detach_against_live_broker(tmp_path):
    """The twin of TestMultiProcessClient (test_workload.py:870)."""
    from tpudra.mpdaemon import ControlDaemon, query

    pipe_dir = str(tmp_path / "mp")
    daemon = ControlDaemon(pipe_dir, env={
        "TPUDRA_MP_CHIP_UUIDS": "chip-x",
        "TPUDRA_MP_ACTIVE_TENSORCORE_PERCENTAGE": "25",
        "TPUDRA_MP_PINNED_HBM_LIMITS": "chip-x=2048Mi",
    })
    daemon.start()
    try:
        env = ClaimEnv.from_environ({"TPUDRA_MP_PIPE_DIRECTORY": pipe_dir})
        with env.attach_multiprocess() as limits:
            assert limits["activeTensorCorePercentage"] == 25
            assert limits["pinnedHbmLimits"] == {"chip-x": "2048Mi"}
            assert query(pipe_dir, "STATUS").startswith("READY 1 ")
        assert query(pipe_dir, "STATUS").startswith("READY 0 ")
    finally:
        daemon.stop()
    with ClaimEnv.from_environ({}).attach_multiprocess() as limits:
        assert limits is None
