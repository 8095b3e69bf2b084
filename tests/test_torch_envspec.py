"""The port's claim-env parsing (tpudra_torch.workload.envspec) against the
JAX package's, and the port's isolation: it imports neither JAX nor the
JAX package, and its entry points do not run on the CPU unless asked."""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpudra.workload.envspec import ClaimEnv as JaxClaimEnv
from tpudra_torch.workload import model as tm
from tpudra_torch.workload.convert import params_from_numpy
from tpudra_torch.workload.envspec import ClaimEnv

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
    code = (
        "import sys\n"
        "import tpudra_torch.workload.model, tpudra_torch.workload.ce_kernel\n"
        "import tpudra_torch.workload.opt_kernel, tpudra_torch.workload.envspec\n"
        "import tpudra_torch.workload.convert, tpudra_torch.workload._build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tpudra')]\n"
        "print(sorted(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


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
    # Asked for explicitly, the CPU is taken.
    assert params_from_numpy({"w": np.zeros(3, np.float32)}, device="cpu")["w"].device.type == "cpu"
