"""A throwaway cell built from files alone, small enough for the CPU."""

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
# A tiny cut of the flagship configuration: every layer kind, a few rows.
TINY_MODEL = dict(vocab=512, d_model=128, n_heads=2, n_layers=2, d_ff=256, ce_chunk=32)
TINY_TRAFFIC = {"seq": 64, "batch": 4, "pool": 16, "loss_every": 10}
# Set from the tiny cell's readings on the CPU (bf16 program against the f32
# reference; seeds 1-4): sound runs read grad_gap <= 1.0e-3 and change_gap
# <= 6.4e-4; the fp8 control 6.0e-3 and 3.8e-3, half the batch 0.41 and 5.8e-2.
TINY_LIMITS = {"loss_gap": 1e-2, "grad_gap": 3e-3, "change_gap": 2.5e-3}


def add_tiny_cell(root: Path, name: str = "tiny-cell", experts: int = 0,
                  dtype: str = "bf16") -> None:
    """Add a cell to ``root``'s benchmark by adding files and entries only."""
    base = "switch_moe" if experts else "flagship_dense"
    conf = json.loads((ROOT / "perfbench" / "configs" / f"{base}.json").read_text())
    conf["model"].update(TINY_MODEL, num_experts=experts, compute_dtype=dtype)
    data = root / "perfbench"
    (data / "configs" / f"{name}.json").write_text(json.dumps(conf))
    (data / "traffic" / f"{name}.json").write_text(json.dumps(TINY_TRAFFIC))
    (data / "limits" / f"{name}.json").write_text(json.dumps({"limits": TINY_LIMITS}))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": name, "source": "test", "file":
                                f"perfbench/configs/{name}.json", "reduced": [], "why": "test"})
    manifest["workloads"].append({"name": name, "config": name, "traffic": name, "chips": 1,
                                  "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))


@pytest.fixture
def bench_root(tmp_path) -> Path:
    """A copy of the benchmark's files (BENCHMARK.json and perfbench/)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("tests", ".cache", "__pycache__"))
    return tmp_path
