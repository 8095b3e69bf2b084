"""On the card, at each cell's own size: sound runs of the program stay
under the cell's limits, and the control and each planted fault fail one
of its numbers.  Run there with:

    python -m pytest -m cuda perfbench/tests/test_perfbench_card.py
"""

import json
from pathlib import Path

import pytest

from perfbench import calibrate, harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail_at_the_cells_size(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the program's kernels run only there")
    c = harness.load_cell(cell)
    summary = calibrate.readings(c, [90001, 90002, 2**31 + 90003], 3, "cuda",
                                 emit=lambda line: None)
    limits = c.limits["limits"]
    assert all(summary["lower"][n] <= limit for n, limit in limits.items()), summary["lower"]
    for kind in ("control", "half_batch", "unchanged"):
        assert any(summary[kind][n] > limit for n, limit in limits.items()), (kind, summary)
