"""Nothing that the benchmark runs imports JAX or the JAX package, compared
by whole top-level module names (the port's name begins with the JAX
package's); the plain reference imports nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BANNED = {"jax", "jaxlib", "flax", "tpudra"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(folder: str) -> list[Path]:
    return sorted(p for p in (ROOT / folder).rglob("*.py") if "tests" not in p.parts[-2:])


@pytest.mark.parametrize("folder", ["perfbench", "tpudra_torch"])
def test_no_jax_in_what_the_benchmark_runs(folder):
    found = {str(p.relative_to(ROOT)): top_level_imports(p) & BANNED for p in sources(folder)}
    assert not {k: v for k, v in found.items() if v}


def test_the_port_passes_the_name_check():
    import tpudra_torch.workload.model  # noqa: F401

    from perfbench import harness

    assert "tpudra_torch" in sys.modules and harness.banned_modules() == []


def test_the_reference_imports_nothing_of_the_program():
    for path in sources("perfbench/reference"):
        assert not top_level_imports(path) & {"tpudra_torch", "perfbench", *BANNED}, path


def test_a_run_loads_no_jax():
    """The modules a run loads, loaded in a fresh process."""
    metrics = [str(p) for p in sorted((ROOT / "perfbench" / "metrics").glob("*.py"))]
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from perfbench import harness, calibrate, devtrace, feed
from tpudra_torch.workload import envspec, model, moe, convert
import torch.profiler
cell = harness.load_cell("moe-s1024-b32")
harness.reference(cell)
for i, path in enumerate({metrics!r}):
    harness.load_module(harness.Path(path), f"m{{i}}")
print(json.dumps(harness.banned_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
