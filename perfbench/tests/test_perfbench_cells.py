"""The harness end to end on the CPU, on a throwaway cell made of files
only: a sound run is correct, the timed path broken underneath is not, and
the control fails the cell's limits."""

import time

import pytest

from perfbench import calibrate, harness
from perfbench.tests.conftest import TINY_LIMITS, add_tiny_cell


def run_tiny(root, seed=3, seconds=0.3):
    cell = harness.load_cell("tiny-cell", root)
    return harness.run(cell, seed, seconds, False, time.perf_counter(), device="cpu",
                       log=lambda m: None)


def test_a_cell_from_files_alone(bench_root):
    add_tiny_cell(bench_root)
    cell = harness.load_cell("tiny-cell", bench_root)
    assert cell.traffic["seq"] == 64 and cell.conf["model"]["d_model"] == 128
    assert [m["name"] for m in cell.end_to_end] == [
        "tokens_per_s", "step_ms_p90", "peak_mem_gib", "setup_s"]
    out = run_tiny(bench_root)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"tokens_per_s", "step_ms_p90", "peak_mem_gib", "setup_s"}
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(TINY_LIMITS)


def test_same_seed_same_inputs(bench_root):
    add_tiny_cell(bench_root)
    a, b = run_tiny(bench_root, seed=2**31 + 7), run_tiny(bench_root, seed=2**31 + 7)
    assert a["losses"] == b["losses"]


def _unchanged(model):
    real = model.make_train_step

    def make(cfg, learning_rate=1e-3):
        init, _ = real(cfg, learning_rate)
        value = model.value_and_grad(model.loss_fn)
        return init, lambda params, state, tokens: (params, state, value(params, tokens, cfg)[0])

    return make


def _half_batch(model):
    real = model.make_train_step

    def make(cfg, learning_rate=1e-3):
        init, step = real(cfg, learning_rate)
        return init, lambda params, state, tokens: step(params, state, tokens[: len(tokens) // 2])

    return make


@pytest.mark.parametrize("fault", [_unchanged, _half_batch], ids=["state_unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(bench_root, monkeypatch, fault):
    from tpudra_torch.workload import model

    add_tiny_cell(bench_root)
    monkeypatch.setattr(model, "make_train_step", fault(model))
    out = run_tiny(bench_root)
    assert not out["correct"], out["checks"]


def test_the_control_fails_the_limits(bench_root):
    add_tiny_cell(bench_root)
    cell = harness.load_cell("tiny-cell", bench_root)
    summary = calibrate.readings(cell, [1, 2], 2, "cpu", emit=lambda line: None)
    assert all(summary["lower"][n] <= limit for n, limit in TINY_LIMITS.items())
    for kind in ("control", "half_batch", "unchanged"):
        assert any(summary[kind][n] > limit for n, limit in TINY_LIMITS.items()), kind


def test_a_run_without_the_program_gives_no_result(bench_root, monkeypatch):
    """A run needs the program: where it is missing, the run raises and no
    result is made."""
    import builtins

    add_tiny_cell(bench_root)
    real_import = builtins.__import__

    def no_program(name, *args, **kwargs):
        if name.startswith("tpudra_torch"):
            raise ModuleNotFoundError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_program)
    with pytest.raises(ModuleNotFoundError):
        run_tiny(bench_root)


def test_banned_modules_are_found(monkeypatch):
    import sys
    import types

    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "tpudra_torchx", types.ModuleType("tpudra_torchx"))
    assert harness.banned_modules() == ["jax"]


def test_profile_reduction():
    from perfbench import devtrace

    sl = devtrace.Slice(window_s=10e-6, device_ops=[
        ("attn_fwd_kernel<128>", 0.0, 2.0), ("gemm", 1.0, 2.0), ("attn_fwd_kernel<128>", 5.0, 1.0)],
        host_ops=[("step", 0.0, 10.0), ("aten::mm", 3.5, 1.0)])
    assert devtrace.busy_intervals(sl.device_ops) == [(0.0, 3.0), (5.0, 6.0)]
    assert sl.busy_s == pytest.approx(4e-6)
    assert sl.time_of("attn_fwd_kernel") == (2, 3.0)
    assert devtrace.idle_gaps(sl) == [["host in aten::mm", pytest.approx(2e-6)]]
    assert devtrace.top_device_ops(sl)[0] == ["attn_fwd_kernel<128>", pytest.approx(3e-6)]
