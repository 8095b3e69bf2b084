"""Each metric's FLOP and byte arithmetic against values worked out by hand
for the three cells."""

import json
import math
from pathlib import Path

import pytest

from perfbench import feed, harness

ROOT = Path(__file__).resolve().parents[2]
PEAKS = json.loads((ROOT / "perfbench" / "peaks.json").read_text())["devices"][
    "NVIDIA H100 80GB HBM3"]


def metric(name):
    return harness.load_module(ROOT / "perfbench" / "metrics" / f"{name}.py", f"m_{name}")


def cell(name):
    return harness.load_cell(name)


# Params: embed V·D + pos S·D + L·(wqkv D·3D + wo D·D + FFN + 2D norms) + D.
# Dense FFN 2·D·F; MoE FFN D·E router + 2·E·D·F.
@pytest.mark.parametrize("name, n_params, tokens, flops", [
    ("dense-s1024", 471_894_016, 81_840, 248_195_405_905_920),
    ("dense-s8192", 486_574_080, 98_292, 445_268_383_875_072),
    # active params: 605,111,296 − 8·7·2·1024·4096 = 135,349,248
    ("moe-s1024", 605_111_296, 16_368, 14_940_035_776_512),
])
def test_model_flops(name, n_params, tokens, flops):
    c = cell(name)
    ref = harness.reference(c)
    shapes = ref.param_shapes(c.conf, c.traffic["seq"])
    assert sum(math.prod(shape) for shape, _ in shapes.values()) == n_params
    assert feed.tokens_per_step(c.traffic) == tokens
    got = metric("step.mfu_pct").model_flops_per_step(c.conf["model"], c.traffic["seq"],
                                                      c.traffic["batch"], n_params)
    assert got == flops


# [B, H, S, hd]; causal pairs B·H·S(S+1)/2; forward 4·hd FLOPs a pair and
# 4 bf16 tensors + f32 lse; backward 10·hd and 8 tensors + lse.
@pytest.mark.parametrize("name, fwd_flops, fwd_bytes, bwd_flops, bwd_bytes", [
    ("dense-s1024", 343_932_928_000, 1_347_420_160, 859_832_320_000, 2_689_597_440),
    ("dense-s8192", 3_298_937_536_512, 1_616_904_192, 8_247_343_841_280, 3_227_516_928),
    ("moe-s1024", 34_393_292_800, 134_742_016, 85_983_232_000, 268_959_744),
])
def test_attention_bounds(name, fwd_flops, fwd_bytes, bwd_flops, bwd_bytes):
    c = cell(name)
    m = c.conf["model"]
    fwd, bwd = metric("attn_roofline").launch_bounds(
        c.traffic["batch"], m["n_heads"], c.traffic["seq"], m["d_model"] // m["n_heads"], PEAKS)
    assert fwd == pytest.approx(max(fwd_flops / 989e12, fwd_bytes / 3.35e12), rel=1e-12)
    assert bwd == pytest.approx(max(bwd_flops / 989e12, bwd_bytes / 3.35e12), rel=1e-12)


def test_the_flagship_bounds_in_microseconds():
    """bytes bound the forward at seq 1024 (80.4 µs), products the backward
    (173.9 µs); both are products at seq 8192 (555.9 and 1389.8 µs)."""
    bounds = metric("attn_roofline").launch_bounds
    assert [round(t * 1e6, 1) for t in bounds(16, 16, 1024, 128, PEAKS)] == [80.4, 173.9]
    assert [round(t * 1e6, 1) for t in bounds(2, 16, 8192, 128, PEAKS)] == [555.9, 1389.8]


class _Window:
    steps, seconds = 100, 30.0


class _Slice:
    window_s, busy_s = 2.0, 1.9
    device_ops = [("k", 0.0, 1.0)]

    def time_of(self, fragment):
        return {"attn_fwd_kernel": (16, 400.0), "attn_bwd_dq_kernel": (8, 300.0),
                "attn_bwd_dkv_kernel": (8, 500.0)}[fragment]


class _Run:
    peaks = PEAKS
    window = _Window()
    slice = _Slice()

    def __init__(self, c):
        self.conf, self.traffic = c.conf, c.traffic
        self.n_params = 471_894_016


def test_readers_from_their_inputs():
    run = _Run(cell("dense-s1024"))
    # 100 steps of 2.4820e14 FLOPs in 30 s against 989e12.
    assert metric("step.mfu_pct").read(run) == pytest.approx(
        100 * 248_195_405_905_920 * 100 / 30 / 989e12)
    assert metric("device.idle_pct").read(run) == pytest.approx(5.0)
    # 16 forward launches of 402.2 µs and 8 backward of 869.4 µs over 1200 µs
    # (a made-up time: the reader does not cap what it reads).
    assert metric("attn_roofline").read(run) == pytest.approx(
        100 * (16 * 1_347_420_160 / 3.35e12 + 8 * 859_832_320_000 / 989e12) / 1200e-6)
    run.peaks, run.slice = None, None
    for name in ("step.mfu_pct", "device.idle_pct", "attn_roofline"):
        assert metric(name).read(run) is None
