"""BENCHMARK.json against the benchmark's schema: its keys, the character
sets of its names and units, and the files that it names."""

import json
import math
import re
from pathlib import Path

import pytest

from perfbench import feed, harness

ROOT = Path(__file__).resolve().parents[2]
MANIFEST_PATH = ROOT / "BENCHMARK.json"
M = json.loads(MANIFEST_PATH.read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
# Keys that name a width, which no configuration may cut.
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|width|head|expansion|d_model|d_ff"
                   r"|experts_per_tok|_dim$|_rank$)")
COMPARED = {"loss1_gap", "loss_gap", "grad_gap", "grad_gap.median", "change_gap",
            "change_gap.median"}


def text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and not set(s) & {"\n", "\t"}


def test_top_level():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert MANIFEST_PATH.stat().st_size <= 64 * 1024
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert 1 <= len(M["command"]) <= 32 and all(text(w) for w in M["command"])
    for word in M["command"]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in M["paths"]) and (ROOT / word).exists()


def test_run_seconds_fit_a_full_check():
    rs = M["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    assert 1 <= len(M["configs"]) <= 24
    files = [c["file"] for c in M["configs"]]
    assert len(set(files)) == len(files)
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and text(c["source"]) and text(c["why"])
        assert any(c["file"].startswith(p + "/") for p in M["paths"])
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.fullmatch(key) and not WIDTH.search(key), key
        assert {"vocab", "d_model", "n_heads", "n_layers", "d_ff"} <= set(conf["model"])
        assert {"reference", "model", "optimizer"} <= set(conf)
        ref = conf["reference"]
        assert any(ref.startswith(p + "/") for p in M["paths"]) and (ROOT / ref).is_file()
        assert any(w["config"] == c["name"] for w in M["workloads"])


def test_workloads():
    cells = M["workloads"]
    assert 1 <= len(cells) <= 24
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(set(pairs)) == len(pairs)
    configs = {c["name"] for c in M["configs"]}
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and NAME.fullmatch(w["traffic"]) and text(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        feed.check_traffic(json.loads(
            (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text()),
            harness.CHECK_STEPS)
        limits = json.loads((ROOT / "perfbench" / "limits" / f"{w['name']}.json").read_text())
        assert limits["limits"] and set(limits["limits"]) <= COMPARED
        assert all(0 < v < 1 for v in limits["limits"].values())


def test_metrics():
    e2e, per_layer = M["end_to_end"], M["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(per_layer) <= 128
    cells = {w["name"] for w in M["workloads"]}
    names = [m["name"] for m in e2e + per_layer]
    assert len(set(names)) == len(names)
    for m in e2e + per_layer:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = next(m for m in e2e if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25
    layers = {}
    for m in per_layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert text(m["layer"]) and m["moves"] in {x["name"] for x in e2e}
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").exists()
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_every_cell_reports_enough(cell):
    def here(m):
        return cell in m.get("workloads", [cell])

    e2e = {m["name"] for m in M["end_to_end"] if here(m)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in M["per_layer"] if here(m)]
    assert layer and all(m["moves"] in e2e for m in layer)


def test_peaks_table():
    peaks = json.loads((ROOT / "perfbench" / "peaks.json").read_text())["devices"]
    h100 = peaks["NVIDIA H100 80GB HBM3"]
    assert (h100["bf16_flops_per_s"], h100["bytes_per_s"]) == (989e12, 3.35e12)
    assert all(math.isfinite(v) and v > 0 for d in peaks.values() for v in d.values())
