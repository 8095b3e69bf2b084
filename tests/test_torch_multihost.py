"""The port's multi-host rank worker (tpudra_torch/sim/multihost.py), its
span layer (tpudra_torch/trace.py) and its launcher (tools/torch_multihost.py)
against the JAX package's: the grants a real gang reservation writes, the
contract checks, the one-host grant chip_smoke.py gives the card, a gloo
gang of 2 hosts × 2 ranks, and spans read back by tpudra.trace.

The e2e twins of tests/test_multihost.py (a gang-reserved claim → one
process per granted chip, 16 at 4 hosts) start many processes that import
torch, so they ride the ``slow`` and ``multihost`` lane like their JAX twins:
``pytest -m multihost tests/test_torch_multihost.py``.
"""

from __future__ import annotations

import dataclasses
import importlib
import logging
import os
import re
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

import chip_smoke
import torch_gloo
from tpudra import trace
from tpudra.sim import multihost as jax_multihost
from tpudra.workload.envspec import ClaimEnv as JaxClaimEnv
from tpudra_torch import trace as port_trace
from tpudra_torch.sim import multihost
from tpudra_torch.workload.envspec import ClaimEnv

REPO = Path(__file__).resolve().parents[1]


def _tool(name: str):
    """A module of tools/ (the launcher, trace_report)."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.pop(0)


@pytest.fixture(scope="module")
def grants(tmp_path_factory) -> dict:
    """{num_hosts: [each member's grant env]} of real traced gang
    reservations of 1 and 2 hosts (reserve only, no launch)."""
    log = tmp_path_factory.mktemp("reserve") / "trace.jsonl"
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(trace.ENV_TRACE, "1")
        mp.setenv(trace.ENV_TRACE_LOG, str(log))
        trace.reset_for_tests()
        try:
            for n in (1, 2):
                with jax_multihost.MultiHostGang(jax_multihost.MultiHostConfig(num_hosts=n)) as gang:
                    gang.reserve()
                    out[n] = [gang._grant_env(m.node, m.claim_uid) for m in gang._members]
                    gang.release()
        finally:
            trace.reset_for_tests()
    return out


def test_check_grant_accepts_every_member_of_a_real_reserve(grants):
    for env in grants[2]:
        multihost.check_grant(ClaimEnv.from_environ(env))


# One case per check of the JAX worker (tpudra/sim/multihost.py:696-706):
# the fields to set (None: remove) on host 0's grant, and the refusal.
BROKEN = {
    "one_host": ({"TPUDRA_NUM_HOSTS": "1"}, "TPUDRA_NUM_HOSTS"),
    "worker_id": ({"TPU_WORKER_ID": "1"}, "TPU_WORKER_ID"),
    "hostnames": ({"TPU_WORKER_HOSTNAMES": "compute-domain-daemon-0000"}, "TPU_WORKER_HOSTNAMES"),
    "skip_mds_query": ({"TPU_SKIP_MDS_QUERY": None}, "TPU_SKIP_MDS_QUERY"),
    "host_bounds": ({"TPU_HOST_BOUNDS": None}, "TPU_HOST_BOUNDS"),
    "chips_per_host_bounds": ({"TPU_CHIPS_PER_HOST_BOUNDS": None}, "TPU_CHIPS_PER_HOST_BOUNDS"),
    "mesh_shape": ({"TPUDRA_MESH_SHAPE": None}, "TPUDRA_MESH_SHAPE"),
    "host_coords": ({"TPUDRA_HOST_COORDS": None}, "TPUDRA_HOST_COORDS"),
    "host_coords_outside": ({"TPUDRA_HOST_COORDS": "0,0,2"}, "outside TPUDRA_MESH_SHAPE"),
    "coordinator": ({"TPUDRA_COORDINATOR": None}, "TPUDRA_COORDINATOR"),
}


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_check_grant_refuses_each_broken_field(grants, case):
    changes, match = BROKEN[case]
    env = dict(grants[2][0])
    for key, value in changes.items():
        if value is None:
            del env[key]
        else:
            env[key] = value
    with pytest.raises(RuntimeError, match=match):
        multihost.check_grant(ClaimEnv.from_environ(env))


@pytest.mark.parametrize("hosts,member", [(1, 0), (2, 0), (2, 1)])
def test_claim_env_parses_real_grants_as_jax_does(grants, hosts, member):
    env = grants[hosts][member]
    got, want = ClaimEnv.from_environ(env), JaxClaimEnv.from_environ(env)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.libtpu_env() == want.libtpu_env()
    assert got.slice_device_count == want.slice_device_count == 4 * hosts
    assert got.traceparent and multihost.chips_per_host(got) == 4


def _form(key: str, value: str):
    """What a grant value's shape is: digits stand for any number; the
    names a deployment picks stand for any name."""
    if key == "TPUDRA_CD_DIR":
        return os.path.isabs(value)
    if key == "TPUDRA_TRACEPARENT":
        return trace.parse_traceparent(value) is not None
    if key in ("TPUDRA_DOMAIN_UID", "TPUDRA_CLIQUE_ID"):
        return re.sub(r"[\w-]+", "w", value)
    return re.sub(r"\d+", "N", value)


def test_one_host_grant_has_the_keys_and_forms_of_a_real_grant(grants, tmp_path):
    got = chip_smoke.one_host_grant(3, str(tmp_path))
    extras = {"TPU_VISIBLE_DEVICES": "3", "TPUDRA_TRACE": "1",
              "TPUDRA_TRACE_LOG": str(tmp_path / "trace.jsonl")}
    assert {k: got.pop(k) for k in extras} == extras
    (real,) = grants[1]
    assert sorted(got) == sorted(real)
    for key in got:
        assert _form(key, got[key]) == _form(key, real[key]), (key, got[key], real[key])
    env = ClaimEnv.from_environ(got)
    assert dataclasses.asdict(env) == dataclasses.asdict(JaxClaimEnv.from_environ(got))
    assert (env.num_hosts, env.slice_device_count, multihost.chips_per_host(env)) == (1, 1, 1)


def test_worker_refuses_the_cpu_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device is valid")
    env = ClaimEnv.from_environ(chip_smoke.one_host_grant(0, str(tmp_path)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost._worker_body(env)
    assert not dist.is_initialized()


def _spans(path) -> list:
    return [s for s in trace.read_log(str(path)) if s["name"] == "rank.worker"]


def test_one_host_rank_on_the_cpu(tmp_path, monkeypatch, capsys):
    """chip_smoke.py's rank phase on the CPU: a one-rank group started by the
    worker, its RESULT line and one span parented on the grant's
    traceparent."""
    grant = chip_smoke.one_host_grant(0, str(tmp_path))
    for key in ("TPUDRA_TRACE", "TPUDRA_TRACE_LOG"):
        monkeypatch.setenv(key, grant[key])
    assert multihost.run_rank(ClaimEnv.from_environ(grant), "cpu") == 0
    assert not dist.is_initialized()
    assert capsys.readouterr().out == chip_smoke.RANK_RESULT + "\n"
    (span,) = _spans(grant["TPUDRA_TRACE_LOG"])
    trace_id, span_id = trace.parse_traceparent(grant["TPUDRA_TRACEPARENT"])
    assert (span["trace"], span["parent"], span["pid"]) == (trace_id, span_id, os.getpid())
    assert span["attrs"] == {"host": 0, "num_hosts": 1, "local_rank": 0}


@pytest.mark.parametrize("changes,match", [
    ({"TPUDRA_MESH_SHAPE": "1,1,2"}, "a world of 1 for a slice of 2 chips"),
    ({"TPU_CHIPS_PER_HOST_BOUNDS": "2,1,1"}, "LOCAL_WORLD_SIZE=1 for a host block of 2 chips"),
], ids=["slice", "host_block"])
def test_worker_refuses_a_world_that_is_not_the_grant(tmp_path, capsys, changes, match):
    grant = {**chip_smoke.one_host_grant(0, str(tmp_path)), **changes}
    with pytest.raises(RuntimeError, match=match):
        multihost._worker_body(ClaimEnv.from_environ(grant), "cpu")
    assert not dist.is_initialized()
    assert capsys.readouterr().out == ""


def _gang_grant(host: int, port: int, cd_dirs) -> dict:
    """Host ``host`` of a 2-host slice, mesh (2, 2, 1), 2 chips a host, in
    the CD plugin's keys; TPUDRA_SIM_COORDINATOR points at the store."""
    return {
        "TPUDRA_DOMAIN_UID": "gang-uid", "TPUDRA_DOMAIN_CHANNELS": "0",
        "TPUDRA_NUM_HOSTS": "2", "TPUDRA_HOST_INDEX": str(host),
        "TPUDRA_CLIQUE_ID": "gang-slice.0",
        "TPUDRA_COORDINATOR": "compute-domain-daemon-0000:7175",
        "TPUDRA_CD_DIR": str(cd_dirs[host]),
        "TPUDRA_TRACEPARENT": f"00-{'ab' * 16}-{'%016x' % (host + 1)}-01",
        "TPUDRA_HOST_COORDS": f"0,{host},0", "TPUDRA_MESH_SHAPE": "2,2,1",
        "TPU_CHIPS_PER_HOST_BOUNDS": "2,1,1", "TPU_HOST_BOUNDS": "1,2,1",
        "TPU_SKIP_MDS_QUERY": "true",
        "TPU_WORKER_HOSTNAMES": "compute-domain-daemon-0000,compute-domain-daemon-0001",
        "TPU_WORKER_ID": str(host),
        multihost.ENV_SIM_COORDINATOR: f"127.0.0.1:{port}",
    }


def test_worker_on_a_gloo_gang_of_2_hosts_by_2_ranks(tmp_path):
    """Four processes, each through the worker's entry point from its
    host's grant, LOCAL_RANK and LOCAL_WORLD_SIZE: rank 0 registers its
    store in its domain dir, every rank prints the RESULT line the JAX
    worker prints, and each rank's span parents on its host's bind."""
    cd_dirs = [tmp_path / "cd0", tmp_path / "cd1"]
    for d in cd_dirs:
        d.mkdir()
    log = tmp_path / "trace.jsonl"
    ports = []

    def env_for_rank(rank, port):
        ports.append(port)
        return {**_gang_grant(rank // 2, port, cd_dirs), "LOCAL_RANK": str(rank % 2),
                "LOCAL_WORLD_SIZE": "2", "TPUDRA_TRACE": "1", "TPUDRA_TRACE_LOG": str(log)}

    results = torch_gloo.values(torch_gloo.run_world("gang_rank", 4, env_for_rank=env_for_rank))
    # 8 columns × 2 chips a host × (1 + 2).
    for rank, r in enumerate(results):
        assert r["rc"] == 0
        assert r["stdout"] == f"RESULT gang-psum: 48.0 host {rank // 2} devices 4 mesh 2,2,1\n"
    assert (cd_dirs[0] / "coordinator").read_text().strip().endswith(f":{ports[0]}")
    assert not (cd_dirs[1] / "coordinator").exists()
    spans = sorted(_spans(log), key=lambda s: (s["attrs"]["host"], s["attrs"]["local_rank"]))
    assert [s["pid"] for s in spans] == [r["pid"] for r in results]
    for rank, s in enumerate(spans):
        assert s["trace"] == "ab" * 16 and s["parent"] == "%016x" % (rank // 2 + 1)
        assert s["attrs"] == {"host": rank // 2, "num_hosts": 2, "local_rank": rank % 2}


def test_port_span_reads_back_under_a_tpudra_root(tmp_path, monkeypatch):
    """A port span parented on a tpudra.trace span's traceparent lands in
    the same trace, with the same record keys, and is on disk as soon as
    it closes."""
    trace_report = _tool("trace_report")
    log = tmp_path / "trace.jsonl"
    monkeypatch.setenv(trace.ENV_TRACE, "1")
    monkeypatch.setenv(trace.ENV_TRACE_LOG, str(log))
    trace.reset_for_tests()
    try:
        with trace.start_span("gang.reserve", attrs={"members": 2}) as root:
            with port_trace.start_span("rank.worker", parent=root.traceparent, attrs={"host": 1}):
                pass
            with pytest.raises(ValueError):
                with port_trace.start_span("rank.failed", parent=root.traceparent):
                    raise ValueError("boom")
            # Written at close, before tpudra.trace writes its batch.
            assert [s["name"] for s in trace.read_log(str(log))] == ["rank.worker", "rank.failed"]
        trace.flush()
    finally:
        trace.reset_for_tests()
    spans = {s["name"]: s for s in trace.read_log(str(log))}
    reserve, worker, failed = spans["gang.reserve"], spans["rank.worker"], spans["rank.failed"]
    assert set(worker) == set(reserve)
    assert (worker["trace"], worker["parent"]) == (reserve["trace"], reserve["span"])
    assert worker["attrs"] == {"host": 1} and worker["pid"] == os.getpid()
    assert failed["error"] == "ValueError: boom"
    traces = trace_report.build_traces(list(spans.values()))
    (t,) = traces.values()
    assert [r["name"] for r in t["roots"]] == ["gang.reserve"]
    below = {s["name"] for s in trace_report.descendants(t["roots"][0], t["children"])}
    assert below == {"rank.worker", "rank.failed"}


def test_port_span_off_and_unwritable_log(tmp_path, monkeypatch, caplog):
    """Off: the shared no-op span, nothing written.  An unwritable log:
    spans dropped with one warning, the traced work unharmed."""
    monkeypatch.delenv(trace.ENV_TRACE, raising=False)
    assert port_trace.start_span("rank.worker") is port_trace.NOOP_SPAN
    monkeypatch.setenv(trace.ENV_TRACE, "1")
    monkeypatch.setenv(trace.ENV_TRACE_LOG, str(tmp_path / "missing" / "trace.jsonl"))
    monkeypatch.setattr(port_trace, "_write_warned", False)
    with caplog.at_level(logging.WARNING, logger=port_trace.__name__):
        for _ in range(2):
            with port_trace.start_span("rank.worker", parent="garbled"):
                pass
    assert len(caplog.records) == 1, caplog.records
    assert "unwritable" in caplog.records[0].getMessage()
    assert not (tmp_path / "missing").exists()


# -- the e2e twins of tests/test_multihost.py (slow, multihost) ---------------


@pytest.mark.slow
@pytest.mark.multihost
def test_four_node_claim_yields_sixteen_processes_and_psum():
    out = _tool("torch_multihost").run_e2e(num_hosts=4, deadline_s=120.0)
    assert out["ok"], out
    assert out["bound_claims"] == 4
    # v5p, 4 hosts: mesh (2, 2, 4), a (2, 2, 1) block of 4 chips a host.
    assert [(r["host"], r["local_rank"]) for r in out["ranks"]] == [
        (h, i) for h in range(4) for i in range(4)]
    for rank in out["ranks"]:
        assert rank["rc"] == 0, rank
        assert "devices 16 mesh 2,2,4" in rank["tail"], rank
        # 8 columns × 4 chips a host × (1 + 2 + 3 + 4).
        assert "RESULT gang-psum: 320.0" in rank["tail"], rank
    assert out["bound_claims_after_release"] == 0
    assert out["cdi_leaks_after_release"] == 0


@pytest.mark.slow
@pytest.mark.multihost
def test_two_node_gang():
    out = _tool("torch_multihost").run_e2e(num_hosts=2, deadline_s=120.0)
    assert out["ok"], out
    assert len(out["ranks"]) == 8
    for rank in out["ranks"]:
        # mesh (2, 2, 2) = 8 chips; 8 × 4 × (1 + 2) = 96.
        assert "RESULT gang-psum: 96.0" in rank["tail"], rank


@pytest.mark.slow
@pytest.mark.multihost
def test_traced_gang_yields_one_root_to_rank_trace(tmp_path, monkeypatch):
    """One trace: the controller's gang.reserve → each member's bind → the
    rank.worker span of every process of that member's host, joined through
    the grant env alone."""
    trace_report = _tool("trace_report")
    log = str(tmp_path / "e2e-trace.jsonl")
    monkeypatch.setenv(trace.ENV_TRACE, "1")
    monkeypatch.setenv(trace.ENV_TRACE_LOG, log)
    trace.reset_for_tests()
    try:
        out = _tool("torch_multihost").run_e2e(num_hosts=2, deadline_s=120.0)
        assert out["ok"], out
        trace.flush()
    finally:
        trace.reset_for_tests()

    traces = trace_report.build_traces(trace.read_log(log))
    gang_traces = [t for t in traces.values() if any(r["name"] == "gang.reserve" for r in t["roots"])]
    assert len(gang_traces) == 1, "expected ONE gang-reserve-rooted trace"
    (t,) = gang_traces
    root = next(r for r in t["roots"] if r["name"] == "gang.reserve")
    binds = [s for s in trace_report.descendants(root, t["children"])
             if s["name"] == "gang.bind-member"]
    assert len(binds) == 2
    ranks = [s for s in t["spans"].values() if s["name"] == "rank.worker"]
    assert len(ranks) == 8
    pids = {s["pid"] for s in ranks}
    assert len(pids) == 8 and root["pid"] not in pids
    for bind in binds:
        # Each bind's own host: its 4 ranks hang below it.
        below = [s for s in trace_report.descendants(bind, t["children"])
                 if s["name"] == "rank.worker"]
        assert sorted(s["attrs"]["local_rank"] for s in below) == [0, 1, 2, 3]
        assert len({s["attrs"]["host"] for s in below}) == 1
    for rank in ranks:
        chain = trace_report._ancestor_chain(rank, t["spans"])
        assert "gang.bind-member" in chain and "gang.reserve" in chain
    text = trace_report.report(log, trace_id=root["trace"])
    assert "gang.reserve" in text and "rank.worker" in text and "critical path" in text


@pytest.mark.slow
@pytest.mark.multihost
def test_kill_one_host_rolls_back_to_zero_bound():
    out = _tool("torch_multihost").run_e2e(num_hosts=4, kill_rank=2, deadline_s=25.0)
    assert out["ok"], out
    assert not out["launch_ok"]
    victims = [r for r in out["ranks"] if r["host"] == 2]
    assert len(victims) == 4 and all(r["rc"] != 0 for r in victims)
    assert out["bound_claims_after_release"] == 0
    assert out["cdi_leaks_after_release"] == 0


@pytest.mark.slow
@pytest.mark.multihost
def test_chip_fault_remediates_to_spare_and_psum_completes():
    """A chip fault on a bound member with a spare cabled at its slot: the
    gang remediates to the spare, with no partially bound window, and the
    relaunched processes' all-reduce completes on the new membership."""
    import threading
    import time

    from tpudra.controller.gang import published_slice_health

    cfg = jax_multihost.MultiHostConfig(num_hosts=4, spare_slots=(2,))
    with _tool("torch_multihost").TorchMultiHostGang(cfg) as gang:
        gang.reserve()
        assert gang.bound_claim_count() == 4
        partial_windows: list = []
        stop = threading.Event()

        def probe(member) -> bool:
            d = gang.drivers.get(member.node)
            return d is not None and member.claim_uid in d.state.prepared_claim_uids()

        def monitor() -> None:
            while not stop.is_set():
                try:
                    partial = gang.gangs.partially_bound(probe)
                except Exception:  # noqa: BLE001 — mid-mutate read window
                    partial = []
                if partial:
                    partial_windows.append(tuple(partial))
                time.sleep(0.002)

        t = threading.Thread(target=monitor)
        t.start()
        try:
            gang.fault_chip(2)
            health = published_slice_health(gang.kube)
            assert not health["mh-node-2"].healthy, health
            assert health["mh-spare-2"].healthy, health
            status = gang.remediate_unhealthy()
        finally:
            stop.set()
            t.join(timeout=10)
        assert not t.is_alive()
        assert partial_windows == [], partial_windows
        assert status.phase == "bound"
        assert [m.node for m in status.members] == [
            "mh-node-0", "mh-node-1", "mh-spare-2", "mh-node-3"]
        assert gang.bound_claim_count() == 4
        sick_driver = gang.drivers["mh-node-2"]
        assert not sick_driver.state.prepared_claim_uids()
        assert not sick_driver.state._cdi.list_claim_uids()

        results = gang.launch()
        assert len(results) == 16
        for r in results:
            assert r.ok, (r.rank, r.output[-400:])
            assert "RESULT gang-psum: 320.0" in r.output, r.output[-400:]
            assert "devices 16 mesh 2,2,4" in r.output, r.output[-400:]
        gang.release()
        assert gang.bound_claim_count() == 0
        assert gang.cdi_leak_count() == 0
