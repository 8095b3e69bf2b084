"""Run one cell of the benchmark: set up the program's train step, time a
closed loop of steps for a fixed number of seconds, read the cell's
metrics, and decide ``correct`` against the plain reference.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file found by its name in ``BENCHMARK.json``:

- ``configs[].file``: the model's sizes and flags and its optimizer, and
  under ``reference`` the path, from the root, of the plain reference
  module that follows this configuration (interface below);
- ``perfbench/traffic/<traffic>.json``: read by ``feed``;
- ``perfbench/limits/<cell>.json``: the limits of the cell's correctness
  numbers, with the readings they were set from;
- ``perfbench/metrics/<metric>.py``: a per-layer metric's reader,
  ``read(run) -> float | None``.

A reference module is plain PyTorch that imports nothing of the program.
It gives:

- ``make_params(conf, seq, seed, device)``: the weights' tree, from
  ``seed``, which the program is handed too;
- ``flatten(tree)``: ``{leaf name: tensor}`` of a tree of the params' form
  (the params, the optimizer's moments);
- ``follow(conf, params, batches, precision, rows, frozen)``: its own
  training of ``params`` on ``batches`` and its readings (``losses``,
  ``grad_norms``, ``change_norms``); ``precision="fp8"`` is the control,
  ``rows`` and ``frozen`` the planted faults;
- ``model_flops_per_step(conf, seq, batch, n_params)``: the model FLOPs of
  one step, which ``step.mfu_pct`` counts.

The program under test is ``tpudra_torch``: the benchmark takes from it the
train step (``model.make_train_step``), the modules its readers time alone,
and the kernel names in the profiler's trace.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

from perfbench import feed

ROOT = Path(__file__).resolve().parents[1]
# Top-level module names that no process of the benchmark may hold.
BANNED_MODULES = ("jax", "jaxlib", "flax", "tpudra")
# Steps in the profiled slices of a traced run (device time, then host
# ops), each after PROFILE_WARMUP steps under the profiler's warm-up.
PROFILE_STEPS = 8
HOST_PROFILE_STEPS = 2
PROFILE_WARMUP = 2
# Steps that set-up drives and the reference follows; every limit in
# perfbench/limits was set from readings over this many steps.
CHECK_STEPS = 3
# Gradients under this share of the median leaf's, in the reference, are
# round-off: such a leaf's change is left out of the comparison.
ROUNDOFF_GRAD = 1e-3
GIB = 2.0 ** 30


class RunError(Exception):
    """A run that cannot give a result: no result line, a non-zero exit."""


@dataclass
class Cell:
    name: str
    chips: int
    conf: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    root: Path


def _read_json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError as e:
        raise RunError(f"missing file {path}") from e


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    manifest = _read_json(root / "BENCHMARK.json")
    cells = [w for w in manifest["workloads"] if w["name"] == name]
    if not cells:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[0]
    conf_entry = next(c for c in manifest["configs"] if c["name"] == w["config"])
    data = root / "perfbench"
    traffic = _read_json(data / "traffic" / f"{w['traffic']}.json")
    feed.check_traffic(traffic, CHECK_STEPS)

    def here(metric):
        return name in metric.get("workloads", [name])

    return Cell(
        name=name, chips=w["chips"], conf=_read_json(root / conf_entry["file"]),
        traffic=traffic, limits=_read_json(data / "limits" / f"{name}.json"),
        end_to_end=[m for m in manifest["end_to_end"] if here(m)],
        per_layer=[m for m in manifest["per_layer"] if here(m)], root=root,
    )


def load_module(path: Path, name: str):
    """Import the file ``path`` as a module called ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise RunError(f"missing module file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(cell: Cell):
    """The plain reference module that the cell's configuration names,
    imported under its file's stem; there is no default."""
    if "reference" not in cell.conf:
        raise RunError(f"the configuration of {cell.name} names no reference")
    path = cell.root / cell.conf["reference"]
    return load_module(path, "perfbench_reference_" + path.stem)


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is one of BANNED_MODULES."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED_MODULES))


class Clock:
    """Step boundaries: CUDA events recorded on the stream (no host sync),
    or the host clock on the CPU, which runs each step to its end."""

    def __init__(self, torch, device):
        self.torch, self.cuda = torch, device.type == "cuda"
        self.marks: list = []

    def mark(self):
        if self.cuda:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self) -> list[float]:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()


class Loop:
    """The closed loop: each step on the next batch of the pool, issued as
    soon as the host is free; the loss read every ``loss_every`` steps."""

    def __init__(self, step, params, state, pool, first: int, loss_every: int):
        self.step, self.params, self.state, self.pool = step, params, state, pool
        self.next, self.loss_every = first, loss_every
        self.done, self.losses, self.wrapped = 0, [], False

    def one(self):
        if self.next == len(self.pool):
            self.next, self.wrapped = 0, True
        self.params, self.state, loss = self.step(self.params, self.state, self.pool[self.next])
        self.next += 1
        self.done += 1
        if self.done % self.loss_every == 0:
            self.losses.append(float(loss))

    def run(self, n: int):
        for _ in range(n):
            self.one()


@dataclass
class Window:
    steps: int
    seconds: float
    step_ms: list


def timed_window(loop: Loop, clock: Clock, seconds: float) -> Window:
    """Steps back to back until ``seconds`` have passed on the host clock,
    and at least two; the window runs from a synchronised device before the
    first step to one after the last."""
    clock.sync()
    start = loop.done
    t0 = time.perf_counter()
    clock.mark()
    while True:
        loop.one()
        clock.mark()
        if time.perf_counter() - t0 >= seconds and loop.done - start >= 2:
            break
    clock.sync()
    return Window(steps=loop.done - start, seconds=time.perf_counter() - t0,
                  step_ms=clock.step_ms())


@dataclass
class Run:
    """What a per-layer reader reads."""

    torch: object
    model: object
    ref: object
    device: object
    seed: int
    conf: dict
    traffic: dict
    cfg: object
    params: dict
    state: object
    pool: object
    n_params: int
    window: Window
    peaks: dict | None
    slice: object = None
    host_slice: object = None

    def device_ms(self, fn, iters: int = 5, warmup: int = 2) -> float:
        """Device ms a call of ``fn()``, from the profiler's trace: the union
        of the device operations' intervals over ``iters`` calls, after
        ``warmup`` calls, divided by ``iters``."""
        from torch.profiler import profile

        from perfbench import devtrace

        def calls(n):
            return lambda: [fn() for _ in range(n)]

        sl = devtrace.record(profile, calls(warmup), calls(iters), with_host=False)
        return sl.busy_s * 1e3 / iters


def first_steps(loop: Loop, ref, cell: Cell, seed: int, device) -> dict:
    """Drive the program's first CHECK_STEPS steps through the loop and
    read what the reference is compared on: each loss; each leaf's gradient
    norm at step 1, worked out from the optimizer's first moment (m =
    (1 − b1)·g after one step); each leaf's change over the steps, read
    before the next step moves it."""
    b1 = cell.conf["optimizer"]["b1"]
    losses, grad_norms, marks = [], None, [time.perf_counter()]
    for _ in range(CHECK_STEPS):
        loop.params, loop.state, loss = loop.step(loop.params, loop.state, loop.pool[loop.next])
        loop.next += 1
        losses.append(float(loss))
        marks.append(time.perf_counter())
        if grad_norms is None:
            mu = ref.flatten(loop.state[0])
            grad_norms = {n: float(m.float().norm()) / (1.0 - b1) for n, m in mu.items()}
    start = ref.flatten(ref.make_params(cell.conf, cell.traffic["seq"], seed, device))
    change = {n: float((p.detach() - start[n]).norm()) for n, p in ref.flatten(loop.params).items()}
    del start
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change,
            "step_s": [b - a for a, b in zip(marks, marks[1:])]}


def _leaf_gaps(got: dict, want: dict, counted) -> dict:
    """Each counted leaf's gap between the two sides' norms, over the
    reference's norm of that leaf or of the median leaf, whichever is
    larger."""
    median = statistics.median(want.values())
    return {n: abs(got[n] - want[n]) / max(want[n], median) for n in counted}


def compare(prog: dict, ref: dict) -> tuple[dict, dict]:
    """The numbers ``correct`` may be decided on, and each leaf's gaps."""
    grads = ref["grad_norms"]
    moving = [n for n in grads if grads[n] >= ROUNDOFF_GRAD * statistics.median(grads.values())]
    leaf = {"grad_gap": _leaf_gaps(prog["grad_norms"], grads, grads),
            "change_gap": _leaf_gaps(prog["change_norms"], ref["change_norms"], moving)}
    numbers = {
        "loss1_gap": abs(prog["losses"][0] - ref["losses"][0]),
        "loss_gap": max(abs(a - b) for a, b in zip(prog["losses"], ref["losses"])),
    }
    for k, v in leaf.items():
        numbers[k] = max(v.values())
        numbers[k + ".median"] = statistics.median(v.values())
    return numbers, leaf


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers that the
    cell's limits file compares; a number that is not finite fails."""
    checks, ok = {}, bool(limits["limits"])
    for name, limit in limits["limits"].items():
        value = numbers[name]
        checks[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, checks


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "nvidia-smi not available"


def peaks_for(kind: str, root: Path) -> dict | None:
    return _read_json(root / "perfbench" / "peaks.json")["devices"].get(kind)


def reference_readings(cell: Cell, ref, seed: int, batches, device, precision="f32",
                       rows=None, frozen=False) -> dict:
    """The reference's readings over the program's first batches, with
    TF32 off, in float32 (or the control's precision)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = ref.make_params(cell.conf, cell.traffic["seq"], seed, device)
    return ref.follow(cell.conf, params, batches, precision, rows=rows, frozen=frozen)


def setup(cell: Cell, ref, model, seed: int, dev):
    """Weights and batches from ``seed``, the program's train step, and its
    first steps: (model config, loop, the program's readings, param count)."""
    traffic, conf = cell.traffic, cell.conf
    cfg = model.ModelConfig(**conf["model"], max_seq=traffic["seq"])
    params = ref.make_params(conf, traffic["seq"], seed, dev)
    n_params = sum(p.numel() for p in ref.flatten(params).values())
    pool = feed.token_pool(traffic, cfg.vocab, seed, dev)
    init, step = model.make_train_step(cfg, learning_rate=conf["optimizer"]["learning_rate"])
    loop = Loop(step, params, init(params), pool, 0, traffic["loss_every"])
    return cfg, loop, first_steps(loop, ref, cell, seed, dev), n_params


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", log=print) -> dict:
    """One run of ``cell``; returns the result line's object."""
    import torch

    from tpudra_torch.workload import envspec, model

    grant = envspec.ClaimEnv.from_environ({
        "TPU_VISIBLE_DEVICES": ",".join(str(i) for i in range(cell.chips)),
        "TPUDRA_CHIP_COORDS": "0,0,0"})
    if len(grant.visible_devices) != cell.chips or grant.mesh_bounds != (1, 1, 1):
        raise RunError(f"grant parsed as {grant.visible_devices} {grant.mesh_bounds}")
    dev = torch.device(device, grant.visible_devices[0]) if device == "cuda" else torch.device(device)
    ref = reference(cell)
    traffic, conf = cell.traffic, cell.conf
    torch.empty(0, device=dev)  # the device's context
    t_ready = time.perf_counter()
    cfg, loop, prog, n_params = setup(cell, ref, model, seed, dev)
    pool = loop.pool
    gc.collect()
    setup_s = time.perf_counter() - t_start
    log(f"perfbench: set-up {setup_s:.3f} s: imports and device {t_ready - t_start:.3f} s, "
        f"checked steps {', '.join(f'{t:.3f}' for t in prog['step_s'])} s, the rest "
        f"{setup_s - (t_ready - t_start) - sum(prog['step_s']):.3f} s")

    clock = Clock(torch, dev)
    window = timed_window(loop, clock, seconds)
    on_cuda = dev.type == "cuda"
    peak_bytes = torch.cuda.max_memory_allocated(dev) if on_cuda else 0
    if loop.wrapped:
        log(f"perfbench: the pool of {traffic['pool']} batches ran out; batches repeat")
    kind = torch.cuda.get_device_name(dev) if on_cuda else "cpu"
    result_device = {"platform": "gpu" if on_cuda else "cpu", "kind": kind, "count": cell.chips,
                     "memory_peak_bytes": int(peak_bytes)}
    failed = sum(not math.isfinite(v) for v in loop.losses)
    tokens = feed.tokens_per_step(traffic)
    breakdown = None
    if not trace:
        values = {
            "tokens_per_s": window.steps * tokens / window.seconds,
            "step_ms_p90": statistics.quantiles(window.step_ms, n=10, method="inclusive")[8],
            "peak_mem_gib": peak_bytes / GIB,
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    else:
        from torch.profiler import profile

        from perfbench import devtrace

        rd = Run(torch=torch, model=model, ref=ref, device=dev, seed=seed, conf=conf,
                 traffic=traffic, cfg=cfg, params=loop.params, state=loop.state, pool=pool,
                 n_params=n_params, window=window,
                 peaks=peaks_for(kind, cell.root) if on_cuda else None)
        if on_cuda:
            warm = lambda: loop.run(PROFILE_WARMUP)  # noqa: E731
            rd.slice = devtrace.record(profile, warm, lambda: loop.run(PROFILE_STEPS),
                                       with_host=False)
            rd.host_slice = devtrace.record(profile, warm, lambda: loop.run(HOST_PROFILE_STEPS),
                                            with_host=True)
            result_device.update(busy_s=rd.slice.busy_s, window_s=rd.slice.window_s)
            log(f"perfbench: profiled slice {rd.slice.window_s / PROFILE_STEPS * 1e3:.3f} ms a "
                f"step, the window {window.seconds / window.steps * 1e3:.3f} ms")
            breakdown = {"device_ops": devtrace.top_device_ops(rd.slice),
                         "idle_gaps": devtrace.idle_gaps(rd.host_slice)}
        rd.params, rd.state = loop.params, loop.state
        metrics = {}
        for m in cell.per_layer:
            reader = load_module(cell.root / "perfbench" / "metrics" / f"{m['name']}.py",
                                 "perfbench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(rd)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        del rd

    # The program's state goes before the reference runs.
    batches = [pool[i].clone() for i in range(CHECK_STEPS)]
    del loop, pool
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    want = reference_readings(cell, ref, seed, batches, dev)
    log(f"perfbench: reference {time.perf_counter() - t_ref:.3f} s")
    numbers, leaf = compare(prog, want)
    correct, checks = judge(numbers, cell.limits)
    correct = correct and failed == 0

    found = banned_modules()
    if found:
        raise RunError(f"modules loaded that the benchmark may not hold: {found}")
    out = {"correct": correct, "attempted": window.steps, "failed": failed,
           "metrics": metrics, "device": result_device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["card"] = card_line() if on_cuda else "cpu"
    out["losses"] = {"program": prog["losses"], "reference": want["losses"]}
    out["readings"] = {**numbers, "worst_leaf": {k: max(v, key=v.get) for k, v in leaf.items()}}
    out["checks"] = checks
    return out
