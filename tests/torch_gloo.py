"""Worlds of gloo processes for the PyTorch port's multi-process tests, and
the functions their ranks run.

``run_world`` starts one Python process per rank, each calling one function
of this module as ``fn(rank, world, port)``, and returns the ranks' results
in rank order.  A rank that raises returns its traceback, which fails the
caller's assertion with the rank's own message.  The world is joined within
``timeout`` seconds and killed past it, so a hang fails its tests instead of
holding the suite.

This module imports torch, numpy and the port only: the ranks start without
JAX.  The tests compare what the ranks return with the JAX package in their
own process.
"""

from __future__ import annotations

import math
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120.0

_BOOT = r"""
import os, pickle, sys, traceback
name, rank, world, port, out = sys.argv[1:6]
try:
    import torch_gloo
    result = ("ok", getattr(torch_gloo, name)(int(rank), int(world), int(port)))
except BaseException:
    result = ("error", traceback.format_exc())
with open(os.path.join(out, rank + ".pkl"), "wb") as f:
    pickle.dump(result, f)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(name: str, world: int, env_for_rank=None, timeout: float = TIMEOUT_S) -> list:
    """``name``'s results on a world of ``world`` processes, in rank order;
    a rank that failed gives ("error", traceback) in its place."""
    port = free_port()
    path = os.pathsep.join([str(REPO), str(REPO / "tests"), os.environ.get("PYTHONPATH", "")])
    with tempfile.TemporaryDirectory(prefix="gloo-") as out:
        procs = []
        try:
            for rank in range(world):
                env = dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1")
                env.update(env_for_rank(rank, port) if env_for_rank else {})
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", _BOOT, name, str(rank), str(world), str(port), out],
                    env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                ))
            deadline = time.monotonic() + timeout
            logs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0] for p in procs]
        except subprocess.TimeoutExpired:
            logs = None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if logs is None:
            return [("error", f"the world of {world} did not finish in {timeout} s")] * world
        results = []
        for rank in range(world):
            f = Path(out) / f"{rank}.pkl"
            if f.exists():
                with open(f, "rb") as fh:
                    results.append(pickle.load(fh))
            else:
                results.append(("error", f"rank {rank} wrote no result:\n{logs[rank]}"))
        return results


def values(results: list) -> list:
    """The ranks' values; raises with the first failed rank's traceback."""
    for rank, (status, value) in enumerate(results):
        if status != "ok":
            raise AssertionError(f"rank {rank} failed:\n{value}")
    return [value for _, value in results]


def _init(rank: int, world: int, port: int) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)


# -- the ranks' functions ---------------------------------------------------


def rendezvous(rank, world, port):
    """Join through the grant env alone (ClaimEnv.initialize_distributed),
    then one cross-process all-reduce."""
    from tpudra_torch.workload.envspec import ClaimEnv

    env = ClaimEnv.from_environ()
    env.initialize_distributed(device="cpu")
    local = torch.ones(4) * (env.host_index + 1)
    dist.all_reduce(local)
    out = {"world": dist.get_world_size(), "rank": dist.get_rank(),
           "backend": dist.get_backend(), "sum": float(local.sum())}
    dist.destroy_process_group()
    return out


def collectives(rank, world, port):
    """verify_collectives and the five benches over a flat mesh, and the
    checks once more over the inner dim of a 2-D mesh (subgroups)."""
    from tpudra_torch.workload import collectives as c
    from tpudra_torch.workload.envspec import mesh_from_devices

    _init(rank, world, port)
    mesh = mesh_from_devices(("data",), device="cpu")
    out = {
        "verified": c.verify_collectives(mesh, "data"),
        "results": [vars(r) for r in c.run_all(mesh, "data", mib_per_device=1, iters=2)],
    }
    out["lines"] = c.bandwidth_lines([c.BenchResult(**r) for r in out["results"]], mesh)
    mesh2 = mesh_from_devices(("a", "b"), (2, world // 2), device="cpu")
    out["verified_inner"] = c.verify_collectives(mesh2, "b")
    dist.destroy_process_group()
    return out


# The sharded-step configurations: the JAX tests' sizes (test_workload.py
# :257 dense, :582 MoE), f32 so that only the order of sums differs.
DENSE = dict(vocab=32, d_model=16, n_heads=2, n_layers=2, d_ff=32, max_seq=8, compute_dtype="f32")
MOE = dict(vocab=32, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq=16, num_experts=4,
           compute_dtype="f32")
BATCH = 4
LR = 1e-2


def numpy_params(kw: dict, seed: int = 0) -> dict:
    """The init_params tree (JAX layout) from numpy; norm scales drawn
    around 1 so that a dropped scale would show."""
    rng = np.random.default_rng(seed)
    L, D, F, V, S = kw["n_layers"], kw["d_model"], kw["d_ff"], kw["vocab"], kw["max_seq"]
    H, E = kw["n_heads"], kw.get("num_experts", 0)
    hd = D // H

    def dense(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def norm(shape):
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)

    # Drawn in the order of the tree's literal: embed, pos, wqkv, wo, the
    # FFN leaves, the norms.
    tree = {"embed": dense((V, D), 0.02), "pos": dense((S, D), 0.02)}
    layers = {"wqkv": dense((L, D, H, 3 * hd), D ** -0.5), "wo": dense((L, H, hd, D), D ** -0.5)}
    if E:
        layers.update(router=dense((L, D, E), D ** -0.5), w1=dense((L, E, D, F), D ** -0.5),
                      w2=dense((L, E, F, D), F ** -0.5))
    else:
        layers.update(w1=dense((L, D, F), D ** -0.5), w2=dense((L, F, D), F ** -0.5))
    layers.update(ln1=norm((L, D)), ln2=norm((L, D)))
    return {**tree, "layers": layers, "ln_f": norm((D,))}


def numpy_tokens(kw: dict, seed: int = 1, batch: int = BATCH) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, kw["vocab"], (batch, kw["max_seq"])).astype(np.int64)


def _rel_errs(got: dict, want: dict) -> dict:
    """Per leaf: max |got - want| over max |want|."""
    from tpudra_torch.workload.convert import tree_leaves

    out = {}
    for (k, g), w in zip(_flat(got).items(), tree_leaves(want)):
        out[k] = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
    return out


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        else:
            out[prefix + k] = tree[k]
    return out


def _full(tree, specs, mesh):
    """Each local shard's whole tensor, gathered over the mesh."""
    from torch.distributed.tensor import DTensor

    from tpudra_torch.workload.convert import tree_map

    return tree_map(
        lambda t, spec: DTensor.from_local(t, mesh, spec, run_check=False).full_tensor(),
        tree, specs,
    )


def _sharded_against_single(kw: dict, mesh, steps: int, batch: int = BATCH) -> dict:
    """The (dp, sp, tp) sharded step against the single-device step on the
    same params and tokens: loss, each gradient leaf and each param after
    one AdamW step; then ``steps - 1`` more sharded steps' losses."""
    from tpudra_torch.workload import model as tm
    from tpudra_torch.workload.convert import params_from_numpy, tree_map
    from tpudra_torch.workload.parallel import local_tree

    cfg = tm.ModelConfig(**kw)
    params_np, tokens = numpy_params(kw), torch.from_numpy(numpy_tokens(kw, batch=batch))
    single = params_from_numpy(params_np, device="cpu")
    loss, grads = tm.value_and_grad(tm.loss_fn)(single, tokens, cfg)
    init, step = tm.make_train_step(cfg, LR)
    single, _, _ = step(single, init(single), tokens)

    dparams = tm.shard_params(params_from_numpy(params_np, device="cpu"), cfg=cfg, mesh=mesh)
    dtokens = tm.shard_batch(tokens, mesh)
    specs = tm.param_specs(cfg)
    s_loss, s_grads = tm.sharded_value_and_grad(cfg, mesh)(dparams, dtokens)
    out = {
        "loss": (float(s_loss), float(loss)),
        "grads": _rel_errs(_full(s_grads, specs, mesh), grads),
        "local_shapes": {k: tuple(v.shape) for k, v in _flat(local_tree(dparams)).items()},
    }
    sinit, sstep = tm.make_sharded_train_step(cfg, mesh, LR)
    state = sinit(dparams)
    losses = []
    for _ in range(steps):
        dparams, state, s_loss = sstep(dparams, state, dtokens)
        losses.append(float(s_loss))
        if len(losses) == 1:
            stepped = tree_map(lambda d: d.full_tensor(), dparams)
            out["params"] = {k: float((g - w).abs().max())
                             for (k, g), w in zip(_flat(stepped).items(), _flat(single).values())}
    out["losses"] = losses
    return out


def _ep_moe_ffn(mesh) -> dict:
    """moe_ffn with its experts sharded over the 4-rank "ep" dim against the
    single-device moe_ffn (the twin of test_workload.py:528): y, aux and the
    gradient of x, and the shapes of every bf16 tensor the ranks made."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from tpudra_torch.workload.moe import MoEConfig, moe_ffn, shard_moe_params

    cfg = MoEConfig(d_model=16, d_ff=32, num_experts=4)
    rng = np.random.default_rng(0)
    params = {"router": torch.from_numpy((rng.standard_normal((16, 4)) * 0.25).astype(np.float32)),
              "w1": torch.from_numpy((rng.standard_normal((4, 16, 32)) * 0.25).astype(np.float32)),
              "w2": torch.from_numpy((rng.standard_normal((4, 32, 16)) / 32 ** 0.5).astype(np.float32))}
    x = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32)).bfloat16()

    def run(p, **groups):
        xg = x.detach().requires_grad_()
        y, aux = moe_ffn(p, xg, cfg, **groups)
        (gx,) = torch.autograd.grad((y.float() ** 2).sum() + aux, xg)
        return y, aux, gx

    class Shapes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
                    self.seen.add(tuple(t.shape))
            return out

    y, aux, gx = run(params)
    local = {k: v.to_local() for k, v in shard_moe_params(params, mesh, "ep").items()}
    with Shapes() as shapes:
        y_ep, aux_ep, gx_ep = run(local, ep_group=mesh.get_group("ep"))
    return {
        "y": float((y.float() - y_ep.float()).abs().max()),
        "aux": abs(float(aux) - float(aux_ep)),
        "gx": float((gx.float() - gx_ep.float()).abs().max()),
        "w1_local": tuple(local["w1"].shape),
        "capacity": cfg.capacity(16),
        "bf16_shapes": sorted(shapes.seen),
    }


# Batches that tp does not divide per dp rank: (mesh shape, batch).
RAGGED = {"1x1x2_b1": ((1, 1, 2), 1), "2x1x2_b6": ((2, 1, 2), 6)}


def parallel(rank, world, port):
    """Everything the 8-rank tests check: the dense and MoE steps sharded
    over a (2, 2, 2) mesh against the single-device step, moe_ffn
    expert-sharded over 4 ranks, and the dense step on the first 2 and 4
    ranks with a per-dp batch that tp does not divide (RAGGED)."""
    from tpudra_torch.workload.envspec import mesh_from_devices

    _init(rank, world, port)
    mesh = mesh_from_devices(("dp", "sp", "tp"), (2, 2, 2), device="cpu")
    out = {
        "dense": _sharded_against_single(DENSE, mesh, steps=1),
        "moe": _sharded_against_single(MOE, mesh, steps=3),
        "ep": _ep_moe_ffn(mesh_from_devices(("rep", "ep"), (2, 4), device="cpu")),
    }
    for name, (shape, batch) in RAGGED.items():
        sub = mesh_from_devices(("dp", "sp", "tp"), shape, "cpu", n_ranks=math.prod(shape))
        if sub.get_coordinate() is not None:
            out[name] = _sharded_against_single(DENSE, sub, steps=1, batch=batch)
    dist.destroy_process_group()
    return out


def _gather_full(tree, cfg, mesh, pp_axis=None):
    """Whole tensors from each rank's local shards: the layer chunks
    concatenated over ``pp_axis`` (stage order), every leaf param_specs
    shards over tp concatenated over the mesh's "tp" dim."""
    from tpudra_torch.workload import model as tm
    from tpudra_torch.workload.convert import tree_map
    from tpudra_torch.workload.parallel import _gather_dim, mesh_shape

    def full(t, spec, stacked):
        if pp_axis and stacked:
            t = _gather_dim(t, mesh.get_group(pp_axis), 0)
        if "tp" in mesh_shape(mesh) and spec[2].is_shard():
            t = _gather_dim(t, mesh.get_group("tp"), spec[2].dim)
        return t

    specs = tm.param_specs(cfg)
    stacked = tree_map(lambda _: False, specs)
    stacked["layers"] = tree_map(lambda _: True, specs["layers"])
    with torch.no_grad():
        return tree_map(full, tree, specs, stacked)


def _numpy_flat(tree) -> dict:
    return {k: v.detach().numpy() for k, v in _flat(tree).items()}


# -- ring attention (tests/test_torch_ringattention.py) -----------------------

RING_QKV = (2, 32, 2, 8)  # [B, S, H, D], the JAX test's shape
RING_LONG = (1, 1024, 2, 16)
# The JAX composition test's model (test_workload.py:1003), and its MoE form
# with a capacity (8 slots an expert for 64 tokens) that drops tokens.
RING_DENSE = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq=16,
                  attention="naive", compute_dtype="f32")
RING_MOE = dict(RING_DENSE, num_experts=4, moe_capacity_factor=0.5)
RING_MESHES = {"dense": (RING_DENSE, (2, 4, 1)), "moe": (RING_MOE, (2, 2, 2))}


def ring_inputs(shape=RING_QKV, seed: int = 0):
    """q, k, v [B, S, H, D] and the weights w of the sum Σ w·out whose
    gradients the tests compare."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _ring_model(kw: dict, mesh) -> dict:
    """ring_value_and_grad's loss and whole gradients, ring_loss_fn's loss
    (global tokens), and the single-device port loss."""
    from tpudra_torch.workload import model as tm
    from tpudra_torch.workload.convert import params_from_numpy
    from tpudra_torch.workload.parallel import local_tree
    from tpudra_torch.workload.ringattention import ring_loss_fn, ring_value_and_grad

    cfg = tm.ModelConfig(**kw)
    params_np, tokens = numpy_params(kw), torch.from_numpy(numpy_tokens(kw))
    dparams = tm.shard_params(params_from_numpy(params_np, device="cpu"), mesh, cfg)
    loss, grads = ring_value_and_grad(cfg, mesh)(dparams, tm.shard_batch(tokens, mesh))
    with torch.no_grad():
        global_loss = ring_loss_fn(local_tree(dparams), tokens, cfg, mesh)
        single = tm.loss_fn(params_from_numpy(params_np, device="cpu"), tokens, cfg)
    return {"loss": float(loss), "ring_loss_fn": float(global_loss), "single": float(single),
            "grads": _numpy_flat(_gather_full(grads, cfg, mesh))}


def _errors(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return "no error"


def ring(rank, world, port):
    """Ring attention over 8 ranks (its output block and the gradients of
    Σ w·out, causal and not, and a bf16 run at seq 1024), and the model
    with it on (dp, sp, tp) meshes; rank 0 also returns the error
    messages."""
    from tpudra_torch.workload import model as tm
    from tpudra_torch.workload.convert import params_from_numpy
    from tpudra_torch.workload.envspec import mesh_from_devices
    from tpudra_torch.workload.ringattention import make_sharded_ring_attention, ring_loss_fn

    _init(rank, world, port)
    sp = mesh_from_devices(("sp",), device="cpu")
    out = {}
    q, k, v, w = (torch.from_numpy(a).chunk(world, 1)[rank] for a in ring_inputs())
    for causal in (True, False):
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        o = make_sharded_ring_attention(sp, "sp", causal=causal)(*qkv)
        grads = torch.autograd.grad((o * w).sum(), qkv)
        out[f"causal={causal}"] = [t.detach().numpy() for t in (o, *grads)]
    x = torch.from_numpy(ring_inputs(RING_LONG)[0]).bfloat16().chunk(world, 1)[rank]
    long = make_sharded_ring_attention(sp, "sp")(x, x, x)
    out["long"] = (tuple(long.shape), bool(torch.isfinite(long.float()).all()))
    for name, (kw, shape) in RING_MESHES.items():
        out[name] = _ring_model(kw, mesh_from_devices(("dp", "sp", "tp"), shape, device="cpu"))

    kw = dict(RING_DENSE, n_layers=1)
    cfg = tm.ModelConfig(**kw)
    params = params_from_numpy(numpy_params(kw), device="cpu")
    tokens = torch.from_numpy(numpy_tokens(kw))
    no_sp = mesh_from_devices(("dp",), device="cpu")
    mesh = mesh_from_devices(("dp", "sp", "tp"), (2, 4, 1), device="cpu")
    out["errors"] = [_errors(lambda: ring_loss_fn(params, tokens, cfg, no_sp)),
                     _errors(lambda: ring_loss_fn(params, tokens[:, :14], cfg, mesh))]
    dist.destroy_process_group()
    return out


# -- the pipeline (tests/test_torch_pipeline.py) ------------------------------

# TestPipelineParallel's model (test_workload.py:380), the MoE pipeline's
# (:630) and the combined program's (:408), each in f32; the combined one
# with an aux weight, so that the aux's accounting over pp and dp shows.
PIPE_DENSE = dict(vocab=64, d_model=32, n_heads=2, n_layers=4, d_ff=64, max_seq=16,
                  compute_dtype="f32")
PIPE_MOE = dict(vocab=32, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq=16, num_experts=2,
                moe_capacity_factor=4.0, compute_dtype="f32")
PIPE_COMBINED = dict(PIPE_DENSE, num_experts=2, moe_capacity_factor=8.0)
# name: (config, mesh axes, mesh shape, batch, microbatches)
PIPE_CASES = {
    "dense": (PIPE_DENSE, ("pp", "dp"), (2, 2), 8, 4),
    "moe": (PIPE_MOE, ("pp", "dp"), (2, 1), 4, 2),
    "combined": (PIPE_COMBINED, ("pp", "dp", "tp"), (2, 2, 2), 8, 4),
}


def _pipelined(kw: dict, mesh, batch: int, M: int) -> dict:
    """pipelined_backbone's rows of this rank and aux, and
    pipelined_value_and_grad's loss and whole gradients."""
    from tpudra_torch.workload import model as tm
    from tpudra_torch.workload.convert import params_from_numpy
    from tpudra_torch.workload.pipeline import (
        pipelined_backbone,
        pipelined_value_and_grad,
        stage_params,
    )

    cfg = tm.ModelConfig(**kw)
    params_np, tokens = numpy_params(kw), torch.from_numpy(numpy_tokens(kw, batch=batch))
    params = stage_params(params_from_numpy(params_np, device="cpu"), mesh, cfg)
    with torch.no_grad():
        x, aux = pipelined_backbone(params, tokens, cfg, mesh, M)
    loss, grads = pipelined_value_and_grad(cfg, mesh, M)(params, tokens)
    return {"x": x.numpy(), "aux": float(aux), "loss": float(loss),
            "dp_rank": dist.get_rank(mesh.get_group("dp")),
            "grads": _numpy_flat(_gather_full(grads, cfg, mesh, pp_axis="pp"))}


def pipeline(rank, world, port):
    """The pipelined backbone, loss and gradients of PIPE_CASES, each on its
    mesh over the first ranks, and the up-front errors."""
    from tpudra_torch.workload import model as tm
    from tpudra_torch.workload.convert import params_from_numpy
    from tpudra_torch.workload.envspec import mesh_from_devices
    from tpudra_torch.workload.pipeline import pipelined_backbone, split_layers, stage_params

    _init(rank, world, port)
    cpu = torch.device("cpu")
    out = {}
    for name, (kw, axes, shape, batch, M) in PIPE_CASES.items():
        mesh = mesh_from_devices(axes, shape, cpu, n_ranks=math.prod(shape))
        if mesh.get_coordinate() is not None:
            out[name] = _pipelined(kw, mesh, batch, M)

    kw = PIPE_DENSE
    cfg = tm.ModelConfig(**kw)
    full = params_from_numpy(numpy_params(kw), device="cpu")
    tokens = torch.from_numpy(numpy_tokens(kw, batch=8))
    no_dp = mesh_from_devices(("pp",), (2,), cpu, n_ranks=2)
    mesh = mesh_from_devices(("pp", "dp"), (2, 2), cpu, n_ranks=4)
    if rank < 2:
        params = stage_params(full, no_dp, cfg)
        with torch.no_grad():
            x, _ = pipelined_backbone(params, tokens, cfg, no_dp, 4, dp_axis=None)
        out["errors"] = {
            "no_dp": _errors(lambda: pipelined_backbone(params, tokens, cfg, no_dp, 4)),
            "nope": _errors(lambda: pipelined_backbone(params, tokens, cfg, mesh, 4,
                                                       pp_axis="nope")),
            "dp_split": _errors(lambda: pipelined_backbone(params, tokens, cfg, mesh, 8)),
            "layers": _errors(lambda: split_layers(full["layers"], 3)),
            "microbatches": _errors(lambda: pipelined_backbone(params, tokens, cfg, mesh, 3)),
        }
        out["no_dp_shape"] = tuple(x.shape)
    dist.destroy_process_group()
    return out


# -- the gang's rank worker (tests/test_torch_multihost.py) -------------------


def gang_rank(rank, world, port):
    """One rank of a gang through the worker's own entry point, from the
    grant env alone; returns its exit code and what it printed."""
    import contextlib
    import io

    from tpudra_torch.sim import multihost

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = multihost.main(["--worker", "--device", "cpu"])
    return {"rc": rc, "stdout": out.getvalue(), "pid": os.getpid()}
