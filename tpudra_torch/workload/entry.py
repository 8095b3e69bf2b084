"""The port's compile-check surface: the counterpart of ``__graft_entry__.py``.

- ``entry()``: the flagship transformer's forward at a tiny size, with
  example args: ``fn, args = entry(); fn(*args)`` gives logits [2, 32, 256].
- ``dryrun_multichip(n)``: n processes, one device each, run the six checks
  of the JAX dryrun on tiny shapes: the (dp, sp, tp) train step, the
  pipeline (pp × dp), the expert-parallel MoE FFN, the combined dp × pp ×
  tp(+ep) train step (its loss within 1e-3 of the unpipelined model's), the
  model with ring attention over sp, and the five collectives.  On CUDA
  (the default) over NCCL, one card per process, refusing when fewer than n
  are visible; on the CPU over gloo when asked, as the JAX dryrun runs on a
  virtual CPU mesh.  Run as ``python -m tpudra_torch.workload.entry N
  [cpu|cuda]``.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch

from tpudra_torch.workload.device import resolve_device
from tpudra_torch.workload.envspec import factor_devices, mesh_from_devices

_ROOT = Path(__file__).resolve().parents[2]
# The world is killed past this (a hang fails the dryrun, it does not hold it).
TIMEOUT_S = 600.0


def entry(device=None):
    """(fn, args): ``fn(params, tokens)`` is ``model.forward`` at the JAX
    entry's config (vocab 256, d_model 128, 4 heads, 2 layers, d_ff 256,
    max_seq 64) on tokens [2, 32], params and tokens from seeds 0 and 1 on
    ``device`` (default CUDA)."""
    from tpudra_torch.workload import model as m

    dev = resolve_device(device)
    cfg = m.ModelConfig(vocab=256, d_model=128, n_heads=4, n_layers=2, d_ff=256, max_seq=64)
    params = m.init_params(torch.Generator(dev).manual_seed(0), cfg, device=dev)
    tokens = torch.randint(0, cfg.vocab, (2, 32), generator=torch.Generator(dev).manual_seed(1),
                           device=dev)

    def fn(params, tokens):
        return m.forward(params, tokens, cfg)

    return fn, (params, tokens)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Runs the six checks on ``n_devices`` processes (see the module
    docstring) and returns rank 0's findings; raises RuntimeError with the
    first failed rank's traceback and output, or when the world does not
    finish within TIMEOUT_S (it is killed then)."""
    if n_devices < 2:
        raise ValueError(f"the dryrun's pipeline needs at least 2 processes, got {n_devices}")
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"need {n_devices} CUDA devices, {torch.cuda.device_count()} visible")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    path = os.pathsep.join(p for p in (str(_ROOT), os.environ.get("PYTHONPATH", "")) if p)
    env = dict(os.environ, PYTHONPATH=path)
    if dev.type == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    with tempfile.TemporaryDirectory(prefix="dryrun-") as out:
        procs = []
        try:
            for rank in range(n_devices):
                with open(Path(out, f"{rank}.log"), "w") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "tpudra_torch.workload.entry", "--rank", str(rank),
                         str(n_devices), str(port), dev.type, out],
                        env=env, stdout=log, stderr=subprocess.STDOUT,
                    ))
            deadline = time.monotonic() + TIMEOUT_S
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"the dryrun over {n_devices} processes did not finish "
                               f"in {TIMEOUT_S} s") from None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        results = []
        for rank in range(n_devices):
            f, log = Path(out, f"{rank}.json"), Path(out, f"{rank}.log").read_text()
            if not f.exists():
                raise RuntimeError(f"dryrun rank {rank} wrote no result:\n{log}")
            status, value = json.loads(f.read_text())
            if status != "ok":
                raise RuntimeError(f"dryrun rank {rank} failed:\n{value}")
            results.append(value)
    return results[0]


# -- one rank of the dryrun --------------------------------------------------


def _on(mesh) -> bool:
    """Whether this rank is in ``mesh`` (a mesh over the world's first
    ranks: the others sit the check out)."""
    return mesh.get_coordinate() is not None


def _params(cfg, seed: int, device):
    """init_params from a CPU generator (the same on every rank), moved."""
    from tpudra_torch.workload import model as m
    from tpudra_torch.workload.convert import tree_map

    params = m.init_params(torch.Generator().manual_seed(seed), cfg, device="cpu")
    return tree_map(lambda p: p.to(device), params)


def _tokens(shape, vocab: int, seed: int, device):
    return torch.randint(0, vocab, shape, generator=torch.Generator().manual_seed(seed)).to(device)


def _finite(name: str, *tensors) -> None:
    for t in tensors:
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite {name}")


def _check_train_step(n: int, device) -> dict:
    """The full train step sharded over a (dp, sp, tp) mesh of every rank."""
    from tpudra_torch.workload import model as m

    dp, sp, tp = factor_devices(n, 3)
    mesh = mesh_from_devices(("dp", "sp", "tp"), (dp, sp, tp), device)
    # Tiny shapes, but every sharded dim divisible by its mesh dim.
    cfg = m.ModelConfig(vocab=64, d_model=8 * tp, n_heads=max(tp, 2), n_layers=2, d_ff=16 * tp,
                        max_seq=4 * sp)
    dparams = m.shard_params(_params(cfg, 0, device), mesh, cfg)
    dtokens = m.shard_batch(_tokens((2 * dp, cfg.max_seq), cfg.vocab, 1, device), mesh)
    init, step = m.make_sharded_train_step(cfg, mesh)
    _, _, loss = step(dparams, init(dparams), dtokens)
    _finite("loss", loss)
    return {"mesh": [dp, sp, tp], "loss": float(loss)}


def _check_pipeline(n: int, device) -> dict:
    """The gradient of the pipelined loss over a (pp, dp) mesh."""
    from tpudra_torch.workload import model as m
    from tpudra_torch.workload.convert import tree_leaves
    from tpudra_torch.workload.pipeline import pipelined_value_and_grad, stage_params

    pp, dp = 2, max(1, n // 2 // 2)
    mesh = mesh_from_devices(("pp", "dp"), (pp, dp), device, n_ranks=pp * dp)
    if not _on(mesh):
        return {}
    cfg = m.ModelConfig(vocab=64, d_model=16, n_heads=2, n_layers=2 * pp, d_ff=32, max_seq=8)
    params = stage_params(_params(cfg, 2, device), mesh, cfg)
    tokens = _tokens((4 * dp, cfg.max_seq), cfg.vocab, 3, device)
    loss, grads = pipelined_value_and_grad(cfg, mesh, num_microbatches=4)(params, tokens)
    _finite("pipelined loss or grads", loss, *tree_leaves(grads))
    return {"mesh": [pp, dp], "loss": float(loss)}


def _check_moe(n: int, device) -> dict:
    """The Switch MoE FFN with its experts sharded over an ep mesh."""
    from tpudra_torch.workload.moe import MoEConfig, init_moe_params, moe_ffn, shard_moe_params

    ep = min(4, n)
    mesh = mesh_from_devices(("ep",), (ep,), device, n_ranks=ep)
    if not _on(mesh):
        return {}
    cfg = MoEConfig(d_model=16, d_ff=32, num_experts=ep)
    params = {k: v.to(device)
              for k, v in init_moe_params(torch.Generator().manual_seed(4), cfg, "cpu").items()}
    local = {k: v.to_local() for k, v in shard_moe_params(params, mesh).items()}
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator().manual_seed(5)).to(device)
    y, aux = moe_ffn(local, x, cfg, ep_group=mesh.get_group("ep"))
    _finite("moe output or aux", y, aux)
    return {"ep": ep, "aux": float(aux)}


def _check_combined(n: int, device) -> dict:
    """One dp × pp × tp(+ep) train step: the Switch-MoE model (experts over
    tp) pipelined over pp, against the unpipelined loss of the same model
    (capacity high enough that no token drops)."""
    from tpudra_torch.workload import model as m
    from tpudra_torch.workload.pipeline import make_pipelined_train_step, stage_params

    if n < 8:
        return {}
    mesh = mesh_from_devices(("pp", "dp", "tp"), (2, 2, 2), device, n_ranks=8)
    if not _on(mesh):
        return {}
    cfg = m.ModelConfig(vocab=64, d_model=32, n_heads=2, n_layers=4, d_ff=64, max_seq=16,
                        num_experts=2, moe_capacity_factor=8.0, moe_aux_weight=0.0,
                        compute_dtype="f32")
    full = _params(cfg, 6, device)
    tokens = _tokens((8, 16), cfg.vocab, 7, device)
    with torch.no_grad():
        dense = float(m.loss_fn(full, tokens, cfg))
    params = stage_params(full, mesh, cfg)
    init, step = make_pipelined_train_step(cfg, mesh, num_microbatches=4)
    _, _, loss = step(params, init(params), tokens)
    _finite("combined loss", loss)
    if not abs(float(loss) - dense) < 1e-3:
        raise AssertionError(f"combined 3D+ep loss {float(loss)} != dense {dense}")
    return {"loss": float(loss), "dense": dense}


def _check_ring(n: int, device) -> dict:
    """The flagship loss with ring attention over sp, sharded over a (dp,
    sp, tp) mesh: loss and every gradient finite."""
    from tpudra_torch.workload import model as m
    from tpudra_torch.workload.convert import tree_leaves
    from tpudra_torch.workload.ringattention import ring_value_and_grad

    if n < 8:
        return {}
    mesh = mesh_from_devices(("dp", "sp", "tp"), (2, 2, 2), device, n_ranks=8)
    if not _on(mesh):
        return {}
    cfg = m.ModelConfig(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq=16,
                        attention="naive", compute_dtype="f32")
    dparams = m.shard_params(_params(cfg, 8, device), mesh, cfg)
    dtokens = m.shard_batch(_tokens((4, 16), cfg.vocab, 9, device), mesh)
    loss, grads = ring_value_and_grad(cfg, mesh)(dparams, dtokens)
    # A finite loss with nan grads is what a broken -inf guard gives.
    _finite("ring loss or grads", loss, *tree_leaves(grads))
    return {"loss": float(loss)}


def _check_collectives(n: int, device) -> dict:
    from tpudra_torch.workload.collectives import verify_collectives

    verified = verify_collectives(mesh_from_devices(("data",), device=device), "data")
    if len(verified) != 5:
        raise AssertionError(verified)
    return {"verified": verified}


CHECKS = {"train_step": _check_train_step, "pipeline": _check_pipeline, "moe": _check_moe,
          "combined": _check_combined, "ring": _check_ring, "collectives": _check_collectives}


def _rank_main(rank: int, world: int, port: int, device_type: str, out: str) -> None:
    import torch.distributed as dist

    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank)
            device = torch.device("cuda", rank)
        else:
            device = torch.device("cpu")
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world)
        try:
            result = ("ok", {name: check(world, device) for name, check in CHECKS.items()})
        finally:
            dist.destroy_process_group()
    except Exception:
        result = ("error", traceback.format_exc())
    Path(out, f"{rank}.json").write_text(json.dumps(result))


def main(argv: list[str]) -> int:
    if argv[:1] == ["--rank"]:
        rank, world, port, device_type, out = argv[1:6]
        _rank_main(int(rank), int(world), int(port), device_type, out)
        return 0
    if not 1 <= len(argv) <= 2:
        print("usage: python -m tpudra_torch.workload.entry N [cpu|cuda]", file=sys.stderr)
        return 2
    print(json.dumps(dryrun_multichip(int(argv[0]), argv[1] if len(argv) > 1 else None)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
