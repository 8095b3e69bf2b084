"""The port's GPipe pipeline (tpudra_torch.workload.pipeline) on a world of 8
gloo processes against the JAX package's pipeline on the same mesh of its
8-device CPU mesh: the twins of tests/test_workload.py
TestPipelineParallel (:371) and test_moe_pipelines_with_per_microbatch_aux
(:616), and of the combined dp × pp × tp(+ep) program (:392).

The same params and tokens, made with numpy from a seed, go through both,
in f32 (the JAX tests' configurations, cast to f32), so only the order of
sums differs: hidden states within 1e-5 of their largest value, the aux and
the loss within 1e-5 of themselves, each gradient leaf (gathered over pp and
tp) within 1e-4 of its own max |g|.  The world runs once per module
(torch_gloo.run_world, killed past its timeout)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from tpudra.workload import jaxcompat
from tpudra.workload import model as jm
from tpudra.workload.pipeline import pipelined_backbone, pipelined_loss_fn

import torch_gloo

WORLD = 8
_GAP = jaxcompat.missing_capability("shard_map-partial-manual")
partial_manual = pytest.mark.skipif(_GAP is not None, reason=_GAP or "")


@pytest.fixture(scope="module")
def ranks():
    return torch_gloo.values(torch_gloo.run_world("pipeline", WORLD))


def _jax_pipeline(name: str) -> dict:
    """JAX's pipelined_backbone (hidden states of the global batch, aux) and
    the value and gradients of pipelined_loss_fn, on the case's mesh."""
    kw, axes, shape, batch, M = torch_gloo.PIPE_CASES[name]
    cfg = jm.ModelConfig(**kw)
    params = jax.tree.map(jnp.asarray, torch_gloo.numpy_params(kw))
    tokens = jnp.asarray(torch_gloo.numpy_tokens(kw, batch=batch).astype(np.int32))
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), axes)
    x, aux = jax.jit(lambda p, t: pipelined_backbone(p, t, cfg, mesh, M))(params, tokens)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: pipelined_loss_fn(p, t, cfg, mesh, M)))(params, tokens)
    return {"x": np.asarray(x), "aux": float(aux), "loss": float(loss), "M": M,
            "dp": dict(zip(axes, shape))["dp"],
            "grads": {k: np.asarray(v) for k, v in torch_gloo._flat(grads).items()}}


def _check(ranks, name: str) -> None:
    want = _jax_pipeline(name)
    got_ranks = [r[name] for r in ranks if name in r]
    assert len(got_ranks) == int(np.prod(torch_gloo.PIPE_CASES[name][2]))
    B, S, D = want["x"].shape
    M, dp = want["M"], want["dp"]
    mb = B // M // dp
    for got in got_ranks:
        # This dp rank's rows of each microbatch, in microbatch order.
        rows = [m * (B // M) + got["dp_rank"] * mb + i for m in range(M) for i in range(mb)]
        err = float(np.abs(got["x"] - want["x"][rows]).max()) / float(np.abs(want["x"]).max())
        assert err <= 1e-5, err
        assert abs(got["aux"] - want["aux"]) <= 1e-5 * max(abs(want["aux"]), 1e-30), (
            got["aux"], want["aux"])
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"]), (
            got["loss"], want["loss"])
        assert got["grads"].keys() == want["grads"].keys()
        for leaf, g in got["grads"].items():
            w = want["grads"][leaf]
            gerr = float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-30)
            assert gerr <= 1e-4, (leaf, gerr)


def test_backbone_loss_and_grads_match_jax(ranks):
    """(pp, dp) = (2, 2), 4 layers, 4 microbatches of 2 rows, 1 per dp
    rank: the dense aux is 0."""
    _check(ranks, "dense")
    assert all(r["dense"]["aux"] == 0.0 for r in ranks if "dense" in r)


def test_moe_pipelines_with_per_microbatch_aux(ranks):
    """The Switch-MoE model over (pp, dp) = (2, 1), 2 microbatches: each
    routes alone, and the aux is the per-microbatch average JAX gives."""
    _check(ranks, "moe")
    assert all(r["moe"]["aux"] > 0.0 for r in ranks if "moe" in r)


@partial_manual
def test_combined_3d_ep_matches_jax(ranks):
    """dp × pp × tp in one program over (2, 2, 2): the Megatron layout and
    the experts split over tp inside each stage, the aux weighted."""
    _check(ranks, "combined")


def test_mesh_validation_up_front(ranks):
    errors = ranks[0]["errors"]
    assert "no 'dp' axis" in errors["no_dp"], errors
    assert "no 'nope' axis" in errors["nope"], errors
    assert "does not split over" in errors["dp_split"], errors
    # dp_axis=None opts out of the dp checks: all rows on every rank.
    kw = torch_gloo.PIPE_DENSE
    assert ranks[0]["no_dp_shape"] == (8, kw["max_seq"], kw["d_model"])


def test_rejects_indivisible_shapes(ranks):
    errors = ranks[0]["errors"]
    assert "layers do not split into 3 stages" in errors["layers"], errors
    assert "does not split into 3 microbatches" in errors["microbatches"], errors
