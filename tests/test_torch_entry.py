"""The port's compile-check surface (tpudra_torch.workload.entry): the twin
of tests/test_workload.py test_graft_entry_contract (:278).

``entry()`` on the CPU, and ``dryrun_multichip`` on worlds of gloo
processes it starts itself, as the JAX dryrun runs on a virtual CPU mesh."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudra.workload import model as jm
from tpudra_torch.workload import model as tm
from tpudra_torch.workload.convert import params_to_numpy
from tpudra_torch.workload.entry import dryrun_multichip, entry

CHECKS = ("train_step", "pipeline", "moe", "combined", "ring", "collectives")


ENTRY = dict(vocab=256, d_model=128, n_heads=4, n_layers=2, d_ff=256, max_seq=64)


def test_entry_contract():
    """entry()'s forward is ``model.forward`` at the JAX entry's config, and
    its logits are JAX's on the same params and tokens: within 2e-2 in bf16
    (the two round the activations at different places; the logits reach
    about 1), and within 1e-5 with the same params in f32."""
    fn, args = entry(device="cpu")
    out = fn(*args)
    assert out.shape == (2, 32, 256) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
    params, tokens = args
    assert torch.equal(out, tm.forward(params, tokens, tm.ModelConfig(**ENTRY)))
    jparams = jax.tree.map(jnp.asarray, params_to_numpy(params))
    jtokens = jnp.asarray(tokens.numpy())
    for dtype, got, tol in (
        ("bf16", out, 2e-2),
        ("f32", tm.forward(params, tokens, tm.ModelConfig(**ENTRY, compute_dtype="f32")), 1e-5),
    ):
        want = np.asarray(jm.forward(jparams, jtokens, jm.ModelConfig(**ENTRY, compute_dtype=dtype)))
        assert float(np.abs(got.numpy() - want).max()) <= tol, dtype


def _check_dryrun(result: dict, n: int) -> None:
    assert tuple(result) == CHECKS
    for name in CHECKS:
        assert result[name], name  # rank 0 takes part in every check
    assert math.prod(result["train_step"]["mesh"]) == n
    combined = result["combined"]
    assert abs(combined["loss"] - combined["dense"]) < 1e-3, combined
    assert len(result["collectives"]["verified"]) == 5


def test_dryrun_multichip_8():
    """All six checks on 8 gloo processes (6–20 s on an 8-core box)."""
    _check_dryrun(dryrun_multichip(8, device="cpu"), 8)


@pytest.mark.slow
def test_dryrun_multichip_16():
    """16 processes: the (2, 2, 4) mesh gives each dp rank 2 rows over tp
    = 4, which the CE head shares raggedly.  Slow: 16 processes."""
    _check_dryrun(dryrun_multichip(16, device="cpu"), 16)


def test_dryrun_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="at least 2"):
        dryrun_multichip(1, device="cpu")
    # CUDA is the default: without enough cards it refuses before starting
    # any process.
    with pytest.raises(RuntimeError, match="CUDA device"):
        dryrun_multichip(max(2, torch.cuda.device_count() + 1))


def test_entry_refuses_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
