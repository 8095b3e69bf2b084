"""The port's AdamW with bf16 moments (tpudra_torch.workload.opt_kernel's
fused sweep and model.adamw_bf16_moments' tree form) against the JAX
package's on the same numpy params and grads, over two chained steps; and,
on a CUDA device only, the Triton kernel against its plain version.

JAX is imported inside the reference function: a machine with a GPU but no
JAX runs this file's CUDA test alone (README, "PyTorch / CUDA port").
"""

import numpy as np
import pytest
import torch

from tpudra_torch.workload import model as tm
from tpudra_torch.workload import opt_kernel

LR = 1e-3
# A lane-aligned leaf and an odd-sized one (the Pallas version pads it).
SHAPES = {"w": (8, 1024), "odd": (3, 37)}


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}


PARAMS, GRADS = _tree(0), [_tree(1), _tree(2)]


def _bf16_bits(a):
    """bf16 values (as f32) → their 16-bit patterns."""
    return (np.asarray(a, np.float32).view(np.uint32) >> 16).astype(np.uint16)


def _jax_two_steps(impl):
    import jax
    import jax.numpy as jnp

    from tpudra.workload.model import adamw_bf16_moments as jax_adamw_tree
    from tpudra.workload.opt_kernel import fused_adamw as jax_fused_adamw

    params = jax.tree.map(jnp.asarray, PARAMS)
    if impl == "fused":
        init, apply = jax_fused_adamw(LR)
        state = init(params)
        for g in GRADS:
            params, state = apply(params, jax.tree.map(jnp.asarray, g), state)
    else:
        init, update = jax_adamw_tree(LR)
        state = init(params)
        for g in GRADS:
            u, state = update(jax.tree.map(jnp.asarray, g), state, params)
            params = jax.tree.map(lambda p, d: p + d, params, u)
    mu, nu, count = state
    as_np = lambda t: {k: np.asarray(v, np.float32) for k, v in t.items()}  # noqa: E731
    return as_np(params), as_np(mu), as_np(nu), int(count)


def _port_two_steps(impl):
    params = {k: torch.from_numpy(v.copy()) for k, v in PARAMS.items()}
    if impl == "fused":
        init, apply = opt_kernel.fused_adamw(LR)
        state = init(params)
        for g in GRADS:
            params, state = apply(params, {k: torch.from_numpy(v) for k, v in g.items()}, state)
    else:
        init, update = tm.adamw_bf16_moments(LR)
        state = init(params)
        for g in GRADS:
            u, state = update({k: torch.from_numpy(v) for k, v in g.items()}, state, params)
            params = {k: params[k] + u[k] for k in params}
    mu, nu, count = state
    as_np = lambda t: {k: v.float().numpy() for k, v in t.items()}  # noqa: E731
    return as_np(params), as_np(mu), as_np(nu), int(count)


@pytest.mark.parametrize("impl", ["fused", "tree"])
def test_two_steps_match_jax(impl):
    want_p, want_m, want_v, want_count = _jax_two_steps(impl)
    got_p, got_m, got_v, count = _port_two_steps(impl)
    assert count == want_count == 2
    for k in SHAPES:
        assert got_p[k].shape == SHAPES[k]
        # Moments: the same f32 arithmetic rounded to bf16 — bit-identical.
        assert np.array_equal(_bf16_bits(got_m[k]), _bf16_bits(want_m[k])), k
        assert np.array_equal(_bf16_bits(got_v[k]), _bf16_bits(want_v[k])), k
        assert float(np.abs(got_p[k] - want_p[k]).max()) <= 1e-6, k


def test_non_cpu_tensor_never_takes_the_plain_version():
    t = lambda dt: torch.empty(4, dtype=dt, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="no kernel"):
        opt_kernel.adamw_step(
            t(torch.float32), t(torch.float32), t(torch.bfloat16), t(torch.bfloat16),
            torch.empty(2, device="meta"), lr=LR, b1=0.9, b2=0.999, eps=1e-8, wd=1e-4,
        )


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    """The Triton sweep against adamw_step_plain on identical inputs of a
    ragged size: moments bit-identical (no FMA contraction, correctly
    rounded division and square root), params within 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the adamw_step kernel runs only on an NVIDIA GPU")
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = 3 * 1024 * 1024 + 37
    p = torch.randn(n, generator=gen, device="cuda")
    g = torch.randn(n, generator=gen, device="cuda")
    m = (0.1 * torch.randn(n, generator=gen, device="cuda")).to(torch.bfloat16)
    v = (0.01 * torch.rand(n, generator=gen, device="cuda")).to(torch.bfloat16)
    c12 = opt_kernel.bias_corrections(torch.full((), 3, dtype=torch.int32, device="cuda"), 0.9, 0.999)
    kw = dict(lr=LR, b1=0.9, b2=0.999, eps=1e-8, wd=1e-4)
    pk, mk, vk = p.clone(), m.clone(), v.clone()
    before = opt_kernel.adamw_step.launches
    opt_kernel.adamw_step(pk, g, mk, vk, c12, **kw)
    torch.cuda.synchronize()
    assert opt_kernel.adamw_step.launches == before + 1
    opt_kernel.adamw_step_plain(p, g, m, v, c12, **kw)
    assert torch.equal(mk.view(torch.int16), m.view(torch.int16))
    assert torch.equal(vk.view(torch.int16), v.view(torch.int16))
    assert float((pk - p).abs().max()) <= 1e-6
