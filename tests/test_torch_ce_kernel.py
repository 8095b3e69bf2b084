"""The port's fused CE head (tpudra_torch.workload.ce_kernel) against the
JAX package's (tpudra.workload.ce_kernel, Pallas in interpret mode) on the
same numpy inputs, loss and gradients; and, on a CUDA device only, the
hand-written kernel against its plain PyTorch version.

JAX is imported inside the reference fixture: a machine with a GPU but no
JAX runs this file's CUDA test alone (README, "PyTorch / CUDA port").
"""

import numpy as np
import pytest
import torch

from tpudra_torch.workload import ce_kernel

D = 32
# (N, V): one block, and sizes whose N and V divide no block (a flooring
# grid would drop the tail).
SIZES = [(13, 64), (600, 1664), (520, 384)]


def _inputs(N, V, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    emb = rng.standard_normal((V, D)).astype(np.float32)
    tgt = rng.integers(0, V, N).astype(np.int32)
    return x, emb, tgt


@pytest.fixture(scope="module")
def ref():
    """JAX loss and (dx, demb) per size, computed once."""
    import jax
    import jax.numpy as jnp

    from tpudra.workload.ce_kernel import fused_ce_mean as jax_fused_ce_mean

    out = {}
    for N, V in SIZES:
        x, emb, tgt = _inputs(N, V)
        t = jnp.asarray(tgt)
        vg = jax.jit(jax.value_and_grad(
            lambda a, b: jax_fused_ce_mean(a, b, t, interpret=True), argnums=(0, 1)))
        loss, (dx, demb) = vg(jnp.asarray(x), jnp.asarray(emb))
        out[(N, V)] = (float(loss), np.asarray(dx), np.asarray(demb))
    return out


def _port_loss_and_grads(x, emb, tgt, fn):
    xt = torch.from_numpy(x).requires_grad_()
    et = torch.from_numpy(emb).requires_grad_()
    loss = fn(xt, et, torch.from_numpy(tgt))
    loss.backward()
    return float(loss.detach()), xt.grad.numpy(), et.grad.numpy()


@pytest.mark.parametrize("N,V", SIZES)
def test_fused_ce_mean_and_grads_match_jax(ref, N, V):
    x, emb, tgt = _inputs(N, V)
    want_loss, want_dx, want_demb = ref[(N, V)]
    loss, dx, demb = _port_loss_and_grads(x, emb, tgt, ce_kernel.fused_ce_mean)
    # f32 on both sides; only the order of the sums differs.
    assert abs(loss - want_loss) <= 1e-4, (loss, want_loss)
    for got, want in ((dx, want_dx), (demb, want_demb)):
        assert got.dtype == np.float32 and got.shape == want.shape
        assert float(np.abs(got - want).max()) <= 1e-4 * float(np.abs(want).max())


def test_pad_rows_stay_out_of_the_sum(ref):
    """Rows past n_valid (a caller's padding) add nothing to the loss and
    get zero gradient; the mean divides by the true N."""
    N, V = 13, 64
    x, emb, tgt = _inputs(N, V)
    pad = 11
    rng = np.random.default_rng(7)
    xp = np.concatenate([x, 100.0 * rng.standard_normal((pad, D)).astype(np.float32)])
    tp = np.concatenate([tgt, rng.integers(0, V, pad).astype(np.int32)])
    loss, dx, demb = _port_loss_and_grads(
        xp, emb, tp, lambda a, b, t: ce_kernel.fused_ce_sum(a, b, t, N) / N)
    want_loss, want_dx, want_demb = ref[(N, V)]
    assert abs(loss - want_loss) <= 1e-4
    assert not dx[N:].any()
    assert float(np.abs(dx[:N] - want_dx).max()) <= 1e-4 * float(np.abs(want_dx).max())
    assert float(np.abs(demb - want_demb).max()) <= 1e-4 * float(np.abs(want_demb).max())


def test_non_cpu_tensor_never_takes_the_plain_version():
    """The plain version is for CPU tensors only; any other device reaches
    a kernel or raises (here: meta tensors, which no kernel takes)."""
    x = torch.empty(4, 8, dtype=torch.bfloat16, device="meta")
    e = torch.empty(16, 8, dtype=torch.bfloat16, device="meta")
    t = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ce_kernel.ce_fwd(x, e, t)


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    """The CUDA kernel against ce_fwd_plain on identical bf16 inputs, with
    ragged N and V.  Both accumulate in f32; only the order of the sums
    differs, hence 2e-3 absolute on values of order 10."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the ce_fwd kernel runs only on an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain f32 product in full f32
    gen = torch.Generator(device="cuda").manual_seed(0)
    N, V, Dk = 1000, 5000, 264
    x = torch.randn(N, Dk, generator=gen, device="cuda").to(torch.bfloat16)
    emb = (0.1 * torch.randn(V, Dk, generator=gen, device="cuda")).to(torch.bfloat16)
    tgt = torch.randint(0, V, (N,), generator=gen, device="cuda", dtype=torch.int32)
    before = ce_kernel.ce_fwd.launches
    lse, tlog = ce_kernel.ce_fwd(x, emb, tgt)
    torch.cuda.synchronize()
    assert ce_kernel.ce_fwd.launches == before + 1
    want_lse, want_tlog = ce_kernel.ce_fwd_plain(x, emb, tgt)
    assert float((lse - want_lse).abs().max()) <= 2e-3
    assert float((tlog - want_tlog).abs().max()) <= 2e-3
