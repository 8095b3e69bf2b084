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


def _summed_like_the_kernel(x, emb, tgt):
    """The plain math in the kernel's order: f32 logits summed over 64-deep
    slices of D, a max and exp2 sum per 4096-column chunk, the chunks then
    combined in order."""
    xf, ef = x.float(), emb.float()
    logits = sum(xf[:, k:k + 64] @ ef[:, k:k + 64].T for k in range(0, x.shape[1], 64))
    chunks = logits.split(4096, dim=1)
    m = torch.stack([c.amax(1) for c in chunks])
    s = torch.stack([torch.exp2((c - mc[:, None]) * 1.4426950408889634).sum(1)
                     for c, mc in zip(chunks, m)])
    top = m.amax(0)
    lse = top + torch.log((s * torch.exp(m - top)).sum(0))
    return lse, logits.gather(1, tgt.long()[:, None])[:, 0]


def test_card_check_passes_rounding_and_rejects_dropped_work():
    """The check chip_smoke.py holds ce_fwd to on the card (lse and target
    logit within CE_TOL absolute of ce_fwd_plain), at the flagship D and V
    and the phase's input scales: the plain math summed in the kernel's
    order passes it with room, and the results of kernels that drop the
    last 128 vocab columns or one 64-deep slice of D (chip_smoke.ce_dropped)
    fail it, the first on every row's lse alone."""
    import chip_smoke

    N, D, V = 256, 2048, 32768
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(N, D, generator=gen).to(torch.bfloat16)
    emb = (0.02 * torch.randn(V, D, generator=gen)).to(torch.bfloat16)
    tgt = torch.randint(0, V, (N,), generator=gen, dtype=torch.int32)
    want = ce_kernel.ce_fwd_plain(x, emb, tgt)
    assert chip_smoke.ce_err(_summed_like_the_kernel(x, emb, tgt), want) <= chip_smoke.CE_TOL / 10
    bad = chip_smoke.ce_dropped(ce_kernel, x, emb, tgt)
    for name, got in bad.items():
        assert chip_smoke.ce_err(got, want) > chip_smoke.CE_TOL, name
    lse_shift = (bad["last 128 vocab columns dropped"][0] - want[0]).abs()
    assert float(lse_shift.min()) > chip_smoke.CE_TOL


# (N, V, D, targets in the last vocab tile): ragged N, V and D in one; N not
# a multiple of the 128-row tile with V below one 256-column tile; V not a
# multiple of the tile with a ragged last depth box (D = 264); several
# 4096-column chunks with a partial last one; and 17 row tiles (a partial
# last launch group of 16) at one depth slice.
CUDA_SIZES = [(1000, 5000, 264, False), (300, 100, 128, False), (129, 1000, 264, True),
              (1000, 9000, 256, True), (2100, 8192, 64, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("N,V,Dk,last_tile", CUDA_SIZES)
def test_kernel_matches_plain_on_cuda(N, V, Dk, last_tile):
    """The CUDA kernel against ce_fwd_plain on identical bf16 inputs, with
    ragged N, V and D.  Both accumulate in f32; only the order of the sums
    differs, hence 2e-3 absolute on values of order 10."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the ce_fwd kernel runs only on an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain f32 product in full f32
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(N, Dk, generator=gen, device="cuda").to(torch.bfloat16)
    emb = (0.1 * torch.randn(V, Dk, generator=gen, device="cuda")).to(torch.bfloat16)
    low = (V - 1) // 256 * 256 if last_tile else 0
    tgt = torch.randint(low, V, (N,), generator=gen, device="cuda", dtype=torch.int32)
    before = ce_kernel.ce_fwd.launches
    lse, tlog = ce_kernel.ce_fwd(x, emb, tgt)
    torch.cuda.synchronize()
    assert ce_kernel.ce_fwd.launches == before + 1
    want_lse, want_tlog = ce_kernel.ce_fwd_plain(x, emb, tgt)
    assert float((lse - want_lse).abs().max()) <= 2e-3
    assert float((tlog - want_tlog).abs().max()) <= 2e-3
