"""The port's fused CE head (tpudra_torch.workload.ce_kernel) against the
JAX package's (tpudra.workload.ce_kernel, Pallas in interpret mode) on the
same numpy inputs, loss and gradients; and, on a CUDA device only, the
hand-written kernel against its plain PyTorch version.  Also the chunked
head's chunk function (``CEChunk``): its exact three-plane split of the
cotangent, its dispatch, and its gradients against the upcast path.

JAX is imported inside the reference fixture: a machine with a GPU but no
JAX runs this file's CUDA test alone (README, "PyTorch / CUDA port").
"""

import numpy as np
import pytest
import torch

from tpudra_torch.workload import ce_kernel, model

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


def _softmax_cotangent(n, V, g, scale, seed=0):
    """(logits, lse, targets, d): d = g·(softmax(logits) − onehot) in f32,
    the chunked head's cotangent, at logits of standard deviation ``scale``."""
    gen = torch.Generator().manual_seed(seed)
    logits = scale * torch.randn(n, V, generator=gen)
    lse = torch.logsumexp(logits, dim=-1)
    targets = torch.randint(0, V, (n,), generator=gen)
    p = torch.exp(logits - lse[:, None])
    p[torch.arange(n), targets] -= 1.0
    return logits, lse, targets, p * torch.tensor(g)


@pytest.mark.parametrize("g", [1 / 81840, 1 / 98292, 1.0, 2.0**-40, 3.0e4])
@pytest.mark.parametrize("scale", [0.02, 1.0, 8.0])
def test_plain_split_is_exact(g, scale):
    """hi + mid + lo == d elementwise, with no rounding, over softmax-shaped
    cotangents (g = 1/81840 is the dense-s1024 step's 1/(80·1023)), wherever
    |d| ≥ 2⁻¹¹⁰; below, where lo would fall under bf16's subnormal step, the
    sum misses d by at most that step, 2⁻¹³⁴.  hi alone and hi + mid are not
    exact."""
    logits, lse, targets, d = _softmax_cotangent(64, 3000, g, scale)
    planes = ce_kernel.ce_split_plain(logits, lse, targets, torch.tensor(g))
    assert planes.dtype == torch.bfloat16 and planes.shape == (3, 64, 3000)
    exact, want = planes.double(), d.double()
    normal = want.abs() >= 2.0**-110
    assert normal.float().mean() > 0.5
    assert torch.equal(exact.sum(0)[normal], want[normal])
    assert float((exact.sum(0) - want).abs().max()) <= 2.0**-134
    assert not torch.equal(exact[:2].sum(0)[normal], want[normal])
    assert not torch.equal(exact[0][normal], want[normal])


def _upcast_chunk_sum(x, emb, targets):
    """The chunked head's chunk before CEChunk: the upcast product under
    autograd."""
    logits = ce_kernel.matmul_f32(x, emb.t())
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets[..., None].long())[..., 0]
    return (lse - tgt).sum()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_and_f32_take_the_upcast_path(dtype):
    """CPU tensors (and f32 operands anywhere) keep the upcast path bit for
    bit: same loss and gradients, no CEChunk node, no split launched."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 7, D, generator=gen).to(dtype).requires_grad_()
    emb = torch.randn(96, D, generator=gen).requires_grad_()
    tgt = torch.randint(0, 96, (2, 7), generator=gen)
    before = ce_kernel.ce_split.launches
    got = ce_kernel.ce_chunk_sum(x, emb.to(dtype), tgt)
    want = _upcast_chunk_sum(x, emb.to(dtype), tgt)
    assert "CEChunk" not in type(got.grad_fn).__name__
    assert torch.equal(got, want)
    for a, b in zip(torch.autograd.grad(got, (x, emb)), torch.autograd.grad(want, (x, emb))):
        assert torch.equal(a, b)
    assert ce_kernel.ce_split.launches == before


def _bf16_close(got, want):
    """Equal up to one rounding of a bf16 gradient: 2⁻⁷ of each element,
    or 2⁻¹⁶ of the largest where an element is near 0."""
    if not want.numel():
        return got.shape == want.shape
    tol = 2.0**-7 * want.abs() + 2.0**-16 * want.abs().max()
    return bool(((got - want).abs() <= tol).all())


# (batch, seq, ce_chunk): whole chunks only; two whole chunks and a ragged
# third; one ragged chunk; no rows (an empty tensor-parallel row share,
# [1, 0, D]).
CHUNKINGS = [(2, 32, 16), (3, 37, 16), (2, 5, 16), (1, 0, 16)]


def _plain_mm_f32(a, b, depth, acc=None):
    """ce_kernel._mm_f32 for CPU tensors, which have no f32-output bf16
    product: the same depth slices, each upcast and added into acc."""
    for k0 in range(0, a.shape[1], depth):
        part = a[:, k0:k0 + depth].float() @ b[k0:k0 + depth].float()
        acc = part if acc is None else acc.add_(part)
    return acc


@pytest.mark.parametrize("b,s,chunk", CHUNKINGS)
def test_chunk_function_matches_the_chunked_head_on_cpu(monkeypatch, b, s, chunk):
    """model._ce_sum with every chunk through CEChunk (its plain split, and
    its products cut in depth as on the card, each slice upcast) against the
    same head on the upcast path: the same loss, gradients equal up to one
    bf16 rounding, and an empty share still 0 with gradients reaching both
    inputs."""
    cfg = model.ModelConfig(vocab=300, d_model=D, ce_chunk=chunk)
    gen = torch.Generator().manual_seed(b * 100 + s)
    xs = torch.randn(b, s, D, generator=gen).to(torch.bfloat16)
    embed = 0.3 * torch.randn(cfg.vocab, D, generator=gen)
    targets = torch.randint(0, cfg.vocab, (b, s), generator=gen)

    def loss_and_grads():
        x, e = xs.clone().requires_grad_(), embed.clone().requires_grad_()
        loss = model._ce_sum(e, x, targets, cfg)
        return (loss, *torch.autograd.grad(loss, (x, e)))

    want = loss_and_grads()
    monkeypatch.setattr(ce_kernel, "_on_tensor_cores", lambda x, emb: True)
    monkeypatch.setattr(ce_kernel, "_mm_f32", _plain_mm_f32)
    # Depths that cut every product here into several slices.
    for name, depth in (("FWD_DEPTH", 12), ("SPLIT_COLS", 128), ("SPLIT_DEPTH", 10)):
        monkeypatch.setattr(ce_kernel, name, depth)
    before = ce_kernel.ce_split.launches
    got = loss_and_grads()
    assert ce_kernel.ce_split.launches == before  # the plain split on the CPU
    assert torch.allclose(got[0], want[0], rtol=1e-6, atol=0.0)
    for a, w in zip(got[1:], want[1:]):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert _bf16_close(a.float(), w.float())
    if not b * s:
        assert float(got[0].detach()) == 0.0 and not got[1].numel() and not got[2].any()


def _rel_err(got, want):
    return float((got.double() - want).norm() / want.norm())


@pytest.mark.cuda
def test_chunk_function_keeps_f32_precision_on_cuda():
    """At [4096, 2048] × [32768, 2048]: the chunk function's f32 logits are
    within 4× the error of the f32 upcast product (SIMT, TF32 off) against
    an f64 product, and bf16 logits are not; the Triton split equals its
    plain version bit for bit and sums to the f32 cotangent exactly; the
    chunk function's f32 dx and dE (before the cast) are within 4× the
    upcast product's error against f64; and two planted faults fail that
    tolerance: a bf16-rounded cotangent (hi alone, about 2⁻⁹) and a
    two-term split (hi + mid).  A product that reduced in bf16 would fail it
    as the first fault does.

    g = 1/98292 (12 rows of 8191) rounds to bf16 as a typical g does (1/81840
    lies within 1e-6 of a bf16 value, which would hide the first fault).
    Targets uniform, then all in the last vocab tile: there the target's
    large term enters the upcast product's sum last, so its own dx error is
    smallest and a two-term split shows in dx as well as in dE."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the split pass and tensor-core products run only on an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False  # the upcast product in full f32
    N, Dk, V = 4096, 2048, 32768
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(N, Dk, generator=gen, device="cuda").to(torch.bfloat16)
    emb = (0.02 * torch.randn(V, Dk, generator=gen, device="cuda")).to(torch.bfloat16)
    logits = ce_kernel._mm_f32(x, emb.t(), ce_kernel.FWD_DEPTH)
    logits64 = x.double() @ emb.double().t()
    tol_logits = 4 * _rel_err(x.float() @ emb.float().t(), logits64)
    assert _rel_err(logits, logits64) <= tol_logits, (_rel_err(logits, logits64), tol_logits)
    assert _rel_err(logits.bfloat16(), logits64) > tol_logits  # the planted fault
    del logits64
    lse = torch.logsumexp(logits, dim=-1)
    g = torch.tensor(1 / 98292, device="cuda")
    for low in (0, V - 128):
        tgt = torch.randint(low, V, (N,), generator=gen, device="cuda")
        before = ce_kernel.ce_split.launches
        planes = ce_kernel.ce_split(logits, lse, tgt, g)
        torch.cuda.synchronize()
        assert ce_kernel.ce_split.launches == before + 1
        want = ce_kernel.ce_split_plain(logits, lse, tgt, g)
        assert torch.equal(planes.view(torch.int16), want.view(torch.int16))
        p = torch.exp(logits - lse[:, None])
        p[torch.arange(N, device="cuda"), tgt] -= 1.0
        d = p * g
        del p
        assert torch.equal(planes.double().sum(0), d.double())
        dx64, de64 = d.double() @ emb.double(), d.double().t() @ x.double()
        tol_dx = 4 * _rel_err(d @ emb.float(), dx64)
        tol_de = 4 * _rel_err(d.t() @ x.float(), de64)
        dx, de = ce_kernel.ce_chunk_grads(x, emb, tgt, logits, lse, g)
        assert _rel_err(dx, dx64) <= tol_dx and _rel_err(de, de64) <= tol_de, (
            _rel_err(dx, dx64), tol_dx, _rel_err(de, de64), tol_de)
        for k in (1, 2):  # the planted faults
            dx = torch.zeros_like(dx)
            de = torch.zeros_like(de)
            ce_kernel.planes_grads(planes[:k], x, emb, dx, de)
            assert _rel_err(dx, dx64) > tol_dx or _rel_err(de, de64) > tol_de, k
        del planes, want, d, dx64, de64, dx, de


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,chunk", CHUNKINGS)
def test_chunked_head_takes_the_split_on_cuda(monkeypatch, b, s, chunk):
    """model._ce_sum in bf16 on the card goes through CEChunk (the split
    launched once a chunk with rows) and agrees with the upcast path:
    loss within f32 rounding, gradients up to one bf16 rounding."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the split pass and tensor-core products run only on an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = model.ModelConfig(vocab=5000, d_model=256, ce_chunk=chunk)
    gen = torch.Generator(device="cuda").manual_seed(b * 100 + s)
    xs = torch.randn(b, s, 256, generator=gen, device="cuda").to(torch.bfloat16)
    embed = 0.05 * torch.randn(cfg.vocab, 256, generator=gen, device="cuda")
    targets = torch.randint(0, cfg.vocab, (b, s), generator=gen, device="cuda")

    def loss_and_grads():
        x, e = xs.clone().requires_grad_(), embed.clone().requires_grad_()
        loss = model._ce_sum(e, x, targets, cfg)
        return (loss, *torch.autograd.grad(loss, (x, e)))

    before = ce_kernel.ce_split.launches
    got = loss_and_grads()
    torch.cuda.synchronize()
    assert ce_kernel.ce_split.launches - before == -(-s // chunk)
    monkeypatch.setattr(ce_kernel, "_on_tensor_cores", lambda x, emb: False)
    want = loss_and_grads()
    assert torch.allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    for a, w in zip(got[1:], want[1:]):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert _bf16_close(a.float(), w.float())
