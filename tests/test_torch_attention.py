"""The port's causal flash attention (tpudra_torch.workload.attn_kernel) and
the port's model with ``attention="splash"``, against the JAX package's
splash path on the same numpy inputs; and, on a CUDA device only, the
hand-written kernels against their plain PyTorch versions.

The JAX side runs jax's splash kernel in interpret mode, built as
``tpudra/workload/model.py::_layer`` builds it (``interpret=True`` is the
only addition); the port runs on the CPU, where the kernels take their plain
versions.  The JAX references are computed once per module.  JAX is
imported inside the fixtures: a machine with a GPU but no JAX runs this
file's CUDA tests alone (README, "PyTorch / CUDA port").
"""

import numpy as np
import pytest
import torch

from tpudra_torch.workload import attn_kernel
from tpudra_torch.workload import model as tm
from tpudra_torch.workload.convert import params_from_numpy, params_to_numpy

# [B, H, S, hd]: two heads of width 64 over two 128-blocks, and width 128.
CORE_SHAPES = [(2, 2, 256, 64), (1, 2, 128, 128)]
# (o and lse within TOL[0] of their max, each grad within TOL[1] of its
# max).  f32: only the order of the sums differs.  bf16: the two frameworks
# round at other places (splash rounds its f32 probabilities' product
# inputs, the plain version keeps f32 to the end).
TOL = {"f32": (2e-5, 1e-4), "bf16": (2e-2, 5e-2)}
KW = dict(vocab=256, d_model=128, n_heads=2, n_layers=2, d_ff=256, max_seq=128)
BATCH = 2


def _splash(H, S, save_residuals=False):
    """jax's splash kernel as tpudra/workload/model.py:277-287 builds it."""
    from jax.experimental.pallas.ops.tpu.splash_attention import (
        splash_attention_kernel as _sk,
        splash_attention_mask as _sm,
    )

    mask = _sm.MultiHeadMask([_sm.CausalMask((S, S)) for _ in range(H)])
    blk = min(1024, S)
    blocks = _sk.BlockSizes(
        block_q=blk, block_kv=blk, block_q_dkv=blk, block_kv_dkv=blk,
        use_fused_bwd_kernel=True,
    )
    return _sk.make_splash_mha(
        mask=mask, head_shards=1, q_seq_shards=1, block_sizes=blocks,
        save_residuals=save_residuals, interpret=True,
    )


def _core_inputs(shape, seed=0):
    """q (already scaled by hd^-½, as _layer hands it over), k, v and the
    output cotangent do, f32."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    return q * np.float32(shape[-1] ** -0.5), k, v, do


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


@pytest.fixture(scope="module")
def core_ref():
    """Splash's (o, lse) and (dq, dk, dv) per shape and dtype, as f32 numpy."""
    import jax
    import jax.numpy as jnp

    out = {}
    for shape in CORE_SHAPES:
        B, H, S, hd = shape
        for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
            q, k, v, do = (jnp.asarray(a).astype(dt) for a in _core_inputs(shape))
            o, (lse,) = jax.jit(jax.vmap(_splash(H, S, save_residuals=True)))(q, k, v)
            _, vjp = jax.vjp(jax.vmap(_splash(H, S)), q, k, v)
            grads = vjp(do)
            out[shape, name] = [np.asarray(a.astype(jnp.float32)) for a in (o, lse, *grads)]
    return out


def _port_core(shape, dtype):
    """The port's (o, lse, dq, dk, dv) on the CPU, as f32 numpy."""
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in _core_inputs(shape))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o, lse = attn_kernel.flash_attention(q, k, v, save_residuals=True)
    assert o.dtype == dtype and lse.dtype == torch.float32 and lse.shape == shape[:3]
    o.backward(do)
    return [t.detach().float().numpy() for t in (o, lse, q.grad, k.grad, v.grad)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", CORE_SHAPES)
def test_core_matches_splash(core_ref, shape, dtype):
    """o, lse (splash's save_residuals form) and dq, dk, dv through splash's
    fused backward."""
    got = _port_core(shape, torch.float32 if dtype == "f32" else torch.bfloat16)
    want = core_ref[shape, dtype]
    fwd_tol, grad_tol = TOL[dtype]
    for name, g, w in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        tol = fwd_tol if name in ("o", "lse") else grad_tol
        assert _rel_err(g, w) <= tol, (name, _rel_err(g, w))


@pytest.mark.parametrize("shape", CORE_SHAPES)
def test_core_matches_dense_reference(shape):
    """The core against ringattention.dense_reference ([B, S, H, hd] layout,
    unscaled q, -inf mask), f32."""
    from tpudra.workload.ringattention import dense_reference

    q, k, v, _ = _core_inputs(shape)
    q_unscaled = q / np.float32(shape[-1] ** -0.5)
    bshd = lambda a: np.ascontiguousarray(a.transpose(0, 2, 1, 3))  # noqa: E731
    want = np.asarray(dense_reference(bshd(q_unscaled), bshd(k), bshd(v)))
    got = attn_kernel.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert _rel_err(bshd(got.numpy()), want) <= TOL["f32"][0]


def _numpy_params(seed=0, **kw):
    """The init_params tree (JAX layout) from numpy; norm scales drawn
    around 1 so a dropped scale would show."""
    c = {**KW, **kw}
    rng = np.random.default_rng(seed)
    L, D, F, V, S, H = (c[n] for n in ("n_layers", "d_model", "d_ff", "vocab", "max_seq", "n_heads"))
    hd = D // H

    def dense(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def norm(shape):
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)

    return {
        "embed": dense((V, D), 0.02),
        "pos": dense((S, D), 0.02),
        "layers": {
            "wqkv": dense((L, D, H, 3 * hd), D ** -0.5),
            "wo": dense((L, H, hd, D), D ** -0.5),
            "w1": dense((L, D, F), D ** -0.5),
            "w2": dense((L, F, D), F ** -0.5),
            "ln1": norm((L, D)),
            "ln2": norm((L, D)),
        },
        "ln_f": norm((D,)),
    }


def test_layer_matches_the_jax_naive_branch():
    """One decoder block, the port with attention="splash" against the JAX
    package's naive branch (model.py:293-297) on the same x and params, f32."""
    import jax
    import jax.numpy as jnp

    from tpudra.workload import model as jm

    params = _numpy_params(n_layers=1)
    layer = {k: v[0] for k, v in params["layers"].items()}
    x = np.random.default_rng(2).standard_normal((BATCH, KW["max_seq"], KW["d_model"]))
    x = x.astype(np.float32)
    jcfg = jm.ModelConfig(**{**KW, "n_layers": 1}, attention="naive", compute_dtype="f32")
    want, _ = jax.jit(lambda a, p: jm._layer(jcfg, a, p))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, layer))
    tcfg = tm.ModelConfig(**{**KW, "n_layers": 1}, attention="splash", compute_dtype="f32")
    got, _ = tm._layer(tcfg, torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in layer.items()})
    assert _rel_err(got.numpy(), np.asarray(want)) <= 1e-5


def _tokens(seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, KW["vocab"], (BATCH, KW["max_seq"])).astype(np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(tree[k], dtype=np.float32)
    return out


@pytest.fixture(scope="module")
def model_ref():
    """JAX loss and grads of the whole model with splash (interpret mode) as
    the attention core, built as _layer's splash branch calls it, per dtype."""
    import jax
    import jax.numpy as jnp

    from tpudra.workload import model as jm

    H, S = KW["n_heads"], KW["max_seq"]
    hd = KW["d_model"] // H
    kernel = _splash(H, S)

    def splash_core(q, k, v):  # model.py:288
        return jax.vmap(kernel)(q * (hd ** -0.5), k, v)

    params = jax.tree.map(jnp.asarray, _numpy_params())
    out = {}
    for dtype in ("f32", "bf16"):
        cfg = jm.ModelConfig(**KW, compute_dtype=dtype)
        vg = jax.jit(jax.value_and_grad(
            lambda p, t: jm.loss_fn(p, t, cfg, attn_fn=splash_core)))  # noqa: B023
        loss, grads = vg(params, jnp.asarray(_tokens()))
        out[dtype] = (float(loss), _flat(grads))
    return out


def _port_loss_and_grads(dtype, remat="dots"):
    cfg = tm.ModelConfig(**KW, attention="splash", compute_dtype=dtype, remat=remat)
    params = params_from_numpy(_numpy_params(), device="cpu")
    loss, grads = tm.value_and_grad(tm.loss_fn)(params, torch.from_numpy(_tokens()), cfg)
    return float(loss), _flat(params_to_numpy(grads))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_model_with_splash_matches_jax(model_ref, dtype):
    """Loss and every grad leaf of the whole model, attention="splash" in the
    port against the JAX model through splash."""
    want_loss, want_grads = model_ref[dtype]
    loss, grads = _port_loss_and_grads(dtype)
    loss_tol = 1e-5 if dtype == "f32" else 2e-2
    assert abs(loss - want_loss) <= loss_tol, (loss, want_loss)
    assert grads.keys() == want_grads.keys()
    for k in want_grads:
        assert _rel_err(grads[k], want_grads[k]) <= TOL[dtype][1], (k, _rel_err(grads[k], want_grads[k]))


def test_remat_modes_agree_and_recompute_the_core(monkeypatch):
    """Remat changes what is recomputed, never the math.  The attention core
    is no aten.mm, so "dots" recomputes it like "full": 2 forward calls per
    layer against 1 under "none", and 1 backward call per layer in all."""
    calls = {"fwd": 0, "bwd": 0}

    def counted(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(attn_kernel, "attn_fwd_plain", counted("fwd", attn_kernel.attn_fwd_plain))
    monkeypatch.setattr(attn_kernel, "attn_bwd_plain", counted("bwd", attn_kernel.attn_bwd_plain))
    L = KW["n_layers"]
    results = {}
    for remat, fwd_calls in (("none", L), ("full", 2 * L), ("dots", 2 * L)):
        calls.update(fwd=0, bwd=0)
        results[remat] = _port_loss_and_grads("f32", remat)
        assert calls == {"fwd": fwd_calls, "bwd": L}, (remat, calls)
    for remat, (loss, grads) in results.items():
        assert loss == results["none"][0], remat
        for k, g in grads.items():
            assert _rel_err(g, results["none"][1][k]) <= 1e-6, (remat, k)


def test_auto_attention_selection(monkeypatch):
    """"auto" is naive off CUDA at any length (the twin of the JAX
    package's test_auto_is_naive_on_cpu_and_short_seq); on one CUDA device
    it takes the kernels for bf16 and head width 64 or 128 only."""
    cfg = tm.ModelConfig(max_seq=1024)
    assert not cfg.use_flash_attention(1024, torch.device("cpu"))
    assert not cfg.use_flash_attention(8192, torch.device("cpu"))
    assert tm.ModelConfig(attention="flash").use_flash_attention(128, torch.device("cpu"))
    assert tm.ModelConfig(attention="splash").use_flash_attention(100, torch.device("cpu"))
    assert not tm.ModelConfig(attention="naive").use_flash_attention(128, torch.device("cuda"))

    cuda = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tm.ModelConfig(d_model=256, n_heads=2).use_flash_attention(1000, cuda)
    assert tm.ModelConfig(d_model=256, n_heads=4).use_flash_attention(1024, cuda)
    assert not tm.ModelConfig(d_model=256, n_heads=8).use_flash_attention(1024, cuda)  # hd 32
    assert not tm.ModelConfig(d_model=256, n_heads=2, compute_dtype="f32").use_flash_attention(
        1024, cuda)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert not tm.ModelConfig(d_model=256, n_heads=2).use_flash_attention(1024, cuda)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """The plain versions are for CPU tensors only; any other device reaches
    a kernel or raises (here: meta tensors, which no kernel takes)."""
    q = torch.empty(1, 2, 64, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        attn_kernel.attn_fwd(q, q, q)
    lse = torch.empty(1, 2, 64, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        attn_kernel.attn_bwd(q, q, q, q, lse, q)


def _bf16_inputs(shape, device="cpu", seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(shape, generator=gen, device=device) * shape[-1] ** -0.5
    k, v, do = (torch.randn(shape, generator=gen, device=device) for _ in range(3))
    return [t.to(torch.bfloat16) for t in (q, k, v, do)]


def _rounded_like_the_kernels(q, k, v, o, lse, do):
    """The plain math with the kernels' one departure from it: P, and dS,
    rounded to bf16 where they feed a product (row sums from f32 P).  The
    forward's o, then the backward's grads from the given (o, lse), as the
    card check hands the plain forward's to both backwards."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    S = q.shape[-2]
    s = (qf @ kf.mT).masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), float("-inf"))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    o_r = (e.bfloat16().float() @ vf / e.sum(-1, keepdim=True)).bfloat16()
    p = torch.exp(s - lse[..., None])
    ds = ((dof @ vf.mT - (o.float() * dof).sum(-1, keepdim=True)) * p).bfloat16().float()
    grads = (ds @ kf, ds.mT @ qf, p.bfloat16().float().mT @ dof)
    return (o_r, *(g.bfloat16() for g in grads))


def test_card_check_passes_rounding_and_rejects_a_skipped_tile():
    """The check chip_smoke.py holds the kernels to on the card (every row
    within ATTN_TOL of its norm, attn_kernel.max_row_err), at the flagship
    S and hd on two heads: the kernels' bf16 rounding passes it with room,
    and the result of a kernel that skips one tile (chip_smoke.skipped_tile)
    fails it by far, on o, dq, dk and dv.  Held to each tensor's max |value|
    instead, the skipped tile would come within 2x of the tolerance on dv."""
    import chip_smoke

    q, k, v, do = _bf16_inputs((1, 2, 1024, 128))
    o, lse = attn_kernel.attn_fwd_plain(q, k, v)
    want = (o, *attn_kernel.attn_bwd_plain(q, k, v, o, lse, do))
    rounded = _rounded_like_the_kernels(q, k, v, o, lse, do)
    for name, r, w in zip(("o", "dq", "dk", "dv"), rounded, want):
        assert attn_kernel.max_row_err(r, w) <= chip_smoke.ATTN_TOL / 2, name
    bad = chip_smoke.skipped_tile(torch, q, k, v, o, lse, do)
    for name, b, w in zip(("o", "dq", "dk", "dv"), bad, want):
        assert attn_kernel.max_row_err(b, w) > 10 * chip_smoke.ATTN_TOL, name
    assert _rel_err(bad[3].float(), want[3].float()) < 2 * chip_smoke.ATTN_TOL


# The flagship head width at a ragged S, width 64 over several tiles, a
# sequence shorter than one tile, the long8192 step's S, one query, and one
# query past a whole tile; then, at the backward's tile edges with three
# heads or more (a tile read past S would meet the next head's rows): S of
# one 64-row tile, one row past three, one row short of two 128-row tiles.
CUDA_SHAPES = [(2, 4, 1000, 128), (1, 3, 384, 64), (1, 1, 77, 64), (1, 2, 8192, 128),
               (1, 2, 1, 128), (1, 2, 129, 128), (3, 2, 64, 128), (3, 2, 193, 64),
               (2, 3, 255, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_kernels_match_plain_on_cuda(shape):
    """attn_fwd and attn_bwd against their plain versions on identical bf16
    inputs.  The kernels round P (and dS) to bf16 where they feed a product,
    the plain versions keep f32: every row of o and the grads within 2e-2 of
    that row's norm; lse, an f32 sum of exact bf16 products, within 1e-3
    absolute."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the attention kernels run only on an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do = _bf16_inputs(shape, device="cuda")
    before = (attn_kernel.attn_fwd.launches, attn_kernel.attn_bwd.launches)
    o, lse = attn_kernel.attn_fwd(q, k, v)
    grads = attn_kernel.attn_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert (attn_kernel.attn_fwd.launches, attn_kernel.attn_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want_o, want_lse = attn_kernel.attn_fwd_plain(q, k, v)
    assert attn_kernel.max_row_err(o, want_o) <= 2e-2
    assert float((lse - want_lse).abs().max()) <= 1e-3
    # The backward from the plain forward's (o, lse), so it is held alone.
    want = attn_kernel.attn_bwd_plain(q, k, v, want_o, want_lse, do)
    got = attn_kernel.attn_bwd(q, k, v, want_o, want_lse, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if not w.float().any():
            # dq of a single query is 0 (its one probability is 1, so
            # ds = do·v − rowsum(o·do) = 0): no row norm to hold it to, only
            # the rounding of that difference.
            assert float(g.float().abs().max()) <= 1e-4, name
            continue
        assert attn_kernel.max_row_err(g, w) <= 2e-2, (name, attn_kernel.max_row_err(g, w))
    # Deterministic: no atomics, so a second run repeats bit for bit.
    again = attn_kernel.attn_bwd(q, k, v, want_o, want_lse, do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the attention kernels run only on an NVIDIA GPU")
    q, k, v, _ = _bf16_inputs((1, 2, 64, 64), device="cuda")
    with pytest.raises(TypeError):
        attn_kernel.attn_fwd(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="head_dim"):
        attn_kernel.attn_fwd(q[..., :32].contiguous(), k[..., :32].contiguous(), v[..., :32].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        attn_kernel.attn_fwd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
