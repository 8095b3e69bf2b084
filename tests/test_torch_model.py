"""Parity of the PyTorch port's train step (tpudra_torch.workload.model)
with the JAX package (tpudra.workload.model) on the same inputs.

Params and tokens are made with numpy from a seed and handed to both
frameworks.  The JAX side runs as its own tests run it on the CPU (the
Pallas kernels in interpret mode); the port runs on the CPU, where its
kernels take their plain PyTorch versions.  The JAX reference is computed
once per module.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpudra.workload import model as jm
from tpudra.workload.opt_kernel import fused_adamw as jax_fused_adamw
from tpudra_torch.workload import model as tm
from tpudra_torch.workload.convert import params_from_numpy, params_to_numpy

from torch_gloo import numpy_params

KW = dict(vocab=128, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq=32)
BATCH = 3
LR = 1e-3

# name -> (ce_impl, opt_impl, compute_dtype, also take one optimizer step)
CASES = {
    "fused_f32": ("fused", "fused", "f32", True),
    "fused_bf16": ("fused", "fused", "bf16", False),
    "chunked_f32": ("chunked", "tree", "f32", True),
}


def _numpy_params(seed=0):
    """The init_params tree (JAX layout) from numpy; norm scales are drawn
    around 1 so that a dropped scale would show."""
    return numpy_params(KW, seed)


def _tokens(seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, KW["vocab"], (BATCH, KW["max_seq"])).astype(np.int32)


def _flat(tree, prefix=""):
    """{"layers/w1": array, ...} for a nested dict of arrays."""
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(tree[k], dtype=np.float32)
    return out


@pytest.fixture(scope="module")
def ref():
    """JAX loss, grads and (where asked) params after one AdamW step, per
    case.  The step is what jm.make_train_step's step does: value_and_grad,
    then the optimizer (fused apply, or tree update plus p + u)."""
    params_np, tokens = _numpy_params(), _tokens()
    out = {}
    for name, (ce, opt, dtype, step) in CASES.items():
        cfg = jm.ModelConfig(**KW, attention="naive", ce_impl=ce, opt_impl=opt,
                             compute_dtype=dtype)
        params = jax.tree.map(jnp.asarray, params_np)
        vg = jax.jit(jax.value_and_grad(jm.loss_fn), static_argnums=2)
        loss, grads = vg(params, jnp.asarray(tokens), cfg)
        stepped = None
        if step and opt == "fused":
            finit, fapply = jax_fused_adamw(LR)
            stepped, _ = jax.jit(fapply)(params, grads, finit(params))
        elif step:
            init, update = jm.adamw_bf16_moments(LR)
            updates, _ = jax.jit(update)(grads, init(params), params)
            stepped = jax.tree.map(lambda p, u: p + u, params, updates)
        out[name] = {
            "loss": float(loss),
            "grads": _flat(grads),
            "params": _flat(stepped) if stepped is not None else None,
        }
    return params_np, tokens, out


def _port(name, params_np, tokens, **over):
    """The port's loss, grads and params after one make_train_step step."""
    ce, opt, dtype, _ = CASES[name]
    cfg = tm.ModelConfig(**KW, attention="naive", ce_impl=ce, opt_impl=opt,
                         compute_dtype=dtype, **over)
    params = params_from_numpy(params_np, device="cpu")
    toks = torch.from_numpy(tokens)
    loss, grads = tm.value_and_grad(tm.loss_fn)(params, toks, cfg)
    init, step = tm.make_train_step(cfg, LR)
    params, _, step_loss = step(params, init(params), toks)
    assert float(step_loss) == float(loss)
    return float(loss), _flat(params_to_numpy(grads)), _flat(params_to_numpy(params))


def _assert_grads_close(got, want, rel):
    assert got.keys() == want.keys()
    for k in want:
        scale = float(np.abs(want[k]).max())
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= rel * scale, (k, err, scale)


@pytest.mark.parametrize("name", ["fused_f32", "chunked_f32"])
def test_f32_loss_grads_and_step_match_jax(ref, name):
    params_np, tokens, out = ref
    want = out[name]
    loss, grads, stepped = _port(name, params_np, tokens)
    assert abs(loss - want["loss"]) <= 1e-5, (loss, want["loss"])
    # Each grad leaf within 1e-4 of its own max |g|: f32 throughout, only
    # the order of the sums differs.
    _assert_grads_close(grads, want["grads"], 1e-4)
    # After one step at lr 1e-3.  A moment whose f32 value sits at a bf16
    # rounding boundary can round to the neighbouring bf16 value in one
    # framework (its grad differs in the last bits), which moves that
    # element by up to ~lr/2^8; 2e-5 leaves room for that and no more.
    for k, w in want["params"].items():
        err = float(np.abs(stepped[k] - w).max())
        assert err <= 2e-5, (k, err)


def test_bf16_loss_and_grads_match_jax(ref):
    params_np, tokens, out = ref
    want = out["fused_bf16"]
    loss, grads, _ = _port("fused_bf16", params_np, tokens)
    # bf16 rounds at different places in XLA and PyTorch (fusion decides
    # where an intermediate is materialised), hence the loose bounds.
    assert abs(loss - want["loss"]) <= 2e-2, (loss, want["loss"])
    _assert_grads_close(grads, want["grads"], 5e-2)


def test_remat_modes_agree(ref):
    """Remat trades memory for recompute and never changes the math: the
    three modes give the JAX loss and the same grads."""
    params_np, tokens, out = ref
    results = {r: _port("fused_f32", params_np, tokens, remat=r) for r in ("none", "full", "dots")}
    for r, (loss, grads, _) in results.items():
        assert abs(loss - out["fused_f32"]["loss"]) <= 1e-5, (r, loss)
        _assert_grads_close(grads, results["none"][1], 1e-6)


def test_forward_logits_match_jax(ref):
    params_np, tokens, _ = ref
    jcfg = jm.ModelConfig(**KW, attention="naive", compute_dtype="f32")
    want = np.asarray(jax.jit(jm.forward, static_argnums=2)(
        jax.tree.map(jnp.asarray, params_np), jnp.asarray(tokens), jcfg))
    tcfg = tm.ModelConfig(**KW, attention="naive", compute_dtype="f32")
    got = tm.forward(params_from_numpy(params_np, device="cpu"), torch.from_numpy(tokens), tcfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float(np.abs(got.numpy() - want).max()) <= 1e-4


def test_train_step_reduces_loss():
    """Default config (remat "dots", chunked head, tree AdamW) learns."""
    cfg = tm.ModelConfig(vocab=32, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq=16)
    gen = torch.Generator().manual_seed(0)
    params = tm.init_params(gen, cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (4, cfg.max_seq), generator=gen)
    init, step = tm.make_train_step(cfg, learning_rate=1e-2)
    state = init(params)
    losses = []
    for _ in range(5):
        params, state, loss = step(params, state, tokens)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses


def test_config_validation_matches_jax():
    for bad in (dict(remat="sometimes"), dict(ce_impl="magic"), dict(opt_impl="x"),
                dict(attention="ring"), dict(compute_dtype="f16"), dict(num_experts=-1),
                dict(d_model=30, n_heads=4), dict(attn_block_q=100)):
        with pytest.raises(ValueError):
            jm.ModelConfig(**bad)
        with pytest.raises(ValueError):
            tm.ModelConfig(**bad)
    assert tm.ModelConfig().head_dim == jm.ModelConfig().head_dim
    assert tm.ModelConfig(compute_dtype="f32").act_dtype == torch.float32


def test_unported_paths_raise_with_their_roadmap_item():
    """Every path of the model that once raised NotImplementedError with its
    ROADMAP item is ported now: the attention kernel paths
    (tests/test_torch_attention.py), MoE (tests/test_torch_moe.py) and the
    tensor-parallel layout (tests/test_torch_parallel.py) build."""
    gen = torch.Generator()
    for kw in (dict(attention="flash"), dict(attention="splash")):
        assert tm.init_params(gen, tm.ModelConfig(**kw), device="cpu")["layers"]["wqkv"].ndim == 4
    moe = tm.ModelConfig(num_experts=4)
    assert tm.init_params(gen, moe, device="cpu")["layers"]["w1"].shape == (2, 4, 128, 256)
    assert tm.param_specs(moe)["layers"]["w1"][2].dim == 1
    assert len(tm.batch_spec()) == 3
