"""Parity of the port's Switch-MoE (tpudra_torch.workload.moe and the
num_experts branch of tpudra_torch.workload.model) with the JAX package on
the same inputs.

Params, x and tokens are made with numpy from a seed and handed to both
frameworks; the JAX side runs on the CPU as its own tests run it, the port
on the CPU with its kernels' plain versions.  f32 comparisons are tight
(only the order of sums differs); bf16 ones first assert that both route
every token to the same expert (a near-tie can flip an argmax when the
bf16 activations round differently), then compare with a loose bound.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tpudra.workload.moe as jmoe
from tpudra.workload import model as jm
from tpudra_torch.workload import model as tm
from tpudra_torch.workload import moe as tmoe
from tpudra_torch.workload.convert import params_from_numpy, params_to_numpy

from torch_gloo import MOE, numpy_params, numpy_tokens
from torch_gloo import _flat as _flat_tree

KW = {k: v for k, v in MOE.items() if k != "compute_dtype"}
LR = 1e-3


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(tree[k], dtype=np.float32)
    return out


def _assert_close(got: dict, want: dict, rel: float):
    """Each leaf within ``rel`` of its own max |value|."""
    assert got.keys() == want.keys()
    for k in want:
        scale = float(np.abs(want[k]).max())
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= rel * scale, (k, err, scale)


# -- moe_ffn on its own ------------------------------------------------------


def _ffn_inputs(seed=0, D=16, F=32, E=4, shape=(4, 16)):
    rng = np.random.default_rng(seed)
    params = {"router": (rng.standard_normal((D, E)) * D ** -0.5).astype(np.float32),
              "w1": (rng.standard_normal((E, D, F)) * D ** -0.5).astype(np.float32),
              "w2": (rng.standard_normal((E, F, D)) * F ** -0.5).astype(np.float32)}
    return params, rng.standard_normal((*shape, D)).astype(np.float32)


def _jax_ffn(params, x, dtype, capacity_factor):
    cfg = jmoe.MoEConfig(d_model=16, d_ff=32, num_experts=4, capacity_factor=capacity_factor,
                         compute_dtype=dtype)
    act = cfg.act_dtype

    def loss(p, v):
        y, aux = jmoe.moe_ffn(p, v, cfg)
        return jnp.sum(y.astype(jnp.float32) ** 2) + aux, (y, aux)

    grads, (y, aux) = jax.jit(jax.grad(loss, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x).astype(act))
    return np.asarray(y.astype(jnp.float32)), float(aux), grads


def _port_ffn(params, x, dtype, capacity_factor):
    cfg = tmoe.MoEConfig(d_model=16, d_ff=32, num_experts=4, capacity_factor=capacity_factor,
                         compute_dtype=dtype)
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    xt = torch.from_numpy(x).to(cfg.act_dtype).requires_grad_()
    y, aux = tmoe.moe_ffn(p, xt, cfg)
    g = torch.autograd.grad((y.float() ** 2).sum() + aux, [p["router"], p["w1"], p["w2"], xt])
    grads = {"router": g[0], "w1": g[1], "w2": g[2], "x": g[3]}
    return y.detach().float().numpy(), float(aux.detach()), {k: v.float().numpy() for k, v in grads.items()}


def _routing(params, x, dtype):
    """The expert each token goes to, as each framework routes x in dtype."""
    act = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    xj = jnp.asarray(x).astype(act).reshape(-1, x.shape[-1]).astype(jnp.float32)
    want = np.asarray(jnp.argmax(jax.nn.softmax(xj @ params["router"], axis=-1), axis=-1))
    xt = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    got = torch.softmax(xt.reshape(-1, x.shape[-1]).float() @ torch.from_numpy(params["router"]),
                        -1).argmax(-1).numpy()
    return got, want


# name -> (compute dtype, capacity factor, tolerance of y and of the grads
# against their max).  bf16: y and the grads agree within 0.9% here.
FFN_CASES = {"f32": ("f32", 1.25, 1e-5, 1e-4), "f32_drops": ("f32", 0.5, 1e-5, 1e-4),
             "bf16": ("bf16", 1.25, 2e-2, 2e-2)}


@pytest.mark.parametrize("name", sorted(FFN_CASES))
def test_moe_ffn_matches_jax(name):
    dtype, cf, tol, grad_tol = FFN_CASES[name]
    params, x = _ffn_inputs()
    got_route, want_route = _routing(params, x, dtype)
    np.testing.assert_array_equal(got_route, want_route)
    y, aux, grads = _port_ffn(params, x, dtype, cf)
    wy, waux, (wg, wgx) = _jax_ffn(params, x, dtype, cf)
    if cf < 1:
        assert (np.abs(y).max(-1) == 0).any(), "no token was dropped"
    assert abs(aux - waux) <= 1e-6, (aux, waux)
    _assert_close({"y": y}, {"y": wy}, tol)
    want = {k: np.asarray(v, dtype=np.float32) for k, v in wg.items()}
    want["x"] = np.asarray(wgx.astype(jnp.float32))
    _assert_close(grads, want, grad_tol)


def _dense_moe_ffn(params, x, cfg):
    """The Mesh-TensorFlow formulation, as the JAX package computes it, on
    one device: [T, E, C] dispatch and combine masks in the activation dtype
    and the tokens moved by products over them.  The oracle of moe_ffn's
    index dispatch and combine."""
    import torch.nn.functional as F

    B, S, D = x.shape
    E, T = cfg.num_experts, B * S
    C = cfg.capacity(T)
    tokens = x.reshape(T, D)
    probs = torch.softmax(tokens.float() @ params["router"], dim=-1)
    expert = probs.argmax(dim=-1)
    gate = probs.gather(1, expert[:, None])[:, 0]
    onehot = (expert[:, None] == torch.arange(E)).float()
    position = tmoe._position(onehot.view(B, S, E), None, None).reshape(T, E)
    keep = (position < C) * onehot
    slot = position.sum(-1).long()
    act = cfg.act_dtype
    pos_onehot = (slot[:, None] == torch.arange(C)).to(act)
    dispatch = keep[:, :, None].to(act) * pos_onehot[:, None, :]  # [T, E, C]
    combine = dispatch * gate.to(act)[:, None, None]
    expert_in = (dispatch.reshape(T, E * C).t() @ tokens.to(act)).view(E, C, D)
    h = F.gelu(torch.bmm(expert_in, params["w1"].to(act)), approximate="tanh")
    expert_out = torch.bmm(h, params["w2"].to(act))
    y = combine.reshape(T, E * C) @ expert_out.reshape(E * C, D)
    aux = E * (onehot.mean(0) * probs.mean(0)).sum()
    return y.reshape(B, S, D).to(x.dtype), aux


def _ffn_and_grads(ffn, params, x, dy, cfg):
    """ffn's (y, aux) and the grads of router, w1, w2 and x under the
    cotangents (dy, 1)."""
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    xt = torch.from_numpy(x).to(cfg.act_dtype).requires_grad_()
    y, aux = ffn(p, xt, cfg)
    g = torch.autograd.grad((y, aux), [p["router"], p["w1"], p["w2"], xt],
                            (torch.from_numpy(dy).to(y.dtype), torch.ones(())))
    return y.detach(), aux.detach(), dict(zip(("router", "w1", "w2", "x"), g))


# dtype -> the tolerance of the x and router grads against each leaf's max:
# they differ from the masks' only through the order of the gate
# cotangent's f32 sum, rounded to the activation dtype.
INDEX_GRAD_TOL = {"f32": 1e-6, "bf16": 1e-2}


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_index_dispatch_matches_dense_masks(dtype, capacity_factor):
    """moe_ffn's index dispatch and combine against the mask products they
    replace: y, aux and the expert weights' grads to the bit (every mask
    row and column holds one nonzero), the x and router grads within
    INDEX_GRAD_TOL; at capacity 0.5 with tokens dropped."""
    cfg = tmoe.MoEConfig(d_model=16, d_ff=32, num_experts=4, capacity_factor=capacity_factor,
                         compute_dtype=dtype)
    params, x = _ffn_inputs(seed=3, shape=(4, 32))
    dy = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    y, aux, grads = _ffn_and_grads(tmoe.moe_ffn, params, x, dy, cfg)
    wy, waux, wgrads = _ffn_and_grads(_dense_moe_ffn, params, x, dy, cfg)
    if capacity_factor < 1:
        assert bool((y.reshape(-1, 16) == 0).all(-1).any()), "no token was dropped"
    assert torch.equal(y, wy)
    assert torch.equal(aux, waux)
    for k in ("w1", "w2"):
        assert torch.equal(grads[k], wgrads[k]), k
    _assert_close({k: grads[k].float().numpy() for k in ("router", "x")},
                  {k: wgrads[k].float().numpy() for k in ("router", "x")}, INDEX_GRAD_TOL[dtype])


class _Numels(torch.utils._python_dispatch.TorchDispatchMode):
    """Records the element count of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.numels = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.numels += [t.numel() for t in torch.utils._pytree.tree_leaves(out)
                        if isinstance(t, torch.Tensor)]
        return out


def _largest_tensor(ffn, cfg, x, params):
    """The most elements of any tensor made by ffn's forward and backward."""
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    xt = x.clone().requires_grad_()
    with _Numels() as mode:
        y, aux = ffn(p, xt, cfg)
        torch.autograd.grad((y.float() ** 2).sum() + aux, [xt, *p.values()])
    return max(mode.numels)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_index_dispatch_makes_no_token_by_slot_tensor(capacity_factor):
    """At T = 512, E = 8 (C = 80 at capacity 1.25): no tensor of moe_ffn's
    forward or backward reaches T·E·C elements, where the mask formulation
    makes them; and the ``rows`` counter sums to the tokens kept (the
    nonzero rows of y)."""
    T, E, D = 512, 8, 16
    cfg = tmoe.MoEConfig(d_model=D, d_ff=32, num_experts=E, capacity_factor=capacity_factor,
                         compute_dtype="f32")
    C = cfg.capacity(T)
    assert C == {1.25: 80, 0.5: 32}[capacity_factor]
    params = tmoe.init_moe_params(torch.Generator().manual_seed(5), cfg, device="cpu")
    x = torch.randn(4, T // 4, D, generator=torch.Generator().manual_seed(6))
    assert _largest_tensor(_dense_moe_ffn, cfg, x, params) >= T * E * C  # the check sees them
    assert _largest_tensor(tmoe.moe_ffn, cfg, x, params) < T * E * C
    rows = tmoe.switch_route(x.reshape(T, D), params["router"], cfg, 4, C, 0, E)["rows"]
    y, _ = tmoe.moe_ffn(params, x, cfg)
    kept = int((y.reshape(T, D) != 0).any(-1).sum())
    assert int(rows.sum()) == kept
    if capacity_factor < 1:
        assert kept < T, "no token was dropped"


def test_capacity_rounding():
    # Capacity rounds UP (ceil, then multiples of 8), as the reference's.
    cfg = tmoe.MoEConfig(num_experts=4, capacity_factor=1.0)
    assert cfg.capacity(64) == 16
    assert cfg.capacity(4) == 8
    assert tmoe.MoEConfig(num_experts=4, capacity_factor=1.25).capacity(104) == 40
    for n in (1, 7, 64, 104, 8184, 8192):
        for cf in (0.5, 1.0, 1.25, 2.0):
            assert (tmoe.MoEConfig(num_experts=8, capacity_factor=cf).capacity(n)
                    == jmoe.MoEConfig(num_experts=8, capacity_factor=cf).capacity(n))


def test_capacity_drops_overflow_and_grads_flow():
    cfg = tmoe.MoEConfig(d_model=16, d_ff=32, num_experts=2, capacity_factor=0.5)
    gen = torch.Generator().manual_seed(0)
    params = {k: v.requires_grad_() for k, v in
              tmoe.init_moe_params(gen, cfg, device="cpu").items()}
    x = torch.randn(4, 16, 16, generator=gen)
    y, aux = tmoe.moe_ffn(params, x, cfg)
    grads = torch.autograd.grad((y * y).sum() + 0.01 * aux, list(params.values()))
    assert all(bool((g != 0).any()) for g in grads), "dead gradients"
    # Tight capacity: some tokens dropped (output rows exactly zero).
    assert int((y.reshape(-1, 16) == 0).all(-1).sum()) > 0


def test_aux_loss_penalizes_skewed_routing():
    cfg = tmoe.MoEConfig(d_model=16, d_ff=32, num_experts=4)
    gen = torch.Generator().manual_seed(0)
    params = tmoe.init_moe_params(gen, cfg, device="cpu")
    x = torch.randn(4, 16, 16, generator=gen)
    # Uniform routing (zero router): aux == E * sum(1/E * 1/E) == 1.
    _, aux_uniform = tmoe.moe_ffn(dict(params, router=torch.zeros_like(params["router"])), x, cfg)
    assert abs(float(aux_uniform) - 1.0) < 1e-5
    # All tokens to expert 0 (positive inputs, +/-100 router columns): aux -> E.
    skew = params["router"].clone()
    skew[:, 0], skew[:, 1:] = 100.0, -100.0
    _, aux_skew = tmoe.moe_ffn(dict(params, router=skew), x.abs() + 0.1, cfg)
    assert float(aux_skew) > 3.5, float(aux_skew)


# -- the MoE model -----------------------------------------------------------


@pytest.fixture(scope="module")
def ref():
    """JAX loss and grads of the MoE model in f32 and bf16, and the f32
    params after one tree-AdamW step."""
    params_np, tokens = numpy_params(MOE), numpy_tokens(MOE).astype(np.int32)
    out = {}
    for dtype in ("f32", "bf16"):
        cfg = jm.ModelConfig(**KW, attention="naive", compute_dtype=dtype)
        params = jax.tree.map(jnp.asarray, params_np)
        loss, grads = jax.jit(jax.value_and_grad(jm.loss_fn), static_argnums=2)(
            params, jnp.asarray(tokens), cfg)
        out[dtype] = {"loss": float(loss), "grads": _flat(grads)}
        if dtype == "f32":
            init, update = jm.adamw_bf16_moments(LR)
            updates, _ = jax.jit(update)(grads, init(params), params)
            out[dtype]["params"] = _flat(jax.tree.map(lambda p, u: p + u, params, updates))
    return params_np, tokens, out


def _port_model(params_np, tokens, dtype, **over):
    cfg = tm.ModelConfig(**KW, attention="naive", compute_dtype=dtype, **over)
    params = params_from_numpy(params_np, device="cpu")
    toks = torch.from_numpy(tokens)
    loss, grads = tm.value_and_grad(tm.loss_fn)(params, toks, cfg)
    init, step = tm.make_train_step(cfg, LR)
    params, _, _ = step(params, init(params), toks)
    return float(loss), _flat(params_to_numpy(grads)), _flat(params_to_numpy(params))


def _moe_inputs(params_np, tokens, dtype):
    """Per layer, the input of each framework's moe_ffn (as f32) and the
    router, recorded around moe_ffn in a forward pass: {"jax": [(h, r)],
    "port": [(h, r)]}."""
    seen = {"jax": [], "port": []}
    jcfg = jm.ModelConfig(**KW, attention="naive", compute_dtype=dtype, remat="none")
    real_j = jmoe.moe_ffn

    def record_j(p, x, cfg):
        jax.debug.callback(lambda h, r: seen["jax"].append((np.asarray(h), np.asarray(r))),
                           x.astype(jnp.float32), p["router"])
        return real_j(p, x, cfg)

    tcfg = tm.ModelConfig(**KW, attention="naive", compute_dtype=dtype, remat="none")
    real_t = tm.moe_ffn

    def record_t(p, x, cfg, **groups):
        seen["port"].append((x.float().numpy(), p["router"].numpy()))
        return real_t(p, x, cfg, **groups)

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jmoe, "moe_ffn", record_j)
        mp.setattr(tm, "moe_ffn", record_t)
        # A new function each call: a cached trace would call back into an
        # earlier call's lists.
        jax.block_until_ready(jax.jit(lambda p, t: jm.loss_fn(p, t, jcfg))(
            jax.tree.map(jnp.asarray, params_np), jnp.asarray(tokens)))
        with torch.no_grad():
            tm.loss_fn(params_from_numpy(params_np, device="cpu"), torch.from_numpy(tokens), tcfg)
    finally:
        mp.undo()
    return seen


def test_f32_loss_grads_and_step_match_jax(ref):
    params_np, tokens, out = ref
    want = out["f32"]
    seen = _moe_inputs(params_np, tokens, "f32")
    for (h, r), (hj, _) in zip(seen["port"], seen["jax"]):
        flat, flat_j = h.reshape(-1, h.shape[-1]), hj.reshape(-1, hj.shape[-1])
        np.testing.assert_array_equal((flat @ r).argmax(-1), (flat_j @ r).argmax(-1))
    loss, grads, stepped = _port_model(params_np, tokens, "f32")
    assert abs(loss - want["loss"]) <= 1e-5, (loss, want["loss"])
    _assert_close(grads, want["grads"], 1e-4)
    # After one step at lr 1e-3: a moment at a bf16 rounding boundary can
    # round to its neighbour in one framework (as in test_torch_model.py).
    for k, w in want["params"].items():
        assert float(np.abs(stepped[k] - w).max()) <= 2e-5, k


# bf16 router logits (up to 3.7 here) agree within 5e-2, 1.4%: bf16 keeps 8
# significant bits (0.4%) and the activations round at other places in each
# framework, layer after layer (0.012 seen in layer 0, 0.026 in layer 1).
LOGIT_TOL = 5e-2


def _kept(expert, num_experts, capacity):
    """Whether each token (in routing order) fits its expert's capacity."""
    onehot = np.eye(num_experts, dtype=np.int64)[expert]
    return ((np.cumsum(onehot, 0) - onehot) * onehot).sum(-1) < capacity


def test_bf16_routing_then_loss_match_jax(ref):
    """In bf16 the two frameworks round the activations at different
    places, so a token whose top two router logits nearly tie can go to
    another expert.  A flip reaches other tokens: through causal attention
    to the later positions of its sequence, and through capacity, where it
    shifts another token of the two experts' queues past the last slot or
    back.  Per layer, over the tokens no earlier flip reached: the router
    logits agree within LOGIT_TOL, and the routing agrees except where
    JAX's margin between the two experts is within 2 * LOGIT_TOL.  At this
    seed one token of 64 flips, in layer 1 (margin 0.0101 in JAX, -0.0020
    here); a flip moves the model's grads by up to 18% of a leaf's max, so
    here only the loss is held, within 2e-2, the bound of the dense model's
    bf16 test.  The grads are held in bf16 where every margin clears the
    logit error (test_bf16_routing_identical_then_grads_match_jax)."""
    params_np, tokens, out = ref
    E = KW["num_experts"]
    capacity = tmoe.MoEConfig(num_experts=E).capacity(tokens.size)
    seen = _moe_inputs(params_np, tokens, "bf16")
    assert len(seen["port"]) == len(seen["jax"]) == KW["n_layers"]
    reached = np.zeros(tokens.size, dtype=bool)  # an earlier flip reaches the token
    n_flips = 0
    for layer, ((h, r), (hj, _)) in enumerate(zip(seen["port"], seen["jax"])):
        logits, logits_j = h.reshape(tokens.size, -1) @ r, hj.reshape(tokens.size, -1) @ r
        err = np.abs(logits - logits_j)[~reached].max()
        assert err <= LOGIT_TOL, (layer, err)
        got, want = logits.argmax(-1), logits_j.argmax(-1)
        flips = np.flatnonzero(~reached & (got != want))
        for t in flips:
            margin = logits_j[t, want[t]] - logits_j[t, got[t]]
            assert margin <= 2 * LOGIT_TOL, (layer, t, margin)
        n_flips += len(flips)
        differs = (got != want) | (_kept(got, E, capacity) != _kept(want, E, capacity))
        reached |= np.maximum.accumulate(differs.reshape(tokens.shape), axis=1).reshape(-1)
    assert n_flips <= 1 and reached.mean() < 0.5, (n_flips, reached.mean())
    loss, _, _ = _port_model(params_np, tokens, "bf16")
    assert abs(loss - out["bf16"]["loss"]) <= 2e-2, (loss, out["bf16"]["loss"])


def _decisive_routers(params_np, tokens, margin):
    """``params_np`` with each layer's router refit, first layer first, so
    that in JAX's bf16 forward every token's expert leads the next best by
    at least ``margin``.  Each token keeps the expert it went to; gradient
    descent on a squared hinge (at 1.5 * margin) moves the router only as
    far as the tokens short of the margin need (3-4% of its norm here)."""
    params = {**params_np, "layers": dict(params_np["layers"])}
    routers = params["layers"]["router"] = params_np["layers"]["router"].copy()
    E = routers.shape[-1]
    for layer in range(len(routers)):
        h = _moe_inputs(params, tokens, "bf16")["jax"][layer][0]
        h = h.reshape(-1, h.shape[-1]).astype(np.float64)
        r, rows = routers[layer].astype(np.float64), np.arange(len(h))
        want = (h @ r).argmax(-1)
        lr = 1 / (4 * E * np.linalg.eigvalsh(h.T @ h)[-1])
        for _ in range(10_000):
            logits = h @ r
            lead = logits[rows, want][:, None] - logits
            if np.where(np.eye(E, dtype=bool)[want], np.inf, lead).min() >= margin:
                break
            short = np.maximum(0, 1.5 * margin - lead)
            short[rows, want] = 0
            short[rows, want] = -short.sum(1)
            r -= lr * 2 * h.T @ short
        else:
            raise AssertionError(f"layer {layer}: no router with margin {margin}")
        routers[layer] = r.astype(np.float32)
    return params


def test_bf16_routing_identical_then_grads_match_jax(ref):
    """The bf16 model on routers refit so that every top-two margin in JAX
    is at least 3 * LOGIT_TOL: per layer, the router logits agree within
    LOGIT_TOL and both frameworks route every token to the same expert
    (the same tokens overflow capacity); then the loss within 2e-2 and the
    grads within 5e-2 of each leaf's max, the dense model's bf16 bounds
    (tests/test_torch_model.py).  Measured here: logits 0.021, loss 9e-5,
    grads 1.7%."""
    params_np, tokens, _ = ref
    params_np = _decisive_routers(params_np, tokens, 3 * LOGIT_TOL)
    E = KW["num_experts"]
    capacity = tmoe.MoEConfig(num_experts=E).capacity(tokens.size)
    seen = _moe_inputs(params_np, tokens, "bf16")
    assert len(seen["port"]) == len(seen["jax"]) == KW["n_layers"]
    for layer, ((h, r), (hj, _)) in enumerate(zip(seen["port"], seen["jax"])):
        logits, logits_j = h.reshape(tokens.size, -1) @ r, hj.reshape(tokens.size, -1) @ r
        top2 = np.sort(logits_j, -1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() >= 2 * LOGIT_TOL, layer
        assert np.abs(logits - logits_j).max() <= LOGIT_TOL, layer
        got, want = logits.argmax(-1), logits_j.argmax(-1)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(_kept(got, E, capacity), _kept(want, E, capacity))
    cfg = jm.ModelConfig(**KW, attention="naive", compute_dtype="bf16")
    want_loss, want_grads = jax.jit(jax.value_and_grad(jm.loss_fn), static_argnums=2)(
        jax.tree.map(jnp.asarray, params_np), jnp.asarray(tokens), cfg)
    loss, grads, _ = _port_model(params_np, tokens, "bf16")
    assert abs(loss - float(want_loss)) <= 2e-2, (loss, float(want_loss))
    _assert_close(grads, _flat(want_grads), 5e-2)


def test_remat_modes_agree(ref):
    """Remat never changes the math: the three modes give the JAX loss and
    the same grads."""
    params_np, tokens, out = ref
    results = {r: _port_model(params_np, tokens, "f32", remat=r) for r in ("none", "full", "dots")}
    for r, (loss, grads, _) in results.items():
        assert abs(loss - out["f32"]["loss"]) <= 1e-5, (r, loss)
        _assert_close(grads, results["none"][1], 1e-6)


def test_convert_carries_the_moe_tree():
    params_np = numpy_params(MOE)
    params = params_from_numpy(params_np, device="cpu")
    layers = params["layers"]
    L, D, F, E = MOE["n_layers"], MOE["d_model"], MOE["d_ff"], MOE["num_experts"]
    assert (layers["router"].shape, layers["w1"].shape, layers["w2"].shape) == (
        (L, D, E), (L, E, D, F), (L, E, F, D))
    back = _flat(params_to_numpy(params))
    want = _flat(params_np)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])
    # init_params makes the same tree as the JAX package's.
    tree = tm.init_params(torch.Generator(), tm.ModelConfig(**KW), device="cpu")
    jtree = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0), jm.ModelConfig(**KW)))
    assert {k: tuple(v.shape) for k, v in _flat_tree(tree).items()} == {
        k: tuple(v.shape) for k, v in _flat_tree(jtree).items()}
