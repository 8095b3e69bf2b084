"""The port's ring attention (tpudra_torch.workload.ringattention) on a world
of 8 gloo processes against the JAX package's on its 8-device CPU mesh: the
twins of tests/test_workload.py TestRingAttention (:695) and
TestRingModelComposition (:989).

The same inputs, made with numpy from a seed, go through both.  f32, so
only the order of sums differs: outputs and gradients within 1e-5 of their
largest value, losses within 1e-5 of themselves, each gradient leaf within
1e-4 of its own max |g|.  The world runs once per module
(torch_gloo.run_world, killed past its timeout)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpudra.workload import jaxcompat
from tpudra.workload import model as jm
from tpudra.workload.ringattention import (
    dense_reference as jax_dense_reference,
    make_sharded_ring_attention as jax_ring,
    ring_loss_fn as jax_ring_loss_fn,
)
from tpudra_torch.workload.ringattention import dense_reference, ring_blocks

import torch_gloo

WORLD = 8
_GAP = jaxcompat.missing_capability("shard_map-partial-manual")
partial_manual = pytest.mark.skipif(_GAP is not None, reason=_GAP or "")


@pytest.fixture(scope="module")
def ranks():
    return torch_gloo.values(torch_gloo.run_world("ring", WORLD))


def _jax_ring_and_grads(causal: bool):
    """JAX's sharded ring over the 8-device sp mesh: out and the gradients
    of Σ w·out with respect to q, k, v."""
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("sp",))
    sharding = NamedSharding(mesh, P(None, "sp", None, None))
    q, k, v, w = (jax.device_put(jnp.asarray(a), sharding) for a in torch_gloo.ring_inputs())
    ring = jax_ring(mesh, "sp", causal=causal)
    out, vjp = jax.vjp(ring, q, k, v)
    return [np.asarray(t) for t in (out, *vjp(w))]


def _close(got: np.ndarray, want: np.ndarray, tol: float) -> None:
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert err <= tol, err


@pytest.mark.parametrize("causal", [True, False])
def test_matches_jax_ring_and_dense_reference(ranks, causal):
    """Output and q, k, v gradients (the ppermute's backward carries k's and
    v's back round the ring) against JAX's ring, block by block."""
    want = _jax_ring_and_grads(causal)
    got = [np.concatenate(parts, axis=1) for parts in zip(*(r[f"causal={causal}"] for r in ranks))]
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    q, k, v, _ = (torch.from_numpy(a) for a in torch_gloo.ring_inputs())
    _close(got[0], dense_reference(q, k, v, causal=causal).numpy(), 1e-5)
    _close(np.asarray(jax_dense_reference(*map(jnp.asarray, (q, k, v)), causal=causal)),
           dense_reference(q, k, v, causal=causal).numpy(), 1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_one_process_schedule_matches_the_ring(ranks, causal):
    """ring_blocks (the schedule chip_smoke.py drives on one card) gives
    the distributed ring's output and gradients over 8 blocks."""
    q, k, v, w = (torch.from_numpy(a) for a in torch_gloo.ring_inputs())
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ring_blocks(*qkv, n_blocks=WORLD, causal=causal)
    grads = torch.autograd.grad((out * w).sum(), qkv)
    got = [t.detach().numpy() for t in (out, *grads)]
    ring = [np.concatenate(parts, axis=1) for parts in zip(*(r[f"causal={causal}"] for r in ranks))]
    for g, want in zip(got, ring):
        _close(g, want, 1e-6)


def test_long_sequence_never_materializes_globally(ranks):
    for r in ranks:
        shape, finite = r["long"]
        assert shape == (1, torch_gloo.RING_LONG[1] // WORLD, 2, 16) and finite


def _jax_ring_model(kw: dict, shape):
    cfg = jm.ModelConfig(**kw)
    params = jax.tree.map(jnp.asarray, torch_gloo.numpy_params(kw))
    tokens = jnp.asarray(torch_gloo.numpy_tokens(kw).astype(np.int32))
    mesh = Mesh(np.array(jax.devices()).reshape(shape), ("dp", "sp", "tp"))
    sharded = jm.shard_params(params, mesh, cfg)
    tok = jax.device_put(tokens, NamedSharding(mesh, P("dp", "sp")))
    loss, grads = jax.jit(jax.value_and_grad(lambda p, t: jax_ring_loss_fn(p, t, cfg, mesh)))(
        sharded, tok)
    return float(loss), {k: np.asarray(v) for k, v in torch_gloo._flat(grads).items()}


@partial_manual
@pytest.mark.parametrize("model", list(torch_gloo.RING_MESHES))
def test_ring_loss_and_grads_match_jax(ranks, model):
    """The model with ring attention: dense on a (2, 4, 1) mesh, MoE (4
    experts over tp, capacity 8 for 64 tokens, so tokens drop and routing
    order matters) on (2, 2, 2); every rank's loss and every gathered
    gradient leaf against JAX's ring_loss_fn."""
    kw, shape = torch_gloo.RING_MESHES[model]
    want_loss, want_grads = _jax_ring_model(kw, shape)
    for r in ranks:
        got = r[model]
        for loss in (got["loss"], got["ring_loss_fn"], got["single"]):
            assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), (loss, want_loss)
        assert got["grads"].keys() == want_grads.keys()
        for leaf, g in got["grads"].items():
            w = want_grads[leaf]
            err = float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-30)
            assert err <= 1e-4, (leaf, err)


def test_ring_loss_fn_validates_the_mesh(ranks):
    no_sp, ragged = ranks[0]["errors"]
    assert "no 'sp' axis" in no_sp, no_sp
    assert "does not shard over 'sp'" in ragged, ragged


def test_chip_ring_check_has_teeth():
    """The check chip_smoke.py holds the one-process ring to on the card
    (each row of o, dq, dk, dv within RING_TOL of the exact attention of
    the same bf16 inputs), at a small shape: the ring passes it, a ring
    that drops one block step (chip_smoke.ring_skipping) fails it by far."""
    import chip_smoke
    from tpudra_torch.workload import attn_kernel, ringattention

    B, H, S, hd = 1, 2, 512, 64
    n = chip_smoke.RING_BLOCKS
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(B, H, S, hd, generator=gen).bfloat16() for _ in range(4))
    scale = hd ** -0.5

    def with_grads(fn):
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        o = fn(*qkv)
        return (o.detach(), *torch.autograd.grad(o, qkv, do))

    f32 = [q.float() * scale, k.float(), v.float()]
    o, lse = attn_kernel.attn_fwd_plain(*f32)
    dq, dk, dv = attn_kernel.attn_bwd_plain(*f32, o, lse, do.float())
    exact = (o, dq * scale, dk, dv)
    good = with_grads(lambda *t: ringattention.ring_blocks(*t, n_blocks=n, layout="bhsd"))
    bad = with_grads(lambda *t: chip_smoke.ring_skipping(torch, ringattention, *t,
                                                         skip=(n - 1, n - 2)))
    for g, b, w in zip(good, bad, exact):
        assert attn_kernel.max_row_err(g, w) <= chip_smoke.RING_TOL / 2
        assert attn_kernel.max_row_err(b, w) > 10 * chip_smoke.RING_TOL
