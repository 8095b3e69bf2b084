"""The port's sharded train step (tpudra_torch.workload.model param_specs,
shard_params, make_sharded_train_step) and expert-parallel moe_ffn on a
world of 8 gloo processes: the twins of tests/test_workload.py
test_sharded_step_matches_single_device (:257),
test_ep_sharded_matches_single_device (:528) and
test_moe_transformer_trains_and_shards (:582); and the sharded step with a
per-dp batch that tp does not divide, which the JAX package accepts.

The ranks hold the (2, 2, 2) ("dp", "sp", "tp") sharded step against the
single-device port step on the same params and tokens, which
tests/test_torch_model.py and tests/test_torch_moe.py hold against JAX.
f32, so only the order of sums differs.  The world runs once per module
(torch_gloo.run_world, killed past its timeout)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpudra.workload import model as jm
from tpudra_torch.workload import model as tm

import torch_gloo

WORLD = 8
MODELS = ["dense", "moe"]


@pytest.fixture(scope="module")
def ranks():
    return torch_gloo.values(torch_gloo.run_world("parallel", WORLD))


@pytest.mark.parametrize("model", MODELS)
def test_sharded_loss_and_grads_match_single_device(ranks, model):
    for r in ranks:
        got = r[model]
        sharded, single = got["loss"]
        assert abs(sharded - single) <= 1e-5 * abs(single), (sharded, single)
        # Each gathered gradient leaf within 1e-5 of its own max |g|.
        for leaf, err in got["grads"].items():
            assert err <= 1e-5, (leaf, err)


@pytest.mark.parametrize("model", MODELS)
def test_sharded_adamw_step_matches_single_device(ranks, model):
    # lr 1e-2.  A moment at a bf16 rounding boundary rounds to its neighbour
    # in one of the two steps (their grads differ in the last bits), which
    # moves an element by up to ~lr/128 (7.6e-5 seen); an element whose
    # gradient is near AdamW's eps (1e-8) moves further.  A wrong or missing
    # update moves an element by ~lr.
    for r in ranks:
        for leaf, err in r[model]["params"].items():
            assert err <= torch_gloo.LR / 20, (leaf, err)


def test_sharded_moe_transformer_trains(ranks):
    for r in ranks:
        losses = r["moe"]["losses"]
        assert losses[-1] < losses[0], losses
        assert losses == ranks[0]["moe"]["losses"]


@pytest.mark.parametrize("model", MODELS)
def test_local_shards_follow_param_specs(ranks, model):
    """Every rank holds 1/tp of each tp-sharded leaf: for the MoE model its
    E/tp experts."""
    kw = torch_gloo.DENSE if model == "dense" else torch_gloo.MOE
    cfg = tm.ModelConfig(**kw)
    specs = torch_gloo._flat(tm.param_specs(cfg))
    full = {k: v.shape for k, v in torch_gloo._flat(torch_gloo.numpy_params(kw)).items()}
    for r in ranks:
        for leaf, shape in r[model]["local_shapes"].items():
            want = list(full[leaf])
            for placement in specs[leaf]:
                if placement.is_shard():
                    want[placement.dim] //= 2
            assert list(shape) == want, (leaf, shape, want)
    if model == "moe":
        assert ranks[0]["moe"]["local_shapes"]["layers/w1"][1] == kw["num_experts"] // 2


def test_ep_sharded_moe_ffn_matches_single_device(ranks):
    for r in ranks:
        ep = r["ep"]
        assert ep["y"] < 1e-6 and ep["aux"] < 1e-6 and ep["gx"] < 1e-6, ep


def test_ep_sharded_expert_compute_is_e_over_ep_sized(ranks):
    """The twin of the JAX test's HLO check: each rank computes on its one
    expert's bf16 weights ([E/ep=1, D=16, F=32]) and makes no
    full-expert-count bf16 tensor."""
    for r in ranks:
        ep = r["ep"]
        C = ep["capacity"]
        assert ep["w1_local"] == (1, 16, 32)
        assert (1, 16, 32) in ep["bf16_shapes"]
        for full in ((4, 16, 32), (4, 32, 16), (4, C, 32), (4, C, 16)):
            assert full not in ep["bf16_shapes"], full


@pytest.mark.parametrize("num_experts", [0, 4])
def test_param_specs_mirror_jax(num_experts):
    """Leaf by leaf: the mesh dim each JAX PartitionSpec names "tp" on is the
    dim the port shards over tp; everything else replicated."""
    kw = dict(torch_gloo.MOE, num_experts=num_experts)
    want = torch_gloo._flat(jm.param_specs(jm.ModelConfig(**kw)))
    got = torch_gloo._flat(tm.param_specs(tm.ModelConfig(**kw)))
    assert got.keys() == want.keys()
    for leaf, spec in want.items():
        dp, sp, tp = got[leaf]
        assert dp.is_replicate() and sp.is_replicate(), leaf
        tp_dims = [i for i, axis in enumerate(spec) if axis == "tp"]
        assert ([tp.dim] if tp.is_shard() else []) == tp_dims, (leaf, spec, tp)
    dp, sp, tp = tm.batch_spec()
    assert (dp.dim, sp.dim, tp.is_replicate()) == (0, 1, True)
    assert tuple(jm.batch_spec()) == ("dp", "sp")


@pytest.mark.parametrize("name", list(torch_gloo.RAGGED))
def test_sharded_step_takes_a_batch_tp_does_not_divide(ranks, name):
    """(1, 1, 2) with batch 1 and (2, 1, 2) with batch 6 (3 rows a dp
    rank): the CE head shares the b·(S−1) rows over tp, the last share
    ragged.  Loss and every gathered gradient leaf against the
    single-device port step (1e-5), the loss against JAX's (1e-5), and the
    params after one AdamW step as the other sharded steps are held."""
    shape, batch = torch_gloo.RAGGED[name]
    kw = torch_gloo.DENSE
    params = jax.tree.map(jnp.asarray, torch_gloo.numpy_params(kw))
    tokens = jnp.asarray(torch_gloo.numpy_tokens(kw, batch=batch).astype(np.int32))
    want = float(jm.loss_fn(params, tokens, jm.ModelConfig(**kw)))
    got_ranks = [r[name] for r in ranks if name in r]
    assert len(got_ranks) == int(np.prod(shape))
    for got in got_ranks:
        sharded, single = got["loss"]
        assert abs(sharded - single) <= 1e-5 * abs(single), (sharded, single)
        assert abs(sharded - want) <= 1e-5 * abs(want), (sharded, want)
        for leaf, err in got["grads"].items():
            assert err <= 1e-5, (leaf, err)
        for leaf, err in got["params"].items():
            assert err <= torch_gloo.LR / 20, (leaf, err)
