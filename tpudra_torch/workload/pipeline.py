"""Pipeline parallelism (GPipe) over the flagship model's layer stack: the
counterpart of ``tpudra/workload/pipeline.py``.

The same SPMD schedule as the JAX program: ``M + npp - 1`` ticks; every
tick every stage runs its layers on what it holds (stage 0 feeds
microbatch t, the others what the stage before handed over) and passes the
result on with one ``ppermute`` over pp.  Stage s computes real
microbatches on ticks s .. s+M-1 and garbage on the others, which is masked
out: the aux loss is counted on valid ticks only, and the outputs are taken
from the last stage and summed over pp.  Every rank builds the same
autograd graph (the stage-dependent choices are ``torch.where`` on a
tensor, not Python branches), so the backward issues the reverse permutes
in the same order on every rank.  Skipping the bubble ticks (a 1F1B
point-to-point schedule) is a speed item for later.

Each pp rank holds its stage's L/pp layers (``stage_params``), and over a
tp axis its tp shards of them in ``model.param_specs``' layout (the
experts of an MoE layer split over tp).  Embedding, the final norm and the
head run on every stage.  Stage 0's feed is the only use of the embedding,
so it passes f (``copy_to`` over pp): every stage then holds the lookup's
share of the embed/pos gradients, as it holds the head's.  An MoE layer
routes each (microbatch, dp shard) on its own, as the JAX pipeline does
(dp is a manual axis there).
"""

from __future__ import annotations

from functools import partial

import torch

from tpudra_torch.workload.convert import tree_map
from tpudra_torch.workload.model import (
    ModelConfig,
    _optimizer,
    _rmsnorm,
    ce_head,
    embed_tokens,
    param_specs,
    remat_layer_body,
    value_and_grad,
)
from tpudra_torch.workload.parallel import (
    Groups,
    copy_to,
    mean_over,
    mesh_shape,
    ppermute,
    reduce_from,
    size_and_rank,
)


def split_layers(params: dict, num_stages: int) -> dict:
    """The stacked layer params [L, ...] as [pp, L/pp, ...]: row s is stage
    s's chunk."""

    def reshape(a):
        L = a.shape[0]
        if L % num_stages:
            raise ValueError(f"{L} layers do not split into {num_stages} stages")
        return a.reshape(num_stages, L // num_stages, *a.shape[1:])

    return tree_map(reshape, params)


def stage_params(params: dict, mesh, cfg: ModelConfig, pp_axis: str = "pp") -> dict:
    """This rank's share of the parameter tree (the same on every rank) for
    the pipeline over ``mesh``: its stage's L/pp layers and, where the mesh
    has a "tp" dim, its tp shard of every leaf ``param_specs`` shards over
    tp.  Copies of their own, as ``shard_params`` makes."""
    npp, stage = size_and_rank(mesh.get_group(pp_axis))
    tree = dict(params, layers=tree_map(lambda a: a[stage], split_layers(params["layers"], npp)))
    if "tp" in mesh_shape(mesh):
        n_tp, tp_rank = size_and_rank(mesh.get_group("tp"))

        def shard(a, spec):
            tp = spec[2]
            return a.chunk(n_tp, tp.dim)[tp_rank] if tp.is_shard() else a

        tree = tree_map(shard, tree, param_specs(cfg))
    return tree_map(lambda a: a.clone(memory_format=torch.contiguous_format), tree)


def _setup(tokens, mesh, num_microbatches: int, pp_axis: str, dp_axis: str | None):
    """The up-front checks of the JAX pipeline, then (groups, this rank's
    rows of each microbatch [M, B/M/dp, S])."""
    B, S = tokens.shape
    M = num_microbatches
    if B % M:
        raise ValueError(f"batch {B} does not split into {M} microbatches")
    shape = mesh_shape(mesh)
    if pp_axis not in shape:
        raise ValueError(f"mesh {shape} has no {pp_axis!r} axis for the pipeline")
    if dp_axis:
        if dp_axis not in shape:
            raise ValueError(
                f"mesh {shape} has no {dp_axis!r} axis; pass dp_axis=None to run "
                "without data parallelism"
            )
        if (B // M) % shape[dp_axis]:
            raise ValueError(
                f"microbatch size {B // M} does not split over the {dp_axis!r} axis "
                f"of size {shape[dp_axis]}"
            )
    groups = Groups(dp=mesh.get_group(dp_axis) if dp_axis else None,
                    tp=mesh.get_group("tp") if "tp" in shape else None,
                    pp=mesh.get_group(pp_axis))
    # Microbatch m is rows m·B/M .. (m+1)·B/M of the batch, split over dp.
    n_dp, dp_rank = size_and_rank(groups.dp)
    mb = B // M // n_dp
    rows = tokens.reshape(M, B // M, S)[:, dp_rank * mb:(dp_rank + 1) * mb]
    return groups, rows


def _schedule(params, rows, cfg: ModelConfig, groups: Groups):
    """The tick schedule over this rank's microbatch rows [M, mb, S]:
    (hidden states [M·mb, S, D] after the final norm, mean aux)."""
    M, mb, S = rows.shape
    npp, stage = size_and_rank(groups.pp)
    # The layers see tp only: MoE routes each (microbatch, dp shard) alone.
    layer_groups = Groups(tp=groups.tp)
    x = embed_tokens(params, rows.reshape(M * mb, S), cfg, layer_groups)
    xs = copy_to(x, groups.pp).view(M, mb, S, -1)

    layer = remat_layer_body(cfg, layer_groups)
    per_layer = {k: v.unbind(0) for k, v in params["layers"].items()}
    n_local = params["layers"]["ln1"].shape[0]

    def stage_fn(h):
        auxs = []
        for i in range(n_local):
            h, aux = layer(h, {k: v[i] for k, v in per_layer.items()})
            auxs.append(aux)
        return h, torch.stack(auxs).mean()

    first = torch.tensor(stage == 0, device=x.device)
    last = torch.tensor(stage == npp - 1, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    buf = torch.zeros_like(xs[0])
    ys = [None] * M
    aux_acc = torch.zeros((), dtype=torch.float32, device=x.device)
    ticks = M + npp - 1
    for t in range(ticks):
        # Stage 0 feeds microbatch t (the last one again past M); the others
        # take what the stage before handed over last tick.
        out, aux = stage_fn(torch.where(first, xs[min(t, M - 1)], buf))
        if stage <= t < stage + M:
            aux_acc = aux_acc + aux
        # The last stage finishes microbatch t - (npp - 1) this tick.
        w = t - (npp - 1)
        if 0 <= w < M:
            ys[w] = torch.where(last, out, zero)
        if t < ticks - 1:
            buf = ppermute(out, groups.pp)
    ys = reduce_from(torch.stack(ys), groups.pp)
    # Every stage counted M per-microbatch means of its own layers: the sum
    # over stages / (npp·M) is the mean over (layer, microbatch) pairs.
    aux = mean_over(reduce_from(aux_acc, groups.pp) / (npp * M), groups.dp)
    return _rmsnorm(ys.reshape(M * mb, S, -1), params["ln_f"]), aux


def pipelined_backbone(params, tokens, cfg: ModelConfig, mesh, num_microbatches: int,
                       pp_axis: str = "pp", dp_axis: str | None = "dp"):
    """tokens [B, S] (the global batch, the same on every rank) → (this dp
    rank's hidden states [M·B/M/dp, S, D], its rows of each microbatch in
    microbatch order; the mean MoE aux loss, zero for dense models), the
    layer stack pipelined over ``pp_axis``.  ``params``: ``stage_params``."""
    groups, rows = _setup(tokens, mesh, num_microbatches, pp_axis, dp_axis)
    return _schedule(params, rows, cfg, groups)


def pipelined_loss_fn(params, tokens, cfg: ModelConfig, mesh, num_microbatches: int,
                      pp_axis: str = "pp", dp_axis: str | None = "dp"):
    """Next-token cross-entropy of the global batch through the pipelined
    backbone: the pipelined twin of ``model.loss_fn``.  For MoE configs the
    aux is the per-microbatch average (see the module docstring).  This
    rank's gradients are those of its dp shard (average them over dp:
    ``pipelined_value_and_grad``)."""
    groups, rows = _setup(tokens, mesh, num_microbatches, pp_axis, dp_axis)
    x, aux = _schedule(params, rows, cfg, groups)
    loss = mean_over(ce_head(params, x, rows.reshape(x.shape[0], -1), cfg, Groups(tp=groups.tp)),
                     groups.dp)
    if cfg.num_experts:
        loss = loss + cfg.moe_aux_weight * aux
    return loss


def pipelined_value_and_grad(cfg: ModelConfig, mesh, num_microbatches: int):
    """``fn(params, tokens) -> (loss, grads)`` for ``stage_params`` over a
    mesh with "pp" and "dp" dims: the loss of the global batch, and this
    rank's gradients averaged over dp."""
    dp = mesh.get_group("dp")
    grad_fn = value_and_grad(pipelined_loss_fn)

    def wrapped(params, tokens):
        loss, grads = grad_fn(params, tokens, cfg, mesh, num_microbatches)
        with torch.no_grad():
            return loss, tree_map(partial(mean_over, group=dp), grads)

    return wrapped


def make_pipelined_train_step(cfg: ModelConfig, mesh, num_microbatches: int,
                              learning_rate: float = 1e-3):
    """``model.make_train_step`` for ``stage_params``: (init_opt_state,
    train_step); AdamW runs on each rank's stage tree, updated in place."""
    grad_fn = pipelined_value_and_grad(cfg, mesh, num_microbatches)
    init, apply = _optimizer(cfg, learning_rate)

    def train_step(params, opt_state, tokens):
        loss, grads = grad_fn(params, tokens)
        return params, apply(params, grads, opt_state), loss

    return init, train_step
