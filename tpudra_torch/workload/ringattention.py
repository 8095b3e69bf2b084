"""Ring attention: causal attention over a sequence sharded across ranks,
the counterpart of ``tpudra/workload/ringattention.py``.

The same schedule (Liu et al., "Ring Attention with Blockwise
Transformers"):

- q, k, v are sharded along the sequence over the ranks of an ``sp`` group;
- each step, every rank computes blockwise attention of its q block against
  the k/v block it holds, then passes k/v one hop around the ring
  (``parallel.ppermute``); after n steps every q block has seen every k/v
  block while each rank held one block at a time;
- the softmax is accumulated online in f32 (running max and denominator),
  so no rank ever holds the scores of the whole sequence.

Causality: with q block i and k block j, pairs j > i are fully masked (they
contribute nothing), j == i uses the causal triangle, j < i attends fully.

Plain PyTorch, as the reference is plain einsums.  ``block_update`` is one
step of the schedule; the distributed ring (``ring_self_attention``) and the
one-process schedule over the blocks of a whole sequence (``ring_blocks``)
run the same code.  At the model level (``ring_loss_fn``,
``ring_value_and_grad``) each sp rank keeps its own block of the sequence
through every layer.
"""

from __future__ import annotations

from dataclasses import replace
from functools import partial

import torch

from tpudra_torch.workload.convert import tree_map
from tpudra_torch.workload.model import (
    ModelConfig,
    backbone_and_aux,
    ce_rows_sum,
    value_and_grad,
)
from tpudra_torch.workload.parallel import (
    Groups,
    local_tree,
    mean_over,
    mesh_shape,
    ppermute,
    reduce_from,
    size_and_rank,
)

# (scores, p·v) einsums per layout: "bshd" [B, s, H, D], the standalone
# convention; "bhsd" [B, H, s, D], the model layer's own layout.
_EQUATIONS = {
    "bshd": ("bqhd,bkhd->bhqk", "bhqk,bkhd->bhqd"),
    "bhsd": ("bhqd,bhkd->bhqk", "bhqk,bhkd->bhqd"),
}


def _check_layout(layout: str) -> None:
    if layout not in _EQUATIONS:
        raise ValueError(f"layout must be bshd|bhsd, got {layout!r}")


def _seq_dim(layout: str) -> int:
    return 1 if layout == "bshd" else 2


def init_state(q, layout: str):
    """The running (acc [B, H, s, D], max [B, H, s], denominator [B, H, s])
    for q's block: zeros, -inf, zeros, in f32."""
    B, D = q.shape[0], q.shape[-1]
    H, s = (q.shape[2], q.shape[1]) if layout == "bshd" else (q.shape[1], q.shape[2])
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.zeros((B, H, s, D), **f32), torch.full((B, H, s), float("-inf"), **f32),
            torch.zeros((B, H, s), **f32))


def block_update(q, k_blk, v_blk, state, q_off: int, k_off: int, causal: bool, layout: str):
    """One step of the ring: the scores of the q block (sequence positions
    from ``q_off``) against one k/v block (from ``k_off``), in f32 and
    scaled by D^-½, folded into the running ``state`` (init_state)."""
    qk_eq, pv_eq = _EQUATIONS[layout]
    acc, m, l = state
    scores = torch.einsum(qk_eq, q, k_blk).float() * q.shape[-1] ** -0.5
    if causal:
        sd = _seq_dim(layout)
        q_pos = q_off + torch.arange(q.shape[sd], device=q.device)[:, None]
        k_pos = k_off + torch.arange(k_blk.shape[sd], device=q.device)[None, :]
        scores = scores.masked_fill(q_pos < k_pos, float("-inf"))
    # amax splits the gradient among ties, as jnp.max does.
    m_new = torch.maximum(m, scores.amax(dim=-1))
    # A row masked in every block so far keeps m_new == -inf, where
    # exp(-inf - -inf) is nan: the where comes before the exp, so that the
    # backward takes no 0·nan either.
    dead = torch.isneginf(m_new)
    shift = torch.where(dead, 0.0, m - m_new)
    p = torch.exp(torch.where(dead[..., None], float("-inf"), scores - m_new[..., None]))
    acc = acc * torch.exp(shift)[..., None] + torch.einsum(pv_eq, p, v_blk.float())
    l = l * torch.exp(shift) + p.sum(dim=-1)
    return acc, m_new, l


def finish(state, layout: str, dtype: torch.dtype):
    """The attention output of a finished ``state``, in ``layout`` and
    ``dtype``."""
    acc, _, l = state
    out = acc / l.clamp_min(1e-30)[..., None]  # [B, H, s, D]
    if layout == "bshd":
        out = out.transpose(1, 2)
    return out.to(dtype)


def ring_self_attention(q, k, v, group, causal: bool = True, layout: str = "bshd"):
    """Ring attention over the ranks of ``group``: q, k, v are this rank's
    block of the sequence (block index = rank in the group), in ``layout``
    "bshd" ([B, s, H, D]) or "bhsd" ([B, H, s, D]); returns this block's
    output in that layout and q's dtype.  q is not pre-scaled."""
    _check_layout(layout)
    n, me = size_and_rank(group)
    s = q.shape[_seq_dim(layout)]
    state = init_state(q, layout)
    for step in range(n):
        # k and v hold block j = (me - step) mod n.
        j = (me - step) % n
        state = block_update(q, k, v, state, me * s, j * s, causal, layout)
        if step < n - 1:
            k, v = ppermute(k, group), ppermute(v, group)
    return finish(state, layout, q.dtype)


def ring_blocks(q, k, v, n_blocks: int, causal: bool = True, layout: str = "bshd"):
    """The ring's schedule in one process: the whole sequence in
    ``n_blocks`` blocks, each q block stepping through the k/v blocks in the
    order its rank of an ``n_blocks`` ring would see them.  Equal to
    ``ring_self_attention`` over n_blocks ranks, block by block."""
    _check_layout(layout)
    sd = _seq_dim(layout)
    S = q.shape[sd]
    if S % n_blocks:
        raise ValueError(f"sequence {S} does not split into {n_blocks} blocks")
    s = S // n_blocks
    qs, ks, vs = (t.split(s, dim=sd) for t in (q, k, v))
    outs = []
    for i in range(n_blocks):
        state = init_state(qs[i], layout)
        for step in range(n_blocks):
            j = (i - step) % n_blocks
            state = block_update(qs[i], ks[j], vs[j], state, i * s, j * s, causal, layout)
        outs.append(finish(state, layout, q.dtype))
    return torch.cat(outs, dim=sd)


def make_sharded_ring_attention(mesh, axis_name: str = "sp", causal: bool = True,
                                layout: str = "bshd"):
    """``fn(q, k, v)`` over this rank's blocks of a sequence sharded over the
    mesh dim ``axis_name`` (block index = the rank's coordinate on it),
    returning this rank's block of the output.  The other mesh dims take no
    part: shard the batch over them in the caller."""
    if axis_name not in mesh_shape(mesh):
        raise ValueError(f"mesh {mesh_shape(mesh)} has no {axis_name!r} axis")
    return partial(ring_self_attention, group=mesh.get_group(axis_name), causal=causal,
                   layout=layout)


def dense_reference(q, k, v, causal: bool = True):
    """Unsharded attention over [B, S, H, D] for correctness checks."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * q.shape[-1] ** -0.5
    if causal:
        S = q.shape[1]
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bhqd", probs, v.float())
    return out.transpose(1, 2).to(q.dtype)


def _ring_groups(mesh, sp_axis: str) -> Groups:
    if sp_axis not in mesh_shape(mesh):
        raise ValueError(f"mesh {mesh_shape(mesh)} has no {sp_axis!r} axis")
    return replace(Groups.from_mesh(mesh, ("dp", "tp")), sp=mesh.get_group(sp_axis))


def _block_loss(params, tokens, cfg: ModelConfig, groups: Groups, seq_len: int):
    """The loss of this rank's dp shard, from its block tokens [b, s] of
    sequences of ``seq_len`` (block index = its sp rank), with the ring
    attention core.  Each block's last position predicts the next block's
    first token; the last block's last position predicts nothing.  Summed
    over sp: every sp rank holds the value, and the gradients of its own
    part (sum them over sp)."""
    n_sp, me = size_and_rank(groups.sp)
    b, s = tokens.shape
    attn_fn = partial(ring_self_attention, group=groups.sp, layout="bhsd")
    x, aux = backbone_and_aux(params, tokens, cfg, groups, attn_fn, pos_offset=me * s)
    # The next block's first tokens (the last block gets the first block's,
    # which it does not use).
    following = ppermute(tokens[:, :1].contiguous(), groups.sp, shift=-1)
    if me == n_sp - 1:
        xs, targets = x[:, :-1], tokens[:, 1:]
    else:
        xs, targets = x, torch.cat([tokens[:, 1:], following], dim=1)
    part = ce_rows_sum(params, xs, targets, cfg, groups.tp) / (b * (seq_len - 1))
    if cfg.num_experts:
        # aux is the same on every sp rank (its statistics are means over sp
        # and dp): each adds its 1/n_sp share, so that the sum over sp holds
        # it once and the gradients summed over sp hold it once.
        part = part + cfg.moe_aux_weight * aux / n_sp
    return reduce_from(part, groups.sp)


def ring_loss_fn(params, tokens, cfg: ModelConfig, mesh, sp_axis: str = "sp"):
    """The flagship loss with the attention core replaced by ring attention
    over ``sp_axis``: the counterpart of JAX's ``ring_loss_fn``.  ``params``
    are this rank's shards (``model.param_specs`` over ``mesh``), ``tokens``
    the global batch [B, S] (the same on every rank); each rank keeps its
    (dp, sp) block of it through every layer.  Returns the loss of the
    global batch; this rank's gradients are a part (see
    ``ring_value_and_grad``)."""
    groups = _ring_groups(mesh, sp_axis)
    n_sp, me = size_and_rank(groups.sp)
    B, S = tokens.shape
    if S % n_sp:
        raise ValueError(f"sequence {S} does not shard over {sp_axis!r} of size {n_sp}")
    n_dp, dp_rank = size_and_rank(groups.dp)
    rows, cols = B // n_dp, S // n_sp
    block = tokens[dp_rank * rows:(dp_rank + 1) * rows, me * cols:(me + 1) * cols]
    return mean_over(_block_loss(params, block, cfg, groups, S), groups.dp)


def ring_value_and_grad(cfg: ModelConfig, mesh):
    """``fn(dparams, dtokens) -> (loss, grads)`` for the model sharded over
    ``mesh`` (``model.shard_params``, ``model.shard_batch``) with the ring
    attention core, the twin of ``model.sharded_value_and_grad``: each rank
    computes on its (dp, sp) block of the tokens; the loss of the global
    batch, and this rank's local shard of each gradient, summed over sp and
    averaged over dp."""
    groups = _ring_groups(mesh, "sp")
    grad_fn = value_and_grad(_block_loss)

    def reduce(g):
        return mean_over(reduce_from(g, groups.sp), groups.dp)

    def wrapped(dparams, dtokens):
        loss, grads = grad_fn(local_tree(dparams), dtokens.to_local(), cfg, groups,
                              dtokens.shape[1])
        with torch.no_grad():
            return mean_over(loss, groups.dp), tree_map(reduce, grads)

    return wrapped
