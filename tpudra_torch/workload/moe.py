"""Switch-style top-1 mixture-of-experts FFN: the counterpart of
``tpudra/workload/moe.py``.

The same Mesh-TensorFlow dispatch/combine formulation: routing builds a
[tokens, experts, capacity] dispatch tensor, the expert FFNs run batched
over the expert axis, and a combine product gathers the outputs back to
token order.  Tokens past an expert's capacity are dropped (their output
row is zero, the residual passes them through).

Expert parallelism is explicit here, where the JAX package leaves it to
GSPMD.  With ``ep_group``, ``w1``/``w2`` are this rank's ``E/ep`` experts
and the tokens are the same on every rank of the group: each rank routes
all tokens (the router is replicated), runs the dispatch, expert and
combine products for its own experts only, and the partial outputs are
summed over the group.  With ``token_group`` the tokens are sharded over
that group (data parallel) and routing is still global, as in the JAX
program, which routes the global batch: capacity counts every rank's
tokens, a token's slot counts the tokens of lower ranks before it, and the
load-balancing fractions are means over all ranks.  With ``seq_group`` too
(ring attention: each rank holds one block of every sequence of its dp
shard) the global order is (dp rank, row, sequence block): a token's slot
counts the tokens of every earlier (rank, row, block) before it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from tpudra_torch.workload.device import resolve_device
from tpudra_torch.workload.parallel import (
    copy_to,
    distribute_local,
    gather,
    mean_over,
    reduce_from,
    size_and_rank,
)


@dataclass
class MoEConfig:
    d_model: int = 128
    d_ff: int = 256
    num_experts: int = 4
    # capacity = capacity_factor * tokens / num_experts, rounded up to a
    # multiple of 8, as the reference rounds it; overflowing tokens drop.
    capacity_factor: float = 1.25
    # Expert-compute dtype: "bf16" or "f32" (router, softmax and aux stay f32).
    compute_dtype: str = "bf16"

    @property
    def act_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bf16" else torch.float32

    def capacity(self, num_tokens: int) -> int:
        cap = math.ceil(self.capacity_factor * num_tokens / self.num_experts)
        return max(8, -(-cap // 8) * 8)


def init_moe_params(rng: torch.Generator, cfg: MoEConfig, device=None):
    """Random params with the JAX shapes and scales, drawn from ``rng`` (a
    generator on ``device``, default CUDA)."""
    dev = resolve_device(device)
    E, D, F_ = cfg.num_experts, cfg.d_model, cfg.d_ff

    def dense(shape, scale):
        return torch.randn(shape, generator=rng, dtype=torch.float32, device=dev) * scale

    return {
        "router": dense((D, E), D ** -0.5),
        "w1": dense((E, D, F_), D ** -0.5),
        "w2": dense((E, F_, D), F_ ** -0.5),
    }


def expert_specs():
    """DTensor placements over a one-dimensional expert mesh: the expert
    axis sharded, the router replicated."""
    from torch.distributed.tensor import Replicate, Shard

    return {"router": (Replicate(),), "w1": (Shard(0),), "w2": (Shard(0),)}


def moe_ffn(params, x, cfg: MoEConfig, ep_group=None, token_group=None, seq_group=None):
    """x [B, S, D] -> (y [B, S, D] in x's dtype, aux); top-1 routed expert
    FFN and the Switch load-balancing loss (E · Σ fraction routed · mean
    router prob, per expert).  ``ep_group``/``token_group``/``seq_group``:
    see the module docstring; None for one device."""
    B, S, D = x.shape
    E = cfg.num_experts
    T = B * S
    n_tok, tok_rank = size_and_rank(token_group)
    n_seq, _ = size_and_rank(seq_group)
    C = cfg.capacity(T * n_tok * n_seq)
    n_ep, ep_rank = size_and_rank(ep_group)
    E_local = params["w1"].shape[0]
    if E_local * n_ep != E:
        raise ValueError(f"{E_local} local experts on each of {n_ep} ranks, config has {E}")
    tokens = x.reshape(T, D)

    logits = tokens.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)  # [T, E]
    expert = probs.argmax(dim=-1)  # the first maximum, as jnp.argmax
    gate = probs.gather(1, expert[:, None])[:, 0]  # [T]

    # By comparison: F.one_hot checks its indices on the host, a device sync
    # each call.
    onehot = (expert[:, None] == torch.arange(E, device=x.device)).float()  # [T, E]
    # Position of each token within its expert's queue; >= C drops.
    position = _position(onehot.view(B, S, E), token_group, seq_group).reshape(T, E)
    keep = (position < C) * onehot
    # The slot's one-hot: a slot >= C (an overflowing token) gives a zero
    # row, as jax.nn.one_hot does; F.one_hot would raise.
    slot = position.sum(-1).long()
    act = cfg.act_dtype
    pos_onehot = (slot[:, None] == torch.arange(C, device=x.device)).to(act)  # [T, C]

    # This rank's experts.  dispatch and combine are built in the activation
    # dtype: 0/1 masks and the gate rounded once, the values JAX casts to it.
    lo = ep_rank * E_local
    dispatch = keep[:, lo:lo + E_local, None].to(act) * pos_onehot[:, None, :]  # [T, El, C]
    combine = dispatch * copy_to(gate, ep_group).to(act)[:, None, None]
    # Dispatch → per-expert FFN → combine.  The two routing products are
    # 2-D (aten.mm, kept by remat "dots" as JAX keeps tec,td->ecd and
    # tec,ecd->td); the expert products carry the expert axis as a batch
    # dim (aten.bmm, recomputed, as JAX recomputes ecd,edf->ecf).
    routed = copy_to(tokens, ep_group).to(act)
    expert_in = (dispatch.reshape(T, E_local * C).t() @ routed).view(E_local, C, D)
    h = F.gelu(torch.bmm(expert_in, params["w1"].to(act)), approximate="tanh")
    expert_out = torch.bmm(h, params["w2"].to(act))  # [El, C, D]
    # Each row of combine holds at most one nonzero, so this product rounds
    # once, like JAX's f32 product cast back to x's dtype.
    y = combine.reshape(T, E_local * C) @ expert_out.reshape(E_local * C, D)
    y = reduce_from(y, ep_group)

    frac_tokens = mean_over(mean_over(onehot.mean(0), token_group), seq_group)
    frac_probs = mean_over(mean_over(probs.mean(0), token_group), seq_group)
    aux = E * (frac_tokens * frac_probs).sum()
    return y.reshape(B, S, D).to(x.dtype), aux


def _position(onehot, token_group, seq_group):
    """Each token's place in its expert's queue, for onehot [b, s, E] this
    rank's block of its dp shard's rows, in the global order (dp rank, row,
    sequence block): its place within its (row, block), plus the counts of
    every earlier (dp rank, row, block), gathered over sp and dp.  With no
    groups: the running count over the flattened b·s tokens."""
    b, s, E = onehot.shape
    # The running count is a scan along the inner dim of [b, E, s]: along
    # the outer dim of [b·s, E] the scan has only E columns to spread over
    # the card (1.3 ms a call at b·s = 8192 on an H100).
    inner = (onehot.transpose(1, 2).contiguous().cumsum(2).transpose(1, 2) - onehot) * onehot
    n_tok, tok_rank = size_and_rank(token_group)
    n_seq, seq_rank = size_and_rank(seq_group)
    counts = onehot.sum(1)[None]  # [1, b, E]: this (row, block)'s counts
    counts = gather(counts, seq_group, 0, partial_grads=False)  # [n_seq, b, E]
    counts = gather(counts[None], token_group, 0, partial_grads=False)  # [n_tok, n_seq, b, E]
    order = counts.permute(0, 2, 1, 3).reshape(-1, E)  # (dp rank, row, block)
    before = (order.cumsum(0) - order).view(n_tok, b, n_seq, E)[tok_rank, :, seq_rank]
    return inner + before[:, None, :] * onehot


def shard_moe_params(params, mesh, ep_axis: str = "ep"):
    """The params as DTensors over ``mesh[ep_axis]`` with ``expert_specs``;
    each rank keeps its own copy of its shard."""
    sub = mesh[ep_axis]
    specs = expert_specs()
    return {k: distribute_local(v, sub, specs[k]) for k, v in params.items()}
