"""Switch-style top-1 mixture-of-experts FFN: the counterpart of
``tpudra/workload/moe.py``; and DeepSeek-V2's dropless top-k FFN with shared
experts (``moe_topk_ffn``), which the JAX package does not have.

The Switch layer computes what the JAX package's Mesh-TensorFlow
dispatch/combine products compute, by index instead of by product over
[tokens, experts, capacity] masks: routing gives each token a slot (its
expert's row block of a [experts, capacity] buffer, at its place in the
expert's queue) and each slot its token (``switch_route``); dispatch
gathers the tokens into the buffer, the expert FFNs run batched over the
expert axis, and combine gathers each token's output row back, scaled by
its gate.  Each mask row and column holds at most one nonzero, so the
gathers give the products' values to the bit (the gate's gradient sums
its row in another order).  Tokens past an expert's capacity are dropped
(their output row is zero, the residual passes them through).

Expert parallelism is explicit here, where the JAX package leaves it to
GSPMD.  With ``ep_group``, ``w1``/``w2`` are this rank's ``E/ep`` experts
and the tokens are the same on every rank of the group: each rank routes
all tokens (the router is replicated), runs the dispatch, expert and
combine steps for its own experts only, and the partial outputs are
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
from torch.profiler import record_function

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
    n_tok, _ = size_and_rank(token_group)
    n_seq, _ = size_and_rank(seq_group)
    C = cfg.capacity(T * n_tok * n_seq)
    n_ep, ep_rank = size_and_rank(ep_group)
    E_local = params["w1"].shape[0]
    if E_local * n_ep != E:
        raise ValueError(f"{E_local} local experts on each of {n_ep} ranks, config has {E}")
    tokens = x.reshape(T, D)
    act = cfg.act_dtype

    with record_function("moe.route"):
        rt = switch_route(tokens, params["router"], cfg, B, C, ep_rank * E_local, E_local,
                          token_group, seq_group)
        # The gate rounded once to the activation dtype, the value JAX casts
        # its combine tensor to.
        gate = copy_to(rt["gate"], ep_group).to(act)
        routed = copy_to(tokens, ep_group).to(act)
        expert_in = switch_dispatch(routed, rt).view(E_local, C, D)
    # The expert products carry the expert axis as a batch dim (aten.bmm,
    # recomputed under remat "dots", as JAX recomputes ecd,edf->ecf).
    with record_function("moe.experts"):
        h = F.gelu(torch.bmm(expert_in, params["w1"].to(act)), approximate="tanh")
        expert_out = torch.bmm(h, params["w2"].to(act))  # [El, C, D]
    y = switch_combine(expert_out.view(E_local * C, D), gate, rt)
    y = reduce_from(y, ep_group)

    frac_tokens = mean_over(mean_over(rt["onehot"].mean(0), token_group), seq_group)
    frac_probs = mean_over(mean_over(rt["probs"].mean(0), token_group), seq_group)
    aux = E * (frac_tokens * frac_probs).sum()
    return y.reshape(B, S, D).to(x.dtype), aux


def switch_route(tokens, router, cfg: MoEConfig, B: int, C: int, lo: int, E_local: int,
                 token_group=None, seq_group=None):
    """Top-1 routing of tokens [T, D] (T = B·S, rows batch-major) at
    capacity C, for the experts lo .. lo + E_local − 1 held here.  Returns a
    dict: ``probs`` [T, E] (softmax of the f32 router product), ``onehot``
    [T, E] f32 (each token's expert: the first maximum, as jnp.argmax),
    ``gate`` [T] f32 (its probability), ``slot`` [T] (its row of the
    [E_local·C] buffer, (expert − lo)·C + its place in the expert's queue;
    E_local·C, one past the buffer, where it is dropped or its expert is not
    held), ``src`` [E_local·C] (each row's token; T where the row is empty)
    and ``rows`` [E_local] (tokens kept per held expert).  For the gathers
    (``switch_dispatch``, ``switch_combine``): ``slot_row`` and ``src_row``,
    the same indices clamped into range, and ``kept`` [T, 1] and ``filled``
    [E_local·C, 1], 1 where the index is real, 0 where not, in the
    activation dtype.  All on the device, with no host sync."""
    T, _ = tokens.shape
    E = cfg.num_experts
    n_rows = E_local * C
    probs = torch.softmax(tokens.float() @ router, dim=-1)  # [T, E]
    expert = probs.argmax(dim=-1)  # the first maximum, as jnp.argmax
    gate = probs.gather(1, expert[:, None])[:, 0]
    # By comparison: F.one_hot checks its indices on the host, a device sync
    # each call.
    onehot = (expert[:, None] == torch.arange(E, device=tokens.device)).float()  # [T, E]
    # Position of each token within its expert's queue; >= C drops.
    position = _position(onehot.view(B, T // B, E), token_group, seq_group).reshape(T, E)
    keep = ((position < C) * onehot)[:, lo:lo + E_local]  # [T, E_local]
    kept = keep.sum(1, keepdim=True)  # [T, 1]: 1 where kept here
    slot = torch.where(kept[:, 0] > 0, (expert - lo) * C + position.sum(-1).long(), n_rows)
    # Every dropped token writes the spare last entry, which is cut off; the
    # kept tokens' slots are unique.
    src = torch.full((n_rows + 1,), T, dtype=torch.int64, device=tokens.device)
    src = src.scatter_(0, slot, torch.arange(T, device=tokens.device))[:n_rows]
    act = cfg.act_dtype
    return {"probs": probs, "onehot": onehot, "gate": gate, "slot": slot, "src": src,
            "rows": keep.sum(0).long(), "slot_row": slot.clamp(max=n_rows - 1),
            "src_row": src.clamp(max=T - 1), "kept": kept.to(act),
            "filled": (src < T)[:, None].to(act)}


class _SlotGather(torch.autograd.Function):
    """The buffer [E_local·C, D] of a Switch layer's held experts: row s is
    token src[s]'s row of h [T, D], zero where empty.  The backward gathers
    too: token t's gradient is the buffer gradient's row slot[t], zero where
    it was dropped.  Every index is unique, so neither way needs atomics.
    Indices in range, masks in h's dtype (``switch_route``'s ``*_row``,
    ``kept`` and ``filled``)."""

    @staticmethod
    def forward(ctx, h, slot, src, kept, filled):
        ctx.save_for_backward(slot, kept)
        return h.index_select(0, src) * filled

    @staticmethod
    def backward(ctx, g):
        slot, kept = ctx.saved_tensors
        return g.index_select(0, slot) * kept, None, None, None, None


class _SlotCombine(torch.autograd.Function):
    """y [T, D] = gate[t] · out[slot[t]] for the buffer's rows out
    [E_local·C, D] back in token order, zero for a dropped token: one
    product of two values in out's dtype, which PyTorch takes in f32 and
    rounds once, as a mask product with one nonzero a row rounds it.
    Backward: out's gradient is gate · gy gathered by ``src`` (rounded once,
    zero where empty), the gate's the f32 sum over d of gy · out[slot]
    rounded to its dtype (zero where dropped).  Indices and masks as
    ``_SlotGather``'s; gate [T] in out's dtype."""

    @staticmethod
    def forward(ctx, out, gate, slot, src, kept, filled):
        gate = gate[:, None] * kept  # [T, 1], 0 where dropped
        rows = out.index_select(0, slot)
        ctx.save_for_backward(rows, gate, src, kept, filled)
        return rows * gate

    @staticmethod
    def backward(ctx, gy):
        rows, gate, src, kept, filled = ctx.saved_tensors
        g_out = (gy * gate).index_select(0, src) * filled
        g_gate = ((gy.float() * rows).sum(-1) * kept[:, 0]).to(gate.dtype)
        return g_out, g_gate, None, None, None, None


def switch_dispatch(h, rt):
    """The held experts' buffer [E_local·C, D]: h [T, D]'s row of each
    slot's token, per ``switch_route``'s ``rt``; zeros in empty slots."""
    return _SlotGather.apply(h, rt["slot_row"], rt["src_row"], rt["kept"], rt["filled"])


def switch_combine(out, gate, rt):
    """y [T, D] in out's dtype: each token's row of the buffer out
    [E_local·C, D] times its gate [T] (out's dtype); zero where dropped."""
    return _SlotCombine.apply(out, gate, rt["slot_row"], rt["src_row"], rt["kept"],
                              rt["filled"])


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


# -- DeepSeek-V2's top-k FFN ---------------------------------------------------


@dataclass
class TopKConfig:
    d_model: int = 128
    # Each routed expert's SwiGLU width.
    d_ff: int = 64
    # The routed experts held here: experts first .. first + num_experts − 1
    # of the n_routed that the router scores (an expert-parallel share).
    num_experts: int = 4
    n_routed: int = 8
    top_k: int = 2
    # The shared experts' SwiGLU width (0: none).
    shared_d_ff: int = 64
    compute_dtype: str = "bf16"

    @property
    def act_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bf16" else torch.float32


def _gated(gu):
    """silu(g) ⊙ u for gu = [g | u] [N, 2F]."""
    f = gu.shape[1] // 2
    return F.silu(gu[:, :f]) * gu[:, f:]


def swiglu(h, w_in, w_out):
    """(silu(h·Wg) ⊙ (h·Wu))·Wd for h [N, D], w_in = [Wg | Wu] [D, 2F] and
    w_out = Wd [F, D]: two 2-D products."""
    return _gated(h @ w_in) @ w_out


def grouped_mm(x, w, offs):
    """Rows [offs[e−1], offs[e]) of x [R, K] times w[e] [K, N], for each of
    the G groups of w [G, K, N]; offs [G] int32 on x's device, cumulative.
    Rows past offs[−1] are not read and come out zero.  CUDA tensors take
    ``torch._grouped_mm`` (the card's grouped GEMM, offsets read on the
    device, no host sync); CPU tensors the plain loop, which reads the
    offsets on the host."""
    if x.is_cuda:
        return torch._grouped_mm(x, w, offs=offs)
    parts, start = [], 0
    for e, end in enumerate(offs.tolist()):
        parts.append(x[start:end] @ w[e])
        start = end
    parts.append(x.new_zeros((x.shape[0] - start, w.shape[-1])))
    return torch.cat(parts)


def expert_products(xs, experts_in, experts_out, offs):
    """Each held expert's SwiGLU over its rows of xs [R, D] (rows in expert
    order, ``offs`` cumulative): two grouped products and the gating between
    them.  Rows past offs[−1] come out zero or are never read."""
    return grouped_mm(_gated(grouped_mm(xs, experts_in, offs)), experts_out, offs)


class _Dispatch(torch.autograd.Function):
    """Rows of h [T, D] in expert order: out[r] = h[token[r]] where
    valid[r], else 0.  The backward gathers instead of scattering: token t's
    gradient is the sum over its k slots of the rows ``inv`` [T, k] points
    at (row R, one past the buffer, is zero), in f32 and in slot order, so
    that it repeats bit for bit."""

    @staticmethod
    def forward(ctx, h, token, valid, inv):
        ctx.save_for_backward(valid, inv)
        return torch.where(valid[:, None], h[token], 0)

    @staticmethod
    def backward(ctx, g):
        valid, inv = ctx.saved_tensors
        g = torch.cat((torch.where(valid[:, None], g, 0), g.new_zeros((1, g.shape[1]))))
        total = g[inv[:, 0]].float()
        for j in range(1, inv.shape[1]):
            total += g[inv[:, j]].float()
        return total.to(g.dtype), None, None, None


class _Combine(torch.autograd.Function):
    """y [T, D] (f32) = Σ over token t's k slots of gate × out row: the
    gate-weighted expert rows out [R, D] back in token order, summed in
    slot order (no atomics).  gate [R] f32 is 0 where a row is not valid."""

    @staticmethod
    def forward(ctx, out, gate, token, valid, inv):
        ctx.save_for_backward(out, gate, token, valid)
        weighted = torch.cat((torch.where(valid[:, None], out, 0).float() * gate[:, None],
                              out.new_zeros((1, out.shape[1]), dtype=torch.float32)))
        y = weighted[inv[:, 0]].clone()
        for j in range(1, inv.shape[1]):
            y += weighted[inv[:, j]]
        return y

    @staticmethod
    def backward(ctx, gy):
        out, gate, token, valid = ctx.saved_tensors
        g = torch.where(valid[:, None], gy[token], 0)  # [R, D] f32
        gout = (g * gate[:, None]).to(out.dtype)
        ggate = (g * out.float()).sum(-1)
        return gout, ggate, None, None, None


def route_topk(h, router, cfg: TopKConfig, B: int, first: int = 0):
    """Routing of h [T, D] (T = B·S, rows batch-major): the probabilities
    softmax(h·Wr) in f32 over all n_routed experts, each token's top_k
    (weights the probabilities themselves, not renormalised), and the
    (token, slot) pairs whose expert is held here, ordered by expert on the
    device.  Returns a dict: ``offs`` [E] int32 (cumulative rows per held
    expert), ``rows`` [E] (rows per held expert), ``token``/``gate``/
    ``valid`` [R] for the buffer's rows (R = T·min(k, E), enough for every
    token to reach min(k, E) held experts), ``inv`` [T, k] (each slot's
    buffer row, R where its expert is not held), ``aux`` (DeepSeek's
    sequence-wise balance loss over all experts: mean over rows of
    Σ_e (n_routed / (S·k))·count_e · mean_s p_e)."""
    T, _ = h.shape
    S, E, k = T // B, cfg.num_experts, cfg.top_k
    R = T * min(k, E)
    probs = torch.softmax(h.float() @ router, dim=-1)  # [T, n_routed]
    top_p, top_e = probs.topk(k, dim=-1)
    counts = torch.zeros((B, cfg.n_routed), device=h.device).scatter_add_(
        1, top_e.view(B, S * k), torch.ones((B, S * k), device=h.device))
    aux = (counts * (cfg.n_routed / (S * k)) * probs.view(B, S, -1).mean(1)).sum(1).mean()
    local = top_e.view(-1) - first
    held = (local >= 0) & (local < E)
    key = torch.where(held, local, E)  # the experts not held sort last
    order = torch.argsort(key, stable=True)
    # Counts by scatter, not bincount: bincount reads its size on the host.
    per = torch.zeros(E + 1, dtype=torch.int64, device=h.device).scatter_add_(
        0, key, torch.ones_like(key))
    offs = per[:E].cumsum(0).to(torch.int32)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(T * k, device=h.device)
    order = order[:R]
    return {"offs": offs, "rows": per[:E], "token": order // k,
            "gate": torch.where(held[order], top_p.view(-1)[order], 0.0),
            "valid": held[order], "inv": torch.where(held, pos, R).view(T, k), "aux": aux}


def dispatch(h, routed):
    """The buffer of rows [R, D] that ``route_topk``'s ``routed`` orders by
    expert: h's row of each held (token, slot) pair, zeros past them."""
    return _Dispatch.apply(h, routed["token"], routed["valid"], routed["inv"])


def moe_topk_ffn(params, x, cfg: TopKConfig, first: int = 0):
    """x [B, S, D] → (y [B, S, D] in x's dtype, aux, rows [num_experts]):
    DeepSeek-V2's MoE FFN over the routed experts held here (``first`` on)
    plus the shared expert; dropless, every (token, held expert) pair is
    computed.  ``params``: router [D, n_routed] (f32 product), experts_in
    [E, D, 2F], experts_out [E, F, D], and shared_in, shared_out where
    cfg.shared_d_ff.  The experts run as grouped products over their rows,
    ordered by expert on the device (no host sync); ``rows`` counts each
    held expert's rows."""
    B, S, D = x.shape
    act = cfg.act_dtype
    h = x.reshape(B * S, D)
    with record_function("moe.route"):
        rt = route_topk(h, params["router"], cfg, B, first)
        xs = dispatch(h, rt)
    with record_function("moe.experts"):
        out = expert_products(xs, params["experts_in"].to(act), params["experts_out"].to(act),
                              rt["offs"])
    y = _Combine.apply(out, rt["gate"], rt["token"], rt["valid"], rt["inv"])
    if cfg.shared_d_ff:
        with record_function("moe.shared"):
            y = y + swiglu(h, params["shared_in"].to(act), params["shared_out"].to(act)).float()
    return y.to(x.dtype).view(B, S, D), rt["aux"], rt["rows"]
