"""Plain reference of the decoder train step that the benchmark's cells run.

Written from the model's equations, in float32 and plain PyTorch, with no
kernel and no dispatch tensor (each layer is recomputed in the backward, so
that a full batch fits; that changes no arithmetic):

- x = embed[tokens] + pos[:S]
- each layer: h = rmsnorm(x)·ln1; q, k, v from one product h·Wqkv (Wqkv
  [D, H, 3·hd], split on the 3-axis); causal softmax(q·kᵀ/√hd)·v; x += o·Wo;
  h = rmsnorm(x)·ln2; x += gelu_tanh(h·W1)·W2, or the Switch FFN below
- the Switch FFN (top-1): router probabilities softmax(h·Wr) in f32, each
  token to its argmax expert, the expert's queue in token order (batch
  major), tokens at or past the capacity max(8, ⌈cf·T/E⌉ rounded up to 8)
  dropped (output 0), a kept token's output gate·FFN_e(h); aux =
  E·Σ_e (share of tokens routed to e)·(mean probability of e); the loss
  adds aux_weight × the mean of the layers' aux
- rmsnorm(x)·ln_f, then the next-token cross-entropy against the tied
  embedding: mean over B·(S−1) rows of logsumexp(x·Eᵀ) − the target's logit
- AdamW with its moments stored in bfloat16: m = bf16(b1·m + (1−b1)·g),
  v = bf16(b2·v + (1−b2)·g²), p += −lr·((m/c1)/(√(v/c2) + eps) + wd·p),
  c = 1 − b^count

It imports nothing of the program.  The weights come from ``make_params``,
which the benchmark hands to the program and to this reference alike.

``precision="fp8"`` is the control: every tensor that the configuration
holds in bfloat16 (the activations, the residual stream and each product's
operands and result) is rounded to float8, its value to e4m3 and its
gradient to e5m2, one scale per tensor; the router's float32 product takes
bfloat16 operands.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def param_shapes(conf: dict, seq: int) -> dict:
    """Leaf → (shape, init scale); scale None is a norm's ones."""
    m = conf["model"]
    V, D, H, L, F_, E = (m[k] for k in ("vocab", "d_model", "n_heads", "n_layers", "d_ff",
                                         "num_experts"))
    hd = D // H
    s = D ** -0.5
    shapes = {
        "embed": ((V, D), 0.02),
        "pos": ((seq, D), 0.02),
        "layers.wqkv": ((L, D, H, 3 * hd), s),
        "layers.wo": ((L, H, hd, D), s),
    }
    if E:
        shapes.update({"layers.router": ((L, D, E), s),
                       "layers.w1": ((L, E, D, F_), s),
                       "layers.w2": ((L, E, F_, D), F_ ** -0.5)})
    else:
        shapes.update({"layers.w1": ((L, D, F_), s), "layers.w2": ((L, F_, D), F_ ** -0.5)})
    shapes.update({"layers.ln1": ((L, D), None), "layers.ln2": ((L, D), None),
                   "ln_f": ((D,), None)})
    return shapes


def nest(flat: dict) -> dict:
    """{"layers.w1": t, ...} → {"layers": {"w1": t}, ...}."""
    tree: dict = {}
    for name, t in flat.items():
        *outer, leaf = name.split(".")
        node = tree
        for key in outer:
            node = node.setdefault(key, {})
        node[leaf] = t
    return tree


def flatten(tree: dict, prefix: str = "") -> dict:
    """The reverse of ``nest``."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, name + "."))
        else:
            out[name] = v
    return out


def make_params(conf: dict, seq: int, seed: int, device) -> dict:
    """The weights of a run, from ``seed``: one normal draw on ``device`` for
    every random leaf at once, each leaf a view of it times its scale; the
    norms' scales are ones.  float32, the type the program keeps its master
    weights in.  The same seed on the same device gives the same weights."""
    shapes = param_shapes(conf, seq)
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(shape) for shape, scale in shapes.values() if scale is not None)
    buf = torch.randn(total, generator=gen, dtype=torch.float32, device=device)
    flat, at = {}, 0
    for name, (shape, scale) in shapes.items():
        if scale is None:
            flat[name] = torch.ones(shape, dtype=torch.float32, device=device)
            continue
        n = math.prod(shape)
        flat[name] = buf[at:at + n].view(shape).mul_(scale)
        at += n
    return nest(flat)


def _to_fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """x rounded to a float8 ``dtype`` with one scale for the tensor, its
    largest magnitude at ``top``."""
    if not x.numel():
        return x
    scale = top / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).float() / scale


_ROUND = {
    # forward, backward
    "fp8": (lambda x: _to_fp8(x, torch.float8_e4m3fn, 448.0),
            lambda g: _to_fp8(g, torch.float8_e5m2, 57344.0)),
    "bf16": (lambda x: x.bfloat16().float(), lambda g: g.bfloat16().float()),
}


class _Round(torch.autograd.Function):
    """A tensor held in a lower precision: the value rounded on the way
    forward, its gradient rounded on the way back."""

    @staticmethod
    def forward(ctx, x, fmt: str):
        ctx.fmt = fmt
        return _ROUND[fmt][0](x)

    @staticmethod
    def backward(ctx, g):
        return _ROUND[ctx.fmt][1](g), None


class _Precision:
    def __init__(self, precision: str):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision must be f32|fp8, got {precision!r}")
        lo = precision == "fp8"
        # A tensor the configuration holds in bfloat16 (float8: e4m3 values,
        # e5m2 gradients), and the router's float32 operands (bfloat16).
        self.act = (lambda t: _Round.apply(t, "fp8")) if lo else (lambda t: t)
        self.router = (lambda t: _Round.apply(t, "bf16")) if lo else (lambda t: t)

    def mm(self, a, b):
        """A product the configuration runs in bfloat16, and its result."""
        return self.act(self.act(a) @ self.act(b))


def _rmsnorm(x, scale):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + 1e-6) * scale


def _gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


class _CausalAttention(torch.autograd.Function):
    """softmax(q·kᵀ + causal mask)·v over q, k, v [B, H, S, hd] (q already
    scaled), computed in blocks of ``block`` queries so that the [S, S]
    probabilities never exist at once; the backward recomputes them from
    the saved row logsumexp."""

    @staticmethod
    def forward(ctx, q, k, v, block: int):
        S = q.shape[2]
        o = torch.empty_like(q)
        lse = torch.empty(q.shape[:3], dtype=q.dtype, device=q.device)
        for i0 in range(0, S, block):
            i1 = min(S, i0 + block)
            p, lse[:, :, i0:i1] = _probs(q, k, i0, i1)
            o[:, :, i0:i1] = p @ v[:, :, :i1]
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.block = block
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        S = q.shape[2]
        dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
        for i0 in range(0, S, ctx.block):
            i1 = min(S, i0 + ctx.block)
            p, _ = _probs(q, k, i0, i1, lse[:, :, i0:i1])
            dob = do[:, :, i0:i1]
            dv[:, :, :i1] += p.transpose(-1, -2) @ dob
            dp = dob @ v[:, :, :i1].transpose(-1, -2)
            ds = p * (dp - (dob * o[:, :, i0:i1]).sum(-1, keepdim=True))
            dq[:, :, i0:i1] = ds @ k[:, :, :i1]
            dk[:, :, :i1] += ds.transpose(-1, -2) @ q[:, :, i0:i1]
        return dq, dk, dv, None


def _probs(q, k, i0, i1, lse=None):
    """Probabilities of queries [i0, i1) over keys [0, i1), and their row
    logsumexp (given, or computed)."""
    s = q[:, :, i0:i1] @ k[:, :, :i1].transpose(-1, -2)
    later = (torch.arange(i1, device=q.device)[None, :]
             > torch.arange(i0, i1, device=q.device)[:, None])
    s = s.masked_fill(later, float("-inf"))
    if lse is None:
        lse = torch.logsumexp(s, dim=-1)
    return torch.exp(s - lse[..., None]), lse


def _switch_ffn(h, lp, m: dict, prec: _Precision):
    """The Switch FFN over h [B, S, D]; returns (out [B, S, D], aux)."""
    B, S, D = h.shape
    E, T = m["num_experts"], B * S
    cap = math.ceil(m["moe_capacity_factor"] * T / E)
    cap = max(8, -(-cap // 8) * 8)
    t = h.reshape(T, D)
    probs = torch.softmax(prec.router(t) @ prec.router(lp["router"]), dim=-1)  # [T, E]
    expert = probs.argmax(dim=-1)
    gate = probs.gather(1, expert[:, None])[:, 0]
    routed = F.one_hot(expert, E).float()
    # Each token's place in its expert's queue, in token order.
    place = (routed.cumsum(0) - routed).gather(1, expert[:, None])[:, 0]
    out = torch.zeros_like(t)
    for e in range(E):
        idx = torch.nonzero((expert == e) & (place < cap))[:, 0]
        y = prec.mm(prec.act(_gelu_tanh(prec.mm(t[idx], lp["w1"][e]))), lp["w2"][e])
        out = out.index_add(0, idx, gate[idx, None] * y)
    aux = E * (routed.mean(0) * probs.mean(0)).sum()
    return prec.act(out).view(B, S, D), aux


def _layer(x, lp: dict, m: dict, prec: _Precision, attn_block: int):
    """One decoder layer over x [B, S, D]; returns (x, aux or None)."""
    B, S, D = x.shape
    H = m["n_heads"]
    hd = D // H
    h = prec.act(_rmsnorm(x, lp["ln1"])).reshape(B * S, D)
    qkv = prec.mm(h, lp["wqkv"].reshape(D, H * 3 * hd)).view(B, S, H, 3, hd)
    q, k, v = (qkv[:, :, :, i].transpose(1, 2) for i in range(3))
    o = prec.act(_CausalAttention.apply(prec.act(q * hd ** -0.5), k, v, attn_block))
    x = prec.act(x + prec.mm(o.transpose(1, 2).reshape(B * S, D),
                             lp["wo"].reshape(D, D)).view(B, S, D))
    h = prec.act(_rmsnorm(x, lp["ln2"]))
    aux = None
    if m["num_experts"]:
        y, aux = _switch_ffn(h, lp, m, prec)
    else:
        h = prec.act(_gelu_tanh(prec.mm(h.reshape(B * S, D), lp["w1"])))
        y = prec.mm(h, lp["w2"]).view(B, S, D)
    return prec.act(x + y), aux


def _ce_rows_sum(x, target, embed, prec: _Precision):
    """Σ over rows of logsumexp(x·Eᵀ) − the target's logit: bfloat16
    operands, a float32 result."""
    logits = prec.act(x) @ prec.act(embed.t())
    return (torch.logsumexp(logits, dim=-1) - logits.gather(1, target[:, None])[:, 0]).sum()


def loss_fn(params: dict, tokens: torch.Tensor, conf: dict, precision: str = "f32",
            attn_block: int = 1024, ce_rows: int = 8192):
    """Next-token cross-entropy of ``tokens`` [B, S] (plus the MoE aux term).

    Each layer, and the head over each block of ``ce_rows`` rows, is
    recomputed in the backward (``torch.utils.checkpoint``), so that only
    one layer's activations and one block's logits are held at a time: the
    same arithmetic, in memory that a full batch fits in."""
    m = conf["model"]
    prec = _Precision(precision)
    B, S = tokens.shape
    D = m["d_model"]
    x = prec.act(params["embed"][tokens] + params["pos"][:S])
    auxs = []
    for layer in range(m["n_layers"]):
        lp = {k: v[layer] for k, v in params["layers"].items()}
        x, aux = checkpoint(_layer, x, lp, m, prec, attn_block, use_reentrant=False)
        if aux is not None:
            auxs.append(aux)
    x = prec.act(_rmsnorm(x, params["ln_f"]))[:, :-1].reshape(B * (S - 1), D)
    target = tokens[:, 1:].reshape(-1)
    total = sum(checkpoint(_ce_rows_sum, x[i:i + ce_rows], target[i:i + ce_rows],
                           params["embed"], prec, use_reentrant=False)
                for i in range(0, len(x), ce_rows))
    loss = total / len(x)
    if auxs:
        loss = loss + m["moe_aux_weight"] * torch.stack(auxs).mean()
    return loss


def adamw_bf16_moments(params: dict, grads: dict, state, opt: dict):
    """One AdamW step in place on the flat ``params``; state (m, v, count)
    with bfloat16 moments, None before the first step.  Returns the state."""
    if state is None:
        state = ({n: torch.zeros_like(p, dtype=torch.bfloat16) for n, p in params.items()},
                 {n: torch.zeros_like(p, dtype=torch.bfloat16) for n, p in params.items()}, 0)
    mu, nu, count = state
    count += 1
    b1, b2 = opt["b1"], opt["b2"]
    c1, c2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    for n, p in params.items():
        g = grads[n]
        mu[n] = (b1 * mu[n].float() + (1.0 - b1) * g).bfloat16()
        nu[n] = (b2 * nu[n].float() + (1.0 - b2) * g * g).bfloat16()
        step = (mu[n].float() / c1) / (torch.sqrt(nu[n].float() / c2) + opt["eps"])
        p.sub_(opt["learning_rate"] * (step + opt["weight_decay"] * p))
    return mu, nu, count


def model_flops_per_step(conf: dict, seq: int, batch: int, n_params: int) -> float:
    """Model FLOPs a step, over the batch·(seq − 1) tokens trained: dense,
    6·N + 12·L·S·D a token (N the params, counted from the cell's tree; the
    second term the attention products); Switch-MoE, the same with N the
    active params, one expert FFN a layer: N − L·(E − 1)·2·D·F.  Capacity
    padding and the dispatch/combine products are not model FLOPs."""
    L, D, F_, E = (conf["model"][k] for k in ("n_layers", "d_model", "d_ff", "num_experts"))
    active = n_params - L * (E - 1) * 2 * D * F_ if E else n_params
    return batch * (seq - 1) * (6 * active + 12 * L * seq * D)


def follow(conf: dict, params: dict, batches, precision: str = "f32", rows=None,
           frozen: bool = False) -> dict:
    """Train ``params`` (the tree of ``make_params``, updated in place) on
    ``batches`` one step each and read what the benchmark compares: each
    step's loss, each leaf's gradient norm at the first step, and each
    leaf's change over all the steps.  Planted faults: ``rows`` keeps only
    those rows of each batch; ``frozen`` is a step that returns its state
    unchanged (no update, and the program's first moment, which its
    gradient norm is read from, stays zero)."""
    flat = flatten(params)
    start = {n: p.clone() for n, p in flat.items()}
    losses, grad_norms, state = [], None, None
    for tokens in batches:
        tokens = tokens if rows is None else tokens[rows]
        live = {n: p.detach().requires_grad_() for n, p in flat.items()}
        loss = loss_fn(nest(live), tokens, conf, precision)
        grads = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
        del live
        losses.append(float(loss.detach()))
        if grad_norms is None:
            grad_norms = {n: 0.0 if frozen else float(g.norm()) for n, g in grads.items()}
        if not frozen:
            with torch.no_grad():
                state = adamw_bf16_moments(flat, grads, state, conf["optimizer"])
        del grads, loss
    with torch.no_grad():
        change = {n: float((flat[n] - start[n]).norm()) for n in flat}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
