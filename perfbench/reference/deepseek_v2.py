"""Plain reference of the DeepSeek-V2 train step that the benchmark's
``deepseek_v2_lite`` cells run (DeepSeek-AI 2024, "DeepSeek-V2"; the
published config.json of DeepSeek-V2-Lite), as one card's share of an
expert-parallel group.

Written from the model's equations, in float32 and plain PyTorch, with no
kernel and no grouped product (each layer is recomputed in the backward, so
that a full batch fits; that changes no arithmetic).  x [B, S, D]; rmsnorm
with eps 1e-6; swiglu(h) = (silu(h·Wg) ⊙ (h·Wu))·Wd, Wg and Wu side by side
in one [D, 2F] matrix, gate columns first:

- x = embed[tokens]: no position table
- attention, each layer: h = rmsnorm(x)·ln1; q = h·Wq [B, S, H, nope + rope];
  c = h·Wkv_a = [latent (kv_lora_rank) | k_pe (rope)]; [k_nope | v] =
  (rmsnorm(latent)·kv_norm)·Wkv_b [B, S, H, nope + v]; RoPE on q's rope part
  and on k_pe (one for all heads): the pair (x[2i], x[2i+1]) at position t
  (from 0) turned by the angle t·θ_i, as a complex product; YaRN's θ_i:
  base^(−2i/d) for the pairs before the ramp, that divided by the factor for
  those past it, linear between low = ⌊d·ln(orig/(2π·beta_fast))/(2 ln base)⌋ and high = ⌈the same
  at beta_slow⌉; cos and sin times yarn(factor, mscale) /
  yarn(factor, mscale_all_dim), yarn(f, m) = 0.1·m·ln f + 1; k = [k_nope |
  k_pe], q = [q_nope | q_pe]; causal softmax(q·kᵀ·scale)·v with scale =
  (nope + rope)^(−1/2) · yarn(factor, mscale_all_dim)²; x += o·Wo
- FFN: the first ``first_k_dense_replace`` layers x += swiglu_{d_ff}(h),
  h = rmsnorm(x)·ln2; the others route h over all n_routed_experts:
  p = softmax(h·Wr) in f32, each token's top k by p with the weights p
  themselves (norm_topk_prob false, routed_scaling_factor 1); y = Σ over
  its top k that are held here (experts first .. first + num_experts − 1)
  of p_e·swiglu_e(h), plus the shared expert (one swiglu of n_shared ×
  moe_d_ff); every routed pair is computed (dropless); aux = DeepSeek's
  sequence-wise balance loss: mean over rows b of Σ_e f_e·P_e, f_e =
  (n_routed / (S·k))·(times e is in row b's top k), P_e = the mean over the
  row of p_e
- rmsnorm(x)·ln_f, then the next-token cross-entropy against the untied
  head [V, D]; the loss adds moe_aux_weight × the mean of the MoE layers' aux
- AdamW with bfloat16 moments (``decoder.py``'s)

Departures from the published model, also in the configuration's
``assumed``: the init scales (below); the routing is dropless (the model's
own code drops nothing; the paper's device-level dropping belongs to its
training stack); the aux is averaged over layers, weight 0.001 (the
config's aux_loss_alpha, which the configuration file sets apart from
the published numbers); only the
experts held here, which the configuration states, compute.

Init: embed and head normal·0.02; every projection normal·(fan-in)^(−1/2);
norms ones.  ``precision="fp8"`` is the control, as in ``decoder.py``.  It
imports nothing of the program; ``decoder.py``'s generic helpers are loaded
from the file beside this one.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _load_decoder():
    path = Path(__file__).with_name("decoder.py")
    spec = importlib.util.spec_from_file_location("perfbench_reference_decoder_helpers", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_decoder = _load_decoder()
flatten, nest, _Precision = _decoder.flatten, _decoder.nest, _decoder._Precision
_rmsnorm, _probs, _ce_rows_sum = _decoder._rmsnorm, _decoder._probs, _decoder._ce_rows_sum
adamw_bf16_moments = _decoder.adamw_bf16_moments


def param_shapes(conf: dict, seq: int) -> dict:
    """Leaf → (shape, init scale); scale None is a norm's ones.  The dense
    and the MoE layers are stacked apart, each with a leading layer axis."""
    del seq  # no position table
    m = conf["model"]
    D, H, V = m["d_model"], m["n_heads"], m["vocab"]
    dn, dr, dv, r = (m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"],
                     m["kv_lora_rank"])
    F_, Fm, Fs = m["d_ff"], m["moe_d_ff"], m["n_shared_experts"] * m["moe_d_ff"]

    def attention(key, L):
        return {f"{key}.wq": ((L, D, H * (dn + dr)), D ** -0.5),
                f"{key}.wkv_a": ((L, D, r + dr), D ** -0.5),
                f"{key}.kv_norm": ((L, r), None),
                f"{key}.wkv_b": ((L, r, H * (dn + dv)), r ** -0.5),
                f"{key}.wo": ((L, H * dv, D), (H * dv) ** -0.5),
                f"{key}.ln1": ((L, D), None), f"{key}.ln2": ((L, D), None)}

    shapes = {"embed": ((V, D), 0.02)}
    L = m["first_k_dense_replace"]
    if L:
        shapes.update(attention("dense_layers", L))
        shapes.update({"dense_layers.w_in": ((L, D, 2 * F_), D ** -0.5),
                       "dense_layers.w_out": ((L, F_, D), F_ ** -0.5)})
    L, E = m["n_layers"] - m["first_k_dense_replace"], m["num_experts"]
    if L:
        shapes.update(attention("moe_layers", L))
        shapes.update({"moe_layers.router": ((L, D, m["n_routed_experts"]), D ** -0.5),
                       "moe_layers.experts_in": ((L, E, D, 2 * Fm), D ** -0.5),
                       "moe_layers.experts_out": ((L, E, Fm, D), Fm ** -0.5)})
        if Fs:
            shapes.update({"moe_layers.shared_in": ((L, D, 2 * Fs), D ** -0.5),
                           "moe_layers.shared_out": ((L, Fs, D), Fs ** -0.5)})
    shapes["ln_f"] = ((D,), None)
    shapes["head"] = ((V, D), 0.02)
    return shapes


def make_params(conf: dict, seq: int, seed: int, device) -> dict:
    """The weights of a run, from ``seed``: one normal draw on ``device`` for
    every random leaf at once, each leaf a view of it times its scale; the
    norms' scales are ones.  float32.  The same seed on the same device
    gives the same weights."""
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


def _yarn(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_range(m: dict) -> tuple[int, int]:
    """YaRN's (low, high) pair indices of the ramp."""
    d, base, orig = m["qk_rope_head_dim"], m["rope_theta"], m["rope_original_max_position"]

    def dim(rotations):
        return d * math.log(orig / (rotations * 2 * math.pi)) / (2 * math.log(base))

    return (max(math.floor(dim(m["rope_beta_fast"])), 0),
            min(math.ceil(dim(m["rope_beta_slow"])), d - 1))


def rotations(m: dict, S: int, device) -> torch.Tensor:
    """[S, d/2] complex64: e^(i·t·θ_j) times YaRN's magnitude ratio."""
    d, f = m["qk_rope_head_dim"], m["rope_factor"]
    theta = [m["rope_theta"] ** (-2 * j / d) for j in range(d // 2)]
    if f > 1:
        low, high = yarn_range(m)
        span = max(high - low, 1e-3)
        ramp = [min(max((j - low) / span, 0.0), 1.0) for j in range(d // 2)]
        theta = [t / f * a + t * (1 - a) for t, a in zip(theta, ramp)]
    mag = _yarn(f, m["rope_mscale"]) / _yarn(f, m["rope_mscale_all_dim"])
    angle = torch.outer(torch.arange(S, dtype=torch.float64),
                        torch.tensor(theta, dtype=torch.float64))
    return torch.polar(torch.full_like(angle, mag), angle).to(torch.complex64).to(device)


def attention_scale(m: dict) -> float:
    scale = (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]) ** -0.5
    if m["rope_mscale_all_dim"]:
        scale *= _yarn(m["rope_factor"], m["rope_mscale_all_dim"]) ** 2
    return scale


def _rope(x, rot):
    """x [..., d] (pairs interleaved) turned by rot [..., d/2] (broadcast)."""
    z = torch.view_as_complex(x.float().unflatten(-1, (-1, 2)).contiguous()) * rot
    return torch.view_as_real(z).flatten(-2)


class _CausalAttention(torch.autograd.Function):
    """softmax(q·kᵀ + causal mask)·v over q, k [B, H, S, dk] and v [B, H,
    S, dv] (q already scaled), in blocks of ``block`` queries, the backward
    recomputing the probabilities from the saved row logsumexp
    (``decoder.py``'s, with v narrower than q)."""

    @staticmethod
    def forward(ctx, q, k, v, block: int):
        S = q.shape[2]
        o = q.new_empty(q.shape[:3] + v.shape[3:])
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


def _attention(x, lp: dict, m: dict, prec: _Precision, attn_block: int):
    """x + latent attention of x [B, S, D]."""
    B, S, D = x.shape
    H, dn, dr, dv, r = (m["n_heads"], m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                        m["v_head_dim"], m["kv_lora_rank"])
    h = prec.act(_rmsnorm(x, lp["ln1"])).reshape(B * S, D)
    q = prec.mm(h, lp["wq"]).view(B, S, H, dn + dr)
    c = prec.mm(h, lp["wkv_a"])
    latent = prec.act(_rmsnorm(c[:, :r], lp["kv_norm"]))
    kv = prec.mm(latent, lp["wkv_b"]).view(B, S, H, dn + dv)
    rot = rotations(m, S, x.device)
    q_pe = prec.act(_rope(q[..., dn:], rot[:, None]))
    k_pe = prec.act(_rope(c[:, r:].reshape(B, S, dr), rot))
    q = torch.cat((q[..., :dn], q_pe), dim=-1).transpose(1, 2)
    k = torch.cat((kv[..., :dn], k_pe[:, :, None].expand(B, S, H, dr)), dim=-1).transpose(1, 2)
    v = kv[..., dn:].transpose(1, 2)
    o = prec.act(_CausalAttention.apply(prec.act(q * attention_scale(m)), k, v, attn_block))
    return prec.act(x + prec.mm(o.transpose(1, 2).reshape(B * S, H * dv), lp["wo"]).view(B, S, D))


def _swiglu(h, w_in, w_out, prec: _Precision):
    f = w_out.shape[0]
    gu = prec.mm(h, w_in)
    return prec.mm(prec.act(F.silu(gu[:, :f]) * gu[:, f:]), w_out)


def moe_ffn(h, lp: dict, m: dict, prec: _Precision, first: int = 0):
    """The top-k FFN over h [B, S, D] with the held experts ``first`` on:
    (routed part [B, S, D], shared part or None, aux)."""
    B, S, D = h.shape
    k, E = m["experts_per_token"], m["num_experts"]
    n = m["n_routed_experts"]
    t = h.reshape(B * S, D)
    probs = torch.softmax(prec.router(t) @ prec.router(lp["router"]), dim=-1)  # [T, n]
    top_p, top_e = probs.topk(k, dim=-1)
    chosen = F.one_hot(top_e, n).sum(1).float()  # [T, n]: 1 where e is in the top k
    f = chosen.view(B, S, n).sum(1) * (n / (S * k))
    aux = (f * probs.view(B, S, n).mean(1)).sum(1).mean()
    routed = torch.zeros_like(t)
    for e in range(E):
        tok, slot = torch.nonzero(top_e == first + e, as_tuple=True)
        y = _swiglu(t[tok], lp["experts_in"][e], lp["experts_out"][e], prec)
        routed = routed.index_add(0, tok, top_p[tok, slot, None] * y)
    shared = None
    if "shared_in" in lp:
        shared = _swiglu(t, lp["shared_in"], lp["shared_out"], prec).view(B, S, D)
    return routed.view(B, S, D), shared, aux


def _layer(x, lp: dict, m: dict, prec: _Precision, attn_block: int, moe: bool):
    """One layer over x [B, S, D]; returns (x, aux or None)."""
    B, S, D = x.shape
    x = _attention(x, lp, m, prec, attn_block)
    h = prec.act(_rmsnorm(x, lp["ln2"]))
    if not moe:
        return prec.act(x + _swiglu(h.reshape(B * S, D), lp["w_in"], lp["w_out"],
                                    prec).view(B, S, D)), None
    routed, shared, aux = moe_ffn(h, lp, m, prec)
    y = prec.act(routed) if shared is None else prec.act(routed + shared)
    return prec.act(x + y), aux


def loss_fn(params: dict, tokens: torch.Tensor, conf: dict, precision: str = "f32",
            attn_block: int = 1024, ce_rows: int = 8192):
    """Next-token cross-entropy of ``tokens`` [B, S] plus the aux term;
    each layer, and the head over each block of ``ce_rows`` rows, recomputed
    in the backward."""
    m = conf["model"]
    prec = _Precision(precision)
    B, S = tokens.shape
    D = m["d_model"]
    x = prec.act(params["embed"][tokens])
    auxs = []
    for key, moe in (("dense_layers", False), ("moe_layers", True)):
        if key not in params:
            continue
        for layer in range(next(iter(params[key].values())).shape[0]):
            lp = {k: v[layer] for k, v in params[key].items()}
            x, aux = checkpoint(_layer, x, lp, m, prec, attn_block, moe, use_reentrant=False)
            if aux is not None:
                auxs.append(aux)
    x = prec.act(_rmsnorm(x, params["ln_f"]))[:, :-1].reshape(B * (S - 1), D)
    target = tokens[:, 1:].reshape(-1)
    total = sum(checkpoint(_ce_rows_sum, x[i:i + ce_rows], target[i:i + ce_rows],
                           params["head"], prec, use_reentrant=False)
                for i in range(0, len(x), ce_rows))
    loss = total / len(x)
    if auxs:
        loss = loss + m["moe_aux_weight"] * torch.stack(auxs).mean()
    return loss


def model_flops_per_step(conf: dict, seq: int, batch: int, n_params: int) -> float:
    """Model FLOPs a step over the batch·(seq − 1) tokens trained: 6 × the
    active params (the tree's N less the embedding, which is a lookup, and
    less the share of the held routed experts a token does not use, 1 −
    k/n_routed) + 6·L·S·H·(q·k width + v width) for attention (the decoder's
    convention: non-causal, the head counted once)."""
    m = conf["model"]
    D, H, L = m["d_model"], m["n_heads"], m["n_layers"]
    routed = (L - m["first_k_dense_replace"]) * m["num_experts"] * 3 * D * m["moe_d_ff"]
    active = (n_params - m["vocab"] * D
              - (1 - m["experts_per_token"] / m["n_routed_experts"]) * routed)
    attn = 6 * L * seq * H * (m["qk_nope_head_dim"] + m["qk_rope_head_dim"] + m["v_head_dim"])
    return batch * (seq - 1) * (6 * active + attn)


def follow(conf: dict, params: dict, batches, precision: str = "f32", rows=None,
           frozen: bool = False) -> dict:
    """Train ``params`` (the tree of ``make_params``, updated in place) on
    ``batches`` one step each and read what the benchmark compares (as
    ``decoder.follow``: each step's loss, each leaf's gradient norm at the
    first step, each leaf's change; the planted faults ``rows`` and
    ``frozen``)."""
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
