"""Flagship decoder train step on one CUDA device: the counterpart of
``tpudra/workload/model.py``.

The same causal transformer as the JAX package, with the same config
fields, the same parameter tree (nested dicts, stacked leading layer axis)
and the same numerics: bf16 activations and matmuls with f32 master params,
RMSNorm and softmax in f32, tanh-GELU, a chunked or fused cross-entropy
head, and AdamW with bf16 moments (tree or fused), and causal attention
naive or through the flash kernels (attn_kernel).

Functions keep the JAX names so each has a visible counterpart.  Parameters
are plain tensors; ``value_and_grad`` differentiates a loss with respect to
a parameter tree, and the optimizers update params and moments in place.

Ported: the dense single-device path, with naive or flash attention.  Not
yet ported (raising NotImplementedError with the ROADMAP item that ports
each): MoE layers and the tensor-parallel layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from tpudra_torch.workload.attn_kernel import HEAD_DIMS, flash_attention
from tpudra_torch.workload.ce_kernel import fused_ce_mean, matmul_f32
from tpudra_torch.workload.convert import tree_leaves, tree_map, tree_unflatten
from tpudra_torch.workload.device import resolve_device
from tpudra_torch.workload.opt_kernel import bias_corrections, fused_adamw, init_bf16_moments


@dataclass(frozen=True)
class ModelConfig:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 256
    max_seq: int = 128
    # Sequence-chunk width of the chunked cross-entropy head.
    ce_chunk: int = 512
    # CE head: "chunked" (per sequence chunk, logits kept for the backward)
    # or "fused" (ce_kernel: no logits in device memory, recompute backward).
    ce_impl: str = "chunked"
    # Optimizer: "tree" (per-leaf PyTorch ops) or "fused" (opt_kernel: one
    # in-place sweep per leaf).
    opt_impl: str = "tree"
    # Attention core: "auto" | "naive" | "flash"/"splash" (both name the
    # kernel path, attn_kernel.flash_attention); see use_flash_attention.
    attention: str = "auto"
    # Block sizes of the TPU's splash kernel, validated as the JAX package
    # validates them.  The CUDA kernels' tiles are fixed in their sources, so
    # these tune nothing here.
    attn_block_q: int = 0
    attn_block_kv: int = 0
    # Rematerialization of the layer body:
    #   "dots"  — keep matmul outputs without batch dims, recompute the rest
    #   "full"  — save nothing, recompute everything
    #   "none"  — save all residuals
    remat: str = "dots"
    # Sparse (Switch-MoE) FFN: 0 = dense.  Not ported yet.
    num_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    # Activation/matmul compute dtype: "bf16" or "f32".
    compute_dtype: str = "bf16"

    def __post_init__(self):
        if self.attention not in ("auto", "naive", "flash", "splash"):
            raise ValueError(
                f"attention must be auto|naive|flash|splash, got {self.attention!r}"
            )
        if self.remat not in ("dots", "full", "none"):
            raise ValueError(f"remat must be dots|full|none, got {self.remat!r}")
        if self.num_experts < 0:
            raise ValueError(f"num_experts must be >= 0, got {self.num_experts}")
        if self.compute_dtype not in ("bf16", "f32"):
            raise ValueError(
                f"compute_dtype must be bf16|f32, got {self.compute_dtype!r}"
            )
        if self.ce_impl not in ("chunked", "fused"):
            raise ValueError(f"ce_impl must be chunked|fused, got {self.ce_impl!r}")
        if self.opt_impl not in ("tree", "fused"):
            raise ValueError(f"opt_impl must be tree|fused, got {self.opt_impl!r}")
        for name in ("attn_block_q", "attn_block_kv"):
            blk = getattr(self, name)
            if blk and (blk % 128 or self.max_seq % blk):
                raise ValueError(
                    f"{name}={blk} must be a multiple of 128 dividing "
                    f"max_seq={self.max_seq}"
                )
        if self.d_model % self.n_heads:
            raise ValueError(
                f"d_model {self.d_model} not divisible by n_heads {self.n_heads}"
            )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def act_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bf16" else torch.float32

    def use_flash_attention(self, seq_len: int, device: torch.device) -> bool:
        """Whether ``_layer`` takes the flash kernels.  "flash"/"splash"
        always, "naive" never.  "auto" only where the kernels run and pay:
        a CUDA device, one visible device (the JAX package's conservative
        rule: a multi-device program shards attention another way), bf16,
        and a head width the kernels are built for.  The kernels mask a
        ragged sequence, so ``seq_len`` sets no condition; off CUDA "auto"
        is naive, as the JAX package's is off a TPU."""
        del seq_len
        if self.attention in ("flash", "splash"):
            return True
        if self.attention == "naive":
            return False
        return (
            torch.device(device).type == "cuda"
            and torch.cuda.device_count() == 1
            and self.compute_dtype == "bf16"
            and self.head_dim in HEAD_DIMS
        )


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.num_experts:
        raise NotImplementedError(
            "num_experts > 0 is not ported yet (ROADMAP queue 1, item 5: MoE)"
        )


def init_params(rng: torch.Generator, cfg: ModelConfig, device=None):
    """Random params with the JAX tree, shapes and scales, drawn from ``rng``
    (a generator on ``device``, default CUDA).  The draws differ from
    ``jax.random``; tests carry JAX params over with convert.params_from_numpy."""
    _check_ported(cfg)
    dev = resolve_device(device)
    if rng.device.type != dev.type:
        raise ValueError(f"rng is on {rng.device}, params go to {dev}")

    def dense(shape, scale):
        return torch.randn(shape, generator=rng, dtype=torch.float32, device=dev) * scale

    L, D, F_ = cfg.n_layers, cfg.d_model, cfg.d_ff
    H, hd = cfg.n_heads, cfg.head_dim
    s = D ** -0.5
    return {
        "embed": dense((cfg.vocab, D), 0.02),
        "pos": dense((cfg.max_seq, D), 0.02),
        # Stacked per-layer params, leading axis = layer.
        "layers": {
            "wqkv": dense((L, D, H, 3 * hd), s),
            "wo": dense((L, H, hd, D), s),
            "w1": dense((L, D, F_), s),
            "w2": dense((L, F_, D), F_ ** -0.5),
            "ln1": torch.ones((L, D), dtype=torch.float32, device=dev),
            "ln2": torch.ones((L, D), dtype=torch.float32, device=dev),
        },
        "ln_f": torch.ones((D,), dtype=torch.float32, device=dev),
    }


def _rmsnorm(x, scale):
    x32 = x.float()
    inv = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + 1e-6)
    return (x32 * inv * scale).to(x.dtype)


def _layer(cfg: ModelConfig, x, layer_params):
    """One decoder block; x: [B, S, D] in cfg.act_dtype.  Returns (x, aux),
    aux being the (zero) MoE loss of a dense layer.

    Every projection is a 2-D product over the flattened [B*S] rows (an
    ``aten.mm``, what the "dots" remat policy keeps); attention's products
    carry batch dims (``aten.bmm``), and the flash kernels are no ``aten.mm``,
    so under "dots" the attention core is recomputed, as JAX recomputes the
    splash call.
    """
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    act = cfg.act_dtype
    p = layer_params

    h = _rmsnorm(x, p["ln1"])
    # [D, H, 3hd] → [D, H, 3, hd]: q, k, v split on the 3-axis.
    wqkv = p["wqkv"].to(act).reshape(D, H * 3 * hd)
    qkv = (h.reshape(B * S, D) @ wqkv).view(B, S, H, 3, hd).permute(3, 0, 2, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # each [B, H, S, hd]
    if cfg.use_flash_attention(S, x.device):
        # q scaled in the activation dtype before the kernel, as the JAX
        # model scales it before splash.
        attn = flash_attention(q * (hd ** -0.5), k, v)
    else:
        # Scores: the product in the activation dtype, then f32 and the
        # scale; softmax in f32; the masked value is -1e30 (not -inf), as in
        # JAX.
        scores = torch.matmul(q, k.transpose(-1, -2)).float() * (hd ** -0.5)
        mask = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~mask, -1e30)
        probs = torch.softmax(scores, dim=-1).to(act)
        attn = torch.matmul(probs, v)  # [B, H, S, hd]
    attn = attn.permute(0, 2, 1, 3).reshape(B * S, H * hd)
    x = x + (attn @ p["wo"].to(act).reshape(H * hd, D)).view(B, S, D)

    h = _rmsnorm(x, p["ln2"]).reshape(B * S, D)
    h = h @ p["w1"].to(act)
    h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    h = h @ p["w2"].to(act)
    return x + h.view(B, S, D), torch.zeros((), dtype=torch.float32, device=x.device)


def embed_tokens(params, tokens, cfg: ModelConfig):
    """tokens [B, S] int → embedded inputs [B, S, D] in cfg.act_dtype."""
    S = tokens.shape[1]
    x = params["embed"][tokens].to(cfg.act_dtype)
    return x + params["pos"][:S].to(cfg.act_dtype)[None]


_DOTS = {torch.ops.aten.mm.default}


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat="dots": keep the outputs of
    products without batch dims (JAX's checkpoint_dots_with_no_batch_dims),
    recompute everything else."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def remat_layer_body(cfg: ModelConfig):
    """The per-layer body ``(x, layer_params) -> (x, aux)`` with cfg.remat
    applied."""
    layer_body = partial(_layer, cfg)
    if cfg.remat == "none":
        return layer_body
    if cfg.remat == "full":
        return partial(checkpoint, layer_body, use_reentrant=False)
    return partial(
        checkpoint, layer_body, use_reentrant=False,
        context_fn=partial(create_selective_checkpoint_contexts, _save_dots),
    )


def backbone_and_aux(params, tokens, cfg: ModelConfig):
    """tokens [B, S] int → (hidden states [B, S, D] in cfg.act_dtype, mean
    per-layer MoE aux loss — zero for dense models)."""
    _check_ported(cfg)
    x = embed_tokens(params, tokens, cfg)
    layer = remat_layer_body(cfg)
    # unbind (not indexing) so the backward stacks the per-layer grads once.
    per_layer = {k: v.unbind(0) for k, v in params["layers"].items()}
    auxs = []
    for i in range(cfg.n_layers):
        x, aux = layer(x, {k: v[i] for k, v in per_layer.items()})
        auxs.append(aux)
    return _rmsnorm(x, params["ln_f"]), torch.stack(auxs).mean()


def backbone(params, tokens, cfg: ModelConfig):
    """tokens [B, S] int → final hidden states [B, S, D]."""
    return backbone_and_aux(params, tokens, cfg)[0]


def forward(params, tokens, cfg: ModelConfig):
    """tokens [B, S] int → logits [B, S, V] float32."""
    x = backbone(params, tokens, cfg)
    return matmul_f32(x, params["embed"].to(cfg.act_dtype).t())


def loss_fn(params, tokens, cfg: ModelConfig):
    """Next-token NLL over tokens [B, S]: the whole sequence goes through
    the backbone and the shift happens at the loss."""
    x, aux = backbone_and_aux(params, tokens, cfg)
    loss = ce_head(params, x, tokens, cfg)
    if cfg.num_experts:
        loss = loss + cfg.moe_aux_weight * aux
    return loss


def ce_head(params, x, tokens, cfg: ModelConfig):
    """The cross-entropy head over hidden states [B, S, D]: chunked over
    the sequence (logits in f32 per chunk, reduced to logsumexp - target
    logit at once) or fused (ce_kernel)."""
    xs, targets = x[:, :-1], tokens[:, 1:]
    B, Sm1, D = xs.shape

    if cfg.ce_impl == "fused":
        return fused_ce_mean(
            xs.reshape(B * Sm1, D),
            params["embed"],
            targets.reshape(-1).to(torch.int32),
        )

    emb_t = params["embed"].to(cfg.act_dtype).t()

    def ce_sum(xc, tc):
        logits = matmul_f32(xc, emb_t)  # bf16 operands, f32 result
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, tc[..., None].long())[..., 0]
        return (lse - tgt).sum()

    chunk = cfg.ce_chunk
    n = Sm1 // chunk
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + ce_sum(xs[:, sl], targets[:, sl])
    if Sm1 % chunk:
        total = total + ce_sum(xs[:, n * chunk:], targets[:, n * chunk:])
    return total / (B * Sm1)


def value_and_grad(fn):
    """``jax.value_and_grad`` for a loss of a parameter tree:
    ``fn(params, *args)`` → (detached loss, grads tree)."""

    def wrapped(params, *args):
        live = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss = fn(tree_unflatten(params, live), *args)
        grads = torch.autograd.grad(loss, live)
        return loss.detach(), tree_unflatten(params, list(grads))

    return wrapped


def adamw_bf16_moments(learning_rate: float, b1=0.9, b2=0.999, eps=1e-8, wd=1e-4):
    """AdamW with both moments stored in bfloat16 (f32 master params), as
    per-leaf PyTorch ops.  Moment arithmetic in f32, rounded to bf16 before
    the update reads it.  Returns (init, update) with the optax contract:
    update(grads, state, params) -> (updates, state)."""

    def update(grads, state, params):
        mu, nu, count = state
        count = count + 1
        mu = tree_map(
            lambda m, g: (b1 * m.float() + (1 - b1) * g).to(torch.bfloat16), mu, grads
        )
        nu = tree_map(
            lambda v, g: (b2 * v.float() + (1 - b2) * g * g).to(torch.bfloat16), nu, grads
        )
        c1, c2 = bias_corrections(count, b1, b2)

        def upd(p, m, v):
            mhat = m.float() / c1
            vhat = v.float() / c2
            return -learning_rate * (mhat / (torch.sqrt(vhat) + eps) + wd * p)

        updates = tree_map(upd, params, mu, nu)
        return updates, (mu, nu, count)

    return init_bf16_moments, update


def make_train_step(cfg: ModelConfig, learning_rate: float = 1e-3):
    """Returns (init_opt_state, train_step);
    train_step(params, opt_state, tokens) -> (params, opt_state, loss).
    Params are updated in place and returned."""
    grad_fn = value_and_grad(loss_fn)

    if cfg.opt_impl == "fused":
        finit, fapply = fused_adamw(learning_rate)

        def train_step(params, opt_state, tokens):
            loss, grads = grad_fn(params, tokens, cfg)
            params, opt_state = fapply(params, grads, opt_state)
            return params, opt_state, loss

        return finit, train_step

    init, update = adamw_bf16_moments(learning_rate)

    def train_step(params, opt_state, tokens):
        loss, grads = grad_fn(params, tokens, cfg)
        updates, opt_state = update(grads, opt_state, params)
        # p + u, as the JAX tree path adds the update.
        tree_map(lambda p, u: p.add_(u), params, updates)
        return params, opt_state, loss

    return init, train_step


# -- sharding layout: not ported yet -----------------------------------------

_TP_TODO = "the tensor-parallel layout is not ported yet (ROADMAP queue 1, item 4)"


def param_specs(cfg: ModelConfig):
    raise NotImplementedError(_TP_TODO)


def batch_spec():
    raise NotImplementedError(_TP_TODO)


def shard_params(params, mesh, cfg: ModelConfig):
    raise NotImplementedError(_TP_TODO)
