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

Ported: the dense and Switch-MoE models on one device, with naive or flash
attention, and the same models sharded over a ("dp", "sp", "tp") device
mesh (``param_specs``, ``shard_params``, ``make_sharded_train_step``): each
rank computes on its local shards with the collectives of
``tpudra_torch.workload.parallel`` placed by hand where GSPMD places them
in the JAX program.  Ring attention (``ringattention``) plugs into ``_layer``
through ``attn_fn``, as in the JAX package; the pipeline is ``pipeline``.
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
from tpudra_torch.workload.ce_kernel import ce_chunk_sum, fused_ce_sum, matmul_f32
from tpudra_torch.workload.convert import tree_leaves, tree_map, tree_unflatten
from tpudra_torch.workload.device import resolve_device
from tpudra_torch.workload.moe import MoEConfig, moe_ffn
from tpudra_torch.workload.opt_kernel import bias_corrections, fused_adamw, init_bf16_moments
from tpudra_torch.workload.parallel import (
    Groups,
    copy_to,
    mean_over,
    distribute_local,
    gather,
    local_tree,
    reduce_from,
    size_and_rank,
)


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
    # Sparse (Switch-MoE) FFN: 0 = dense.  With E experts each layer's FFN
    # is top-1 routed (moe.moe_ffn); the expert axis shards over tp in
    # param_specs, and loss_fn adds moe_aux_weight * the mean aux loss.
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


def init_params(rng: torch.Generator, cfg: ModelConfig, device=None):
    """Random params with the JAX tree, shapes and scales, drawn from ``rng``
    (a generator on ``device``, default CUDA).  The draws differ from
    ``jax.random``; tests carry JAX params over with convert.params_from_numpy."""
    dev = resolve_device(device)
    if rng.device.type != dev.type:
        raise ValueError(f"rng is on {rng.device}, params go to {dev}")

    def dense(shape, scale):
        return torch.randn(shape, generator=rng, dtype=torch.float32, device=dev) * scale

    L, D, F_, E = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.num_experts
    H, hd = cfg.n_heads, cfg.head_dim
    s = D ** -0.5
    if E:
        ffn = {
            "router": dense((L, D, E), s),
            "w1": dense((L, E, D, F_), s),
            "w2": dense((L, E, F_, D), F_ ** -0.5),
        }
    else:
        ffn = {"w1": dense((L, D, F_), s), "w2": dense((L, F_, D), F_ ** -0.5)}
    return {
        "embed": dense((cfg.vocab, D), 0.02),
        "pos": dense((cfg.max_seq, D), 0.02),
        # Stacked per-layer params, leading axis = layer.
        "layers": {
            "wqkv": dense((L, D, H, 3 * hd), s),
            "wo": dense((L, H, hd, D), s),
            **ffn,
            "ln1": torch.ones((L, D), dtype=torch.float32, device=dev),
            "ln2": torch.ones((L, D), dtype=torch.float32, device=dev),
        },
        "ln_f": torch.ones((D,), dtype=torch.float32, device=dev),
    }


def _rmsnorm(x, scale):
    x32 = x.float()
    inv = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + 1e-6)
    return (x32 * inv * scale).to(x.dtype)


def _moe_config(cfg: ModelConfig) -> MoEConfig:
    return MoEConfig(d_model=cfg.d_model, d_ff=cfg.d_ff, num_experts=cfg.num_experts,
                     capacity_factor=cfg.moe_capacity_factor, compute_dtype=cfg.compute_dtype)


def _layer(cfg: ModelConfig, x, layer_params, groups: Groups | None = None, attn_fn=None):
    """One decoder block; x: [B, S, D] in cfg.act_dtype.  Returns (x, aux),
    aux being the MoE load-balancing loss (zero for a dense layer).

    ``attn_fn`` overrides the attention core: (q, k, v) each [B, H, S, hd],
    q not scaled, → [B, H, S, hd] (ring attention plugs in here); its
    output is cast to the activation dtype, as in JAX.

    Every projection is a 2-D product over the flattened [B*S] rows (an
    ``aten.mm``, what the "dots" remat policy keeps); attention's products
    carry batch dims (``aten.bmm``), and the flash kernels are no ``aten.mm``,
    so under "dots" the attention core is recomputed, as JAX recomputes the
    splash call.

    With ``groups``, the params are this rank's shards (Megatron: qkv and
    w1 column-parallel, wo and w2 row-parallel, the experts split over tp)
    and x is the same on every tp rank: f before each column-parallel
    product, g after each row-parallel one.  An MoE layer routes its tokens
    over ``groups.dp`` and, where the sequence is sharded, ``groups.sp``.
    """
    B, S, D = x.shape
    hd = cfg.head_dim
    H = layer_params["wqkv"].shape[-2]  # this rank's heads
    act = cfg.act_dtype
    p = layer_params
    tp = groups.tp if groups else None

    h = copy_to(_rmsnorm(x, p["ln1"]), tp)
    # [D, H, 3hd] → [D, H, 3, hd]: q, k, v split on the 3-axis.
    wqkv = p["wqkv"].to(act).reshape(D, H * 3 * hd)
    qkv = (h.reshape(B * S, D) @ wqkv).view(B, S, H, 3, hd).permute(3, 0, 2, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # each [B, H, S, hd]
    if attn_fn is not None:
        attn = attn_fn(q, k, v).to(act)
    elif cfg.use_flash_attention(S, x.device):
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
    x = x + reduce_from(attn @ p["wo"].to(act).reshape(H * hd, D), tp).view(B, S, D)

    h = _rmsnorm(x, p["ln2"])
    if cfg.num_experts:
        moe_params = {k: p[k] for k in ("router", "w1", "w2")}
        ffn, aux = moe_ffn(moe_params, h, _moe_config(cfg), ep_group=tp,
                           token_group=groups.dp if groups else None,
                           seq_group=groups.sp if groups else None)
        return x + ffn, aux
    h = copy_to(h, tp).reshape(B * S, D) @ p["w1"].to(act)
    h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    h = reduce_from(h @ p["w2"].to(act), tp)
    return x + h.view(B, S, D), torch.zeros((), dtype=torch.float32, device=x.device)


def embed_tokens(params, tokens, cfg: ModelConfig, groups: Groups | None = None,
                 pos_offset: int = 0):
    """tokens [B, S] int → embedded inputs [B, S, D] in cfg.act_dtype, the
    tokens at positions ``pos_offset`` on (a block of a longer sequence).  A
    D-sharded table gives this rank's slice of D, gathered over tp."""
    S = tokens.shape[1]
    x = params["embed"][tokens].to(cfg.act_dtype)
    x = x + params["pos"][pos_offset:pos_offset + S].to(cfg.act_dtype)[None]
    return gather(x, groups.tp if groups else None, dim=2, partial_grads=False)


_DOTS = {torch.ops.aten.mm.default}


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat="dots": keep the outputs of
    products without batch dims (JAX's checkpoint_dots_with_no_batch_dims),
    recompute everything else."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def remat_layer_body(cfg: ModelConfig, groups: Groups | None = None, attn_fn=None):
    """The per-layer body ``(x, layer_params) -> (x, aux)`` with cfg.remat
    applied (shared by the layer loop and the pipeline's stages)."""
    layer_body = partial(_layer, cfg, groups=groups, attn_fn=attn_fn)
    if cfg.remat == "none":
        return layer_body
    if cfg.remat == "full":
        return partial(checkpoint, layer_body, use_reentrant=False)
    return partial(
        checkpoint, layer_body, use_reentrant=False,
        context_fn=partial(create_selective_checkpoint_contexts, _save_dots),
    )


def backbone_and_aux(params, tokens, cfg: ModelConfig, groups: Groups | None = None,
                     attn_fn=None, pos_offset: int = 0):
    """tokens [B, S] int (at positions ``pos_offset`` on) → (hidden states
    [B, S, D] in cfg.act_dtype, mean per-layer MoE aux loss — zero for dense
    models)."""
    x = embed_tokens(params, tokens, cfg, groups, pos_offset)
    layer = remat_layer_body(cfg, groups, attn_fn)
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


def loss_fn(params, tokens, cfg: ModelConfig, groups: Groups | None = None, attn_fn=None):
    """Next-token NLL over tokens [B, S]: the whole sequence goes through
    the backbone and the shift happens at the loss.  With ``groups``: this
    rank's shards, and the tokens of its dp shard (whole sequences).
    ``attn_fn``: see ``_layer``."""
    x, aux = backbone_and_aux(params, tokens, cfg, groups, attn_fn)
    loss = ce_head(params, x, tokens, cfg, groups)
    if cfg.num_experts:
        loss = loss + cfg.moe_aux_weight * aux
    return loss


def ce_head(params, x, tokens, cfg: ModelConfig, groups: Groups | None = None):
    """The cross-entropy head over hidden states [B, S, D]: chunked over
    the sequence (logits in f32 per chunk, reduced to logsumexp - target
    logit at once) or fused (ce_kernel).

    Over tp, see ``ce_rows_sum``."""
    xs, targets = x[:, :-1], tokens[:, 1:]
    B, Sm1, _ = xs.shape
    return ce_rows_sum(params, xs, targets, cfg, groups.tp if groups else None) / (B * Sm1)


def ce_rows_sum(params, xs, targets, cfg: ModelConfig, tp=None):
    """Σ (logsumexp − target logit) over the rows of xs [b, s, D] against
    targets [b, s], summed over ``tp``.

    Over tp, the D-sharded ``embed`` is gathered (its gradient
    reduce-scattered) and each rank takes its share of the b·s rows
    (``_row_share``), rather than each computing [b, s, V] logits for a
    slice of D and all-reducing them; the sums meet in one all-reduce.  xs
    is the same on every tp rank: f (``copy_to``) sums the gradients of the
    shares, each zero off its own rows."""
    embed = params["embed"]
    if tp is not None:
        embed = gather(embed, tp, dim=1, partial_grads=True)
        xs, targets = _row_share(copy_to(xs, tp), targets, tp)
    return reduce_from(_ce_sum(embed, xs, targets, cfg), tp)


def _row_share(xs, targets, group):
    """This rank's share of the rows of xs [b, s, D] and targets [b, s]:
    of n ranks, rank r takes rows [r·c, (r+1)·c) of the flattened b·s, c =
    ceil(b·s / n), cut at b·s (the last shares ragged, possibly empty), as
    [1, rows, D] and [1, rows].  One rank takes them all as they are."""
    n, r = size_and_rank(group)
    if n == 1:
        return xs, targets
    b, s, D = xs.shape
    rows = b * s
    share = -(-rows // n)
    lo, hi = min(r * share, rows), min((r + 1) * share, rows)
    return xs.reshape(1, rows, D)[:, lo:hi], targets.reshape(1, rows)[:, lo:hi]


def _ce_sum(embed, xs, targets, cfg: ModelConfig):
    """Σ (logsumexp − target logit) over the rows of xs [b, s, D].  No rows
    give 0 through the chunked path, so that the gradients still reach
    ``embed`` and ``xs`` (the collectives of their backward run on every
    rank)."""
    b, s, D = xs.shape
    if cfg.ce_impl == "fused" and b * s:
        return fused_ce_sum(
            xs.reshape(b * s, D), embed, targets.reshape(-1).to(torch.int32), b * s
        )

    emb = embed.to(cfg.act_dtype)
    chunk = cfg.ce_chunk
    n = s // chunk
    total = torch.zeros((), dtype=torch.float32, device=xs.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + ce_chunk_sum(xs[:, sl], emb, targets[:, sl])
    if s % chunk or not s:
        total = total + ce_chunk_sum(xs[:, n * chunk:], emb, targets[:, n * chunk:])
    return total


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


def _optimizer(cfg: ModelConfig, learning_rate: float):
    """(init, apply) of cfg.opt_impl's AdamW; apply(params, grads, state)
    updates the params in place and returns the new state."""
    if cfg.opt_impl == "fused":
        finit, fapply = fused_adamw(learning_rate)
        return finit, lambda params, grads, state: fapply(params, grads, state)[1]

    init, update = adamw_bf16_moments(learning_rate)

    def apply(params, grads, state):
        updates, state = update(grads, state, params)
        # p + u, as the JAX tree path adds the update.
        tree_map(lambda p, u: p.add_(u), params, updates)
        return state

    return init, apply


def make_train_step(cfg: ModelConfig, learning_rate: float = 1e-3):
    """Returns (init_opt_state, train_step);
    train_step(params, opt_state, tokens) -> (params, opt_state, loss).
    Params are updated in place and returned."""
    grad_fn = value_and_grad(loss_fn)
    init, apply = _optimizer(cfg, learning_rate)

    def train_step(params, opt_state, tokens):
        loss, grads = grad_fn(params, tokens, cfg)
        return params, apply(params, grads, opt_state), loss

    return init, train_step


# -- sharding layout ---------------------------------------------------------


def param_specs(cfg: ModelConfig):
    """The Megatron tensor-parallel layout as DTensor placements over a
    ("dp", "sp", "tp") mesh (the JAX package's PartitionSpecs): params
    replicated over dp and sp; on tp, column-parallel wqkv, w1 and embed's
    and pos's model dim, row-parallel wo and w2, norms replicated.  MoE
    models shard the expert axis over tp instead (tp must divide
    num_experts), router replicated."""
    from torch.distributed.tensor import Replicate, Shard

    R = Replicate()

    def tp(dim):
        return (R, R, Shard(dim))

    rep = (R, R, R)
    if cfg.num_experts:
        ffn = {"router": rep, "w1": tp(1), "w2": tp(1)}
    else:
        ffn = {"w1": tp(2), "w2": tp(1)}
    return {
        "embed": tp(1),
        "pos": tp(1),
        "layers": {
            # The head axis (tp must divide H); the per-head minors stay whole.
            "wqkv": tp(2),
            "wo": tp(1),
            **ffn,
            "ln1": rep,
            "ln2": rep,
        },
        "ln_f": rep,
    }


def batch_spec():
    """Token batch [B, S]: B over dp, S over sp, replicated over tp.  The
    dense model gathers the sequence over sp before it runs, so sp ranks
    compute the same thing: sequence-parallel compute is ring attention's."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0), Shard(1), Replicate())


def shard_params(params, mesh, cfg: ModelConfig):
    """The parameter tree (the same on every rank) as DTensors over
    ``mesh`` with ``param_specs``; each rank keeps its own copy of its shard."""
    return tree_map(lambda p, spec: distribute_local(p, mesh, spec), params, param_specs(cfg))


def shard_batch(tokens, mesh):
    """Tokens [B, S] (the same on every rank) as a DTensor with ``batch_spec``."""
    return distribute_local(tokens, mesh, batch_spec())


def sharded_value_and_grad(cfg: ModelConfig, mesh):
    """``fn(dparams, dtokens) -> (loss, grads)`` for the model sharded over
    ``mesh``: the loss of the global batch, and this rank's local shard of
    each gradient, averaged over dp."""
    sp = mesh.get_group("sp") if "sp" in mesh.mesh_dim_names else None
    # The whole sequence on every sp rank: the model runs unsharded over sp.
    groups = Groups.from_mesh(mesh, ("dp", "tp"))
    grad_fn = value_and_grad(loss_fn)

    def wrapped(dparams, dtokens):
        tokens = gather(dtokens.to_local(), sp, dim=1, partial_grads=False)
        loss, grads = grad_fn(local_tree(dparams), tokens, cfg, groups)
        with torch.no_grad():
            mean = partial(mean_over, group=groups.dp)
            return mean(loss), tree_map(mean, grads)

    return wrapped


def make_sharded_train_step(cfg: ModelConfig, mesh, learning_rate: float = 1e-3):
    """``make_train_step`` for params from ``shard_params`` and tokens from
    ``shard_batch``: (init_opt_state, train_step).  AdamW runs on each
    rank's local shards; the DTensors are updated in place and returned."""
    grad_fn = sharded_value_and_grad(cfg, mesh)
    init, apply = _optimizer(cfg, learning_rate)

    def train_step(dparams, opt_state, dtokens):
        loss, grads = grad_fn(dparams, dtokens)
        return dparams, apply(local_tree(dparams), grads, opt_state), loss

    return lambda dparams: init(local_tree(dparams)), train_step
