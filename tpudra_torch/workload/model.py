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

Beyond the JAX package, ``arch="deepseek_v2"`` is DeepSeek-V2's block on one
device: multi-head latent attention with YaRN RoPE through the flash kernels
at q·k width 192 and v width 128, a leading dense SwiGLU layer, then layers
of a dropless top-k MoE with shared experts (``moe.moe_topk_ffn``) over the
experts this device holds, and an untied head.

Ported: the dense and Switch-MoE models on one device, with naive or flash
attention, and the same models sharded over a ("dp", "sp", "tp") device
mesh (``param_specs``, ``shard_params``, ``make_sharded_train_step``): each
rank computes on its local shards with the collectives of
``tpudra_torch.workload.parallel`` placed by hand where GSPMD places them
in the JAX program.  Ring attention (``ringattention``) plugs into ``_layer``
through ``attn_fn``, as in the JAX package; the pipeline is ``pipeline``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from tpudra_torch.workload.attn_kernel import WIDTHS, flash_attention
from tpudra_torch.workload.ce_kernel import ce_chunk_sum, fused_ce_sum, matmul_f32
from tpudra_torch.workload.convert import tree_leaves, tree_map, tree_unflatten
from tpudra_torch.workload.device import resolve_device
from tpudra_torch.workload.moe import MoEConfig, TopKConfig, moe_ffn, moe_topk_ffn, swiglu
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
    # The block: "gpt" (the JAX package's decoder) or "deepseek_v2"
    # (DeepSeek-V2: the fields below and an untied head; for it d_ff is the
    # dense layers' SwiGLU width, num_experts the routed experts held here,
    # the first of them, and n_heads the query heads).
    arch: str = "gpt"
    # Latent attention: kv compressed to kv_lora_rank; q·k heads of
    # qk_nope_head_dim + qk_rope_head_dim (the RoPE part one for all heads),
    # v heads of v_head_dim.
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # RoPE with YaRN scaling (factor 1: plain RoPE).
    rope_theta: float = 10000.0
    rope_factor: float = 1.0
    rope_original_max_position: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 1.0
    rope_mscale_all_dim: float = 0.0
    # Leading dense layers, then MoE layers: n_routed_experts routed by
    # softmax top experts_per_token (weights not renormalised), experts of
    # width moe_d_ff, and one shared SwiGLU of n_shared_experts × moe_d_ff.
    first_k_dense_replace: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 1
    n_routed_experts: int = 0

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
        if self.arch not in ("gpt", "deepseek_v2"):
            raise ValueError(f"arch must be gpt|deepseek_v2, got {self.arch!r}")
        if self.arch == "deepseek_v2":
            if min(self.kv_lora_rank, self.qk_nope_head_dim, self.qk_rope_head_dim,
                   self.v_head_dim, self.moe_d_ff) <= 0 or self.qk_rope_head_dim % 2:
                raise ValueError("deepseek_v2 needs positive latent, head and expert widths "
                                 "and an even qk_rope_head_dim")
            if not 0 < self.num_experts <= self.n_routed_experts:
                raise ValueError(f"{self.num_experts} experts held of "
                                 f"{self.n_routed_experts} routed")
            if not 0 < self.experts_per_token <= self.n_routed_experts:
                raise ValueError(f"experts_per_token {self.experts_per_token} of "
                                 f"{self.n_routed_experts}")
            if not 0 <= self.first_k_dense_replace <= self.n_layers:
                raise ValueError(f"first_k_dense_replace {self.first_k_dense_replace} of "
                                 f"{self.n_layers} layers")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def qk_head_dim(self) -> int:
        """Width of a q·k head: gpt's head_dim; deepseek_v2's nope + rope."""
        if self.arch == "deepseek_v2":
            return self.qk_nope_head_dim + self.qk_rope_head_dim
        return self.head_dim

    @property
    def n_moe_layers(self) -> int:
        """deepseek_v2's layers after the leading dense ones."""
        return self.n_layers - self.first_k_dense_replace

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
        widths = ((self.qk_head_dim, self.v_head_dim) if self.arch == "deepseek_v2"
                  else (self.head_dim, self.head_dim))
        return (
            torch.device(device).type == "cuda"
            and torch.cuda.device_count() == 1
            and self.compute_dtype == "bf16"
            and widths in WIDTHS
        )


def one_device_only(cfg: ModelConfig, what: str) -> None:
    """Raise for a block that ``what`` (a sharded, pipelined or ring path)
    does not carry: deepseek_v2 runs on one device."""
    if cfg.arch != "gpt":
        raise ValueError(f"{what} carries the gpt block only; arch {cfg.arch!r} runs on "
                         "one device (model.make_train_step)")


def init_params(rng: torch.Generator, cfg: ModelConfig, device=None):
    """Random params with the JAX tree, shapes and scales, drawn from ``rng``
    (a generator on ``device``, default CUDA).  The draws differ from
    ``jax.random``; tests carry JAX params over with convert.params_from_numpy."""
    dev = resolve_device(device)
    if rng.device.type != dev.type:
        raise ValueError(f"rng is on {rng.device}, params go to {dev}")

    def dense(shape, scale):
        return torch.randn(shape, generator=rng, dtype=torch.float32, device=dev) * scale

    if cfg.arch == "deepseek_v2":
        tree: dict = {}
        for name, (shape, scale) in deepseek_v2_shapes(cfg).items():
            *outer, leaf = name.split(".")
            node = tree
            for key in outer:
                node = node.setdefault(key, {})
            node[leaf] = (dense(shape, scale) if scale else
                          torch.ones(shape, dtype=torch.float32, device=dev))
        return tree
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


def deepseek_v2_shapes(cfg: ModelConfig) -> dict:
    """deepseek_v2's leaves, "outer.leaf" → (shape, init scale; None for a
    norm's ones).  The dense and the MoE layers are stacked apart
    ("dense_layers", "moe_layers"), each with a leading layer axis.  Gate
    and up projections are one matrix, gate columns first (w_in [D, 2F])."""
    D, H, V = cfg.d_model, cfg.n_heads, cfg.vocab
    dn, dr, dv, r = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim,
                     cfg.kv_lora_rank)
    F_, Fm, Fs = cfg.d_ff, cfg.moe_d_ff, cfg.n_shared_experts * cfg.moe_d_ff

    def attention(key, L):
        return {f"{key}.wq": ((L, D, H * (dn + dr)), D ** -0.5),
                f"{key}.wkv_a": ((L, D, r + dr), D ** -0.5),
                f"{key}.kv_norm": ((L, r), None),
                f"{key}.wkv_b": ((L, r, H * (dn + dv)), r ** -0.5),
                f"{key}.wo": ((L, H * dv, D), (H * dv) ** -0.5),
                f"{key}.ln1": ((L, D), None), f"{key}.ln2": ((L, D), None)}

    shapes = {"embed": ((V, D), 0.02)}
    L = cfg.first_k_dense_replace
    if L:
        shapes |= attention("dense_layers", L)
        shapes |= {"dense_layers.w_in": ((L, D, 2 * F_), D ** -0.5),
                   "dense_layers.w_out": ((L, F_, D), F_ ** -0.5)}
    L, E = cfg.n_moe_layers, cfg.num_experts
    if L:
        shapes |= attention("moe_layers", L)
        shapes |= {"moe_layers.router": ((L, D, cfg.n_routed_experts), D ** -0.5),
                   "moe_layers.experts_in": ((L, E, D, 2 * Fm), D ** -0.5),
                   "moe_layers.experts_out": ((L, E, Fm, D), Fm ** -0.5)}
        if Fs:
            shapes |= {"moe_layers.shared_in": ((L, D, 2 * Fs), D ** -0.5),
                       "moe_layers.shared_out": ((L, Fs, D), Fs ** -0.5)}
    shapes["ln_f"] = ((D,), None)
    shapes["head"] = ((V, D), 0.02)
    return shapes


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
    else:
        attn = _attend(cfg, q, k, v, hd ** -0.5)  # [B, H, S, hd]
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


def _attend(cfg: ModelConfig, q, k, v, scale: float):
    """Causal attention over q, k [B, H, S, dk] and v [B, H, S, dv] with
    the softmax ``scale``: the flash kernels or the naive products."""
    S = q.shape[2]
    if cfg.use_flash_attention(S, q.device):
        # q scaled in the activation dtype before the kernel, as the JAX
        # model scales it before splash.
        return flash_attention(q * scale, k, v)
    # Scores: the product in the activation dtype, then f32 and the scale;
    # softmax in f32; the masked value is -1e30 (not -inf), as in JAX.
    scores = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(cfg.act_dtype)
    return torch.matmul(probs, v)


# -- DeepSeek-V2 (arch="deepseek_v2") ------------------------------------------


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention-magnitude correction for a context stretched by
    ``factor``: 0.1·mscale·ln(factor) + 1 (1 when not stretched)."""
    return 1.0 if factor <= 1.0 else 0.1 * mscale * math.log(factor) + 1.0


def softmax_scale(cfg: ModelConfig) -> float:
    """deepseek_v2's softmax scale: the q·k width's 1/√d times
    yarn_mscale(factor, mscale_all_dim)² where mscale_all_dim is set."""
    scale = cfg.qk_head_dim ** -0.5
    if cfg.rope_mscale_all_dim:
        scale *= yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim) ** 2
    return scale


def yarn_ramp(cfg: ModelConfig) -> tuple[int, int]:
    """(low, high): the rotary pairs below low keep their frequency, those
    above high are slowed by the factor, a linear ramp between (YaRN's
    correction range for beta_fast and beta_slow rotations)."""
    d, base, orig = cfg.qk_rope_head_dim, cfg.rope_theta, cfg.rope_original_max_position

    def dim(rotations):
        return d * math.log(orig / (rotations * 2 * math.pi)) / (2 * math.log(base))

    low, high = math.floor(dim(cfg.rope_beta_fast)), math.ceil(dim(cfg.rope_beta_slow))
    return max(low, 0), min(high, d - 1)


def rope_frequencies(cfg: ModelConfig, device=None) -> torch.Tensor:
    """θ_i of the qk_rope_head_dim / 2 rotary pairs (f64, made on
    ``device``): base^(−2i/d), divided by the factor past YaRN's ramp."""
    d, f = cfg.qk_rope_head_dim, cfg.rope_factor
    i = torch.arange(d // 2, dtype=torch.float64, device=device)
    extra = cfg.rope_theta ** (-2 * i / d)
    if f <= 1.0:
        return extra
    low, high = yarn_ramp(cfg)
    ramp = ((i - low) / max(high - low, 1e-3)).clamp(0, 1)
    return extra / f * ramp + extra * (1 - ramp)


def rope_tables(cfg: ModelConfig, S: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin [S, d/2] (f32, made on ``device``: no copy from the host)
    of position t·θ_i, t from 0, times YaRN's ratio yarn_mscale(factor,
    mscale) / yarn_mscale(factor, mscale_all_dim)."""
    f = cfg.rope_factor
    mag = yarn_mscale(f, cfg.rope_mscale) / yarn_mscale(f, cfg.rope_mscale_all_dim)
    t = torch.arange(S, dtype=torch.float64, device=device)
    angle = t[:, None] * rope_frequencies(cfg, device)[None]
    return (angle.cos() * mag).float(), (angle.sin() * mag).float()


def apply_rope(x, cos, sin):
    """Rotate each pair (x[2i], x[2i+1]) of x's last dim by the angle whose
    cos and sin broadcast against x[..., i], in f32; x's dtype back."""
    xf = x.float().unflatten(-1, (-1, 2))
    x0, x1 = xf[..., 0], xf[..., 1]
    return torch.stack((x0 * cos - x1 * sin, x0 * sin + x1 * cos), dim=-1).flatten(-2).to(x.dtype)


def _mla(cfg: ModelConfig, x, p, rope):
    """x + latent attention of x [B, S, D]: q = h·Wq ([nope | rope] a head),
    c = h·Wkv_a ([latent | k_pe]), [k_nope | v] = rmsnorm(latent)·Wkv_b,
    RoPE on q's rope part and on k_pe (one for all heads), causal attention
    at q·k width nope + rope and v width v_head_dim, then ·Wo.  ``rope``:
    (cos, sin) of ``rope_tables``."""
    B, S, D = x.shape
    H, dn, dr, dv, r = (cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                        cfg.v_head_dim, cfg.kv_lora_rank)
    act = cfg.act_dtype
    with record_function("mla.attention"):
        h = _rmsnorm(x, p["ln1"]).reshape(B * S, D)
        q = (h @ p["wq"].to(act)).view(B, S, H, dn + dr)
        c = h @ p["wkv_a"].to(act)
        kv = (_rmsnorm(c[:, :r], p["kv_norm"]) @ p["wkv_b"].to(act)).view(B, S, H, dn + dv)
        cos, sin = rope
        q_pe = apply_rope(q[..., dn:], cos[:, None], sin[:, None])
        k_pe = apply_rope(c[:, r:].view(B, S, dr), cos, sin)
        q = torch.cat((q[..., :dn], q_pe), dim=-1).transpose(1, 2)
        k = torch.cat((kv[..., :dn], k_pe[:, :, None].expand(B, S, H, dr)), dim=-1).transpose(1, 2)
        o = _attend(cfg, q, k, kv[..., dn:].transpose(1, 2), softmax_scale(cfg))
        o = o.transpose(1, 2).reshape(B * S, H * dv) @ p["wo"].to(act)
    return x + o.view(B, S, D)


def topk_config(cfg: ModelConfig) -> TopKConfig:
    return TopKConfig(d_model=cfg.d_model, d_ff=cfg.moe_d_ff, num_experts=cfg.num_experts,
                      n_routed=cfg.n_routed_experts, top_k=cfg.experts_per_token,
                      shared_d_ff=cfg.n_shared_experts * cfg.moe_d_ff,
                      compute_dtype=cfg.compute_dtype)


_TOPK_LEAVES = ("router", "experts_in", "experts_out", "shared_in", "shared_out")


def _ds_layer(cfg: ModelConfig, x, p, moe: bool, rope):
    """One deepseek_v2 layer: latent attention, then a dense SwiGLU FFN or
    the top-k MoE FFN.  Returns (x, aux; zero for a dense layer)."""
    B, S, D = x.shape
    x = _mla(cfg, x, p, rope)
    h = _rmsnorm(x, p["ln2"])
    if moe:
        y, aux, _ = moe_topk_ffn({k: p[k] for k in _TOPK_LEAVES if k in p}, h, topk_config(cfg))
        return x + y, aux
    act = cfg.act_dtype
    y = swiglu(h.reshape(B * S, D), p["w_in"].to(act), p["w_out"].to(act))
    return x + y.view(B, S, D), torch.zeros((), dtype=torch.float32, device=x.device)


def _ds_backbone(params, tokens, cfg: ModelConfig):
    """deepseek_v2's (hidden states [B, S, D], mean aux over its MoE
    layers): the embedding (no position table), the dense layers, then the
    MoE layers, each under cfg.remat."""
    x = params["embed"][tokens].to(cfg.act_dtype)
    # Outside the layers' checkpoints: constants to them.
    rope = rope_tables(cfg, tokens.shape[1], x.device)
    auxs = []
    for key, moe, n in (("dense_layers", False, cfg.first_k_dense_replace),
                        ("moe_layers", True, cfg.n_moe_layers)):
        if not n:
            continue
        layer = _remat(cfg, partial(_ds_layer, cfg, moe=moe, rope=rope))
        per_layer = {k: v.unbind(0) for k, v in params[key].items()}
        for i in range(n):
            x, aux = layer(x, {k: v[i] for k, v in per_layer.items()})
            if moe:
                auxs.append(aux)
    aux = torch.stack(auxs).mean() if auxs else torch.zeros((), device=x.device)
    return _rmsnorm(x, params["ln_f"]), aux


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
    return _remat(cfg, partial(_layer, cfg, groups=groups, attn_fn=attn_fn))


def _remat(cfg: ModelConfig, layer_body):
    """``layer_body`` under cfg.remat."""
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
    if cfg.arch == "deepseek_v2":
        if groups is not None or attn_fn is not None or pos_offset:
            one_device_only(cfg, "a sharded, ring or offset backbone")
        return _ds_backbone(params, tokens, cfg)
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
    return matmul_f32(x, head_weight(params).to(cfg.act_dtype).t())


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
    embed = head_weight(params)
    if tp is not None:
        embed = gather(embed, tp, dim=1, partial_grads=True)
        xs, targets = _row_share(copy_to(xs, tp), targets, tp)
    return reduce_from(_ce_sum(embed, xs, targets, cfg), tp)


def head_weight(params):
    """The head's [V, D] matrix: the untied "head" where the tree has one
    (deepseek_v2), else the embedding."""
    return params["head"] if "head" in params else params["embed"]


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

    one_device_only(cfg, "param_specs")
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
    one_device_only(cfg, "the sharded step")
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
