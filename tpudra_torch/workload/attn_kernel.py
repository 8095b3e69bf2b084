"""Causal flash attention: the counterpart of jax's splash attention kernel
as ``tpudra/workload/model.py::_layer`` calls it (causal mask, fused
backward, q pre-scaled by the caller).

Forward: per (batch, head), ``o = softmax(q·kᵀ)·v`` under the causal mask and
the row logsumexp ``lse``, by the hand-written CUDA kernel
``csrc/attn_fwd.cu``; the [S, S] scores never reach device memory.  Backward:
``csrc/attn_bwd.cu``, two Hopper kernels (TMA, mbarrier rings, wgmma) that
recompute the probabilities from the saved ``lse``: one for dq, which also
writes ``di = rowsum(o·do)``, then one for dk and dv.  They do 7 products
where 5 would do (dq's kernel computes q·kᵀ and do·vᵀ again); the bound of
the 5 is 0.174 ms at the flagship [16, 16, 1024, 128] on an H100.  No
atomics: a run on the card repeats bit for bit.

The kernels apply no scale: the caller scales q, in its own dtype, as the
JAX model does before it calls splash.  ``attn_fwd`` and ``attn_bwd`` launch
the kernels for CUDA tensors and take their plain versions, which follow
splash's reference math, only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

HEAD_DIMS = (64, 128)  # the head widths the kernels are built for
_FWD_LIB = ("attn_fwd", ("attn_fwd.cu",))
_BWD_LIB = ("attn_bwd", ("attn_bwd.cu",))


def _causal_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """f32 ``q·kᵀ`` [B, H, S, S] with the keys after each query at -inf."""
    S = q.shape[-2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    above = torch.ones((S, S), dtype=torch.bool, device=q.device).triu(1)
    return s.masked_fill(above, float("-inf"))


def attn_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Plain PyTorch version of the forward kernel: q, k, v [B, H, S, hd]
    (one dtype) → (o [B, H, S, hd] in that dtype, lse [B, H, S] f32).
    Splash's reference math: f32 scores, f32 softmax, ``o = p·v`` in f32,
    ``lse = m + log l``."""
    s = _causal_scores(q, k)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    o = torch.matmul(e / l, v.float())
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def attn_bwd_plain(q, k, v, o, lse, do):
    """Plain PyTorch version of the backward kernels: the probabilities
    recomputed from ``lse``, ``di = rowsum(o·do)`` and ``ds = (dp − di)·p``
    in f32; (dq, dk, dv) in the input dtype."""
    p = torch.exp(_causal_scores(q, k) - lse[..., None])
    dof = do.float()
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    di = (o.float() * dof).sum(dim=-1, keepdim=True)
    ds = (dp - di) * p
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def row_errs(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """How far ``got`` is from ``want`` (same shape, any float dtype), row by
    row along the last dim: ``‖got − want‖ / ‖want‖`` for each row.
    Attention's rows differ in scale by orders (o of the first query is
    v[0], of the last an average of S values), so each row is held to its
    own norm, not to the tensor's largest value.  A row whose norm is below
    1e-3 of the tensor's RMS row norm (dq of the first query is 0 up to
    rounding) is held to that floor instead."""
    got, want = got.float(), want.float()
    norms = want.norm(dim=-1)
    floor = 1e-3 * float(norms.square().mean().sqrt())
    return (got - want).norm(dim=-1) / norms.clamp_min(floor)


def max_row_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest of ``row_errs(got, want)``."""
    return float(row_errs(got, want).max())


def _check(name: str, shape, tensors: dict) -> str:
    """The device type the tensors share; for CUDA, raise unless every
    tensor is what the kernels take."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices: {devices}")
    dev = next(iter(devices))
    if dev.type == "cpu":
        return "cpu"
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if len(shape) != 4:
        raise ValueError(f"{name}: q must be [B, H, S, hd], got {tuple(shape)}")
    B, H, S, hd = shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name} kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    if not (0 < B * H < 65536 and 0 < S < 2**31):
        raise ValueError(f"{name} kernel: B*H={B * H}, S={S} out of range")
    for tn, t in tensors.items():
        want = torch.float32 if tn == "lse" else torch.bfloat16
        want_shape = (B, H, S) if tn == "lse" else (B, H, S, hd)
        if t.dtype != want or tuple(t.shape) != want_shape:
            raise TypeError(
                f"{name} kernel takes {tn} {want} {list(want_shape)}, "
                f"got {t.dtype} {list(t.shape)}"
            )
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} kernel needs a contiguous, 16-byte aligned {tn}")
    return "cuda"


def _launch(fn, name: str, device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(o, lse) of causal attention over q, k, v [B, H, S, hd].  CPU tensors
    take ``attn_fwd_plain``; CUDA tensors launch the kernel (bf16,
    contiguous, hd 64 or 128, any S ≥ 1) or raise."""
    if _check("attn_fwd", q.shape, {"q": q, "k": k, "v": v}) == "cpu":
        return attn_fwd_plain(q, k, v)
    B, H, S, hd = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    _launch(_kernel_fn(_FWD_LIB, "tpudra_attn_fwd", 5), "attn_fwd", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            B * H, S, hd)
    attn_fwd.launches += 1
    return o, lse


attn_fwd.launches = 0  # kernel launches, for showing a run went through it


def attn_bwd(q, k, v, o, lse, do):
    """(dq, dk, dv) of ``attn_fwd`` given its (o, lse) and the output's
    cotangent ``do``.  CPU tensors take ``attn_bwd_plain``; CUDA tensors
    launch the two backward kernels (same constraints as ``attn_fwd``) or
    raise."""
    tensors = {"q": q, "k": k, "v": v, "o": o, "lse": lse, "do": do}
    if _check("attn_bwd", q.shape, tensors) == "cpu":
        return attn_bwd_plain(q, k, v, o, lse, do)
    B, H, S, hd = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    di = torch.empty((B, H, S), dtype=torch.float32, device=q.device)  # scratch
    _launch(_kernel_fn(_BWD_LIB, "tpudra_attn_bwd", 10), "attn_bwd", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), di.data_ptr(),
            B * H, S, hd)
    attn_bwd.launches += 1
    return dq, dk, dv


attn_bwd.launches = 0


def _kernel_fn(lib, symbol: str, n_ptrs: int):
    from tpudra_torch.workload import _build

    fn = getattr(_build.load(*lib), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class FlashAttention(torch.autograd.Function):
    """Causal attention with the kernels' backward; the counterpart of
    splash's custom_vjp.  Saves (q, k, v, o, lse); lse is an output without
    a gradient."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = attn_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        return attn_bwd(q, k, v, o, lse, do.contiguous())


def flash_attention(q, k, v, save_residuals: bool = False):
    """Causal attention over q, k, v [B, H, S, hd] (q already scaled): o, or
    (o, lse) with ``save_residuals`` as splash returns them."""
    o, lse = FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous())
    return (o, lse) if save_residuals else o
