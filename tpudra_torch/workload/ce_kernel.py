"""Fused cross-entropy head: the counterpart of ``tpudra/workload/ce_kernel.py``.

Forward: per row of x, ``logsumexp(x @ E^T)`` and the target logit, computed
by the hand-written CUDA kernels of ``csrc/ce_fwd.cu`` (per vocab chunk, then
a combine over the chunks) without writing the [N, V] logits to device
memory.  Backward: the port of ``_fused_bwd``,
recomputing the logits in BWD_CHUNK-row chunks (plain matrix products, as
the JAX package leaves them to XLA), so the softmax intermediate exists only
at [chunk, V].

``ce_fwd`` launches the kernel for CUDA tensors and takes its plain version,
``ce_fwd_plain``, only for CPU tensors.  The kernel takes any N and V, so
``fused_ce_mean`` needs no padding; ``fused_ce_sum`` still takes ``n_valid``
so a caller with padded rows keeps them out of the sum.

The chunked head (``model._ce_sum``) calls ``ce_chunk_sum`` per chunk.  With
bf16 x and E on CUDA it takes ``CEChunk``, whose three products all run on
tensor cores with f32 accumulation: the forward's x·Eᵀ (a product of two
bf16 values is exact in f32), and the backward's d·E and dᵀ·x, with the f32
cotangent d split exactly into three bf16 planes by ``ce_split`` (a Triton
pass): hi = bf16(d), mid = bf16(d − hi), lo = bf16(d − hi − mid).  Each
rounding leaves an f32 residual that is exact; hi and mid take 8 bits each
of d's 24-bit significand and lo holds the last 8 exactly, with f32's
exponent range, so hi + mid + lo = d wherever |d| ≥ 2⁻¹¹⁰ (below, lo misses
by at most bf16's subnormal step, 2⁻¹³⁴), and Σ plane·E = d·E up to the f32
sums.  The tensor cores' f32 accumulation loses more than an f32 FMA over a
long sum, so the forward's product and the hi plane's are cut in depth and
the slices summed in f32 (``_mm_f32``).  Any other input (the CPU, f32)
takes the upcast product as before.
"""

from __future__ import annotations

import ctypes
import functools

import torch

BWD_CHUNK = 4096
_LIB = ("ce_fwd", ("ce_fwd.cu",))
SPLIT_BLOCK = 1024  # vocab columns per program of the split pass
FWD_DEPTH = 1024  # depth (d_model columns) of each product of the forward's logits
SPLIT_COLS = 4096  # depth (vocab columns) of each product of the hi plane's dx
SPLIT_DEPTH = 1024  # depth (rows) of each product of the hi plane's dE

# triton.language and its libdevice, bound by _split_kernel() at the first launch
tl = libdevice = None


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [..., K] @ b [K, M]`` with an f32 result, the counterpart of
    ``preferred_element_type=jnp.float32``.

    f32 operands multiply as they are.  bf16 operands on CUDA, where no
    gradient is asked for, go through an f32-output product
    (``torch.mm(..., out_dtype=torch.float32)``: bf16 inputs, f32
    accumulation and result; that overload has no derivative).  Otherwise
    they are upcast first, which computes the same thing: the product of two
    bf16 values is exact in f32.
    """
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    wants_grad = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        out = a2 @ b
    elif a.is_cuda and a.dtype == b.dtype == torch.bfloat16 and not wants_grad:
        out = torch.mm(a2, b, out_dtype=torch.float32)
    else:
        out = a2.float() @ b.float()
    return out.reshape(*lead, b.shape[-1])


def ce_fwd_plain(x: torch.Tensor, emb: torch.Tensor, targets: torch.Tensor):
    """Plain PyTorch version of the kernel: x [N, D], emb [V, D] (same
    dtype), targets [N] int → (lse [N] f32, target logit [N] f32)."""
    logits = matmul_f32(x, emb.t())
    tlog = logits.gather(1, targets.long()[:, None])[:, 0]
    return torch.logsumexp(logits, dim=-1), tlog


def ce_fwd(x: torch.Tensor, emb: torch.Tensor, targets: torch.Tensor):
    """(lse, target logit) per row.  CPU tensors take ``ce_fwd_plain``; CUDA
    tensors launch the kernel (x, emb bf16 and contiguous, D a multiple of
    8, targets int32) or raise."""
    devices = {x.device, emb.device, targets.device}
    if len(devices) != 1:
        raise ValueError(f"ce_fwd: tensors on several devices: {devices}")
    if x.device.type == "cpu":
        return ce_fwd_plain(x, emb, targets)
    if x.device.type != "cuda":
        raise ValueError(f"ce_fwd: no kernel for device {x.device}")
    N, D = x.shape
    V = emb.shape[0]
    if x.dtype != torch.bfloat16 or emb.dtype != torch.bfloat16:
        raise TypeError(f"ce_fwd kernel takes bf16 x and emb, got {x.dtype}, {emb.dtype}")
    if targets.dtype != torch.int32 or targets.shape != (N,):
        raise TypeError(f"ce_fwd kernel takes int32 targets [{N}], got {targets.dtype} {tuple(targets.shape)}")
    if emb.shape[1] != D or D % 8:
        raise ValueError(f"ce_fwd kernel needs emb [V, {D}] with D % 8 == 0, got {tuple(emb.shape)}")
    for name, t in (("x", x), ("emb", emb), ("targets", targets)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"ce_fwd kernel needs a contiguous, 16-byte aligned {name}")
    if not 0 < max(N, V) < 2**31:
        raise ValueError(f"ce_fwd kernel: N={N}, V={V} out of range")
    lib = _library()
    lse = torch.empty(N, dtype=torch.float32, device=x.device)
    tlog = torch.empty(N, dtype=torch.float32, device=x.device)
    # Per vocab chunk and row: partial max, sum and target logit.
    scratch = torch.empty(lib.tpudra_ce_fwd_scratch_floats(N, V), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tpudra_ce_fwd(
            x.data_ptr(), emb.data_ptr(), targets.data_ptr(), lse.data_ptr(),
            tlog.data_ptr(), scratch.data_ptr(), N, V, D, stream,
        )
    if err:
        raise RuntimeError(f"ce_fwd kernel launch failed: CUDA error {err}")
    ce_fwd.launches += 1
    return lse, tlog


ce_fwd.launches = 0  # kernel launches, for showing a run went through it


def _library():
    from tpudra_torch.workload import _build

    lib = _build.load(*_LIB)
    lib.tpudra_ce_fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.tpudra_ce_fwd.restype = ctypes.c_int
    lib.tpudra_ce_fwd_scratch_floats.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.tpudra_ce_fwd_scratch_floats.restype = ctypes.c_longlong
    return lib


class FusedCE(torch.autograd.Function):
    """Sum over the first ``n_valid`` rows of ``lse - target_logit``; the
    counterpart of ``fused_ce_sum``'s custom_vjp."""

    @staticmethod
    def forward(ctx, x, emb, targets, n_valid: int):
        lse, tlog = ce_fwd(x, emb.to(x.dtype), targets)
        valid = torch.arange(x.shape[0], device=x.device) < n_valid
        loss = torch.where(valid, lse - tlog, 0.0).sum()
        ctx.save_for_backward(x, emb, targets, lse)
        ctx.n_valid = n_valid
        return loss

    @staticmethod
    def backward(ctx, g):
        """d_logits = g·(softmax − onehot) on valid rows, per row chunk;
        dx = d·E in the activation dtype, dE accumulated in f32."""
        x, emb, targets, lse = ctx.saved_tensors
        n_valid = ctx.n_valid
        e_act = emb.to(x.dtype)
        Np, D = x.shape
        dx = torch.empty_like(x)
        demb = torch.zeros(emb.shape, dtype=torch.float32, device=x.device)
        for r0 in range(0, Np, BWD_CHUNK):
            r1 = min(Np, r0 + BWD_CHUNK)
            xc = x[r0:r1]
            p = torch.exp(matmul_f32(xc, e_act.t()) - lse[r0:r1, None])
            # p − onehot on the valid rows (a prefix), 0 on the pad rows.
            nv = max(0, min(r1, n_valid) - r0)
            rows = torch.arange(nv, device=x.device)
            p[rows, targets[r0:r0 + nv].long()] -= 1.0
            p[nv:] = 0.0
            d = (p * g).to(x.dtype)
            dx[r0:r1] = d @ e_act
            demb += matmul_f32(d.t(), xc)
        return dx, demb.to(emb.dtype), None, None


def fused_ce_sum(x, emb, targets, n_valid: int):
    """x [Np, D] activation dtype, emb [V, D], targets [Np] int32 in [0, V):
    the sum over the first ``n_valid`` rows of ``logsumexp - target_logit``."""
    return FusedCE.apply(x, emb, targets, n_valid)


def fused_ce_mean(x2d, emb, targets1d):
    """Mean next-token CE over x2d [N, D] / targets1d [N] (any N)."""
    N = x2d.shape[0]
    return fused_ce_sum(x2d, emb, targets1d, N) / N


def ce_split_plain(logits, lse, targets, g):
    """Plain PyTorch version of the split pass: logits [n, V] f32, lse [n]
    f32, targets [n] int, g a 0-d f32 tensor → bf16 planes [3, n, V] whose
    sum is d = g·(exp(logits − lse) − onehot(targets)), exactly wherever
    |d| ≥ 2⁻¹¹⁰."""
    p = torch.exp(logits - lse[:, None])
    rows = torch.arange(p.shape[0], device=p.device)
    p[rows, targets.long()] -= 1.0
    d = p * g
    hi = d.to(torch.bfloat16)
    r = d - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return torch.stack([hi, mid, lo])


def ce_split(logits, lse, targets, g):
    """The cotangent of a CE chunk as three bf16 planes [3, n, V]
    (``ce_split_plain``).  CPU tensors take the plain version; CUDA tensors
    launch the Triton pass or raise."""
    devices = {t.device for t in (logits, lse, targets, g)}
    if len(devices) != 1:
        raise ValueError(f"ce_split: tensors on several devices: {devices}")
    if logits.device.type == "cpu":
        return ce_split_plain(logits, lse, targets, g)
    if logits.device.type != "cuda":
        raise ValueError(f"ce_split: no kernel for device {logits.device}")
    n, V = logits.shape
    if (logits.dtype, lse.dtype, g.dtype) != (torch.float32,) * 3 or targets.dtype not in (
        torch.int32, torch.int64,
    ):
        raise TypeError(f"ce_split kernel takes f32 logits, lse, g and int targets; got "
                        f"{logits.dtype}, {lse.dtype}, {g.dtype}, {targets.dtype}")
    if lse.shape != (n,) or targets.shape != (n,) or g.numel() != 1:
        raise ValueError(f"ce_split kernel: lse and targets must be [{n}] and g one value")
    if not all(t.is_contiguous() for t in (logits, lse, targets)):
        raise ValueError("ce_split kernel needs contiguous logits, lse and targets")
    planes = torch.empty((3, n, V), dtype=torch.bfloat16, device=logits.device)
    if n:
        kernel = _split_kernel()
        with torch.cuda.device(logits.device):
            kernel[(n, -(-V // SPLIT_BLOCK))](
                logits, lse, targets, g, planes[0], planes[1], planes[2], V, BLOCK=SPLIT_BLOCK,
                # No contraction into FMA: d and its residuals must round
                # exactly where the plain version rounds them.
                enable_fp_fusion=False,
            )
        ce_split.launches += 1
    return planes


ce_split.launches = 0  # kernel launches, for showing a run went through it


@functools.cache
def _split_kernel():
    """The Triton split pass, built on first use: this module is imported
    where triton is absent (the CPU tests), so triton is imported only here.

    Replaces no TPU kernel: the JAX package leaves the chunked head's
    backward to XLA.  It exists so that the backward's two products can run
    on bf16 tensor cores without rounding the f32 cotangent.  Bound on an
    H100: bytes — 4 read and 6 written per logit, one exp and a few f32
    operations each.  Design: one program per row and SPLIT_BLOCK columns;
    the row's lse, target and g are loaded once; d is formed in registers
    and never written in f32; the three planes are stored through one
    pointer each.  exp is libdevice's, the function torch.exp calls.
    """
    global tl, libdevice
    import triton
    import triton.language as tl
    from triton.language.extra import libdevice

    @triton.jit
    def split_kernel(logits_ptr, lse_ptr, tgt_ptr, g_ptr, hi_ptr, mid_ptr, lo_ptr, V,
                     BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
        mask = cols < V
        offs = row * V + cols
        logit = tl.load(logits_ptr + offs, mask=mask, other=0.0)
        p = libdevice.exp(logit - tl.load(lse_ptr + row))
        d = tl.where(cols == tl.load(tgt_ptr + row), p - 1.0, p) * tl.load(g_ptr)
        hi = d.to(tl.bfloat16)
        r = d - hi.to(tl.float32)
        mid = r.to(tl.bfloat16)
        lo = (r - mid.to(tl.float32)).to(tl.bfloat16)
        tl.store(hi_ptr + offs, hi, mask=mask)
        tl.store(mid_ptr + offs, mid, mask=mask)
        tl.store(lo_ptr + offs, lo, mask=mask)

    return split_kernel


def _mm_f32(a, b, depth, acc=None):
    """``a [m, K] @ b [K, p]`` of bf16 CUDA tensors in f32 on tensor cores,
    added into the f32 ``acc`` [m, p] in place (or a new tensor where acc is
    None) and returned.  The product is cut in depth into slices of
    ``depth``, each added into acc by the product's epilogue.

    On an H100 the tensor cores' f32 accumulation loses more than an f32
    FMA, and the more the deeper one product is, most where a large term
    (a target's −g) enters a sum early and small ones follow.  Against f64,
    in units of the f32 SIMT product's error: dx 12× at depth 32768, 1.5×
    in slices of 4096; dE 19×, 1.9× in slices of 1024; the forward's
    logits 5.4× at depth 2048, 2.6× in slices of 1024 (1.2× in 512, for
    11% more of the head's time)."""
    for k0 in range(0, a.shape[1], depth):
        a_k, b_k = a[:, k0:k0 + depth], b[k0:k0 + depth]
        if acc is None:
            acc = torch.mm(a_k, b_k, out_dtype=torch.float32)
        else:
            torch.addmm(acc, a_k, b_k, out_dtype=torch.float32, out=acc)
    return acc


def planes_grads(planes, x, emb, dx, demb):
    """Adds Σ plane·E to dx [n, D] and Σ planeᵀ·x to demb [V, D] (both f32)
    for the cotangent's bf16 planes [k, n, V] (hi first), x [n, D] and emb
    [V, D].  The hi plane's products are cut in depth, dx into SPLIT_COLS
    vocab columns and dE into SPLIT_DEPTH rows; the smaller planes, at most
    2⁻⁸ of hi, are not: each goes into dx at depth V, the smallest first,
    and they go into dE stacked, at depth (k − 1)·n against x repeated."""
    k, n, V = planes.shape
    for i in range(k - 1, -1, -1):
        _mm_f32(planes[i], emb, SPLIT_COLS if i == 0 else V, dx)
    if k > 1:
        rest = planes[1:].reshape((k - 1) * n, V)
        _mm_f32(rest.t(), x.repeat(k - 1, 1), (k - 1) * n, demb)
    _mm_f32(planes[0].t(), x, SPLIT_DEPTH, demb)


def ce_chunk_grads(x, emb, targets, logits, lse, g):
    """The backward of ``CEChunk`` in f32: (dx [n, D], dE [V, D]) for the
    upstream gradient g, in BWD_CHUNK-row sub-chunks, so that the planes
    exist only at [3, BWD_CHUNK, V]."""
    n = x.shape[0]
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    demb = torch.zeros(emb.shape, dtype=torch.float32, device=x.device)
    for r0 in range(0, n, BWD_CHUNK):
        r1 = min(n, r0 + BWD_CHUNK)
        planes = ce_split(logits[r0:r1], lse[r0:r1], targets[r0:r1], g)
        planes_grads(planes, x[r0:r1], emb, dx[r0:r1], demb)
    return dx, demb


class CEChunk(torch.autograd.Function):
    """Σ over the rows of x [n, D] of ``logsumexp(x·Eᵀ) − target logit``,
    emb [V, D] and x of one dtype, targets [n] int: one chunk of the
    chunked head.  The f32 logits are kept for the backward (as autograd
    keeps them for the plain chunk), with x, E, the targets and lse."""

    @staticmethod
    def forward(ctx, x, emb, targets):
        logits = _mm_f32(x, emb.t(), FWD_DEPTH)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(1, targets.long()[:, None])[:, 0]
        ctx.save_for_backward(x, emb, targets, logits, lse)
        return (lse - tgt).sum()

    @staticmethod
    def backward(ctx, g):
        x, emb, targets, logits, lse = ctx.saved_tensors
        dx, demb = ce_chunk_grads(x, emb, targets, logits, lse, g.float())
        return dx.to(x.dtype), demb.to(emb.dtype), None


def _on_tensor_cores(x, emb) -> bool:
    return x.is_cuda and x.dtype == emb.dtype == torch.bfloat16


def ce_chunk_sum(x, emb, targets):
    """Σ (logsumexp − target logit) over the rows of x [..., D] against emb
    [V, D] and targets [...]: one chunk of the chunked CE head.  bf16 x and
    emb on CUDA take ``CEChunk``; anything else the upcast product under
    autograd."""
    if _on_tensor_cores(x, emb):
        D = x.shape[-1]
        return CEChunk.apply(x.reshape(-1, D).contiguous(), emb, targets.reshape(-1).contiguous())
    logits = matmul_f32(x, emb.t())
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets[..., None].long())[..., 0]
    return (lse - tgt).sum()
