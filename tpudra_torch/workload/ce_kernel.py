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
"""

from __future__ import annotations

import ctypes

import torch

BWD_CHUNK = 4096
_LIB = ("ce_fwd", ("ce_fwd.cu",))


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
