"""Fused single-pass AdamW update: the counterpart of
``tpudra/workload/opt_kernel.py``.

One sweep per leaf reads (p, g, m, v) and writes (p', m', v') in place, with
the moment arithmetic in f32 and the moments stored as bf16 — rounded to
bf16 BEFORE the update rule reads them, as the tree-map AdamW stores and
re-reads them.  The step's bias corrections ``1 - b**count`` come from a
small f32 device tensor, so the host never waits on the step count.

``adamw_step`` launches the Triton kernel for CUDA tensors and takes its
plain version, ``adamw_step_plain``, only for CPU tensors.
"""

from __future__ import annotations

import functools

import torch

from tpudra_torch.workload.convert import tree_leaves, tree_map

BLOCK = 1024  # elements per Triton program

tl = None  # triton.language, bound by _triton_kernel() at the first launch


def bias_corrections(count: torch.Tensor, b1: float, b2: float) -> torch.Tensor:
    """[1 - b1**count, 1 - b2**count] in f32 from the int32 step count, on
    the count's device (JAX: ``1 - b ** count.astype(jnp.float32)``)."""
    cf = count.float()
    base = torch.tensor([b1, b2], dtype=torch.float32, device=count.device)
    return 1.0 - base ** cf


def init_bf16_moments(params):
    """AdamW state (mu, nu, count) for a parameter tree: zero bf16 moments
    shaped like the params and an int32 step count on their device."""
    zeros16 = lambda p: torch.zeros_like(p, dtype=torch.bfloat16)  # noqa: E731
    device = tree_leaves(params)[0].device
    return (
        tree_map(zeros16, params),
        tree_map(zeros16, params),
        torch.zeros((), dtype=torch.int32, device=device),
    )


def adamw_step_plain(p, g, m, v, c12, *, lr, b1, b2, eps, wd):
    """The kernel's arithmetic in plain PyTorch, one op per rounding; updates
    p (f32), m and v (bf16) in place."""
    gf = g.float()
    m16 = (b1 * m.float() + (1.0 - b1) * gf).to(torch.bfloat16)
    v16 = (b2 * v.float() + (1.0 - b2) * gf * gf).to(torch.bfloat16)
    mhat = m16.float() / c12[0]
    vhat = v16.float() / c12[1]
    p.copy_(p - lr * (mhat / (torch.sqrt(vhat) + eps) + wd * p))
    m.copy_(m16)
    v.copy_(v16)


def adamw_step(p, g, m, v, c12, *, lr, b1, b2, eps, wd):
    """One AdamW sweep over a leaf, in place.  p, g f32; m, v bf16; all of
    one shape; c12 [2] f32 (``bias_corrections``).  CPU tensors take
    ``adamw_step_plain``; CUDA tensors launch the Triton kernel or raise."""
    devices = {t.device for t in (p, g, m, v, c12)}
    if len(devices) != 1:
        raise ValueError(f"adamw_step: tensors on several devices: {devices}")
    if p.device.type == "cpu":
        return adamw_step_plain(p, g, m, v, c12, lr=lr, b1=b1, b2=b2, eps=eps, wd=wd)
    if p.device.type != "cuda":
        raise ValueError(f"adamw_step: no kernel for device {p.device}")
    if (p.dtype, g.dtype, m.dtype, v.dtype, c12.dtype) != (
        torch.float32, torch.float32, torch.bfloat16, torch.bfloat16, torch.float32,
    ):
        raise TypeError(
            "adamw_step kernel takes f32 p, g, c12 and bf16 m, v; got "
            f"{p.dtype}, {g.dtype}, {m.dtype}, {v.dtype}, {c12.dtype}"
        )
    if not (p.shape == g.shape == m.shape == v.shape) or c12.shape != (2,):
        raise ValueError("adamw_step kernel: p, g, m, v must share a shape; c12 must be [2]")
    if not all(t.is_contiguous() for t in (p, g, m, v, c12)):
        raise ValueError("adamw_step kernel needs contiguous tensors")
    n = p.numel()
    kernel = _triton_kernel()
    with torch.cuda.device(p.device):
        kernel[(-(-n // BLOCK),)](
            p, g, m, v, c12, n, lr, b1, b2, 1.0 - b1, 1.0 - b2, eps, wd,
            BLOCK=BLOCK,
            # No mul+add contraction into FMA: the moments must round exactly
            # where the plain version and the JAX package round them.
            enable_fp_fusion=False,
        )
    adamw_step.launches += 1


adamw_step.launches = 0  # kernel launches, for showing a run went through it


@functools.cache
def _triton_kernel():
    """The Triton kernel, built on first use: this module is imported where
    triton is absent (the CPU tests), so triton is imported only here.

    Replaces tpudra/workload/opt_kernel.py::_kernel (driven per leaf by
    _leaf_update).  Bound on an H100: bytes — 20 per element (read p, g
    f32 and m, v bf16; write p f32, m, v bf16) against 17 f32 operations,
    so the sweep is memory-bound.  Design: one program per BLOCK elements
    of the flattened leaf, masked 16-byte vector loads and stores, no
    cooperation between threads, p/m/v updated in place — no pad or
    reshape copies (the Pallas version pads each leaf to [rows, 1024]).
    Division and square root are the correctly rounded forms (div_rn,
    sqrt_rn), not Triton's approximate defaults.
    """
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def adamw_kernel(p_ptr, g_ptr, m_ptr, v_ptr, c_ptr, n, lr, b1, b2, omb1, omb2, eps, wd,
                     BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        g = tl.load(g_ptr + offs, mask=mask, other=0.0)
        m = tl.load(m_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        v = tl.load(v_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        p = tl.load(p_ptr + offs, mask=mask, other=0.0)
        m16 = (b1 * m + omb1 * g).to(tl.bfloat16)
        v16 = (b2 * v + omb2 * g * g).to(tl.bfloat16)
        c1 = tl.load(c_ptr)
        c2 = tl.load(c_ptr + 1)
        mhat = tl.div_rn(m16.to(tl.float32), c1)
        vhat = tl.div_rn(v16.to(tl.float32), c2)
        upd = tl.div_rn(mhat, tl.sqrt_rn(vhat) + eps) + wd * p
        tl.store(p_ptr + offs, p - lr * upd, mask=mask)
        tl.store(m_ptr + offs, m16, mask=mask)
        tl.store(v_ptr + offs, v16, mask=mask)

    return adamw_kernel


def fused_adamw(learning_rate: float, b1=0.9, b2=0.999, eps=1e-8, wd=1e-4):
    """(init, apply) with the state of ``model.adamw_bf16_moments``
    ((mu, nu, count), both moments bf16) and a one-sweep apply that returns
    the new params directly.

    apply(params, grads, state) -> (params, state): params and moments are
    updated in place (the same tensors come back); count is a new tensor.
    """

    def apply(params, grads, state):
        mu, nu, count = state
        count = count + 1
        c12 = bias_corrections(count, b1, b2)
        for p, g, m, v in zip(
            tree_leaves(params), tree_leaves(grads), tree_leaves(mu), tree_leaves(nu)
        ):
            adamw_step(p, g, m, v, c12, lr=learning_rate, b1=b1, b2=b2, eps=eps, wd=wd)
        return params, (mu, nu, count)

    return init_bf16_moments, apply
