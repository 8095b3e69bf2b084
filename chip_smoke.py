#!/usr/bin/env python3
"""Drive the PyTorch port (tpudra_torch) on one NVIDIA GPU and check it.

Run from the root of the repository:  python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:
  1. device:  the card's name and power limit (nvidia-smi); no CUDA, no run
  2. build:   nvcc builds the CUDA kernels from csrc/, one nvcc per library,
              all at once (seconds and ptxas report)
  3. kernels: each kernel against its plain PyTorch version at the flagship
              train step's shapes (attention also at head width 64, a
              ragged sequence and the long step's seq 8192, row by row),
              with the tolerance stated; planted faults (a skipped
              attention tile, a dropped vocab tile or depth slice of the
              CE head) must fail those checks; each kernel timed beside its
              plain version, a PyTorch library yardstick and its bound
              (attn_fwd and attn_bwd also at seq 8192); the latent-attention
              pair (q·k 192, v 128) the same way at the shape the
              dsv2lite-s8192 cell hands it, [6, 16, 8192], beside PyTorch's
              SDPA with v at 128.  The chunked CE
              head's split pass (ce_split, Triton) bit for bit against its
              plain version at one backward sub-chunk, and the chunk
              function's logits, dx and dE against f64 products within 4x
              the f32 SIMT product's error (a bf16 cotangent, a two-plane
              split and bf16 logits must fail that)
  4. small:   one train step's loss and grads on the card (kernels) against
              the CPU (plain versions) at a small size, with naive and with
              flash attention, and with the chunked CE head
  5. step:    the flagship train step at full width (472M params, batch 16,
              seq 1024), granted through a one-device ClaimEnv, twice:
              a. fused CE head, fused AdamW, naive attention, remat "none",
                 then profiled;
              b. the JAX bench's configuration (bench.py bench_tpu_step):
                 flash attention, remat "dots", chunked CE, tree AdamW, then
                 profiled;
              1 warm-up and 3 timed steps each
  6. long:    bench.py's long8192: the same width at seq 8192, batch 2,
              remat "dots", flash attention; 1 warm-up and 2 timed steps,
              then profiled; then the dsv2lite-s8192 cell's DeepSeek-V2-Lite
              step (batch 6, seq 8192; 1 warm-up and 1 timed step), whose
              attention launches are the latent-attention pair's
  7. moe_small: one small Switch-MoE step's loss and grads on the card
              against the CPU (f32, naive attention), and its loss in bf16
              with the flash kernels
  8. moe:     bench.py bench_moe's configuration at full width (605M params,
              8 experts, batch 8, seq 1024, splash, remat "dots", chunked CE,
              tree AdamW); 1 warm-up and 3 timed steps, then profiled;
              bench_moe's accounting recomputed here, plus the bytes the
              index dispatch and combine move, timed alone, and the tokens
              the routing keeps
  9. ring:    ring attention's block schedule in one process
              (ringattention.ring_blocks, the code each rank of the ring
              runs) at the long step's attention shape in 8 blocks of 1024:
              o, dq, dk and dv row by row against the flash kernels and
              their plain versions, and timed beside the kernels
 10. entry:   entry()'s forward on the card against the CPU
 11. distributed: a child process granted the card through the env
              (ClaimEnv.apply_cuda_env, mesh_from_devices over a one-rank
              NCCL group): verify_collectives and the five benches on the
              card (no GB/s is published from one rank); the sharded train
              step on a (1, 1, 1) ("dp", "sp", "tp") mesh against the
              single-device step, at the MoE configuration and dense at the
              flagship width with 2 layers; the model with ring attention
              on that mesh (dense, flagship width, 2 layers); the pipelined
              step on a (1, 1, 1) ("pp", "dp", "tp") mesh in PIPE_M
              microbatches at the flagship configuration (1 warm-up and 3
              timed steps, with its attention launches) and at bench_moe's,
              each against the single-device step
 12. rank:    the multi-host rank worker (tpudra_torch.sim.multihost) in a
              child process granted the card through a one-host
              ComputeDomain grant env (one_host_grant: the CD plugin's keys,
              TPU_VISIBLE_DEVICES, a traceparent, tracing on): the card it
              sees must be the granted one (its UUID against nvidia-smi's
              for the granted index); a one-rank NCCL group, the all-reduce
              on the card and its RESULT line (8.0, devices 1, mesh 1,1,1);
              exactly one rank.worker span in the trace log, parented on the
              grant's traceparent, from the child's pid; the seconds from
              spawn to RESULT and of init_process_group.  The gang itself
              (many ranks, the coordinator proxy) runs only on the CPU
              (tools/torch_multihost.py): NCCL takes one GPU per rank.
Each step phase sets every kernel's launch count to 0 just before it and
reads the counts just after.

Then one JSON line {"kernels": [...]} and, last, the run's verdict line
{"ok": true, "device": {...}}.  Every time is from this run, on this card.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

# Flagship width (bench.py BENCH_MODEL / BENCH_BATCH).
FLAGSHIP = dict(vocab=32768, d_model=2048, n_heads=16, n_layers=8, d_ff=8192, max_seq=1024)
BATCH = 16
TIMED_STEPS = 3
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
LONG = dict(FLAGSHIP, max_seq=8192)  # bench.py long8192
# bench.py bench_moe: half the flagship's width, 8 experts, batch 8.
MOE = dict(vocab=32768, d_model=1024, n_heads=8, n_layers=8, d_ff=4096, max_seq=1024,
           num_experts=8)
MOE_BATCH = 8
LONG_BATCH = 2
LONG_TIMED_STEPS = 2
CE_TOL = 2e-3  # lse/target logit, f32 sums of bf16 products in another order
# The chunked head's logits, dx and dE (f32, before any cast) against f64
# products of the same bf16 inputs: within SPLIT_TOL times the error of the
# f32 SIMT product (the upcast path, TF32 off), ‖got − f64‖ / ‖f64‖.
SPLIT_TOL = 4.0
ADAMW_P_TOL = 1e-6  # params; moments must be bit-identical
# Attention, kernel against plain on the same bf16 inputs: the kernels round
# the probabilities (and dS) to bf16 where they feed a product, the plain
# versions keep f32, so every row of o, dq, dk and dv within ATTN_TOL of
# that row's own norm (attn_kernel.max_row_err); lse, an f32 sum of exact
# bf16 products, within LSE_TOL absolute.  A kernel that skips one tile
# misses it by 20x or more (phase_attention checks that too).
ATTN_TOL = 2e-2
LSE_TOL = 1e-3
# Ring attention (plain PyTorch, JAX's ring math) against the exact attention
# of the same bf16 inputs, row by row: the ring rounds the unscaled q·kᵀ
# (|s| ~ 11 at hd 128) to bf16 before it scales it, as the JAX ring does,
# where the kernels multiply a pre-scaled q exactly; worst rows ~2% seen
# (p99.99 ~1.1%).  A ring that drops one block step misses by 0.8 or more.
RING_TOL = 4e-2


def attn_shape(batch, n_heads, max_seq, d_model, **_) -> tuple:
    """The [B, H, S, hd] a step of this configuration hands the flash kernels."""
    return (batch, n_heads, max_seq, d_model // n_heads)


# The pipelined steps' microbatches (pipeline.py, pp = 1 on one card).
PIPE_M = 4
# Every step this script drives at full width, with the batch its attention
# sees (a pipelined step's microbatch); its attention shape is held against
# the plain versions (a flash step whose shape is not in ATTN_SHAPES is
# refused).
STEPS = ((FLAGSHIP, BATCH), (LONG, LONG_BATCH), (MOE, MOE_BATCH),
         (FLAGSHIP, BATCH // PIPE_M), (MOE, MOE_BATCH // PIPE_M))
FLAGSHIP_ATTN, LONG_ATTN, MOE_ATTN, PIPE_ATTN, PIPE_MOE_ATTN = (attn_shape(b, **c) for c, b in STEPS)
# [B, H, S, hd]: the steps' shapes, head width 64 at the flagship d_model,
# and a ragged sequence.
ATTN_SHAPES = (FLAGSHIP_ATTN, (BATCH, 32, 1024, 64), (2, 4, 1000, 128), MOE_ATTN, PIPE_ATTN,
               PIPE_MOE_ATTN, LONG_ATTN)
# The ring phase: the long step's attention in RING_BLOCKS sequence blocks.
RING_BLOCKS = 8


def benchmark_cell(config: str, traffic: str) -> tuple[dict, int]:
    """A benchmark cell's model (its configuration file's ``model``, at the
    traffic's seq) and batch, read from perfbench/."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "perfbench")
    with open(os.path.join(root, "configs", f"{config}.json")) as f:
        model = json.load(f)["model"]
    with open(os.path.join(root, "traffic", f"{traffic}.json")) as f:
        mix = json.load(f)
    return dict(model, max_seq=mix["seq"]), mix["batch"]


# DeepSeek-V2-Lite's step as the dsv2lite-s8192 cell runs it, and the
# [B, H, S, q·k width, v width] it hands the latent-attention kernels.
DSV2, DSV2_BATCH = benchmark_cell("deepseek_v2_lite", "seq8192.batch6")
DSV2_TIMED_STEPS = 1
MLA_ATTN = (DSV2_BATCH, DSV2["n_heads"], DSV2["max_seq"],
            DSV2["qk_nope_head_dim"] + DSV2["qk_rope_head_dim"], DSV2["v_head_dim"])


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean ms per call over ``iters`` calls, by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(ops: float, ops_peak: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / ops_peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_build(build, libs):
    t0 = time.perf_counter()
    paths = build.build_all(libs)
    log(f"build: {', '.join(name for name, _ in libs)} with nvcc in "
        f"{time.perf_counter() - t0:.2f} s")
    for lib in paths:
        for line in build.build_log(lib).read_text().splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill", "warning",
                                       "setmaxnreg", "wgmma")):
                log(f"build: ptxas ({lib.name}): {line.strip()}")


def ce_err(got, want) -> float:
    """Largest absolute difference of (lse, target logit) pairs."""
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def ce_dropped(ce_kernel, x, emb, tgt) -> dict:
    """What kernels that drop work would return, from the plain math: (a) the
    last 128 vocab columns never seen (their targets' logit 0, as the kernel
    gives a target it never meets), (b) the last 64-deep slice of D never
    multiplied.  {fault: (lse, target logit)}."""
    V, D = emb.shape
    keep = V - 128
    lse_a, tlog_a = ce_kernel.ce_fwd_plain(x, emb[:keep], tgt.clamp(max=keep - 1))
    tlog_a = tlog_a.masked_fill(tgt >= keep, 0.0)
    x_b = x.clone()
    x_b[:, D - 64:] = 0
    return {"last 128 vocab columns dropped": (lse_a, tlog_a),
            "one 64-deep slice of D dropped": ce_kernel.ce_fwd_plain(x_b, emb, tgt)}


def phase_ce(torch, ce_kernel) -> dict:
    N, D, V = BATCH * (FLAGSHIP["max_seq"] - 1), FLAGSHIP["d_model"], FLAGSHIP["vocab"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    # Unit-RMS hidden states and an embedding at init scale, as in the step.
    x = torch.randn(N, D, generator=gen, device="cuda").to(torch.bfloat16)
    emb = (0.02 * torch.randn(V, D, generator=gen, device="cuda")).to(torch.bfloat16)
    tgt = torch.randint(0, V, (N,), generator=gen, device="cuda", dtype=torch.int32)

    got = ce_kernel.ce_fwd(x, emb, tgt)
    torch.cuda.synchronize()
    want = ce_kernel.ce_fwd_plain(x, emb, tgt)
    err = ce_err(got, want)
    if not (math.isfinite(err) and err <= CE_TOL):
        fail(f"ce_fwd differs from ce_fwd_plain by {err} (> {CE_TOL})")
    # The comparison has teeth: kernels that drop a vocab tile or a depth
    # slice fail it.
    caught = {name: ce_err(bad, want) for name, bad in ce_dropped(ce_kernel, x, emb, tgt).items()}
    log(f"kernels: ce_fwd, planted faults: "
        f"{', '.join(f'{n} {e:.3g}' for n, e in caught.items())} (tol {CE_TOL})")
    if not min(caught.values()) > CE_TOL:
        fail(f"the CE check passes a kernel that drops work: {caught}")
    del got, want

    def library():  # one f32-output product of the bf16 operands, then logsumexp and gather
        logits = torch.mm(x, emb.t(), out_dtype=torch.float32)
        return logits.logsumexp(-1), logits.gather(1, tgt.long()[:, None])

    def library_bf16():  # the earlier yardstick: bf16 logits, then a second f32 copy
        logits = (x @ emb.t()).float()
        return logits.logsumexp(-1), logits.gather(1, tgt.long()[:, None])

    ms = time_ms(torch, lambda: ce_kernel.ce_fwd(x, emb, tgt))
    plain_ms = time_ms(torch, lambda: ce_kernel.ce_fwd_plain(x, emb, tgt), iters=5)
    library_ms = time_ms(torch, library, iters=5)
    library_bf16_ms = time_ms(torch, library_bf16, iters=5)
    flops = 2.0 * N * D * V
    bound_ms, bound_by = bound(flops, PEAK_BF16_FLOPS, 2 * (N * D + V * D) + 4 * N + 8 * N)
    log(f"kernels: ce_fwd N={N} D={D} V={V} max_abs_err={err:.3g} (tol {CE_TOL}) "
        f"ms={ms:.3f} plain_ms={plain_ms:.3f} library_ms={library_ms:.3f} "
        f"(torch.mm out_dtype=float32 + logsumexp + gather; with bf16 logits as before: "
        f"{library_bf16_ms:.3f}) bound_ms={bound_ms:.3f} ({bound_by}); "
        f"{flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms * 100:.1f}% of bound")
    return {
        "name": "ce_fwd", "route": "cuda", "source": "tpudra_torch/workload/csrc/ce_fwd.cu",
        "replaces": "tpudra/workload/ce_kernel.py:34 (_fwd_kernel, launched at :90 _fwd_pallas)",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
    }


def rel_err(got, want) -> float:
    return float((got.double() - want).norm() / want.norm())


def phase_ce_split(torch, ce_kernel) -> dict:
    """The chunked head at one backward sub-chunk of the flagship step:
    x [BWD_CHUNK, d_model], E [vocab, d_model], f32 logits from the chunk
    function's forward product.  The Triton split bit for bit against its
    plain version, its planes summing to the f32 cotangent exactly; the
    forward's logits and the backward's dx and dE within SPLIT_TOL times
    the f32 SIMT product's error against f64, with planted faults (bf16
    logits, a bf16 cotangent, a two-plane split) failing; the split timed
    beside its plain version and its byte bound, the products beside the
    tensor cores' peak."""
    N, D, V = ce_kernel.BWD_CHUNK, FLAGSHIP["d_model"], FLAGSHIP["vocab"]
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(N, D, generator=gen, device="cuda").to(torch.bfloat16)
    emb = (0.02 * torch.randn(V, D, generator=gen, device="cuda")).to(torch.bfloat16)
    tgt = torch.randint(0, V, (N,), generator=gen, device="cuda", dtype=torch.int32)
    g = torch.tensor(1 / (12 * 8191), device="cuda")  # dense-s8192's 1/tokens

    logits = ce_kernel._mm_f32(x, emb.t(), ce_kernel.FWD_DEPTH)
    want64 = x.double() @ emb.double().t()
    errs = {"logits": rel_err(logits, want64),
            "logits, bf16 (fault)": rel_err(logits.bfloat16(), want64)}
    simt = {"logits": rel_err(x.float() @ emb.float().t(), want64)}
    uncut = rel_err(torch.mm(x, emb.t(), out_dtype=torch.float32), want64)
    del want64
    lse = torch.logsumexp(logits, dim=-1)

    planes = ce_kernel.ce_split(logits, lse, tgt, g)
    torch.cuda.synchronize()
    plain = ce_kernel.ce_split_plain(logits, lse, tgt, g)
    if not torch.equal(planes.view(torch.int16), plain.view(torch.int16)):
        n_diff = int((planes.view(torch.int16) != plain.view(torch.int16)).sum())
        fail(f"ce_split differs from ce_split_plain in {n_diff} of {plain.numel()} values")
    del plain
    p = torch.exp(logits - lse[:, None])
    p[torch.arange(N, device="cuda"), tgt.long()] -= 1.0
    d = p * g
    del p
    if not torch.equal(planes.double().sum(0), d.double()):
        fail("ce_split: hi + mid + lo differs from the f32 cotangent")
    dx64, de64 = d.double() @ emb.double(), d.double().t() @ x.double()
    simt.update(dx=rel_err(d @ emb.float(), dx64), dE=rel_err(d.t() @ x.float(), de64))
    del d
    dx, de = ce_kernel.ce_chunk_grads(x, emb, tgt, logits, lse, g)
    errs.update(dx=rel_err(dx, dx64), dE=rel_err(de, de64))
    for k, fault in ((1, "a bf16 cotangent"), (2, "a two-plane split")):
        dx.zero_()
        de.zero_()
        ce_kernel.planes_grads(planes[:k], x, emb, dx, de)
        errs[f"dx, {fault} (fault)"] = rel_err(dx, dx64)
        errs[f"dE, {fault} (fault)"] = rel_err(de, de64)
    del dx64, de64
    ratio = {n: e / simt[n.split(",")[0]] for n, e in errs.items()}
    log("kernels: ce_split chunk function, error against f64 in units of the f32 SIMT "
        f"product's ({', '.join(f'{n} {e:.3g}' for n, e in simt.items())}): "
        f"{', '.join(f'{n} {r:.3g}x' for n, r in ratio.items())} (tol {SPLIT_TOL}x); "
        f"the forward's product uncut (depth {D}) {uncut / simt['logits']:.3g}x")
    sound = {n: r for n, r in ratio.items() if "fault" not in n}
    if not max(sound.values()) <= SPLIT_TOL:
        fail(f"the chunked CE head loses f32 precision: {sound} of the SIMT product's error "
             f"(tol {SPLIT_TOL})")
    # Each fault fails on one of its products: a two-plane split is about as
    # precise as the SIMT product in dx at depth V, and shows in dE.
    for fault in ("logits, bf16", "a bf16 cotangent", "a two-plane split"):
        if not max(r for n, r in ratio.items() if fault in n) > SPLIT_TOL:
            fail(f"the chunked CE check passes {fault}: {ratio}")

    ms = time_ms(torch, lambda: ce_kernel.ce_split(logits, lse, tgt, g))
    plain_ms = time_ms(torch, lambda: ce_kernel.ce_split_plain(logits, lse, tgt, g), iters=5)
    nbytes = 10.0 * N * V + 8.0 * N  # 4 read and 6 written a logit; lse and targets
    bound_ms, bound_by = bound(0.0, PEAK_BF16_FLOPS, nbytes)
    fwd_ms = time_ms(torch, lambda: ce_kernel._mm_f32(x, emb.t(), ce_kernel.FWD_DEPTH), iters=5)
    uncut_ms = time_ms(torch, lambda: torch.mm(x, emb.t(), out_dtype=torch.float32), iters=5)
    dx.zero_()
    de.zero_()
    grads_ms = time_ms(torch, lambda: ce_kernel.planes_grads(planes, x, emb, dx, de), iters=5)
    flops = 2.0 * N * D * V
    log(f"kernels: ce_split N={N} V={V} bit for bit with its plain version; ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}); "
        f"{nbytes / ms / 1e6:.1f} GB/s, {bound_ms / ms * 100:.1f}% of bound; the forward's "
        f"product {fwd_ms:.3f} ms cut at depth {ce_kernel.FWD_DEPTH} "
        f"({flops / fwd_ms / 1e9:.1f} TFLOP/s), {uncut_ms:.3f} ms uncut; the six backward "
        f"products {grads_ms:.3f} ms ({6 * flops / grads_ms / 1e9:.1f} TFLOP/s)")
    return {
        "name": "ce_split", "route": "triton", "source": "tpudra_torch/workload/ce_kernel.py",
        "replaces": "none (the JAX package leaves the chunked head's backward to XLA)",
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": plain_ms,
    }


def phase_adamw(torch, model, opt_kernel) -> dict:
    cfg = model.ModelConfig(**FLAGSHIP)
    gen = torch.Generator(device="cuda").manual_seed(2)
    params = model.init_params(gen, cfg, device="cuda")
    leaves = [params[k] for k in ("embed", "ln_f", "pos")] + [
        params["layers"][k] for k in sorted(params["layers"])
    ]
    grads = [1e-3 * torch.randn(p.shape, generator=gen, device="cuda") for p in leaves]
    mus = [(1e-4 * torch.randn(p.shape, generator=gen, device="cuda")).bfloat16() for p in leaves]
    nus = [(1e-7 * torch.rand(p.shape, generator=gen, device="cuda")).bfloat16() for p in leaves]
    c12 = opt_kernel.bias_corrections(torch.full((), 5, dtype=torch.int32, device="cuda"), 0.9, 0.999)
    hp = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, wd=1e-4)
    n = sum(p.numel() for p in leaves)

    err = 0.0
    for p, g, m, v in zip(leaves, grads, mus, nus):
        pk, mk, vk = p.clone(), m.clone(), v.clone()
        opt_kernel.adamw_step(pk, g, mk, vk, c12, **hp)
        pp, mp, vp = p.clone(), m.clone(), v.clone()
        opt_kernel.adamw_step_plain(pp, g, mp, vp, c12, **hp)
        if not (torch.equal(mk.view(torch.int16), mp.view(torch.int16))
                and torch.equal(vk.view(torch.int16), vp.view(torch.int16))):
            fail(f"adamw_step moments differ from adamw_step_plain on a {tuple(p.shape)} leaf")
        err = max(err, float((pk - pp).abs().max()))
        del pk, mk, vk, pp, mp, vp
    if not (math.isfinite(err) and err <= ADAMW_P_TOL):
        fail(f"adamw_step params differ from adamw_step_plain by {err} (> {ADAMW_P_TOL})")

    def sweep(step):
        for p, g, m, v in zip(leaves, grads, mus, nus):
            step(p, g, m, v, c12, **hp)

    ms = time_ms(torch, lambda: sweep(opt_kernel.adamw_step))
    plain_ms = time_ms(torch, lambda: sweep(opt_kernel.adamw_step_plain), iters=5)
    # Yardstick: PyTorch's fused AdamW, one call over all leaves.  It keeps
    # f32 moments (28 B per param moved, against the kernel's 20).
    lib_params = [torch.nn.Parameter(p.clone()) for p in leaves]
    for lp, g in zip(lib_params, grads):
        lp.grad = g
    opt = torch.optim.AdamW(lib_params, lr=hp["lr"], betas=(hp["b1"], hp["b2"]), eps=hp["eps"],
                            weight_decay=hp["wd"], fused=True)
    library_ms = time_ms(torch, opt.step)
    del opt, lib_params
    # Per element: read p, g (f32), m, v (bf16); write p (f32), m, v (bf16).
    bound_ms, bound_by = bound(17.0 * n, PEAK_F32_FLOPS, 20.0 * n + 8)
    log(f"kernels: adamw_step {len(leaves)} leaves, {n} params, max_abs_err={err:.3g} "
        f"(tol {ADAMW_P_TOL}, moments bit-identical) ms={ms:.3f} plain_ms={plain_ms:.3f} "
        f"library_ms={library_ms:.3f} bound_ms={bound_ms:.3f} ({bound_by}); "
        f"{20.0 * n / ms / 1e6:.0f} GB/s")
    return {
        "name": "adamw_step", "route": "triton",
        "source": "tpudra_torch/workload/opt_kernel.py (_triton_kernel)",
        "replaces": "tpudra/workload/opt_kernel.py:46 (_kernel, launched at :77 _leaf_update)",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
    }


def by_slice(torch, fn, *tensors):
    """``fn`` over one (b, h) slice at a time, its outputs stacked back to
    [B, H, ...]: the kernels treat each slice alone, and the plain versions'
    f32 scores stay one [S, S] at a time (268 MB at S = 8192)."""
    B, H = tensors[0].shape[:2]
    outs = [fn(*(t[b:b + 1, h:h + 1] for t in tensors)) for b in range(B) for h in range(H)]
    return tuple(torch.cat(parts).reshape(B, H, *parts[0].shape[2:]) for parts in zip(*outs))


def skipped_tile(torch, q, k, v, o, lse, do):
    """What kernels that skip one tile would return, from the plain math:
    the causal pairs of the last 64 queries and the 64 keys just below the
    diagonal dropped, one [64 x 64] tile of both backward kernels (a q tile
    of a dk/dv warpgroup, a kv tile of a dq warpgroup).  Gives the forward's
    o and the backward's dq, dk, dv (from the true o and lse)."""
    S = q.shape[-2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    drop = torch.ones((S, S), dtype=torch.bool, device=q.device).triu(1)
    drop[S - 64:, S - 128:S - 64] = True
    s = s.masked_fill(drop, float("-inf"))
    bad_o = torch.matmul(torch.softmax(s, dim=-1), v.float())
    p = torch.exp(s - lse[..., None])
    dof = do.float()
    ds = (torch.matmul(dof, v.float().transpose(-1, -2))
          - (o.float() * dof).sum(dim=-1, keepdim=True)) * p
    bad_dq = torch.matmul(ds, k.float())
    bad_dk = torch.matmul(ds.transpose(-1, -2), q.float())
    bad_dv = torch.matmul(p.transpose(-1, -2), dof)
    return tuple(t.bfloat16() for t in (bad_o, bad_dq, bad_dk, bad_dv))


def seven_products(flops: float, products: int) -> str:
    """For the backward: the bound of the products its two kernels do (the
    dq kernel computes q·kᵀ and do·vᵀ again, 7 against the 5 needed)."""
    if products != 5:
        return ""
    return f"; bound of the 7 products done {flops * 7 / 5 / PEAK_BF16_FLOPS * 1e3:.3f} ms"


def hold_attention(torch, attn_kernel, label, q, k, v, do, errs: dict):
    """attn_fwd and attn_bwd on (q, k, v, do) against their plain versions,
    row by row (attn_kernel.max_row_err), the plain ones one (b, h) slice at
    a time; the backward from the plain forward's (o, lse), so it is held
    alone, and twice, bit for bit.  Raises ``errs``' "attn_fwd" and
    "attn_bwd" to the largest absolute error seen.  Returns the plain (o,
    lse), (dq, dk, dv) and the seconds the plain forward and backward took."""
    row_err = attn_kernel.max_row_err
    o, lse = attn_kernel.attn_fwd(q, k, v)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want_o, want_lse = by_slice(torch, attn_kernel.attn_fwd_plain, q, k, v)
    torch.cuda.synchronize()
    plain_fwd_s = time.perf_counter() - t0
    o_err = row_err(o, want_o)
    lse_err = float((lse - want_lse).abs().max())
    if not (o_err <= ATTN_TOL and lse_err <= LSE_TOL):
        fail(f"attn_fwd {label}: a row of o off by {o_err} of its norm (> {ATTN_TOL}) "
             f"or lse by {lse_err} (> {LSE_TOL})")
    errs["attn_fwd"] = max(errs["attn_fwd"], float((o.float() - want_o.float()).abs().max()),
                           lse_err)
    del o, lse
    got = attn_kernel.attn_bwd(q, k, v, want_o, want_lse, do)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(
            got, attn_kernel.attn_bwd(q, k, v, want_o, want_lse, do))):
        fail(f"attn_bwd {label}: two runs on the same inputs differ")
    t0 = time.perf_counter()
    want = by_slice(torch, attn_kernel.attn_bwd_plain, q, k, v, want_o, want_lse, do)
    torch.cuda.synchronize()
    plain_bwd_s = time.perf_counter() - t0
    rels = []
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        rels.append(row_err(g, w))
        errs["attn_bwd"] = max(errs["attn_bwd"], float((g.float() - w.float()).abs().max()))
        if not rels[-1] <= ATTN_TOL:
            fail(f"attn_bwd {label}: a row of {name} off by {rels[-1]} of its norm "
                 f"(> {ATTN_TOL})")
    log(f"kernels: attention {label}: worst row of o {o_err:.3g}, of dq/dk/dv "
        f"{', '.join(f'{r:.3g}' for r in rels)} (of the row's norm, tol {ATTN_TOL}); "
        f"lse {lse_err:.3g} abs (tol {LSE_TOL}); backward bit-identical over two runs")
    return want_o, want_lse, want, (plain_fwd_s, plain_bwd_s)


def held_with_teeth(torch, attn_kernel, label, q, k, v, do, want_o, want_lse, want) -> None:
    """The comparison has teeth: what a kernel that skipped one tile would
    return (``skipped_tile``) fails ``hold_attention``'s check against the
    plain (o, lse) and (dq, dk, dv)."""
    row_err = attn_kernel.max_row_err
    bad = skipped_tile(torch, q, k, v, want_o, want_lse, do)
    names = ("o", "dq", "dk", "dv")
    caught = {name: row_err(b, w) for name, b, w in zip(names, bad, (want_o, *want))}
    by_max = {name: float((b.float() - w.float()).abs().max() / w.float().abs().max())
              for name, b, w in zip(names, bad, (want_o, *want))}
    log(f"kernels: attention {label}, one tile skipped: worst row "
        f"{', '.join(f'{n} {e:.3g}' for n, e in caught.items())} (tol {ATTN_TOL}); "
        f"as a share of each tensor's max |value| "
        f"{', '.join(f'{n} {e:.3g}' for n, e in by_max.items())}")
    if not min(caught.values()) > ATTN_TOL:
        fail(f"the attention check passes a kernel that skips a tile: {caught}")


def phase_attention(torch, attn_kernel) -> list[dict]:
    """attn_fwd and attn_bwd against their plain versions at ATTN_SHAPES
    (row by row, attn_kernel.max_row_err), a check that the comparison
    rejects a kernel that skips one tile, then timed at the flagship shape
    beside the plain versions, PyTorch's flash SDPA (forward; backward alone
    on a kept graph) and the bounds; both also at the long step's shape."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    errs = {"attn_fwd": 0.0, "attn_bwd": 0.0}
    for shape in ATTN_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(4)
        # q pre-scaled by hd^-½ (as _layer hands it over): unit-variance scores.
        q = (torch.randn(shape, generator=gen, device="cuda") * shape[-1] ** -0.5).bfloat16()
        k, v, do = (torch.randn(shape, generator=gen, device="cuda").bfloat16() for _ in range(3))
        want_o, want_lse, want, _ = hold_attention(torch, attn_kernel, list(shape), q, k, v, do,
                                                   errs)
        if shape == FLAGSHIP_ATTN:
            held_with_teeth(torch, attn_kernel, list(shape), q, k, v, do, want_o, want_lse, want)
        del want, want_o, want_lse

    B, H, S, hd = FLAGSHIP_ATTN
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = (torch.randn(B, H, S, hd, generator=gen, device="cuda") * hd ** -0.5).bfloat16()
    k, v, do = (torch.randn(B, H, S, hd, generator=gen, device="cuda").bfloat16() for _ in range(3))
    o, lse = attn_kernel.attn_fwd(q, k, v)
    pairs = B * H * S * (S + 1) / 2  # causal (query, key) pairs
    tensor_bytes = 2.0 * B * H * S * hd
    out = []
    for name, kernel, plain, products, n_tensors in (
            ("attn_fwd", lambda: attn_kernel.attn_fwd(q, k, v),
             lambda: attn_kernel.attn_fwd_plain(q, k, v), 2, 4),
            ("attn_bwd", lambda: attn_kernel.attn_bwd(q, k, v, o, lse, do),
             lambda: attn_kernel.attn_bwd_plain(q, k, v, o, lse, do), 5, 8)):
        ms = time_ms(torch, kernel)
        plain_ms = time_ms(torch, plain, iters=5)
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            if name == "attn_fwd":
                library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, scale=1.0))
            else:
                qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
                lib_o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, scale=1.0)
                library_ms = time_ms(torch, lambda: torch.autograd.grad(
                    lib_o, (qg, kg, vg), do, retain_graph=True))
                del lib_o, qg, kg, vg
        flops = 2.0 * hd * pairs * products
        bound_ms, bound_by = bound(flops, PEAK_BF16_FLOPS, n_tensors * tensor_bytes + 4.0 * B * H * S)
        log(f"kernels: {name} {[B, H, S, hd]} ms={ms:.3f} plain_ms={plain_ms:.3f} "
            f"library_ms={library_ms:.3f} (flash SDPA) bound_ms={bound_ms:.3f} ({bound_by}); "
            f"{flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms * 100:.1f}% of bound"
            + seven_products(flops, products))
        out.append({
            "name": name, "route": "cuda", "source": f"tpudra_torch/workload/csrc/{name}.cu",
            "replaces": "tpudra/workload/model.py:288 (_layer's splash call, built at :272-287; "
                        + ("forward flash_attention_kernel)" if name == "attn_fwd"
                           else "fused backward _flash_attention_dkv_kernel)"),
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
        })
    del q, k, v, do, o, lse

    # Both kernels at the long step's shape, beside their bounds and flash
    # SDPA (the plain versions' f32 scores would take ~30 GB here).
    B, H, S, hd = LONG_ATTN
    q = (torch.randn(B, H, S, hd, generator=gen, device="cuda") * hd ** -0.5).bfloat16()
    k, v, do = (torch.randn(B, H, S, hd, generator=gen, device="cuda").bfloat16() for _ in range(3))
    o, lse = attn_kernel.attn_fwd(q, k, v)
    pairs = B * H * S * (S + 1) / 2
    tensor_bytes = 2.0 * B * H * S * hd
    for entry, kernel, products, n_tensors in (
            (out[0], lambda: attn_kernel.attn_fwd(q, k, v), 2, 4),
            (out[1], lambda: attn_kernel.attn_bwd(q, k, v, o, lse, do), 5, 8)):
        ms = time_ms(torch, kernel, iters=5)
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            if products == 2:
                library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, scale=1.0), iters=5)
            else:
                qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
                lib_o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, scale=1.0)
                library_ms = time_ms(torch, lambda: torch.autograd.grad(
                    lib_o, (qg, kg, vg), do, retain_graph=True), iters=5)
                del lib_o, qg, kg, vg
        flops = 2.0 * hd * pairs * products
        bound_ms, bound_by = bound(flops, PEAK_BF16_FLOPS, n_tensors * tensor_bytes + 4.0 * B * H * S)
        log(f"kernels: {entry['name']} {[B, H, S, hd]} ms={ms:.3f} library_ms={library_ms:.3f} "
            f"(flash SDPA) bound_ms={bound_ms:.3f} ({bound_by}); {flops / ms / 1e9:.1f} TFLOP/s, "
            f"{bound_ms / ms * 100:.1f}% of bound" + seven_products(flops, products))
        entry.update(long_shape=[B, H, S, hd], long_ms=ms, long_bound_ms=bound_ms,
                     long_library_ms=library_ms)
    del q, k, v, do, o, lse
    return out


def sdpa_ms(torch, q, k, v, do, iters: int = 5):
    """PyTorch's SDPA on (q, k, v), causal, scale 1 (q pre-scaled): (forward
    ms, backward ms alone on a kept graph, backend) on the first backend
    that takes these widths, of flash, memory-efficient and cuDNN."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION):
        try:
            with sdpa_kernel(backend):
                fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, scale=1.0), iters=iters)
                qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
                lib_o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, scale=1.0)
                bwd = time_ms(torch, lambda: torch.autograd.grad(
                    lib_o, (qg, kg, vg), do, retain_graph=True), iters=iters)
                del lib_o, qg, kg, vg
            return fwd, bwd, backend.name
        except RuntimeError as e:
            log(f"kernels: SDPA {backend.name} does not take q·k {q.shape[-1]} / v "
                f"{v.shape[-1]}: {str(e).strip().splitlines()[0][:160]}")
    return None, None, "none"


def phase_mla_attention(torch, model, attn_kernel) -> list[dict]:
    """The latent-attention instantiations (q·k 192, v 128) at the shape the
    dsv2lite-s8192 step hands them, MLA_ATTN, with q scaled by the model's
    softmax scale: against their plain versions row by row, one (b, h) slice
    at a time (hold_attention), a skipped tile caught on the first slice,
    then timed beside their bounds (the count of mla_attn.roofline_pct: the
    backward's 5 needed products) and PyTorch's SDPA with v at 128.  Their
    launches are counted in the dsv2lite step (main)."""
    B, H, S, dk, dv = MLA_ATTN
    label = str(list(MLA_ATTN))
    gen = torch.Generator(device="cuda").manual_seed(6)
    scale = model.softmax_scale(model.ModelConfig(**DSV2))
    q = (torch.randn(B, H, S, dk, generator=gen, device="cuda") * scale).bfloat16()
    k = torch.randn(B, H, S, dk, generator=gen, device="cuda").bfloat16()
    v, do = (torch.randn(B, H, S, dv, generator=gen, device="cuda").bfloat16() for _ in range(2))
    errs = {"attn_fwd": 0.0, "attn_bwd": 0.0}
    want_o, want_lse, want, plain_s = hold_attention(torch, attn_kernel, label, q, k, v, do, errs)
    first = lambda t: t[:1, :1]  # noqa: E731
    held_with_teeth(torch, attn_kernel, f"{label}, slice (0, 0)",
                    *(first(t) for t in (q, k, v, do)), first(want_o), first(want_lse),
                    tuple(first(w) for w in want))
    del want, want_o, want_lse
    torch.cuda.empty_cache()

    o, lse = attn_kernel.attn_fwd(q, k, v)
    lib_fwd, lib_bwd, backend = sdpa_ms(torch, q, k, v, do)
    pairs = B * H * S * (S + 1) / 2
    rows = 2.0 * B * H * S  # bytes of one bf16 column over every row
    lse_bytes = 4.0 * B * H * S
    out = []
    for name, kernel, plain_ms, flops, nbytes, library_ms in (
            ("attn_fwd", lambda: attn_kernel.attn_fwd(q, k, v), plain_s[0] * 1e3,
             2 * pairs * (dk + dv), rows * (2 * dk + 2 * dv) + lse_bytes, lib_fwd),
            ("attn_bwd", lambda: attn_kernel.attn_bwd(q, k, v, o, lse, do), plain_s[1] * 1e3,
             2 * pairs * (3 * dk + 2 * dv), rows * (4 * dk + 4 * dv) + lse_bytes, lib_bwd)):
        ms = time_ms(torch, kernel, iters=5)
        bound_ms, bound_by = bound(flops, PEAK_BF16_FLOPS, nbytes)
        # The dq kernel computes q·kᵀ and do·vᵀ again: 7 products done.
        done = "" if name == "attn_fwd" else (
            f"; bound of the 7 products done "
            f"{2 * pairs * (4 * dk + 3 * dv) / PEAK_BF16_FLOPS * 1e3:.3f} ms")
        library = "not run" if library_ms is None else f"{library_ms:.3f}"
        log(f"kernels: {name}<{dk}, {dv}> {list(MLA_ATTN)} ms={ms:.3f} plain_ms={plain_ms:.1f} "
            f"(by (b, h) slice) library_ms={library} (SDPA {backend}) bound_ms={bound_ms:.3f} "
            f"({bound_by}); {flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms * 100:.1f}% of bound"
            + done)
        out.append({
            "name": f"{name}<{dk},{dv}>", "counter": name, "route": "cuda",
            "source": f"tpudra_torch/workload/csrc/{name}.cu",
            "replaces": "none: the JAX package has no latent attention",
            "shape": list(MLA_ATTN), "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain_ms, "plain": "by (b, h) slice", "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, "library": f"SDPA {backend}",
        })
    del q, k, v, do, o, lse
    return out


def ring_skipping(torch, ringattention, q, k, v, skip: tuple):
    """ring_blocks' schedule with the (q block, k/v block) step ``skip``
    left out: what a ring that drops one hop would return."""
    s = q.shape[2] // RING_BLOCKS
    qs, ks, vs = (t.split(s, dim=2) for t in (q, k, v))
    outs = []
    for i in range(RING_BLOCKS):
        state = ringattention.init_state(qs[i], "bhsd")
        for step in range(RING_BLOCKS):
            j = (i - step) % RING_BLOCKS
            if (i, j) != skip:
                state = ringattention.block_update(qs[i], ks[j], vs[j], state, i * s, j * s,
                                                   True, "bhsd")
        outs.append(ringattention.finish(state, "bhsd", q.dtype))
    return torch.cat(outs, dim=2)


def phase_ring(torch, attn_kernel, ringattention) -> None:
    """Ring attention's block schedule in one process (ring_blocks: the
    block_update each rank of an sp ring runs, over RING_BLOCKS blocks) at
    the long step's attention shape, bf16: o, and dq, dk, dv of Σ do·o, row
    by row (attn_kernel.row_errs, RING_TOL) against the plain versions run
    in f32 on the same bf16 inputs with q scaled in f32 (the exact
    attention of those inputs) and against the flash kernels (q scaled by
    hd^-½ and rounded to bf16 for them: the ring scales its f32 scores); a
    ring that drops one block step must fail;
    then its forward and backward timed beside the kernels'.  The ring is
    plain PyTorch, as the JAX ring is plain einsums: its time is recorded,
    not judged."""
    B, H, S, hd = LONG_ATTN
    scale = hd ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, do = (torch.randn(B, H, S, hd, generator=gen, device="cuda").bfloat16()
                   for _ in range(4))
    qs = (q.float() * scale).bfloat16()

    def ring(*qkv):
        return ringattention.ring_blocks(*qkv, n_blocks=RING_BLOCKS, causal=True, layout="bhsd")

    def with_grads(fn):
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        o = fn(*qkv)
        return (o.detach(), *torch.autograd.grad(o, qkv, do))

    torch.cuda.reset_peak_memory_stats()
    got = with_grads(ring)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    f32 = [q.float() * scale, k.float(), v.float()]
    o32, lse32 = by_slice(torch, attn_kernel.attn_fwd_plain, *f32)
    dq32, dk32, dv32 = by_slice(torch, attn_kernel.attn_bwd_plain, *f32, o32, lse32, do.float())
    exact = (o32, dq32 * scale, dk32, dv32)
    del f32, lse32, dq32
    o_k, lse_k = attn_kernel.attn_fwd(qs, k, v)
    dq_k, dk_k, dv_k = attn_kernel.attn_bwd(qs, k, v, o_k, lse_k, do)
    kernels = (o_k, dq_k.float() * scale, dk_k, dv_k)
    names = ("o", "dq", "dk", "dv")
    rows = attn_kernel.row_errs
    to_exact = {n: float(rows(g, w).max()) for n, g, w in zip(names, got, exact)}
    kernels_to_exact = {n: float(rows(g, w).max()) for n, g, w in zip(names, kernels, exact)}
    # Against the kernels, every row of o, dk, dv; of dq the rows where the
    # kernels' own dq is within ATTN_TOL of the exact one: the first
    # queries' dq is a small difference, and the kernels take di =
    # rowsum(o·do) from o rounded to bf16 (kernels_to_exact logs how far).
    trusted = rows(kernels[1], exact[1]) <= ATTN_TOL
    to_kernels = {n: float(rows(g, w)[trusted if n == "dq" else ...].max())
                  for n, g, w in zip(names, got, kernels)}
    if not max(max(to_exact.values()), max(to_kernels.values())) <= RING_TOL:
        fail(f"ring {list(LONG_ATTN)}: worst rows {to_exact} off the exact attention, "
             f"{to_kernels} off the kernels (of the row's norm, tol {RING_TOL})")
    # The comparison has teeth: a ring that drops one hop fails it.
    skip = (RING_BLOCKS - 1, RING_BLOCKS - 2)
    bad = with_grads(lambda *qkv: ring_skipping(torch, ringattention, *qkv, skip=skip))
    caught = {n: float(rows(b, w).max()) for n, b, w in zip(names, bad, exact)}
    if not min(caught.values()) > RING_TOL:
        fail(f"the ring check passes a ring that drops a block step: {caught}")
    del got, exact, kernels, bad, dq_k, dk_k, dv_k, trusted

    with torch.no_grad():
        fwd_ms = time_ms(torch, lambda: ring(q, k, v), iters=3, warmup=1)
    qkv = [t.detach().requires_grad_() for t in (q, k, v)]
    o = ring(*qkv)
    bwd_ms = time_ms(torch, lambda: torch.autograd.grad(o, qkv, do, retain_graph=True),
                     iters=3, warmup=1)
    del o, qkv
    kfwd_ms = time_ms(torch, lambda: attn_kernel.attn_fwd(qs, k, v), iters=5)
    kbwd_ms = time_ms(torch, lambda: attn_kernel.attn_bwd(qs, k, v, o_k, lse_k, do), iters=5)

    def fmt(errs):
        return ", ".join(f"{n} {e:.3g}" for n, e in errs.items())

    log(f"ring {list(LONG_ATTN)} in {RING_BLOCKS} blocks of {S // RING_BLOCKS} (one process, "
        f"every step of the ring, masked blocks included): worst row off the exact attention "
        f"{fmt(to_exact)}, off the kernels {fmt(to_kernels)} (of the row's norm, tol "
        f"{RING_TOL}); the kernels off the exact attention {fmt(kernels_to_exact)}; one block "
        f"step dropped: {fmt(caught)}")
    log(f"ring {list(LONG_ATTN)}: forward {fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms "
        f"(peak {peak_gb:.2f} GB with its graph); attn_fwd {kfwd_ms:.3f} ms, attn_bwd "
        f"{kbwd_ms:.3f} ms at the same shape: {fwd_ms / kfwd_ms:.1f}x and "
        f"{bwd_ms / kbwd_ms:.1f}x the kernels'")


def phase_entry(torch, entry, convert) -> None:
    """entry()'s forward (the compile-check surface) on the card, against
    the same params and tokens on the CPU: logits [2, 32, 256], finite,
    within 5e-2 of the largest |logit| (bf16 rounds at other places on the
    two devices)."""
    fn, (params, tokens) = entry.entry()
    out = fn(params, tokens)
    want = fn(convert.tree_map(lambda t: t.cpu(), params), tokens.cpu())
    err = float((out.cpu() - want).abs().max()) / float(want.abs().max())
    if tuple(out.shape) != (2, 32, 256) or not bool(torch.isfinite(out).all()) or not err <= 5e-2:
        fail(f"entry: logits {tuple(out.shape)}, {err} of the largest |logit| off the CPU")
    log(f"entry: forward on {out.device}: logits {list(out.shape)} {out.dtype}, "
        f"{err:.3g} of the largest |logit| off the CPU (tol 5e-2)")


def phase_small(torch, model, convert, attn_kernel, ce_kernel):
    """The same small train step's loss and grads on the card (kernels) and
    on the CPU (plain versions, held against the JAX package by the tests),
    with naive attention and with the flash kernels (S a multiple of 128, as
    the tests run splash), and with the chunked CE head (CEChunk on the
    card, the upcast path on the CPU).  bf16 rounds at other places on the
    two devices: loss within 2e-2, each grad leaf within 5e-2 of its own
    max |g|."""
    for attention, seq, ce_impl in (("naive", 64, "fused"), ("splash", 128, "fused"),
                                    ("naive", 64, "chunked")):
        cfg = model.ModelConfig(vocab=512, d_model=128, n_heads=2, n_layers=2, d_ff=256,
                                max_seq=seq, attention=attention, ce_impl=ce_impl,
                                opt_impl="fused", ce_chunk=16)
        label = f"small step ({attention}, ce {ce_impl}, seq {seq})"
        gen = torch.Generator().manual_seed(3)
        cpu_params = model.init_params(gen, cfg, device="cpu")
        tokens = torch.randint(0, cfg.vocab, (4, cfg.max_seq), generator=gen)
        vg = model.value_and_grad(model.loss_fn)
        loss_c, grads_c = vg(cpu_params, tokens, cfg)
        gpu_params = convert.tree_map(lambda p: p.cuda(), cpu_params)
        before = attn_kernel.attn_bwd.launches
        split_before = ce_kernel.ce_split.launches
        loss_g, grads_g = vg(gpu_params, tokens.cuda(), cfg)
        if (attn_kernel.attn_bwd.launches > before) != (attention == "splash"):
            fail(f"{label}: attention kernels launched "
                 f"{attn_kernel.attn_bwd.launches - before} times")
        if (ce_kernel.ce_split.launches > split_before) != (ce_impl == "chunked"):
            fail(f"{label}: ce_split launched "
                 f"{ce_kernel.ce_split.launches - split_before} times")
        if not abs(float(loss_g) - float(loss_c)) <= 2e-2:
            fail(f"{label}: loss {float(loss_g)} on the card, "
                 f"{float(loss_c)} on the CPU")
        worst = 0.0
        for gc, gg in zip(convert.tree_leaves(grads_c), convert.tree_leaves(grads_g)):
            rel = float((gg.cpu() - gc).abs().max()) / float(gc.abs().max())
            worst = max(worst, rel)
        if not worst <= 5e-2:
            fail(f"{label}: a grad leaf differs by {worst} of its max "
                 "between card and CPU")
        init, step = model.make_train_step(cfg)
        _, _, loss = step(gpu_params, init(gpu_params), tokens.cuda())
        if not math.isfinite(float(loss)):
            fail(f"{label}: non-finite loss")
        log(f"{label}: loss card={float(loss_g):.6f} "
            f"cpu={float(loss_c):.6f}, worst grad leaf diff {worst:.3g} of its max (tol 5e-2)")


def check_attn_shape(label, cfg, batch) -> None:
    """Refuses a flash step whose attention shape is not in ATTN_SHAPES (a
    latent-attention step's: not MLA_ATTN)."""
    if cfg.use_flash_attention(cfg.max_seq, "cuda"):
        if cfg.arch == "deepseek_v2":
            shape = (batch, cfg.n_heads, cfg.max_seq, cfg.qk_head_dim, cfg.v_head_dim)
            held = (MLA_ATTN,)
        else:
            shape, held = attn_shape(batch, cfg.n_heads, cfg.max_seq, cfg.d_model), ATTN_SHAPES
        if shape not in held:
            fail(f"{label}: attention shape {shape} is not held against the plain versions "
                 f"(ATTN_SHAPES, MLA_ATTN)")


def drive_step(torch, model, envspec, convert, counters, label, cfg, batch, timed, profile=False):
    """Train ``cfg`` on the one granted device: 1 warm-up and ``timed`` timed
    steps, every kernel's launch count set to 0 just before and read just
    after.  Checks the losses; returns ({kernel name: launches}, step
    seconds, params).  A dense step's MFU is logged with bench.py's count;
    an MoE step's is its caller's (moe_accounting)."""
    check_attn_shape(label, cfg, batch)
    grant = envspec.ClaimEnv.from_environ({"TPU_VISIBLE_DEVICES": "0", "TPUDRA_CHIP_COORDS": "0,0,0"})
    if len(grant.visible_devices) != 1 or grant.mesh_bounds != (1, 1, 1):
        fail(f"one-device grant parsed as {grant.visible_devices} {grant.mesh_bounds}")
    device = torch.device("cuda", 0)  # the granted device, as the container sees it
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init_params(gen, cfg, device=device)
    n_params = sum(p.numel() for p in convert.tree_leaves(params))
    tokens = torch.randint(0, cfg.vocab, (batch, cfg.max_seq), generator=gen, device=device)
    init, step = model.make_train_step(cfg)
    state = init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    params, state, loss = step(params, state, tokens)
    first = float(loss)  # synchronises
    warm_s = time.perf_counter() - t0
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        params, state, loss = step(params, state, tokens)
        losses.append(loss)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / timed
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    losses = [first] + [float(v) for v in losses]
    if not all(math.isfinite(v) for v in losses):
        fail(f"{label}: non-finite loss: {losses}")
    if abs(first - math.log(cfg.vocab)) > 1.0:
        fail(f"{label}: step-1 loss {first} is not within 1 of ln({cfg.vocab}) = "
             f"{math.log(cfg.vocab):.3f}")
    tokens_per_step = batch * (cfg.max_seq - 1)
    flops = tokens_per_step * (6 * n_params + 12 * cfg.n_layers * cfg.max_seq * cfg.d_model)
    mfu = "" if cfg.num_experts else (
        f" model_tflops_per_s={flops / step_s / 1e12:.1f} mfu_pct="
        f"{flops / step_s / PEAK_BF16_FLOPS * 100:.1f} (of {PEAK_BF16_FLOPS / 1e12:.0f})")
    log(f"{label}: {n_params} params, batch {batch}, seq {cfg.max_seq}, attention "
        f"{cfg.attention}, remat {cfg.remat}, ce {cfg.ce_impl}, opt {cfg.opt_impl}; losses {losses}")
    log(f"{label}: warm-up step {warm_s * 1e3:.1f} ms; step_ms={step_s * 1e3:.2f} "
        f"tokens_per_s={tokens_per_step / step_s:.0f}{mfu} max_memory_allocated_gb={peak_gb:.2f}")
    log(f"{label}: launches over {1 + timed} steps: {launches}")
    if profile:
        phase_profile(torch, label, lambda: step(params, state, tokens), step_s * 1e3)
    return launches, step_s, n_params


def expect_attention_launches(label, cfg, launches, steps, microbatches=1):
    """The flash kernels' launches that cfg.remat implies: the attention
    core is no aten.mm, so "dots" recomputes it like "full" (2 forward
    launches per layer, microbatch and step, against 1 under "none"); 1
    backward."""
    per_layer = 1 if cfg.remat == "none" else 2
    calls = cfg.n_layers * microbatches * steps
    want = {"attn_fwd": per_layer * calls, "attn_bwd": calls}
    got = {name: launches[name] for name in want}
    if got != want:
        fail(f"{label}: attention kernel launches {got}, remat {cfg.remat!r} implies {want}")


def phase_moe_small(torch, model, convert, attn_kernel):
    """One small Switch-MoE step's loss and grads on the card against the
    CPU path (held against the JAX package by the tests): in f32 with naive
    attention, loss within 1e-4 and each grad leaf within 1e-3 of its max
    (TF32 is off); in bf16 with the flash kernels, the loss within 2e-2 (a
    router near-tie rounded differently on the two devices sends a token to
    another expert, which moves the grads by far more than rounding)."""
    for dtype, attention, seq in (("f32", "naive", 64), ("bf16", "splash", 128)):
        cfg = model.ModelConfig(vocab=512, d_model=128, n_heads=2, n_layers=2, d_ff=256,
                                max_seq=seq, num_experts=4, attention=attention,
                                compute_dtype=dtype)
        gen = torch.Generator().manual_seed(6)
        cpu_params = model.init_params(gen, cfg, device="cpu")
        tokens = torch.randint(0, cfg.vocab, (4, cfg.max_seq), generator=gen)
        vg = model.value_and_grad(model.loss_fn)
        loss_c, grads_c = vg(cpu_params, tokens, cfg)
        gpu_params = convert.tree_map(lambda p: p.cuda(), cpu_params)
        before = attn_kernel.attn_bwd.launches
        loss_g, grads_g = vg(gpu_params, tokens.cuda(), cfg)
        if (attn_kernel.attn_bwd.launches > before) != (attention == "splash"):
            fail(f"moe_small ({dtype}): attention kernels launched "
                 f"{attn_kernel.attn_bwd.launches - before} times")
        diff = abs(float(loss_g) - float(loss_c))
        worst = max(float((gg.cpu() - gc).abs().max()) / float(gc.abs().max())
                    for gc, gg in zip(convert.tree_leaves(grads_c), convert.tree_leaves(grads_g)))
        if dtype == "f32" and not (diff <= 1e-4 and worst <= 1e-3):
            fail(f"moe_small (f32): loss off by {diff} (tol 1e-4) or a grad leaf by {worst} "
                 "of its max (tol 1e-3) between card and CPU")
        if dtype == "bf16" and not diff <= 2e-2:
            fail(f"moe_small (bf16): loss {float(loss_g)} on the card, {float(loss_c)} on the CPU")
        init, step = model.make_train_step(cfg)
        _, _, loss = step(gpu_params, init(gpu_params), tokens.cuda())
        if not math.isfinite(float(loss)):
            fail(f"moe_small ({dtype}): non-finite loss")
        log(f"moe_small ({dtype}, {attention}, seq {seq}): loss card={float(loss_g):.6f} "
            f"cpu={float(loss_c):.6f} (diff {diff:.3g}), worst grad leaf diff {worst:.3g} of its max")


def moe_accounting(moe, cfg, batch: int, n_params: int) -> dict:
    """bench.py bench_moe's accounting, recomputed: active params (one
    expert FFN per layer), the model FLOPs on them, and the hardware FLOPs
    with the capacity padding the expert products really compute.  Plus
    what that accounting leaves out: the bytes of bf16 rows the index
    dispatch and combine move over the T = batch·seq tokens the model
    routes, each row read once and written once: forward, the E·C buffer
    rows gathered and the T output rows; backward, the T token rows and the
    E·C buffer rows gathered back, and the T rows of gy and of the expert
    outputs the gate's gradient reads."""
    tokens_per_step = batch * (cfg.max_seq - 1)
    ffn_params_per_expert = 2 * cfg.d_model * cfg.d_ff
    n_active = n_params - cfg.n_layers * (cfg.num_experts - 1) * ffn_params_per_expert
    model_flops = tokens_per_step * (6 * n_active + 12 * cfg.n_layers * cfg.max_seq * cfg.d_model)
    mcfg = moe.MoEConfig(d_model=cfg.d_model, d_ff=cfg.d_ff, num_experts=cfg.num_experts)
    routed = tokens_per_step
    padded_extra = max(0, cfg.num_experts * mcfg.capacity(routed) - routed)
    T = batch * cfg.max_seq
    C = mcfg.capacity(T)
    return {
        "params_m": n_params / 1e6, "active_params_m": n_active / 1e6,
        "model_flops": model_flops,
        "computed_flops": model_flops + 6 * ffn_params_per_expert * padded_extra * cfg.n_layers,
        "capacity": C, "capacity_padding_overhead_pct": 100.0 * padded_extra / routed,
        "dispatch_combine_bytes": (4 * cfg.num_experts * C + 6 * T) * cfg.d_model * 2 * cfg.n_layers,
    }


def time_dispatch_combine(torch, moe, cfg, batch: int, capacity: int):
    """ms of one layer's index dispatch and combine (moe.switch_dispatch and
    moe.switch_combine), forward and backward, at the step's shapes in
    bf16, on the routing of random tokens by a random router; and that
    routing's ``rows`` counter (tokens kept per expert)."""
    T, E, D = batch * cfg.max_seq, cfg.num_experts, cfg.d_model
    gen = torch.Generator(device="cuda").manual_seed(8)
    mcfg = moe.MoEConfig(d_model=D, d_ff=cfg.d_ff, num_experts=E)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    tokens, dy = randn(T, D).requires_grad_(), randn(T, D)
    router = torch.randn(D, E, generator=gen, device="cuda") * D ** -0.5
    with torch.no_grad():
        rt = moe.switch_route(tokens, router, mcfg, batch, capacity, 0, E)
    gate = rt["gate"].bfloat16().requires_grad_()
    expert_out, d_in = randn(E * capacity, D).requires_grad_(), randn(E * capacity, D)

    def dispatch_and_combine():
        expert_in = moe.switch_dispatch(tokens, rt)
        y = moe.switch_combine(expert_out, gate, rt)
        torch.autograd.grad((expert_in, y), (tokens, expert_out, gate), (d_in, dy))

    return time_ms(torch, dispatch_and_combine, iters=5), rt["rows"]


def phase_moe(torch, drive, model, moe) -> dict:
    """bench.py bench_moe at full width; returns the kernels' launches."""
    cfg = model.ModelConfig(**MOE, attention="splash")
    label = "moe (bench_moe: 8 experts, splash, dots, chunked CE, tree AdamW)"
    launches, step_s, n_params = drive(label, cfg, MOE_BATCH, TIMED_STEPS, profile=True)
    acct = moe_accounting(moe, cfg, MOE_BATCH, n_params)
    expect_attention_launches(label, cfg, launches, 1 + TIMED_STEPS)
    dc = acct["dispatch_combine_bytes"]
    layer_ms, rows = time_dispatch_combine(torch, moe, cfg, MOE_BATCH, acct["capacity"])
    dc_ms = layer_ms * cfg.n_layers
    T = MOE_BATCH * cfg.max_seq
    log(f"{label}: the index dispatch and combine alone, forward and backward, at the step's "
        f"shapes: {dc_ms:.3f} ms a step ({dc_ms / (step_s * 1e3) * 100:.2f}% of the step; "
        f"{dc / 1e9:.3f} GB of rows, {dc / dc_ms / 1e6:.0f} GB/s); tokens kept per expert "
        f"{rows.tolist()}, {int(rows.sum())} of {T} ({float(rows.sum()) / T * 100:.2f}%)")
    log(f"{label}: params_m={acct['params_m']:.1f} active_params_m={acct['active_params_m']:.1f} "
        f"capacity={acct['capacity']} capacity_padding_overhead_pct="
        f"{acct['capacity_padding_overhead_pct']:.1f} model_tflop_per_step="
        f"{acct['model_flops'] / 1e12:.3f} model_tflops_per_s={acct['model_flops'] / step_s / 1e12:.1f} "
        f"hw_tflops_per_s={acct['computed_flops'] / step_s / 1e12:.1f} "
        f"mfu_pct={acct['model_flops'] / step_s / PEAK_BF16_FLOPS * 100:.1f}; dispatch/combine "
        f"rows {dc / 1e9:.3f} GB a step ({dc / PEAK_BYTES * 1e3:.3f} ms at the HBM peak)")
    return launches


def granted_index() -> int:
    """The index of the card this run holds, which a child process is
    granted: the first of CUDA_VISIBLE_DEVICES, else 0."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    if not visible.isdigit():
        fail(f"CUDA_VISIBLE_DEVICES={visible!r} names no device index to grant")
    return int(visible)


def phase_distributed() -> dict:
    """Runs ``distributed_child`` in a process of its own, granted the card
    through the env (TPU_VISIBLE_DEVICES, exported to CUDA by the child's
    ClaimEnv.apply_cuda_env before its first CUDA call).  Returns the
    kernels' launches in the child's pipelined flagship steps."""
    env = dict(os.environ, TPU_VISIBLE_DEVICES=str(granted_index()), TPUDRA_CHIP_COORDS="0,0,0")
    env.pop("CUDA_VISIBLE_DEVICES", None)
    t0 = time.perf_counter()
    try:
        child = subprocess.run([sys.executable, __file__, "--distributed"], env=env,
                               capture_output=True, text=True, timeout=600)
    except subprocess.TimeoutExpired:
        fail("the distributed phase did not end within 600 s")
    launches = None
    for line in child.stdout.splitlines():
        if line.startswith(PIPE_LAUNCHES):
            launches = json.loads(line[len(PIPE_LAUNCHES):])
        else:
            log(line)
    if child.returncode != 0:
        fail(f"the distributed phase exited {child.returncode}:\n{child.stderr[-4000:]}")
    if launches is None:
        fail("the distributed phase reported no pipelined launches")
    log(f"distributed: child process took {time.perf_counter() - t0:.1f} s")
    return launches


PIPE_LAUNCHES = "pipelined launches: "


def distributed_child() -> int:
    """The grant path on one card: the env → CUDA, a one-rank NCCL group
    under a named mesh, the five collectives on CUDA tensors, and the
    sharded step on a (1, 1, 1) mesh against the single-device step."""
    from tpudra_torch.workload import envspec

    grant = envspec.ClaimEnv.from_environ()
    applied = grant.apply_cuda_env()  # before the first CUDA call
    import torch
    import torch.distributed as dist

    from tpudra_torch.workload import collectives, convert, model

    if not torch.cuda.is_available():
        fail("distributed: no CUDA device after the grant's export")
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = envspec.mesh_from_devices(("data",))
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        fail(f"distributed: {dist.get_backend()} group of {dist.get_world_size()}")
    verified = collectives.verify_collectives(mesh, "data")
    results = collectives.run_all(mesh, "data", mib_per_device=64, iters=10)
    if collectives.bandwidth_lines(results, mesh):
        fail("distributed: a bandwidth was published from one rank")
    log(f"distributed: grant {applied} on {torch.cuda.get_device_name(0)}; nccl, world 1; "
        f"verified {verified}; benches ran at 64 MiB "
        f"({', '.join(f'{r.op} {r.seconds_per_op * 1e3:.3f} ms' for r in results)}); "
        "no GB/s is published from one rank")

    mesh3 = envspec.mesh_from_devices(("dp", "sp", "tp"), (1, 1, 1))
    for label, kw, batch in (("moe", dict(MOE), MOE_BATCH),
                             ("dense, 2 layers", dict(FLAGSHIP, n_layers=2), BATCH)):
        cfg = model.ModelConfig(**kw, attention="splash")
        gen = torch.Generator(device="cuda").manual_seed(7)
        params = model.init_params(gen, cfg)
        tokens = torch.randint(0, cfg.vocab, (batch, cfg.max_seq), generator=gen, device="cuda")
        dparams = model.shard_params(params, mesh3, cfg)
        dtokens = model.shard_batch(tokens, mesh3)
        loss, grads = model.value_and_grad(model.loss_fn)(params, tokens, cfg)
        s_loss, s_grads = model.sharded_value_and_grad(cfg, mesh3)(dparams, dtokens)
        worst = max(float((s - g).abs().max()) / float(g.abs().max()) for s, g in zip(
            convert.tree_leaves(s_grads), convert.tree_leaves(grads)))
        del grads, s_grads
        init, step = model.make_train_step(cfg)
        sinit, sstep = model.make_sharded_train_step(cfg, mesh3)
        state, sstate = init(params), sinit(dparams)
        after = []
        for _ in range(2):
            params, state, l1 = step(params, state, tokens)
            dparams, sstate, l2 = sstep(dparams, sstate, dtokens)
            after.append((float(l1), float(l2)))
        # Tolerances: loss 1e-3 of itself (a step apart, one near-tie routed
        # otherwise moves it ~1e-4); grads 2e-2 of each leaf's max (the
        # embedding's backward adds with atomics, in any order).
        errs = [abs(float(s_loss) - float(loss))] + [abs(a - b) for a, b in after]
        if not (max(errs) <= 1e-3 * float(loss) and worst <= 2e-2):
            fail(f"distributed ({label}): sharded step loss {float(s_loss)} against {float(loss)}, "
                 f"after steps {after}, worst grad leaf {worst} of its max")
        log(f"distributed ({label}): sharded (1, 1, 1) loss {float(s_loss):.6f} single "
            f"{float(loss):.6f}; worst grad leaf diff {worst:.3g} of its max (tol 2e-2); losses "
            f"after 1 and 2 steps {after} (tol 1e-3 of the loss)")
        del params, dparams, state, sstate
        torch.cuda.empty_cache()

    from tpudra_torch.workload import attn_kernel, ce_kernel, opt_kernel, pipeline, ringattention

    child_ring(torch, model, convert, ringattention, mesh3)
    torch.cuda.empty_cache()
    counters = {"ce_fwd": ce_kernel.ce_fwd, "adamw_step": opt_kernel.adamw_step,
                "attn_fwd": attn_kernel.attn_fwd, "attn_bwd": attn_kernel.attn_bwd,
                "ce_split": ce_kernel.ce_split}
    pmesh = envspec.mesh_from_devices(("pp", "dp", "tp"), (1, 1, 1))
    launches = child_pipeline(torch, model, convert, pipeline, counters, pmesh)
    torch.cuda.empty_cache()
    child_pipeline_moe(torch, model, convert, pipeline, pmesh)
    dist.destroy_process_group()
    print(PIPE_LAUNCHES + json.dumps(launches), flush=True)
    return 0


RANK_RESULT = "RESULT gang-psum: 8.0 host 0 devices 1 mesh 1,1,1"
RANK_TIMES = "rank times: "
UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}")


def one_host_grant(index: int, workdir: str) -> dict:
    """The env of a one-host ComputeDomain grant of card ``index``: the keys
    the CD plugin writes (tpudra/cdplugin/state.py and libtpuenv.py), for a
    slice of one host with a one-chip block; the chip claim's
    TPU_VISIBLE_DEVICES; the bind's traceparent; and tracing switched on
    into ``workdir``/trace.jsonl.  ``workdir`` stands for the per-domain
    dir that the grant mounts."""
    from tpudra_torch import trace

    return {
        "TPUDRA_DOMAIN_UID": "chip-smoke-uid",
        "TPUDRA_DOMAIN_CHANNELS": "0",
        "TPUDRA_NUM_HOSTS": "1",
        "TPUDRA_HOST_INDEX": "0",
        "TPUDRA_CLIQUE_ID": "chip-smoke-slice.0",
        "TPUDRA_COORDINATOR": "compute-domain-daemon-0000:7175",
        "TPUDRA_CD_DIR": workdir,
        trace.TRACEPARENT_ENV: trace.format_traceparent(os.urandom(16).hex(), os.urandom(8).hex()),
        "TPUDRA_HOST_COORDS": "0,0,0",
        "TPUDRA_MESH_SHAPE": "1,1,1",
        "TPU_CHIPS_PER_HOST_BOUNDS": "1,1,1",
        "TPU_HOST_BOUNDS": "1,1,1",
        "TPU_SKIP_MDS_QUERY": "true",
        "TPU_WORKER_HOSTNAMES": "compute-domain-daemon-0000",
        "TPU_WORKER_ID": "0",
        "TPU_VISIBLE_DEVICES": str(index),
        trace.ENV_TRACE: "1",
        trace.ENV_TRACE_LOG: os.path.join(workdir, "trace.jsonl"),
    }


def phase_rank(card: str) -> None:
    """Runs ``rank_child`` in a process of its own under a one-host grant of
    this run's card, and checks its RESULT line and its one rank.worker
    span."""
    import tempfile
    import threading

    from tpudra_torch import trace

    with tempfile.TemporaryDirectory(prefix="chip-smoke-rank-") as workdir:
        grant = one_host_grant(granted_index(), workdir)
        # nvidia-smi numbers the cards in PCI bus order; so does CUDA here.
        env = dict(os.environ, **grant, CUDA_DEVICE_ORDER="PCI_BUS_ID")
        env.pop("CUDA_VISIBLE_DEVICES", None)
        err_path = os.path.join(workdir, "stderr.txt")
        lines, result_s = [], None
        with open(err_path, "w") as err:
            t0 = time.perf_counter()
            child = subprocess.Popen([sys.executable, __file__, "--rank"], env=env,
                                     stdout=subprocess.PIPE, stderr=err, text=True)
            watchdog = threading.Timer(300, child.kill)
            watchdog.start()
            for line in child.stdout:
                if line.startswith("RESULT gang-psum:") and result_s is None:
                    result_s = time.perf_counter() - t0
                lines.append(line.rstrip("\n"))
            rc = child.wait()
            watchdog.cancel()
        with open(err_path) as f:
            stderr = f.read()
        log_path = grant[trace.ENV_TRACE_LOG]
        spans = []
        if os.path.exists(log_path):
            with open(log_path) as f:
                spans = [json.loads(line) for line in f if line.strip()]
    if rc != 0:
        fail(f"the rank phase exited {rc} (killed past 300 s if -9):\n" + "\n".join(lines)
             + f"\n{stderr[-4000:]}")
    times = [json.loads(line[len(RANK_TIMES):]) for line in lines if line.startswith(RANK_TIMES)]
    if RANK_RESULT not in lines or len(times) != 1:
        fail(f"the rank phase printed no {RANK_RESULT!r} or no times:\n" + "\n".join(lines))
    trace_id, span_id = trace.parse_traceparent(grant[trace.TRACEPARENT_ENV])
    workers = [s for s in spans if s.get("name") == "rank.worker"]
    want = {"trace": trace_id, "parent": span_id, "pid": child.pid,
            "attrs": {"host": 0, "num_hosts": 1, "local_rank": 0}}
    if len(workers) != 1 or "error" in workers[0] or any(
            workers[0].get(k) != v for k, v in want.items()):
        fail(f"the rank phase's trace log holds {workers}, expected one rank.worker span with "
             f"{want}")
    log(f"rank: card {grant['TPU_VISIBLE_DEVICES']} granted by a one-host ComputeDomain grant "
        f"(its UUID {times[0]['uuid']} is the granted index's); {RANK_RESULT} over a one-rank "
        f"NCCL group; one rank.worker span ({workers[0]['dur_ms']} ms) parented on the grant's "
        f"traceparent, pid {child.pid}; spawn to RESULT {result_s:.3f} s, init_process_group "
        f"{times[0]['init_process_group_s']:.4f} s ({card})")


def rank_child() -> int:
    """One rank of a one-host ComputeDomain grant, on the card: the env →
    CUDA, then the port's rank worker (the rank.worker span around
    ``_worker_body``) on a one-rank NCCL group."""
    from tpudra_torch.workload import envspec

    grant = envspec.ClaimEnv.from_environ()
    grant.apply_cuda_env()  # before the first CUDA call
    import torch
    import torch.distributed as dist

    from tpudra_torch.sim import multihost

    if not torch.cuda.is_available() or torch.cuda.device_count() != 1:
        fail("rank: the grant's export left no single CUDA device visible")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=index,uuid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    uuids = dict(line.split(", ", 1) for line in smi.stdout.strip().splitlines())
    want = UUID.search(uuids.get(str(grant.visible_devices[0]), "").lower())
    seen = UUID.search(str(torch.cuda.get_device_properties(0).uuid).lower())
    if smi.returncode != 0 or not want or not seen or want.group() != seen.group():
        fail(f"rank: the card seen ({seen and seen.group()}) is not the granted index "
             f"{grant.visible_devices[0]} ({want and want.group()}; nvidia-smi: {smi.stdout!r})")
    # The worker starts one group (a one-rank group for a one-host grant):
    # timed here by wrapping the call it makes.
    starts = []
    real = dist.init_process_group

    def timed(backend, *args, **kwargs):
        t0 = time.perf_counter()
        real(backend, *args, **kwargs)
        starts.append((backend, time.perf_counter() - t0))

    dist.init_process_group = timed
    try:
        rc = multihost.run_rank(grant)
    finally:
        dist.init_process_group = real
    if rc != 0 or [b for b, _ in starts] != ["nccl"]:
        fail(f"rank: the worker returned {rc} after starting the groups {starts}")
    print(RANK_TIMES + json.dumps({"init_process_group_s": starts[0][1], "uuid": seen.group()}),
          flush=True)
    return 0


def worst_leaf(torch, convert, got, want) -> float:
    """The largest |got − want| of a gradient leaf over that leaf's max |want|."""
    return max(float((g - w).abs().max()) / float(w.abs().max())
               for g, w in zip(convert.tree_leaves(got), convert.tree_leaves(want)))


def child_ring(torch, model, convert, ringattention, mesh3) -> None:
    """The model with ring attention (ring_value_and_grad, one sp rank: the
    diagonal block of every layer) on the (1, 1, 1) mesh, dense at the
    flagship width with 2 layers, against the single-device step with naive
    attention: loss within 1e-3 of itself, grads within 5e-2 of each leaf's
    max (the ring keeps the probabilities in f32 where naive attention
    rounds them to bf16 for p·v)."""
    cfg = model.ModelConfig(**dict(FLAGSHIP, n_layers=2), attention="naive")
    gen = torch.Generator(device="cuda").manual_seed(10)
    params = model.init_params(gen, cfg)
    tokens = torch.randint(0, cfg.vocab, (BATCH, cfg.max_seq), generator=gen, device="cuda")
    loss, grads = model.value_and_grad(model.loss_fn)(params, tokens, cfg)
    dparams = model.shard_params(params, mesh3, cfg)
    dtokens = model.shard_batch(tokens, mesh3)
    ring = ringattention.ring_value_and_grad(cfg, mesh3)
    ring(dparams, dtokens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r_loss, r_grads = ring(dparams, dtokens)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    worst = worst_leaf(torch, convert, r_grads, grads)
    if not (abs(float(r_loss) - float(loss)) <= 1e-3 * float(loss) and worst <= 5e-2):
        fail(f"distributed (ring): loss {float(r_loss)} against {float(loss)}, worst grad leaf "
             f"{worst} of its max")
    log(f"distributed (ring, dense, 2 layers, batch {BATCH}, seq {cfg.max_seq}): "
        f"ring_value_and_grad on (1, 1, 1) loss {float(r_loss):.6f}, single-device (naive) "
        f"{float(loss):.6f}; worst grad leaf diff {worst:.3g} of its max (tol 5e-2); "
        f"{ms:.1f} ms for the loss and grads")


def child_pipeline(torch, model, convert, pipeline, counters, pmesh) -> dict:
    """The pipelined step (pp = 1, PIPE_M microbatches) at the flagship
    configuration of the bench step (splash, remat "dots"): loss and grads
    against the single-device step's (loss 1e-3 of itself, grads 2e-2 of
    each leaf's max: the weight gradients are summed over microbatches in
    another order, and the embedding's backward adds with atomics), then 1
    warm-up and TIMED_STEPS timed train steps with every kernel's launches
    counted from 0.  Returns the launches."""
    label = f"distributed (pipelined, pp 1, M {PIPE_M}, bench: splash, dots)"
    cfg = model.ModelConfig(**FLAGSHIP, attention="splash")
    check_attn_shape(label, cfg, BATCH // PIPE_M)
    gen = torch.Generator(device="cuda").manual_seed(11)
    params = model.init_params(gen, cfg)
    n_params = sum(p.numel() for p in convert.tree_leaves(params))
    tokens = torch.randint(0, cfg.vocab, (BATCH, cfg.max_seq), generator=gen, device="cuda")
    loss, grads = model.value_and_grad(model.loss_fn)(params, tokens, cfg)
    sparams = pipeline.stage_params(params, pmesh, cfg)
    del params
    p_loss, p_grads = pipeline.pipelined_value_and_grad(cfg, pmesh, PIPE_M)(sparams, tokens)
    worst = worst_leaf(torch, convert, p_grads, grads)
    del grads, p_grads
    if not (abs(float(p_loss) - float(loss)) <= 1e-3 * float(loss) and worst <= 2e-2):
        fail(f"{label}: loss {float(p_loss)} against {float(loss)}, worst grad leaf {worst}")
    log(f"{label}: loss {float(p_loss):.6f}, single-device {float(loss):.6f}; worst grad leaf "
        f"diff {worst:.3g} of its max (tol 2e-2)")

    init, step = pipeline.make_pipelined_train_step(cfg, pmesh, PIPE_M)
    state = init(sparams)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    sparams, state, first = step(sparams, state, tokens)
    losses = [float(first)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        sparams, state, loss = step(sparams, state, tokens)
        losses.append(loss)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(v) for v in losses]
    if not (all(math.isfinite(v) for v in losses) and abs(losses[0] - math.log(cfg.vocab)) <= 1.0):
        fail(f"{label}: losses {losses}")
    expect_attention_launches(label, cfg, launches, 1 + TIMED_STEPS, PIPE_M)
    tokens_per_step = BATCH * (cfg.max_seq - 1)
    flops = tokens_per_step * (6 * n_params + 12 * cfg.n_layers * cfg.max_seq * cfg.d_model)
    log(f"{label}: losses {losses}; step_ms={step_s * 1e3:.2f} "
        f"tokens_per_s={tokens_per_step / step_s:.0f} model_tflops_per_s="
        f"{flops / step_s / 1e12:.1f} mfu_pct={flops / step_s / PEAK_BF16_FLOPS * 100:.1f} "
        f"max_memory_allocated_gb={peak_gb:.2f}; launches over {1 + TIMED_STEPS} steps: {launches}")
    phase_profile(torch, label, lambda: step(sparams, state, tokens), step_s * 1e3)
    del sparams, state
    return launches


def child_pipeline_moe(torch, model, convert, pipeline, pmesh) -> None:
    """The pipelined step at bench_moe's configuration (pp = 1, PIPE_M
    microbatches, each routed alone) against the mean over microbatches of
    the single-device loss_fn on each, which per-microbatch routing equals
    at any capacity: loss within 1e-3 of itself, grads within 2e-2 of each
    leaf's max (as the dense pipelined step)."""
    label = f"distributed (pipelined MoE, pp 1, M {PIPE_M}, bench_moe)"
    cfg = model.ModelConfig(**MOE, attention="splash")
    mb = MOE_BATCH // PIPE_M
    check_attn_shape(label, cfg, mb)
    gen = torch.Generator(device="cuda").manual_seed(12)
    params = model.init_params(gen, cfg)
    tokens = torch.randint(0, cfg.vocab, (MOE_BATCH, cfg.max_seq), generator=gen, device="cuda")

    def micro_mean(p, t):
        return sum(model.loss_fn(p, t[i * mb:(i + 1) * mb], cfg) for i in range(PIPE_M)) / PIPE_M

    loss, grads = model.value_and_grad(micro_mean)(params, tokens)
    sparams = pipeline.stage_params(params, pmesh, cfg)
    del params
    vg = pipeline.pipelined_value_and_grad(cfg, pmesh, PIPE_M)
    p_loss, p_grads = vg(sparams, tokens)
    worst = worst_leaf(torch, convert, p_grads, grads)
    del grads, p_grads
    if not (abs(float(p_loss) - float(loss)) <= 1e-3 * float(loss) and worst <= 2e-2):
        fail(f"{label}: loss {float(p_loss)} against {float(loss)}, worst grad leaf {worst}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vg(sparams, tokens)
    torch.cuda.synchronize()
    log(f"{label}: loss {float(p_loss):.6f}, mean of the microbatches' single-device losses "
        f"{float(loss):.6f}; worst grad leaf diff {worst:.3g} of its max (tol 2e-2); "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms for the loss and grads")


# Kernel-name fragments per category of the step's device time.
CATEGORIES = (
    ("attention kernels (attn_fwd, attn_bwd)",
     ("attn_fwd_kernel", "attn_bwd_dq_kernel", "attn_bwd_dkv_kernel")),
    ("ce_fwd kernels (chunks, combine)", ("ce_fwd_kernel", "ce_combine_kernel")),
    ("adamw kernel", ("adamw_kernel",)),
    ("matmul (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma")),
    ("softmax", ("softmax",)),
)


def phase_profile(torch, label, run_step, step_ms: float):
    """One more step under torch.profiler (after the counted ones): device
    time by category and the top kernels.  Busy share = summed kernel time
    over the unprofiled step time (one stream, no overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.device_time_total for e in kernels) / 1e3
    if total <= 0:
        log(f"profile ({label}): the profiler saw no device time")
        return
    by_cat: dict[str, float] = {}
    for e in kernels:
        name = e.key.lower()
        cat = next((c for c, keys in CATEGORIES if any(k in name for k in keys)),
                   "other (elementwise, reductions, copies)")
        by_cat[cat] = by_cat.get(cat, 0.0) + e.device_time_total / 1e3
    log(f"profile ({label}): kernel time {total:.2f} ms in a {step_ms:.2f} ms step "
        f"(busy share {total / step_ms * 100:.1f}%)")
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        log(f"profile ({label}): {cat}: {ms:.2f} ms ({ms / total * 100:.1f}%)")
    attention = CATEGORIES[0][1]
    top = sorted(kernels, key=lambda e: -e.device_time_total)
    # The 12 longest, and every attention kernel (each of its own name).
    for e in top[:12] + [e for e in top[12:] if any(k in e.key for k in attention)]:
        log(f"profile ({label}): kernel {e.device_time_total / 1e3:8.2f} ms x{e.count:<4d} "
            f"{e.key[:90]}")


def main() -> int:
    if sys.argv[1:] == ["--distributed"]:
        return distributed_child()
    if sys.argv[1:] == ["--rank"]:
        return rank_child()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run", file=sys.stderr)
        return 2
    from tpudra_torch.workload import (
        _build,
        attn_kernel,
        ce_kernel,
        convert,
        entry,
        envspec,
        model,
        moe,
        opt_kernel,
        ringattention,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    import triton

    log(f"versions: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, triton {triton.__version__}")
    # f32 products in full f32 wherever an f32 result is compared.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build(_build, [ce_kernel._LIB, attn_kernel._FWD_LIB, attn_kernel._BWD_LIB])
    kernels = [phase_ce(torch, ce_kernel), phase_adamw(torch, model, opt_kernel)]
    torch.cuda.empty_cache()
    kernels.append(phase_ce_split(torch, ce_kernel))
    torch.cuda.empty_cache()
    kernels += phase_attention(torch, attn_kernel)
    torch.cuda.empty_cache()
    mla = phase_mla_attention(torch, model, attn_kernel)
    torch.cuda.empty_cache()
    phase_small(torch, model, convert, attn_kernel, ce_kernel)
    torch.cuda.empty_cache()

    counters = {"ce_fwd": ce_kernel.ce_fwd, "adamw_step": opt_kernel.adamw_step,
                "attn_fwd": attn_kernel.attn_fwd, "attn_bwd": attn_kernel.attn_bwd,
                "ce_split": ce_kernel.ce_split}
    drive = lambda *a, **kw: drive_step(torch, model, envspec, convert, counters, *a, **kw)  # noqa: E731
    cfg = model.ModelConfig(**FLAGSHIP, ce_impl="fused", opt_impl="fused", attention="naive",
                            remat="none")
    fused, _, _ = drive("step (fused CE, fused AdamW, naive)", cfg, BATCH, TIMED_STEPS, profile=True)
    for name in ("ce_fwd", "adamw_step"):
        if fused[name] <= 0:
            fail(f"the fused flagship step never launched the {name} kernel")
    torch.cuda.empty_cache()

    # bench.py bench_tpu_step: attention="splash" with the defaults remat
    # "dots", ce_impl "chunked", opt_impl "tree".
    cfg = model.ModelConfig(**FLAGSHIP, attention="splash")
    label = "step (bench: splash, dots, chunked CE, tree AdamW)"
    bench, _, _ = drive(label, cfg, BATCH, TIMED_STEPS, profile=True)
    expect_attention_launches(label, cfg, bench, 1 + TIMED_STEPS)
    if bench["ce_split"] <= 0:
        fail(f"{label}: the chunked CE head never launched the ce_split pass")
    torch.cuda.empty_cache()

    cfg = model.ModelConfig(**LONG, attention="splash")
    label = "long (bench long8192: splash, dots)"
    long, _, _ = drive(label, cfg, LONG_BATCH, LONG_TIMED_STEPS, profile=True)
    expect_attention_launches(label, cfg, long, 1 + LONG_TIMED_STEPS)
    torch.cuda.empty_cache()

    cfg = model.ModelConfig(**DSV2)
    label = "dsv2lite (the dsv2lite-s8192 cell's step: MLA, dropless top-6)"
    dsv2, _, _ = drive(label, cfg, DSV2_BATCH, DSV2_TIMED_STEPS)
    expect_attention_launches(label, cfg, dsv2, 1 + DSV2_TIMED_STEPS)
    for k in mla:
        k["launches"] = dsv2[k.pop("counter")]
        k["launches_per_step"] = k["launches"] / (1 + DSV2_TIMED_STEPS)
    torch.cuda.empty_cache()

    phase_moe_small(torch, model, convert, attn_kernel)
    torch.cuda.empty_cache()
    moe_runs = phase_moe(torch, drive, model, moe)
    torch.cuda.empty_cache()
    phase_ring(torch, attn_kernel, ringattention)
    torch.cuda.empty_cache()
    phase_entry(torch, entry, convert)
    torch.cuda.empty_cache()
    pipe_runs = phase_distributed()
    phase_rank(card)

    # Each kernel's launches from the step that runs it.
    for k in kernels:
        runs = fused if k["name"] in ("ce_fwd", "adamw_step") else bench
        k["launches"] = runs[k["name"]]
        k["launches_per_step"] = k["launches"] / (1 + TIMED_STEPS)
        if k["name"] in moe_runs:
            k["moe_launches"] = moe_runs[k["name"]]
        k["pipelined_launches"] = pipe_runs[k["name"]]
    print(json.dumps({"kernels": kernels + mla}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
