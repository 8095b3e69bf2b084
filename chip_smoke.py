#!/usr/bin/env python3
"""Drive the PyTorch port (tpudra_torch) on one NVIDIA GPU and check it.

Run from the root of the repository:  python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:
  1. device:  the card's name and power limit (nvidia-smi); no CUDA, no run
  2. build:   nvcc builds the CUDA kernel from csrc/ (seconds and ptxas report)
  3. kernels: each kernel against its plain PyTorch version at the flagship
              train step's shapes, with the tolerance stated, and timed beside
              its plain version, a PyTorch library yardstick and its bound
  4. small:   one train step's loss and grads on the card (kernels) against
              the CPU (plain versions) at a small size
  5. step:    the flagship train step at full width (472M params, batch 16,
              seq 1024; fused CE head, fused AdamW, naive attention), granted
              through a one-device ClaimEnv: 1 warm-up and 3 timed steps, with
              the kernels' launch counts reset just before and read just after

Then one JSON line {"kernels": [...]} and, last, the run's verdict line
{"ok": true, "device": {...}}.  Every time is from this run, on this card.
"""

from __future__ import annotations

import json
import math
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
CE_TOL = 2e-3  # lse/target logit, f32 sums of bf16 products in another order
ADAMW_P_TOL = 1e-6  # params; moments must be bit-identical


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


def phase_build(build):
    t0 = time.perf_counter()
    lib = build.build("ce_fwd", ("ce_fwd.cu",))
    log(f"build: ce_fwd with nvcc in {time.perf_counter() - t0:.2f} s -> {lib.name}")
    for line in build.build_log(lib).read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"build: ptxas: {line.strip()}")


def phase_ce(torch, ce_kernel) -> dict:
    N, D, V = BATCH * (FLAGSHIP["max_seq"] - 1), FLAGSHIP["d_model"], FLAGSHIP["vocab"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    # Unit-RMS hidden states and an embedding at init scale, as in the step.
    x = torch.randn(N, D, generator=gen, device="cuda").to(torch.bfloat16)
    emb = (0.02 * torch.randn(V, D, generator=gen, device="cuda")).to(torch.bfloat16)
    tgt = torch.randint(0, V, (N,), generator=gen, device="cuda", dtype=torch.int32)

    lse, tlog = ce_kernel.ce_fwd(x, emb, tgt)
    torch.cuda.synchronize()
    want_lse, want_tlog = ce_kernel.ce_fwd_plain(x, emb, tgt)
    err = max(float((lse - want_lse).abs().max()), float((tlog - want_tlog).abs().max()))
    if not (math.isfinite(err) and err <= CE_TOL):
        fail(f"ce_fwd differs from ce_fwd_plain by {err} (> {CE_TOL})")
    del lse, tlog, want_lse, want_tlog

    def library():  # one product, then logsumexp and gather: the yardstick
        logits = (x @ emb.t()).float()
        return logits.logsumexp(-1), logits.gather(1, tgt.long()[:, None])

    ms = time_ms(torch, lambda: ce_kernel.ce_fwd(x, emb, tgt))
    plain_ms = time_ms(torch, lambda: ce_kernel.ce_fwd_plain(x, emb, tgt), iters=5)
    library_ms = time_ms(torch, library, iters=5)
    bound_ms, bound_by = bound(2.0 * N * D * V, PEAK_BF16_FLOPS, 2 * (N * D + V * D) + 4 * N + 8 * N)
    log(f"kernels: ce_fwd N={N} D={D} V={V} max_abs_err={err:.3g} (tol {CE_TOL}) "
        f"ms={ms:.3f} plain_ms={plain_ms:.3f} library_ms={library_ms:.3f} "
        f"bound_ms={bound_ms:.3f} ({bound_by}); {2.0 * N * D * V / ms / 1e9:.1f} TFLOP/s")
    return {
        "name": "ce_fwd", "route": "cuda", "source": "tpudra_torch/workload/csrc/ce_fwd.cu",
        "replaces": "tpudra/workload/ce_kernel.py:34 (_fwd_kernel, launched at :90 _fwd_pallas)",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
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


def phase_small(torch, model, convert):
    """The same small train step's loss and grads on the card (kernels) and
    on the CPU (plain versions, held against the JAX package by the tests).
    bf16 rounds at other places on the two devices: loss within 2e-2, each
    grad leaf within 5e-2 of its own max |g|."""
    cfg = model.ModelConfig(vocab=512, d_model=128, n_heads=2, n_layers=2, d_ff=256, max_seq=64,
                            attention="naive", ce_impl="fused", opt_impl="fused")
    gen = torch.Generator().manual_seed(3)
    cpu_params = model.init_params(gen, cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (4, cfg.max_seq), generator=gen)
    vg = model.value_and_grad(model.loss_fn)
    loss_c, grads_c = vg(cpu_params, tokens, cfg)
    gpu_params = convert.tree_map(lambda p: p.cuda(), cpu_params)
    loss_g, grads_g = vg(gpu_params, tokens.cuda(), cfg)
    if not abs(float(loss_g) - float(loss_c)) <= 2e-2:
        fail(f"small step: loss {float(loss_g)} on the card, {float(loss_c)} on the CPU")
    worst = 0.0
    for gc, gg in zip(convert.tree_leaves(grads_c), convert.tree_leaves(grads_g)):
        rel = float((gg.cpu() - gc).abs().max()) / float(gc.abs().max())
        worst = max(worst, rel)
    if not worst <= 5e-2:
        fail(f"small step: a grad leaf differs by {worst} of its max between card and CPU")
    init, step = model.make_train_step(cfg)
    _, _, loss = step(gpu_params, init(gpu_params), tokens.cuda())
    if not math.isfinite(float(loss)):
        fail("small step: non-finite loss")
    log(f"small: loss card={float(loss_g):.6f} cpu={float(loss_c):.6f}, "
        f"worst grad leaf diff {worst:.3g} of its max (tol 5e-2)")


def phase_step(torch, model, envspec, convert, ce_kernel, opt_kernel) -> dict:
    grant = envspec.ClaimEnv.from_environ({"TPU_VISIBLE_DEVICES": "0", "TPUDRA_CHIP_COORDS": "0,0,0"})
    if len(grant.visible_devices) != 1 or grant.mesh_bounds != (1, 1, 1):
        fail(f"one-device grant parsed as {grant.visible_devices} {grant.mesh_bounds}")
    device = torch.device("cuda", 0)  # the granted device, as the container sees it
    cfg = model.ModelConfig(**FLAGSHIP, ce_impl="fused", opt_impl="fused", attention="naive",
                            remat="none")
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init_params(gen, cfg, device=device)
    n_params = sum(p.numel() for p in convert.tree_leaves(params))
    tokens = torch.randint(0, cfg.vocab, (BATCH, cfg.max_seq), generator=gen, device=device)
    init, step = model.make_train_step(cfg)
    state = init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ce_kernel.ce_fwd.launches = 0
    opt_kernel.adamw_step.launches = 0
    t0 = time.perf_counter()
    params, state, loss = step(params, state, tokens)
    first = float(loss)  # synchronises
    warm_s = time.perf_counter() - t0
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        params, state, loss = step(params, state, tokens)
        losses.append(loss)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    launches = {"ce_fwd": ce_kernel.ce_fwd.launches, "adamw_step": opt_kernel.adamw_step.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    losses = [first] + [float(v) for v in losses]
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite loss in the flagship steps: {losses}")
    if abs(first - math.log(cfg.vocab)) > 1.0:
        fail(f"step-1 loss {first} is not within 1 of ln({cfg.vocab}) = {math.log(cfg.vocab):.3f}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"the flagship step never launched the {name} kernel")
    tokens_per_step = BATCH * (cfg.max_seq - 1)
    flops = tokens_per_step * (6 * n_params + 12 * cfg.n_layers * cfg.max_seq * cfg.d_model)
    log(f"step: {n_params} params, batch {BATCH}, seq {cfg.max_seq}; losses {losses}")
    log(f"step: warm-up step {warm_s * 1e3:.1f} ms; step_ms={step_s * 1e3:.2f} "
        f"tokens_per_s={tokens_per_step / step_s:.0f} model_tflops_per_s={flops / step_s / 1e12:.1f} "
        f"mfu_pct={flops / step_s / PEAK_BF16_FLOPS * 100:.1f} (of {PEAK_BF16_FLOPS / 1e12:.0f}) "
        f"max_memory_allocated_gb={peak_gb:.2f}")
    log(f"step: launches over {1 + TIMED_STEPS} steps: {launches}")
    phase_profile(torch, lambda: step(params, state, tokens), step_s * 1e3)
    return launches


# Kernel-name fragments per category of the step's device time.
CATEGORIES = (
    ("ce_fwd kernel", ("ce_fwd_kernel",)),
    ("adamw kernel", ("adamw_kernel",)),
    ("matmul (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma")),
    ("softmax", ("softmax",)),
)


def phase_profile(torch, run_step, step_ms: float):
    """One more flagship step under torch.profiler (after the counted run):
    device time by category and the top kernels.  Busy share = summed
    kernel time over the unprofiled step time (one stream, no overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.device_time_total for e in kernels) / 1e3
    if total <= 0:
        log("profile: the profiler saw no device time")
        return
    by_cat: dict[str, float] = {}
    for e in kernels:
        name = e.key.lower()
        cat = next((c for c, keys in CATEGORIES if any(k in name for k in keys)),
                   "other (elementwise, reductions, copies)")
        by_cat[cat] = by_cat.get(cat, 0.0) + e.device_time_total / 1e3
    log(f"profile: kernel time {total:.2f} ms in a {step_ms:.2f} ms step "
        f"(busy share {total / step_ms * 100:.1f}%)")
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        log(f"profile: {cat}: {ms:.2f} ms ({ms / total * 100:.1f}%)")
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:10]:
        log(f"profile: kernel {e.device_time_total / 1e3:8.2f} ms x{e.count:<4d} {e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run", file=sys.stderr)
        return 2
    from tpudra_torch.workload import _build, ce_kernel, convert, envspec, model, opt_kernel

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    import triton

    log(f"versions: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, triton {triton.__version__}")
    # f32 products in full f32 wherever an f32 result is compared.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build(_build)
    kernels = [phase_ce(torch, ce_kernel), phase_adamw(torch, model, opt_kernel)]
    torch.cuda.empty_cache()
    phase_small(torch, model, convert)
    torch.cuda.empty_cache()
    launches = phase_step(torch, model, envspec, convert, ce_kernel, opt_kernel)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["launches_per_step"] = launches[k["name"]] / (1 + TIMED_STEPS)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
