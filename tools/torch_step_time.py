"""Time the PyTorch port's single-device MoE train step, and its MoE layer
alone, on one CUDA card.

    PYTHONPATH=<checkout> python3 tools/torch_step_time.py [--steps N] [--repeats R]

The port (``tpudra_torch``) is imported from PYTHONPATH, not from this
script's directory, so one copy of the script times any checkout: to
compare two, run it on each in turn on the same card (A, B, B, A).

The step is bench.py bench_moe's configuration at full width (8 experts,
d_model 1024, 8 layers, batch 8, seq 1024, splash attention, remat "dots",
chunked CE, tree AdamW), weights and tokens from seed 0.  The layer is one
``moe.moe_ffn`` forward and backward at that step's shapes ([8, 1024,
1024] bf16 tokens, routing included).  Times are means by CUDA events
after a warm-up, ``repeats`` times each.  Prints the card's name and power
limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

MOE = dict(vocab=32768, d_model=1024, n_heads=8, n_layers=8, d_ff=4096, max_seq=1024,
           num_experts=8)
BATCH = 8


def mean_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=5, help="timed steps per repeat")
    parser.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_step_time: no CUDA device is visible")
    from tpudra_torch.workload import model, moe

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)

    cfg = model.ModelConfig(**MOE, attention="splash")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init_params(gen, cfg, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (BATCH, cfg.max_seq), generator=gen, device="cuda")
    init, step = model.make_train_step(cfg)
    state = [params, init(params), None]

    def run_step():
        state[:] = step(*state[:2], tokens)

    step_ms = [mean_ms(run_step, args.steps) for _ in range(args.repeats)]
    loss = float(state[2])
    del params, state
    torch.cuda.empty_cache()

    mcfg = moe.MoEConfig(d_model=cfg.d_model, d_ff=cfg.d_ff, num_experts=cfg.num_experts)
    mparams = {k: v.requires_grad_() for k, v in
               moe.init_moe_params(torch.Generator(device="cuda").manual_seed(1), mcfg).items()}
    x = torch.randn((BATCH, cfg.max_seq, cfg.d_model), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2)).bfloat16()
    x.requires_grad_()

    def run_layer():
        y, aux = moe.moe_ffn(mparams, x, mcfg)
        (y.float().square().mean() + aux).backward()

    layer_ms = [mean_ms(run_layer, 10) for _ in range(args.repeats)]
    print(json.dumps({"port": model.__file__, "step_ms": step_ms, "loss": loss,
                      "moe_ffn_fwd_bwd_ms": layer_ms}), flush=True)


if __name__ == "__main__":
    main()
