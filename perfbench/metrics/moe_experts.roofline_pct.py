"""moe_experts.roofline_pct: the held experts' grouped products
(moe.expert_products, what the top-k layer runs inside its ``moe.experts``
span: the SwiGLU's two grouped products and the gating between them),
forward and backward, alone, on the rows that MoE layer 0's weights route
at the cell's shape, as a share of their roofline.

The bound: 3 products of 2·rows·d_model·moe_d_ff FLOPs forward (gate, up,
down; rows from the layer's counter ``rows``, summed over the held
experts), three times that with the backward (each product's two
gradients), over the bf16 peak; or, if larger, the bytes over the memory
peak: the held experts' weights read and their gradients written, and the
rows' input, hidden and output activations (bf16), each once.  Nothing to
read where the program has no such layer."""

from pathlib import Path


def read(run):
    from perfbench import harness

    torch, cfg = run.torch, run.cfg
    topk = harness.load_module(Path(__file__).with_name("moe_topk.ms.py"),
                               "perfbench_metric_moe_topk_ms")
    call = topk.topk_call(run)
    if call is None or run.peaks is None:
        return None
    from tpudra_torch.workload import moe

    _, rows, weights, x = call
    h = x.detach().reshape(-1, cfg.d_model)
    routed = moe.route_topk(h, weights["router"].detach(), run.model.topk_config(cfg),
                            run.traffic["batch"])
    xs = moe.dispatch(h, routed).requires_grad_()
    w_in = weights["experts_in"].detach().to(cfg.act_dtype).requires_grad_()
    w_out = weights["experts_out"].detach().to(cfg.act_dtype).requires_grad_()
    offs = routed["offs"]
    dout = torch.randn(xs.shape, device=xs.device, dtype=xs.dtype)

    def once():
        out = moe.expert_products(xs, w_in, w_out, offs)
        torch.autograd.grad(out, (xs, w_in, w_out), dout)

    seconds = run.device_ms(once) / 1e3
    n = float(rows.sum())
    D, F = cfg.d_model, cfg.moe_d_ff
    flops = 3 * (3 * 2 * n * D * F)
    weight_bytes = 2 * 2 * (w_in.numel() + w_out.numel())
    act_bytes = 2 * n * (2 * D + 3 * F) * 2  # forward and backward each once
    bound = max(flops / run.peaks["bf16_flops_per_s"],
                (weight_bytes + act_bytes) / run.peaks["bytes_per_s"])
    return 100.0 * bound / seconds
