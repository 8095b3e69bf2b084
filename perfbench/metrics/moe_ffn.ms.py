"""moe_ffn.ms: one forward and backward of the program's MoE FFN
(moe.moe_ffn: routing, capacity, the dispatch/combine and expert products)
alone at the cell's shapes, with layer 0's weights, times the layers: its
device time from the profiler's trace, after a warm-up.  Nothing to read in
a dense cell."""


def read(run):
    cfg = run.cfg
    if run.device.type != "cuda" or not cfg.num_experts:
        return None
    torch = run.torch
    from tpudra_torch.workload import moe

    mcfg = moe.MoEConfig(d_model=cfg.d_model, d_ff=cfg.d_ff, num_experts=cfg.num_experts,
                         capacity_factor=cfg.moe_capacity_factor, compute_dtype=cfg.compute_dtype)
    weights = {k: run.params["layers"][k][0].detach().clone().requires_grad_()
               for k in ("router", "w1", "w2")}
    gen = torch.Generator(device=run.device).manual_seed(run.seed)
    shape = (run.traffic["batch"], run.traffic["seq"], cfg.d_model)
    x = torch.randn(shape, generator=gen, device=run.device).to(cfg.act_dtype).requires_grad_()
    dy = torch.randn(shape, generator=gen, device=run.device).to(cfg.act_dtype)
    one = torch.ones((), device=run.device)

    def once():
        y, aux = moe.moe_ffn(weights, x, mcfg)
        torch.autograd.grad((y, aux), (x, *weights.values()), (dy, one))

    return run.device_ms(once) * cfg.n_layers
