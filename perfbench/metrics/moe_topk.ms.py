"""moe_topk.ms: one forward and backward of the program's top-k MoE FFN
(moe.moe_topk_ffn: routing over all routed experts, the dropless dispatch
to the experts held here, their grouped products, the combine and the
shared expert) alone at the cell's [batch, seq, d_model], with MoE layer
0's weights, times the MoE layers: its device time from the profiler's
trace, after a warm-up.  Nothing to read where the program has no such
layer."""


def topk_call(run):
    """(once, rows): one forward and backward of the layer at the cell's
    shape, and the rows each held expert computed; None where the program
    has no top-k layer or the cell none of its weights."""
    torch, cfg = run.torch, run.cfg
    from tpudra_torch.workload import moe

    layers = run.params.get("moe_layers")
    if run.device.type != "cuda" or layers is None or not hasattr(moe, "moe_topk_ffn"):
        return None
    weights = {k: v[0].detach().clone().requires_grad_() for k, v in layers.items()
               if k in ("router", "experts_in", "experts_out", "shared_in", "shared_out")}
    tcfg = run.model.topk_config(cfg)
    gen = torch.Generator(device=run.device).manual_seed(run.seed)
    shape = (run.traffic["batch"], run.traffic["seq"], cfg.d_model)
    x = torch.randn(shape, generator=gen, device=run.device).to(cfg.act_dtype).requires_grad_()
    dy = torch.randn(shape, generator=gen, device=run.device).to(cfg.act_dtype)
    one = torch.ones((), device=run.device)
    rows = []

    def once():
        y, aux, r = moe.moe_topk_ffn(weights, x, tcfg)
        torch.autograd.grad((y, aux), (x, *weights.values()), (dy, one))
        rows[:] = [r]

    once()
    return once, rows[0], weights, x


def read(run):
    call = topk_call(run)
    if call is None:
        return None
    return run.device_ms(call[0]) * run.cfg.n_moe_layers
