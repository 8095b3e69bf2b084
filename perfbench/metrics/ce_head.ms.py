"""ce_head.ms: one forward and backward of the program's CE head
(model.ce_head, the configuration's ce_impl) alone, at the cell's
[batch, seq, d_model] hidden states, vocabulary and targets: its device
time from the profiler's trace, after a warm-up."""


def read(run):
    if run.device.type != "cuda":
        return None
    torch, cfg = run.torch, run.cfg
    B, S = run.traffic["batch"], run.traffic["seq"]
    gen = torch.Generator(device=run.device).manual_seed(run.seed)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=run.device)
    x = x.to(cfg.act_dtype).requires_grad_()
    embed = run.params["embed"].detach().requires_grad_()
    tokens = run.pool[0]

    def once():
        loss = run.model.ce_head({"embed": embed}, x, tokens, cfg)
        torch.autograd.grad(loss, (x, embed))

    return run.device_ms(once)
