"""optimizer.ms: one apply of the program's optimizer (model._optimizer,
the configuration's opt_impl) over the cell's whole parameter tree and its
state, with gradients drawn from the seed, alone: its device time from the
profiler's trace, after a warm-up."""


def read(run):
    if run.device.type != "cuda":
        return None
    torch = run.torch
    from tpudra_torch.workload.convert import tree_map

    gen = torch.Generator(device=run.device).manual_seed(run.seed)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen, device=p.device) * 1e-3,
                     run.params)
    _, apply = run.model._optimizer(run.cfg, run.conf["optimizer"]["learning_rate"])
    state = [run.state]

    def once():
        state[0] = apply(run.params, grads, state[0])

    return run.device_ms(once)
