"""step.mfu_pct: the train step's model FLOPs over the timed window, as a
share of the card's bf16 peak.

Model FLOPs a step, over the batch·(seq − 1) tokens trained: dense,
6·N + 12·L·S·D a token (N the params, counted from the cell's tree; the
second term the attention products); Switch-MoE, the same with N the
active params, one expert FFN a layer: N − L·(E − 1)·2·D·F.  Capacity
padding and the dispatch/combine products are not model FLOPs.
"""


def model_flops_per_step(model: dict, seq: int, batch: int, n_params: int) -> float:
    L, D, F, E = (model[k] for k in ("n_layers", "d_model", "d_ff", "num_experts"))
    active = n_params - L * (E - 1) * 2 * D * F if E else n_params
    return batch * (seq - 1) * (6 * active + 12 * L * seq * D)


def read(run):
    if run.peaks is None:
        return None
    flops = model_flops_per_step(run.conf["model"], run.traffic["seq"], run.traffic["batch"],
                                 run.n_params)
    return 100.0 * flops * run.window.steps / run.window.seconds / run.peaks["bf16_flops_per_s"]
