"""step.mfu_pct: the train step's model FLOPs over the timed window, as a
share of the card's bf16 peak.  The model FLOPs of a step are the count of
the cell's reference module (``model_flops_per_step``), which knows its
architecture."""


def read(run):
    if run.peaks is None:
        return None
    flops = run.ref.model_flops_per_step(run.conf, run.traffic["seq"], run.traffic["batch"],
                                         run.n_params)
    return 100.0 * flops * run.window.steps / run.window.seconds / run.peaks["bf16_flops_per_s"]
