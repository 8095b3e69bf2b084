"""mla_attn.roofline_pct: the latent-attention flash kernels' share of
their roofline in the profiled slice: the summed bounds of their launches
over their summed device time.  They are the (q·k 192, v 128)
instantiations of attn_fwd_kernel, attn_bwd_dq_kernel and
attn_bwd_dkv_kernel; the dense cells' (128, 128) ones are not counted.

A launch's bound at [B, H, S] and widths DK, DV is the larger of its FLOPs
over the bf16 peak and its bytes over the memory peak.  Causal pairs
B·H·S(S+1)/2; the forward does q·kᵀ and p·v, 2·pairs·(DK + DV) FLOPs, and
moves q, k (DK) and v, o (DV) in bf16 and lse in f32; the backward (one
launch = the dq and the dk/dv kernel) does the 5 products it needs (q·kᵀ,
dq, dk at DK; do·vᵀ, dv at DV), 2·pairs·(3·DK + 2·DV) FLOPs, and moves q,
k, dq, dk (DK) and v, o, do, dv (DV) in bf16 and lse in f32.  Launch counts
are read from the profile: under remat "dots" the forward runs twice a
layer.  Nothing to read where no such kernel ran."""

import re

KERNELS = {part: re.compile(rf"{part}<\s*192\s*,\s*128\s*>")
           for part in ("attn_fwd_kernel", "attn_bwd_dq_kernel", "attn_bwd_dkv_kernel")}


def launch_bounds(B: int, H: int, S: int, dk: int, dv: int, peaks: dict) -> tuple[float, float]:
    """(forward, backward) seconds at the roofline for one launch."""
    pairs = B * H * S * (S + 1) / 2
    rows = 2.0 * B * H * S  # bytes of one bf16 column over every row
    lse = 4.0 * B * H * S

    def bound(flops, nbytes):
        return max(flops / peaks["bf16_flops_per_s"], nbytes / peaks["bytes_per_s"])

    return (bound(2 * pairs * (dk + dv), rows * (2 * dk + 2 * dv) + lse),
            bound(2 * pairs * (3 * dk + 2 * dv), rows * (4 * dk + 4 * dv) + lse))


def read(run):
    sl = run.slice
    if sl is None or run.peaks is None:
        return None
    counts = {part: [0, 0.0] for part in KERNELS}
    for name, _, dur in sl.device_ops:
        for part, pattern in KERNELS.items():
            if pattern.search(name):
                counts[part][0] += 1
                counts[part][1] += dur
    (n_fwd, t_fwd), (n_dq, t_dq), (n_dkv, t_dkv) = counts.values()
    if not n_fwd or n_dq != n_dkv or t_fwd + t_dq + t_dkv <= 0:
        return None
    m = run.conf["model"]
    fwd, bwd = launch_bounds(run.traffic["batch"], m["n_heads"], run.traffic["seq"],
                             m["qk_nope_head_dim"] + m["qk_rope_head_dim"], m["v_head_dim"],
                             run.peaks)
    return 100.0 * (n_fwd * fwd + n_dq * bwd) / ((t_fwd + t_dq + t_dkv) / 1e6)
