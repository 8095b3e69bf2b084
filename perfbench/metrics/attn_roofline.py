"""attn_roofline: the flash attention kernels' share of their roofline in
the profiled slice: the summed bounds of their launches over their summed
device time (attn_fwd_kernel, attn_bwd_dq_kernel, attn_bwd_dkv_kernel).

A launch's bound at [B, H, S, hd] is the larger of its FLOPs over the bf16
peak and its bytes over the memory peak.  Causal pairs B·H·S(S+1)/2; the
forward does 2 products (2·hd FLOPs a pair each) and moves q, k, v, o in
bf16 and lse in f32; the backward (one launch = the dq and the dk/dv
kernel) does the 5 products it needs and moves q, k, v, o, do, dq, dk, dv
in bf16 and lse in f32.  Launch counts are read from the profile: under
remat "dots" the forward runs twice a layer.
"""

FWD, DQ, DKV = "attn_fwd_kernel", "attn_bwd_dq_kernel", "attn_bwd_dkv_kernel"


def launch_bounds(B: int, H: int, S: int, hd: int, peaks: dict) -> tuple[float, float]:
    """(forward, backward) seconds at the roofline for one launch."""
    pairs = B * H * S * (S + 1) / 2
    tensor = 2.0 * B * H * S * hd
    lse = 4.0 * B * H * S

    def bound(products, tensors):
        return max(2.0 * hd * pairs * products / peaks["bf16_flops_per_s"],
                   (tensors * tensor + lse) / peaks["bytes_per_s"])

    return bound(2, 4), bound(5, 8)


def read(run):
    sl = run.slice
    if sl is None or run.peaks is None:
        return None
    (n_fwd, t_fwd), (n_dq, t_dq), (n_dkv, t_dkv) = (sl.time_of(k) for k in (FWD, DQ, DKV))
    if not n_fwd or n_dq != n_dkv or t_fwd + t_dq + t_dkv <= 0:
        return None
    m = run.conf["model"]
    fwd, bwd = launch_bounds(run.traffic["batch"], m["n_heads"], run.traffic["seq"],
                             m["d_model"] // m["n_heads"], run.peaks)
    return 100.0 * (n_fwd * fwd + n_dq * bwd) / ((t_fwd + t_dq + t_dkv) / 1e6)
