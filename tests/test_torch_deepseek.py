"""DeepSeek-V2's block on the port (``arch="deepseek_v2"`` of
tpudra_torch.workload.model, ``moe.moe_topk_ffn``) against the benchmark's
plain reference, ``perfbench/reference/deepseek_v2.py``, on the same seeded
weights.

The CPU tests run at tiny widths (d_model 64, 2 heads, latent 32, q·k heads
16 + 8 RoPE, v heads 16, 8 routed experts of which 4 are held, top 2, one
shared expert, one dense layer then two MoE layers) with naive attention,
through ``make_train_step``.  The tests marked ``cuda`` run on the card
only: the (192, 128) attention kernels against their plain versions, the
top-k layer against its CPU plain path, and a trace of two steps for host
syncs.  This file imports no JAX, so the card runs it with --noconftest.
"""

import importlib.util
from dataclasses import replace
from pathlib import Path

import pytest
import torch

from tpudra_torch.workload import attn_kernel, moe, pipeline, ringattention
from tpudra_torch.workload import model as tm

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "perfbench_reference_deepseek_v2", ROOT / "perfbench" / "reference" / "deepseek_v2.py")
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

YARN = dict(rope_theta=10000.0, rope_factor=40.0, rope_original_max_position=4096,
            rope_beta_fast=32.0, rope_beta_slow=1.0, rope_mscale=0.707,
            rope_mscale_all_dim=0.707)
TINY = dict(arch="deepseek_v2", vocab=256, d_model=64, n_heads=2, n_layers=3, d_ff=128,
            kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            first_k_dense_replace=1, moe_d_ff=32, n_shared_experts=1, experts_per_token=2,
            n_routed_experts=8, num_experts=4, moe_aux_weight=0.001,
            ce_chunk=16, attention="naive", remat="dots", compute_dtype="f32", **YARN)
OPT = {"learning_rate": 1e-3, "b1": 0.9, "b2": 0.999, "eps": 1e-8, "weight_decay": 1e-4}
B, S = 2, 32


def _conf(**over):
    return {"model": {**TINY, **over}, "optimizer": OPT}


def _cfg(conf):
    return tm.ModelConfig(**conf["model"], max_seq=S)


def _tokens(n, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, TINY["vocab"], (n, B, S), generator=gen)


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _ref_loss_and_grads(params, tokens, conf):
    flat = ref.flatten(params)
    live = {n: p.detach().clone().requires_grad_() for n, p in flat.items()}
    loss = ref.loss_fn(ref.nest(live), tokens, conf)
    return float(loss.detach()), dict(zip(live, torch.autograd.grad(loss, list(live.values()))))


def test_the_tree_is_the_references():
    """init_params and the reference's make_params give one tree: the same
    leaves, shapes and dtypes (the draws differ)."""
    conf = _conf()
    got = ref.flatten(tm.init_params(torch.Generator().manual_seed(0), _cfg(conf), "cpu"))
    want = ref.flatten(ref.make_params(conf, S, 0, "cpu"))
    assert {n: (tuple(t.shape), t.dtype) for n, t in got.items()} == {
        n: (tuple(t.shape), t.dtype) for n, t in want.items()}
    assert {"dense_layers.w_in", "moe_layers.experts_in", "moe_layers.router", "head"} <= set(got)


@pytest.mark.parametrize("seed", [1, 2])
def test_loss_and_gradients_match_the_reference(seed):
    """The program's loss and every leaf's gradient against the reference's,
    both in f32: the two differ only in the order of their sums (grouped
    products against a loop over experts, RoPE as a real rotation against a
    complex product, attention at once against in query blocks), so 1e-5 of
    the loss and 1e-4 of each leaf's largest gradient."""
    conf = _conf()
    params = ref.make_params(conf, S, seed, "cpu")
    tokens = _tokens(1, seed)[0]
    loss, grads = tm.value_and_grad(tm.loss_fn)(_clone(params), tokens, _cfg(conf))
    want_loss, want = _ref_loss_and_grads(params, tokens, conf)
    assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
    got = ref.flatten(grads)
    assert got.keys() == want.keys()
    for n, w in want.items():
        scale = float(w.abs().max())
        assert scale > 0, n
        assert float((got[n] - w).abs().max()) <= 1e-4 * scale, n


def test_two_steps_match_the_reference():
    """Params after two steps of make_train_step against the reference's
    two AdamW steps.  Each leaf's change is held by its norm, within 1e-3:
    AdamW normalises the update, so a rounding-level difference in a
    gradient near zero can move that one element by up to a step."""
    conf = _conf()
    params = ref.make_params(conf, S, 3, "cpu")
    batches = _tokens(2, 3)
    init, step = tm.make_train_step(_cfg(conf), learning_rate=OPT["learning_rate"])
    prog = _clone(params)
    state = init(prog)
    for tokens in batches:
        prog, state, _ = step(prog, state, tokens)
    mine = _clone(params)
    ref.follow(conf, mine, list(batches))
    start, got, want = (ref.flatten(t) for t in (params, prog, mine))
    for n in want:
        moved = want[n] - start[n]
        if not moved.any():
            assert torch.equal(got[n], start[n]), n
            continue
        assert float((got[n] - want[n]).norm()) <= 1e-3 * float(moved.norm()), n


def test_flash_path_matches_naive():
    """The flash path (on the CPU the kernels' plain versions, at q·k width
    24 and v width 16) against naive attention in bf16: the same loss within
    bf16's rounding of a 3-layer forward (2e-3 relative)."""
    conf = _conf(compute_dtype="bf16")
    params = ref.make_params(conf, S, 4, "cpu")
    tokens = _tokens(1, 4)[0]
    naive = tm.loss_fn(params, tokens, _cfg(conf))
    flash = tm.loss_fn(params, tokens, replace(_cfg(conf), attention="flash"))
    assert abs(float(flash) - float(naive)) <= 2e-3 * abs(float(naive))


def _moe_layer(conf, seed=5):
    params = ref.make_params(conf, S, seed, "cpu")
    lp = {k: v[0] for k, v in params["moe_layers"].items()}
    h = torch.randn((B, S, TINY["d_model"]), generator=torch.Generator().manual_seed(seed))
    return lp, h


def test_expert_shares_add_up_to_the_whole_layer():
    """The routed parts of two cards' shares (experts 0-3 and 4-7 of 8),
    plus the shared expert counted once, give the uncut reference layer (all
    8 held), in f32 (1e-5 of the output's largest value); between them the
    shares compute every (token, expert) pair: nothing is dropped."""
    conf = _conf(num_experts=8)
    lp, h = _moe_layer(conf)
    routed, shared, aux = ref.moe_ffn(h, lp, conf["model"], ref._Precision("f32"))
    cfg = replace(tm.topk_config(_cfg(conf)), num_experts=4, shared_d_ff=0)
    total = tm.swiglu(h.reshape(B * S, -1), lp["shared_in"], lp["shared_out"]).view(B, S, -1)
    rows = 0
    for first in (0, 4):
        share = {"router": lp["router"], "experts_in": lp["experts_in"][first:first + 4],
                 "experts_out": lp["experts_out"][first:first + 4]}
        y, aux_share, r = moe.moe_topk_ffn(share, h, cfg, first=first)
        total = total + y
        rows += int(r.sum())
        assert abs(float(aux_share) - float(aux)) <= 1e-6
    want = routed + shared
    assert float((total - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert rows == B * S * TINY["experts_per_token"]


def test_rows_count_every_held_pair():
    """``rows`` is each held expert's count of (token, slot) pairs routed to
    it, read from the routing the reference makes."""
    conf = _conf()
    lp, h = _moe_layer(conf, 6)
    probs = torch.softmax(h.reshape(B * S, -1) @ lp["router"], dim=-1)
    top = probs.topk(TINY["experts_per_token"], dim=-1).indices
    want = torch.stack([(top == e).sum() for e in range(TINY["num_experts"])])
    _, _, rows = moe.moe_topk_ffn(lp, h, tm.topk_config(_cfg(conf)))
    assert torch.equal(rows, want)


def test_yarn_at_the_published_numbers():
    """DeepSeek-V2-Lite's RoPE (d 64, base 10000, factor 40, original 4096,
    beta 32 / 1, mscale = mscale_all_dim = 0.707): the ramp runs from pair 10
    to 23, the softmax scale is 192^(-1/2)·(0.1·0.707·ln 40 + 1)² = 0.114721,
    and cos and sin are not rescaled; the program's frequencies and rotation
    match the reference's complex product (f32, 1e-6)."""
    conf = _conf(qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128)
    cfg = _cfg(conf)
    assert tm.yarn_ramp(cfg) == (10, 23) == ref.yarn_range(conf["model"])
    assert tm.softmax_scale(cfg) == pytest.approx(0.114721, abs=1e-6)
    assert tm.softmax_scale(cfg) == pytest.approx(ref.attention_scale(conf["model"]), rel=1e-12)
    cos, sin = tm.rope_tables(cfg, 64, "cpu")
    rot = ref.rotations(conf["model"], 64, "cpu")
    assert torch.allclose(cos, rot.real, atol=1e-6) and torch.allclose(sin, rot.imag, atol=1e-6)
    assert float((cos ** 2 + sin ** 2 - 1).abs().max()) <= 1e-6
    x = torch.randn((3, 64, 2, 64), generator=torch.Generator().manual_seed(7))
    got = tm.apply_rope(x, cos[:, None], sin[:, None])
    assert torch.allclose(got, ref._rope(x, rot[:, None]), atol=1e-5)


def test_model_flops_count_the_active_experts():
    """The reference's count at the published widths: 6·(N − embedding −
    (1 − 6/64) of the held routed experts) + 6·L·S·H·(192 + 128) a token."""
    m = {"d_model": 2048, "n_heads": 16, "n_layers": 9, "first_k_dense_replace": 1,
         "num_experts": 8, "moe_d_ff": 1408, "vocab": 102400, "experts_per_token": 6,
         "n_routed_experts": 64, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
         "v_head_dim": 128}
    n = 1_300_000_000
    routed = 8 * 8 * 3 * 2048 * 1408
    active = n - 102400 * 2048 - (1 - 6 / 64) * routed
    want = 6 * 8191 * (6 * active + 6 * 9 * 8192 * 16 * 320)
    assert ref.model_flops_per_step({"model": m}, 8192, 6, n) == pytest.approx(want)


def _params_and_tokens():
    conf = _conf()
    return ref.make_params(conf, S, 0, "cpu"), _tokens(1)[0], _cfg(conf)


@pytest.mark.parametrize("path", ["sharded step", "param specs", "pipelined step",
                                  "pipelined loss", "ring step", "ring loss", "sharded backbone"])
def test_multi_device_paths_refuse_the_block(path):
    """deepseek_v2 runs on one device: the sharded, pipelined and ring paths
    refuse it with a ValueError before they touch a mesh."""
    params, tokens, cfg = _params_and_tokens()
    calls = {
        "sharded step": lambda: tm.make_sharded_train_step(cfg, None),
        "param specs": lambda: tm.param_specs(cfg),
        "pipelined step": lambda: pipeline.make_pipelined_train_step(cfg, None, 2),
        "pipelined loss": lambda: pipeline.pipelined_loss_fn(params, tokens, cfg, None, 2),
        "ring step": lambda: ringattention.ring_value_and_grad(cfg, None),
        "ring loss": lambda: ringattention.ring_loss_fn(params, tokens, cfg, None),
        "sharded backbone": lambda: tm.backbone_and_aux(params, tokens, cfg, pos_offset=S),
    }
    with pytest.raises(ValueError, match="one device"):
        calls[path]()


@pytest.mark.parametrize("over", [dict(arch="llama"), dict(num_experts=9),
                                  dict(experts_per_token=0), dict(qk_rope_head_dim=7),
                                  dict(first_k_dense_replace=4)])
def test_config_refuses_what_it_cannot_build(over):
    with pytest.raises(ValueError):
        tm.ModelConfig(**{**TINY, **over})


# -- on the card -----------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels and the grouped products run only on an "
                    "NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 16, 1024), (1, 16, 8192), (1, 2, 333)])
def test_mla_kernels_match_plain_on_cuda(shape):
    """attn_fwd and attn_bwd at q·k width 192 and v width 128 against their
    plain versions, row by row: within 2e-2 of each row's norm (the kernels
    round P and dS to bf16 where they feed a product; the plain versions
    keep f32), lse within 1e-3; the backward repeats bit for bit."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((*shape, 192), generator=gen, device="cuda") * 192 ** -0.5
    k = torch.randn((*shape, 192), generator=gen, device="cuda")
    v, do = (torch.randn((*shape, 128), generator=gen, device="cuda") for _ in range(2))
    q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
    before = (attn_kernel.attn_fwd.launches, attn_kernel.attn_bwd.launches)
    o, lse = attn_kernel.attn_fwd(q, k, v)
    got = attn_kernel.attn_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert (attn_kernel.attn_fwd.launches, attn_kernel.attn_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert o.shape == v.shape
    want_o, want_lse = attn_kernel.attn_fwd_plain(q, k, v)
    assert attn_kernel.max_row_err(o, want_o) <= 2e-2
    assert float((lse - want_lse).abs().max()) <= 1e-3
    got = attn_kernel.attn_bwd(q, k, v, want_o, want_lse, do)
    want = attn_kernel.attn_bwd_plain(q, k, v, want_o, want_lse, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape
        assert attn_kernel.max_row_err(g, w) <= 2e-2, (name, attn_kernel.max_row_err(g, w))
    again = attn_kernel.attn_bwd(q, k, v, want_o, want_lse, do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_topk_layer_on_cuda_matches_its_cpu_plain_path():
    """moe_topk_ffn on the card (grouped products) against the same layer
    on the CPU (a loop over the held experts), both bf16 from the same f32
    weights: the same rows counted, the aux within 1e-5, the output and the
    gradients of x and of every weight within 2e-2 of their norms (bf16
    products summed in another order)."""
    _need_cuda()
    cfg = moe.TopKConfig(d_model=256, d_ff=128, num_experts=8, n_routed=16, top_k=6,
                         shared_d_ff=256, compute_dtype="bf16")
    gen = torch.Generator().manual_seed(0)
    params = {"router": torch.randn((256, 16), generator=gen) * 256 ** -0.5,
              "experts_in": torch.randn((8, 256, 256), generator=gen) * 256 ** -0.5,
              "experts_out": torch.randn((8, 128, 256), generator=gen) * 128 ** -0.5,
              "shared_in": torch.randn((256, 512), generator=gen) * 256 ** -0.5,
              "shared_out": torch.randn((256, 256), generator=gen) * 256 ** -0.5}
    x = torch.randn((2, 256, 256), generator=gen).to(torch.bfloat16)
    dy = torch.randn((2, 256, 256), generator=gen).to(torch.bfloat16)
    out = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev).requires_grad_() for k, v in params.items()}
        xd = x.to(dev).requires_grad_()
        y, aux, rows = moe.moe_topk_ffn(p, xd, cfg)
        grads = torch.autograd.grad((y, aux), (xd, *p.values()),
                                    (dy.to(dev), torch.ones((), device=dev)))
        out[dev] = [t.detach().float().cpu() for t in (y, aux, rows, *grads)]
    cpu, card = out["cpu"], out["cuda"]
    assert torch.equal(card[2], cpu[2])
    assert abs(float(card[1] - cpu[1])) <= 1e-5
    for name, a, b in zip(["y", None, None, "dx", *params], card, cpu):
        if name is not None:
            assert float((a - b).norm()) <= 2e-2 * float(b.norm()), name


SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "aten::item", "aten::_local_scalar_dense", "aten::nonzero")


@pytest.mark.cuda
def test_step_makes_no_host_sync():
    """Two train steps of a small deepseek_v2 (the flash kernels at 192 /
    128, the grouped products, the chunked head, tree AdamW) traced on the
    host: no synchronising call or host read of a device value inside them."""
    _need_cuda()
    from torch.profiler import ProfilerActivity, profile, record_function

    conf = _conf(d_model=256, n_heads=2, kv_lora_rank=64, qk_nope_head_dim=128,
                 qk_rope_head_dim=64, v_head_dim=128, vocab=1024, moe_d_ff=128,
                 compute_dtype="bf16", attention="flash", ce_chunk=128)
    cfg = tm.ModelConfig(**conf["model"], max_seq=256)
    params = ref.make_params(conf, 256, 0, "cuda")
    tokens = torch.randint(0, 1024, (2, 2, 256), device="cuda")
    init, step = tm.make_train_step(cfg)
    state = init(params)
    params, state, _ = step(params, state, tokens[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("two_steps"):
            for t in tokens:
                params, state, loss = step(params, state, t)
        torch.cuda.synchronize()
    events = prof.events()
    span = next(e for e in events if e.name == "two_steps")
    lo, hi = span.time_range.start, span.time_range.end
    found = sorted({e.name for e in events
                    if e.name in SYNCS and lo <= e.time_range.start <= hi})
    assert not found, found
    assert torch.isfinite(loss)


def test_the_benchmark_runs_a_tiny_cut_of_the_cell(tmp_path, monkeypatch):
    """The harness end to end on the CPU, on a copy of the benchmark's files
    with a tiny cut of ``deepseek_v2_lite`` (this file's widths, bf16, the
    flash path's plain versions): set-up, the timed loop, and the f32
    reference following the first steps, judged correct.  The limits are
    the tiny cell's, about three times the most its sound runs read over 4
    seeds (bf16 against f32 over 3 layers: loss1_gap 6.9e-4, grad_gap
    1.3e-2); the card's cell has its own, set by calibrate.py."""
    import json
    import shutil
    import time

    from perfbench import harness

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("tests", ".cache", "__pycache__"))
    data = tmp_path / "perfbench"
    conf = json.loads((data / "configs" / "deepseek_v2_lite.json").read_text())
    conf["model"].update({k: v for k, v in TINY.items() if k not in ("attention", "compute_dtype")},
                         attention="splash", compute_dtype="bf16")
    (data / "configs" / "deepseek_v2_lite.json").write_text(json.dumps(conf))
    (data / "traffic" / "seq8192.batch6.json").write_text(
        json.dumps({"seq": S, "batch": B, "pool": 8, "loss_every": 2}))
    limits = {"loss1_gap": 2e-3, "grad_gap": 4e-2}
    (data / "limits" / "dsv2lite-s8192.json").write_text(json.dumps({"limits": limits}))
    # The test process holds JAX (the suite's conftest); the benchmark's own
    # check of that is tested in perfbench/tests.
    monkeypatch.setattr(harness, "banned_modules", lambda: [])
    cell = harness.load_cell("dsv2lite-s8192", tmp_path)
    assert [m["name"] for m in cell.per_layer] == [
        "step.mfu_pct", "device.idle_pct", "optimizer.ms", "mla_attn.roofline_pct",
        "moe_topk.ms", "moe_experts.roofline_pct"]
    out = harness.run(cell, 2**31 + 11, 0.2, False, time.perf_counter(), device="cpu",
                      log=lambda m: None)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 2
