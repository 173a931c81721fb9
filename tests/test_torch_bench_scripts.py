"""The port's measurement scripts (`cvpr23_lfdm_torch/scripts/`:
`bench_attention`, `bench_attn_fused`, `bench_batch_sweep`, `bench_train`,
`profile_sampler`; counterparts of the JAX package's scripts of the same
names) rehearsed on the CPU at tiny configs through the kernels' plain
versions: the keys of every record, the forms of `bench_attention` on one
input, the TPU tiling flags of `bench_attn_fused` refused, the hand-written
FLOP counts of rows 4-5 against `FlopCounterMode` on their plain versions,
and the kernel grouping that `profile_sampler` reads (`utils/profiling.py`).
Times here are host-clock rehearsals, not device readings."""

import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from cvpr23_lfdm_torch.ops import attention as attn_ops
from cvpr23_lfdm_torch.scripts import (
    bench_attention, bench_attn_fused, bench_batch_sweep, bench_train, profile_sampler,
)
from cvpr23_lfdm_torch.utils import profiling
from test_torch_cli import tiny_cfg
from test_torch_train_cli import train_cfg


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: as fast at these sizes, and the test processes
    that share the CPU do not oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bench_attention_forms_agree_on_one_input():
    """Every form of the port's `TemporalAttention` on the same bf16 input:
    `pallas` and `pallas2` within a few bf16 ulps of `xla` (they round the
    scores and the probabilities at other points), `pallas3` of the PreNorm
    composition `x + xla(LN(x))`. An unknown form raises."""
    recs = bench_attention.run(shapes=[(1, 16, 64), (2, 4, 32)],
                               impls=("xla", "pallas", "pallas2", "pallas3"),
                               device="cpu", frames=8, iters=1, warmup=0)
    assert len(recs) == 2
    for rec in recs:
        assert set(rec) == {"B", "HW", "dim", "frames", "dtype", "ms", "max_abs_vs_xla", "clock"}
        assert rec["clock"] == "host" and set(rec["ms"]) == {"xla", "pallas", "pallas2", "pallas3"}
        assert rec["max_abs_vs_xla"]["xla"] == 0.0
        for impl in ("pallas", "pallas2", "pallas3"):
            assert rec["max_abs_vs_xla"][impl] <= 0.05, (impl, rec["max_abs_vs_xla"])
    with pytest.raises(ValueError, match="form"):
        bench_attention.run(shapes=[(1, 16, 64)], impls=("xla", "pallas4"), device="cpu", frames=8)


def test_bench_attn_fused_records_and_refuses_tpu_knobs(capsys):
    recs = bench_attn_fused.main(["--device", "cpu", "--batch", "1", "--hw", "16", "--dim", "64",
                                  "--frames", "8", "--cluster", "2", "4"])
    assert [r["variant"] for r in recs] == ["pallas2+glue", "fused", "fused_cluster2", "fused_cluster4"]
    for r in recs:
        assert set(r) == {"variant", "layer_ms", "max_abs_err", "within_tol", "clock"}
    assert recs[0]["within_tol"] is None and all(r["within_tol"] for r in recs[1:])
    assert recs[0]["max_abs_err"] <= 0.1
    assert '"shape": [1, 8, 16, 64]' in capsys.readouterr().out
    for flag in (["--pm", "2"], ["--pack", "16"]):
        with pytest.raises(SystemExit, match="--cluster"):
            bench_attn_fused.main(["--device", "cpu", *flag])
    with pytest.raises(ValueError, match="divide"):
        bench_attn_fused.run(1, 16, 64, 8, clusters=(3,), device="cpu")


def test_bench_batch_sweep_records():
    args = bench_batch_sweep.parser().parse_args(
        ["--device", "cpu", "--bench-ckpt", "", "--batches", "1", "2", "--iters", "1", "--pipe-depth", "2"])
    *per_batch, summary = bench_batch_sweep.run(tiny_cfg(), args)
    assert [r["batch"] for r in per_batch] == [1, 2]
    keys = {"batch", "weights", "percall_fps", "pipelined_fps", "percall_s", "peak_mem_gb",
            "launches_per_call", "finite", "out_vid_in_unit_range", "out_vid_shape", "pipelined",
            "clock", "card"}
    for r in per_batch:
        assert set(r) == keys
        assert r["finite"] and r["out_vid_in_unit_range"] and r["weights"] == "random"
        assert r["out_vid_shape"] == [r["batch"], 4, 64, 64, 3]
        assert not any(r["launches_per_call"].values())  # the CPU runs the plain versions
        assert r["pipelined"] is False and r["clock"] == "host" and r["card"] == "cpu"
    assert summary["summary"] == "batch_sweep" and summary["host_syncs"] == []
    assert summary["winner"]["batch"] in (1, 2) and set(summary["sweep"]) == {1, 2}


def test_bench_train_records():
    args = bench_train.parser().parse_args(
        ["--device", "cpu", "--bench-ckpt", "", "--stage", "both", "--iters", "1"])
    cfg = train_cfg()
    cfg = cfg.replace(dm_train=dataclasses.replace(cfg.dm_train, batch_size=2),
                      lfae_train=dataclasses.replace(cfg.lfae_train, batch_size=2))
    dm, lfae = bench_train.run(cfg, args)
    common = {"metric", "value", "step_s", "peak_mem_gb", "clock", "flops_counted", "flops_kernels",
              "step_tflop", "achieved_tflops", "device_busy_ms", "device_launches", "by_group",
              "spans", "batch_size", "peak_tflops", "mfu", "card"}
    assert set(dm) == common | {"frames", "attn_impl", "lfae_dtype", "weights"}
    assert set(lfae) == common | {"dtype", "tf32"}
    assert dm["metric"] == "dm_train_step_seconds" and lfae["metric"] == "lfae_train_step_seconds"
    assert dm["batch_size"] == lfae["batch_size"] == 2
    for rec in (dm, lfae):
        assert rec["value"] > 0 and rec["flops_counted"] > 0 and rec["flops_kernels"] == 0
        assert rec["mfu"] is None and rec["achieved_tflops"] is None and rec["device_busy_ms"] is None
        assert rec["spans"] == {}  # no profile off the card
    assert (dm["peak_tflops"], lfae["peak_tflops"]) == (989.0, 67.0)


@pytest.mark.parametrize("b,f,hw,heads", [(1, 4, 3, 2), (2, 5, 4, 4)])
def test_headpacked_flop_counts_match_the_counter(b, f, hw, heads):
    """Rows 4 and 5's hand-written counts (the ones the DM step adds on the
    card, where `FlopCounterMode` cannot see the kernels) equal the
    counter's count of their plain versions, forward and backward."""
    d = 32
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(b, f, hw, 3 * heads * d, generator=g, requires_grad=True)
    bias = attn_ops.build_bias_flat(torch.randn(heads, f, f, generator=g), b, f).requires_grad_()
    cos_t, sin_t = attn_ops.rotary_tables(f, heads, d, d ** -0.5, torch.float32)
    do = torch.randn(b, f, hw, heads * d, generator=g)
    with FlopCounterMode(display=False) as fwd_count:
        out = attn_ops.headpacked_temporal_attention_plain(qkv, bias, cos_t, sin_t, heads, d)
    with FlopCounterMode(display=False) as bwd_count:
        out.backward(do)
    assert bench_train.headpacked_flops(b, f, hw, heads, d) == (
        fwd_count.get_total_flops(), bwd_count.get_total_flops())


def test_profile_sampler_records_and_groups():
    args = profile_sampler.parser().parse_args(["--device", "cpu", "--bench-ckpt", "", "--batch", "2",
                                                "--iters", "1", "--top", "5"])
    (rec,) = profile_sampler.run(tiny_cfg(), args)
    assert set(rec) == {"batch", "weights", "iters", "wall_ms_per_call", "frames_per_s",
                        "device_busy_ms_per_call", "device_busy_share", "device_launches_per_call",
                        "groups", "spans", "top", "clock", "card"}
    assert rec["batch"] == 2 and rec["wall_ms_per_call"] > 0 and rec["clock"] == "host"
    assert rec["groups"] == {} and rec["device_busy_ms_per_call"] == 0.0  # nothing ran on a device
    steps = 10  # the serving form's DDIM-10 (`bench_batch_sweep.serving_model`)
    assert {name: row["calls"] for name, row in rec["spans"].items()} == {
        "sample_video": 1, "encode": 1, "sample": 1, "decode": 1,
        "sampler_step": steps, "denoise": steps, "threshold": steps}
    assert all(row["device_ms"] == row["launches"] == 0 for row in rec["spans"].values())


# the device names of the port's kernels (csrc/*.cu) as the profiler shows them
PORT_KERNELS = {
    "fused_temporal_layer": ["void lfdm::(anonymous namespace)::fused_temporal_layer_mma_kernel<2>(...)",
                             "void lfdm::(anonymous namespace)::fused_temporal_layer_kernel<float>(...)"],
    "fused_spatial_linear_layer": ["void lfdm::(anonymous namespace)::linear_context_mma_kernel(...)",
                                   "void lfdm::(anonymous namespace)::linear_output_mma_kernel(...)",
                                   "void lfdm::(anonymous namespace)::context_kernel<float>(...)",
                                   "void lfdm::(anonymous namespace)::output_kernel<float>(...)"],
    "warp_blend": ["void lfdm::(anonymous namespace)::warp_blend_kernel<0, __nv_bfloat16>(...)"],
    "headpacked_fwd": ["void lfdm::(anonymous namespace)::headpacked_fwd_mma_kernel(...)",
                       "void lfdm::(anonymous namespace)::headpacked_fwd_kernel<float>(...)"],
    "headpacked_bwd": ["void lfdm::(anonymous namespace)::headpacked_bwd_mma_kernel(...)",
                       "void lfdm::(anonymous namespace)::headpacked_bwd_kernel<float>(...)",
                       "void lfdm::(anonymous namespace)::headpacked_dbias_kernel(...)"],
    "packed_attention": ["void lfdm::(anonymous namespace)::packed_attention_mma_kernel(...)",
                         "void lfdm::(anonymous namespace)::packed_attention_kernel<float>(...)"],
    "groupnorm_film_silu": ["void lfdm::(anonymous namespace)::groupnorm_film_silu_kernel(...)"],
}


def test_profile_sampler_gives_each_port_kernel_its_own_group():
    assert set(PORT_KERNELS) == set(profiling.PORT_GROUPS)
    for group, names in PORT_KERNELS.items():
        for name in names:
            assert profiling.group_name(name) == group, name
    library = {"void at::native::vectorized_elementwise_kernel<4, ...>(...)": "elementwise",
               "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc(...)": "conv_gemm",
               "void at::native::reduce_kernel<512, 1, ...>(...)": "reduction",
               "Memcpy HtoD (Pageable -> Device)": "copy",
               "void at::native::gatherKthValue<float, long, 2>(...)": "kthvalue",
               "some_new_kernel": "other"}
    for name, group in library.items():
        assert profiling.group_name(name) == group, name
    rows = [{"name": PORT_KERNELS["warp_blend"][0], "device_ms": 0.6, "count": 6},
            {"name": "Memcpy HtoD (Pageable -> Device)", "device_ms": 0.2, "count": 4}]
    assert profiling.device_groups(rows, per=2) == {
        "warp_blend": {"device_ms": 0.3, "launches": 3.0}, "copy": {"device_ms": 0.1, "launches": 2.0}}
