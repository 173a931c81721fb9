#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`cvpr23_lfdm_torch`) on one NVIDIA GPU.

Run from the repository root: `python3 chip_smoke.py` (one GPU; `nvcc`
under /usr/local/cuda or on PATH). Phases, each printing JSON lines:

1. env      — GPU name and power limit, torch/CUDA versions, and the build
              of the six kernel sources in `cvpr23_lfdm_torch/csrc/` and
              of the eight ablation builds of the temporal layer (one `nvcc`
              per library, all started together); the `-Xptxas -v` lines,
              and per bf16 kernel of the two fused layers (each
              instantiation of the temporal layer's; the linear layer's
              context and output kernels) its registers and spills (gated:
              no spill).
2. kernel   — each kernel against its plain PyTorch version at every shape
              the serving path (fused layers, the decode warp: bit-equal to
              its plain version at the three decode scales, with its device
              time alone and its device launches per call) or the training step
              (head-packed attention, forward and backward, B=5) gives it,
              in bf16 and in fp32 (TF32 off), with its tolerance; median
              CUDA-event times of the kernel, the plain version and one
              library call (`F.grid_sample` for the warp,
              `F.scaled_dot_product_attention` and its autograd backward on
              pre-rotated q, k, v for the head-packed pair; bf16; timed
              here, used nowhere in the port; for that pair also the
              device time alone of the kernels and of SDPA's, from
              torch.profiler, without the host's work around the
              launches); the least time the card
              could take (bytes / 3.35 TB/s or FLOPs / 989 TFLOP/s bf16,
              whichever is larger). The temporal layer also with its
              device time alone per call (torch.profiler, one kernel per
              call) and, in both dtypes and the focus case, run twice for
              bit-identity; the linear layer likewise (two kernels per
              call), and at HW = 48 and 100 (short last tiles, off the
              path), each also on inputs whose attention branch is O(1)
              and residual small, so that the gate holds the branch
              (`branch_max_abs_err`, `branch_rms`). Likewise the packed attention at the
              four B=1 serving shapes and a focus case (library: SDPA on
              pre-permuted q, k, v; device times alone of both; run twice
              for bit-identity), the fused GroupNorm+FiLM+SiLU at every
              `Block` shape of a serving eval and at B=8 (32², 64), with
              the FiLM pair as the UNet passes it and without, run twice
              for bit-identity, with its device time alone and its device
              launches per call (gated: one; no single library call), and the
              fused warp+blend under both of its names for the three blends
              at `[8, 32, 32, 256]` and `[8, 128, 128, 67]` (library:
              `F.grid_sample` for blend none; device times alone of both);
              these warp+blend calls are lines of their own and enter no
              total.
3. serving  — the MUG serving path at full width on the bench checkpoint
              (128² frames, 40 frames, DDIM-10, B=1, cond_scale 1, bf16
              compute): output shapes, finite values, `out_vid` in [0, 1],
              the kernel launch counts of one video (each counter set to 0
              just before, read just after), and frames/s over timed runs.
4. parity   — the same path in fp32 with the kernels against the plain
              versions on the card (a test hook swaps the ops for this run
              only), under the same injected noise; and an fp32 run with
              the kernels against the JAX package's golden
              (`tests/golden/torch_port_mug_ddim10.npz`, 8 frames).

5. profile  — one serving video under torch.profiler: device time by
              kernel (and each fused layer's sum over its 100 or 80 calls) and
              its share of the serving latency; the full table
              goes to `chip_smoke_out/profile_serving.json`.
6. train    — `DMTrainer.train_step` at the full width of the MUG config
              (UNet dim 64, mults (1,2,4,8), 8x32 heads, 40 frames, 128²,
              bf16 UNet compute, fp32 LFAE, B=5, lr 2e-4): UNet and
              generator encoder from the bench checkpoint, region /
              background / pixelwise-flow weights and the batch from a
              seed. Two warm-up steps, five timed steps on one fixed
              (batch, t, noise), one of them with the launch counters set
              to 0 before and read after (10 forward and 10 backward
              head-packed launches, no fused serving launch), one
              monitoring step; gates on finite loss and gradient norm, a
              finite, not-all-zero gradient for every trainable parameter,
              and moved parameters; then the step's parts timed with CUDA
              events and one step under torch.profiler
              (`chip_smoke_out/profile_train.json`).
7. train parity — one fp32 step (B=2) from the same weights, t and noise
              with the kernels and with the plain versions on the card:
              loss, gradient norm and the largest parameter-gradient
              difference; and the kernel step run twice gives bit-identical
              gradients.

8. lfae train — `LFAETrainer.train_step` (stage 1) at the MUG config's full
              widths (128², 10 regions, fp32 with TF32 off, the recipe's
              losses, scales and Adam) and the recipe's batch (B=100),
              seeded weights (`seed_lfae_weights`, `seed_vgg_weights`) and a
              seeded batch: two warm-up and five timed steps (median s per
              step, frames/s, peak memory), the port's kernel launches of a
              step (gated: none, the training path warps with `train_warp`),
              the four losses of each step, gates on finite losses, every
              parameter and every BatchNorm statistic moved, the step
              counter; one step under torch.profiler (device busy, device
              launches; `chip_smoke_out/profile_lfae_train.json`); the
              training warp's two candidates at the step's shapes
              (`scripts/bench_train_warp.py`: forward + backward ms each,
              per call and per step); `reconstruct` (eval) on the same batch,
              row 3's launches per call (gated: at least one) and its
              prediction against the plain version's (a test hook swaps the
              ops; gated at 1e-4); then one fp32 step at B=2 against the
              JAX package's golden (`tests/golden/torch_port_lfae_step.npz`:
              the train-mode forward's prediction, flow, occlusion and three
              region-parameter sets, the losses of steps 1 and 2, with the
              tolerances of `LFAE_GOLDEN_TOL`).
9. serving forms — the full MUG video (bf16, B=1) with
              `temporal_attn_impl="pallas"` (100 packed-attention launches,
              no fused-layer launch, 3 warps; one more video under
              torch.profiler: device busy ms and the packed kernel's share)
              and with `"xla"` (no attention kernel at all): gates as in
              phase 3, frames/s.
10. forms parity — `scripts/check_kernel_parity.py` in fp32 (TF32 off): the
              video under `xla`, `pallas` and `pallas3` on the same weights
              and noise, max-abs per output against `xla`, tolerance 5e-4.
11. fused norm — `scripts/bench_unet.py`: one full-width UNet eval, bf16,
              B=1 and B=8, `fused_norm=True` against `False`, read in turns:
              both times, the output difference, 40 launches per eval
              (gated), the norm kernel's device time in a profiled eval
              (gated: not 0), and every device launch of the eval's 40 norm
              calls, casts and copies included (the calls replayed under
              torch.profiler; gated: 40).
12. ablate   — `scripts/bench_attn_ablate.py` at `[8, 40, 1024, 64]` bf16:
              ms per ablation build (eight stages, the last the cluster's
              sum of the partials) and `full - variant`; `full` is
              bit-equal to the serving kernel and held against the plain
              layer.
13. bench warp — `scripts/bench_warp.py`: the decode-warp variants at
              `[8, 40, 128, 128, 67]` and `warp_video` / `F.grid_sample` /
              `warp_onehot` at every decode scale; its launch counts. Every
              folded warp+blend call of that run (`[320, s, s, C]`, blend
              none) is made again from the script's seeded inputs in phase
              2 (after the other kernel checks), elementwise against the
              plain version and timed beside it and `F.grid_sample` (with
              the device times alone of the kernel and of `F.grid_sample`):
              the totals of `warp_onehot` and `warp_gather` in the
              `kernels` line.

Then one `kernels` line (per kernel: launches on its main path, and its
time, plain time, bound and library time summed over the calls named in
`per`; for rows 1-9 also `device_ms` / `library_device_ms`, the
same calls' device time alone from torch.profiler), the `nvidia-smi`
name/power-limit line, and last
`{"ok": true, "device": {...}}`. Any failure exits non-zero without that
line.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor cores
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
F_FRAMES, HEADS, DH = 40, 8, 32
DDIM_STEPS = 10
# (C, HW) of the fused layers' serving calls and their count per UNet eval:
# `cvpr23_lfdm_torch/scripts/_common.py::TEMPORAL_SHAPES` and `LINEAR_SHAPES`
# (the package is imported once the checkout is known: see main)
# decode warps per video: (H, C) of the shared source, F = 40 grids
WARP_SHAPES = {(32, 256): 1, (64, 128): 1, (128, 67): 1}
TOL = {  # elementwise |kernel - plain| <= atol + rtol * |plain|
    # fp32: the same sums in another order (and expf/rsqrtf vs torch's)
    "float32": {"atol": 2e-4, "rtol": 1e-4},
    # bf16: both round to bf16 at the same points; a value that lands on
    # the other side of a rounding boundary moves by one bf16 ulp (2^-8)
    "bfloat16": {"atol": 3e-2, "rtol": 2e-2},
}
WARP_TOL = {"float32": {"atol": 1e-5, "rtol": 1e-5}, "bfloat16": {"atol": 1e-2, "rtol": 1e-2}}
# head-packed attention per training step: HW -> calls per UNet evaluation
HEADPACKED_SHAPES = {1024: 3, 256: 2, 64: 2, 16: 3}
TRAIN_BATCH = 5
# dbias sums ds over all HW pixels in fp32: the same terms in another order.
# In bf16, ds also moves where an exponential rounds the other way, and those
# moves add over the pixels like a random walk: its atol is per sqrt(HW)
DBIAS_TOL = {"float32": {"atol": 2e-3, "rtol": 1e-3}, "bfloat16": {"atol": 1e-2, "rtol": 2e-2}}
TRAIN_PARITY_TOL = {"loss_rel": 1e-4, "grad_norm_rel": 1e-3, "grad_max_abs_rel": 2e-3}
# the fused GroupNorm+FiLM+SiLU's Block shapes per UNet eval and its 40 Blocks:
# `cvpr23_lfdm_torch/scripts/bench_norm.py::NORM_SHAPES`, `BLOCKS_PER_EVAL`
# warp+blend checks: [B, H, W, C]; one call of each blend at each shape
BLEND_SHAPES = ((8, 32, 32, 256), (8, 128, 128, 67))
ABLATE_SHAPE = (8, 40, 1024, 64)
FUSED_NORM_BATCHES = (1, 8)
# bf16 UNet eval, fused vs unfused norm: each Block rounds to bf16 at other
# points (one rounding after fp32 math against three bf16 steps), 40 Blocks
# deep; relative to the largest output value
FUSED_NORM_TOL = {"max_rel": 5e-2, "mean_rel": 1e-2}
PATH_TOL = 2e-3    # fp32 serving path, kernels vs plain, max-abs
GOLDEN_TOL = 5e-3  # fp32 serving path on the card vs the JAX package on a CPU
# LFAE training at the MUG recipe's batch (`LFAETrainConfig.batch_size`);
# the learning rate's milestones (epochs 60, 90) lie far past the phase's steps
LFAE_BATCH = 100
LFAE_STEPS_PER_EPOCH = 93
LFAE_GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_lfae_step.npz")
# fp32 step on the card vs the JAX package on a CPU (B=2), max-abs per
# output and relative per loss. The port on a CPU reads 2.6e-3 (prediction),
# 8.6e-4 (flow), 6e-5 (occlusion), 3e-5 (region parameters), 6e-6 (step-1
# losses): convolutions summed in another order through ~40 layers, a
# warp's output moving with its flow. Step 2 follows Adam's first update,
# +-lr on every parameter by its gradient's sign, which the two frameworks
# take apart on the ~1-2% of weights whose gradient is near 0; the
# equivariance losses, which rest on the region predictor, move with them
# (the CPU port: 14% and 6%; the total 0.3%)
LFAE_GOLDEN_TOL = {"prediction": 1e-2, "optical_flow": 4e-3, "occlusion_map": 1e-3, "region": 1e-3,
                   "step1_rel": 1e-4, "step2_rel": {"perceptual": 2e-2, "total": 2e-2,
                                                    "equivariance_shift": 0.5,
                                                    "equivariance_affine": 0.5}}
RECON_TOL = 1e-4  # fp32 eval reconstruction, row 3 vs plain (bit-equal warps; other convs)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    from cvpr23_lfdm_torch.utils.profiling import time_fn

    return time_fn(fn, iters=reps, warmup=warmup)["median_ms"]


def device_ms(fn, reps: int = 10, launches: int | None = None) -> float | None:
    from cvpr23_lfdm_torch.utils.profiling import device_ms as read

    return read(fn, reps, launches)


def bound(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def compare(out, ref, tol) -> dict:
    diff = (out.float() - ref.float()).abs()
    rel = diff / ref.float().abs().clamp_min(1e-6)
    ok = bool((diff <= tol["atol"] + tol["rtol"] * ref.float().abs()).all())
    return {"max_abs_err": float(diff.max()), "max_rel_err": float(rel.max()),
            "tol": tol, "ok": ok, "finite": bool(torch_isfinite(out))}


def torch_isfinite(t) -> bool:
    import torch

    return bool(torch.isfinite(t.float()).all())


def ptxas_report(log: str) -> dict:
    """`nvcc -Xptxas -v` output -> {mangled kernel name: {"registers",
    "spill_stores", "spill_loads"}}."""
    import re

    report, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name = m.group(1)
            report[name] = {"registers": None, "spill_stores": None, "spill_loads": None}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            report[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            report[name]["registers"] = int(m.group(1))
            name = None
    return report


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


# ---------------------------------------------------------------- phase 2


def _totals(names) -> dict:
    return {n: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": None,
                "max_abs_err": 0.0, "bytes": 0.0, "flops": 0.0} for n in names}


def _record(totals, failures, name, shape, dname, res, weight, times=None, nbytes=0.0, flops=0.0,
            peak=BF16_FLOPS, **extra):
    """Emit one kernel line; add `weight` calls of it to the kernel's totals
    (0: a call off the kernel's main path, on a line of its own)."""
    line = {"phase": "kernel", "name": name, "shape": shape, "dtype": dname, **res, **extra}
    if not (res["ok"] and res["finite"]):
        failures.append(f"{name} {shape} {dname}")
    if times is not None:
        b_ms, b_by = bound(nbytes, flops, peak)
        line.update(times, bound_ms=b_ms, bound_by=b_by, calls=weight)
        t = totals[name]
        t["ms"] += weight * times["kernel_ms"]
        t["plain_ms"] += weight * times["plain_ms"]
        t["bound_ms"] += weight * b_ms
        t["bytes"] += weight * nbytes
        t["flops"] += weight * flops
        if weight and times.get("library_ms") is not None:
            t["library_ms"] = (t["library_ms"] or 0.0) + weight * times["library_ms"]
        if weight and "kernel_device_ms" in times:  # device time alone (None: not measured)
            for key, src in (("device_ms", "kernel_device_ms"), ("library_device_ms", "library_device_ms")):
                v, so_far = times.get(src), t.get(key, 0.0)
                t[key] = None if v is None or so_far is None else so_far + weight * v
        t["max_abs_err"] = max(t["max_abs_err"], res["max_abs_err"])
    emit(line)


def check_kernels(failures: list) -> dict:
    """Each kernel against its plain version at every serving shape; returns
    per-kernel totals over the calls of one video (bf16 times)."""
    import torch
    import torch.nn.functional as F

    from cvpr23_lfdm_torch.ops import attention as A
    from cvpr23_lfdm_torch.ops import warp as W
    from cvpr23_lfdm_torch.scripts._common import LINEAR_SHAPES, TEMPORAL_SHAPES
    from cvpr23_lfdm_torch.scripts.bench_norm import device_reading, one_launch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)
    totals = _totals(("fused_temporal_layer", "fused_spatial_linear_layer", "warp_video"))
    record = lambda *a, **k: _record(totals, failures, *a, **k)
    hd = HEADS * DH

    pos_bias = randn(HEADS, F_FRAMES, F_FRAMES)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        timed = dtype == torch.bfloat16
        esz = 2 if timed else 4
        for (c, hw), n_eval in TEMPORAL_SHAPES.items():
            x = randn(1, F_FRAMES, hw, c).to(dtype)
            gamma = 1 + 0.1 * randn(c)
            wqkv = (randn(c, 3 * hd) / c ** 0.5).to(dtype)
            wout = (randn(hd, c) / hd ** 0.5).to(dtype)
            bias = A.build_bias_flat(pos_bias, 1, F_FRAMES)
            cos_t, sin_t = A.rotary_tables(F_FRAMES, HEADS, DH, DH ** -0.5, dtype, dev)
            args = (x, gamma, wqkv, wout, bias, cos_t, sin_t, HEADS, DH)
            call = lambda: A.fused_temporal_layer(*args)
            out = call()
            res = compare(out, A.fused_temporal_layer_plain(*args), TOL[dname])
            same = bool(torch.equal(out, call()))  # no atomics: the same bits when run again
            res["ok"] = res["ok"] and same
            times = None
            if timed:
                times = {"kernel_ms": median_ms(call),
                         "plain_ms": median_ms(lambda: A.fused_temporal_layer_plain(*args), reps=5),
                         "library_ms": None,
                         "kernel_device_ms": device_ms(call, launches=1), "library_device_ms": None}
            nbytes = (2 * x.numel() + wqkv.numel() + wout.numel() + 2 * cos_t.numel()) * esz \
                + (gamma.numel() + bias.numel()) * 4
            flops = 2 * F_FRAMES * hw * c * 4 * hd + 4 * hw * HEADS * F_FRAMES * F_FRAMES * DH
            record("fused_temporal_layer", [1, F_FRAMES, hw, c], dname, res,
                   n_eval * DDIM_STEPS, times, nbytes, flops, bit_identical_twice=same,
                   **({"device_launches_per_call": 1} if timed else {}))
        # focus-present rows (not on the serving path): B=2, one entry focused
        c, hw = 64, 256
        x = randn(2, F_FRAMES, hw, c).to(dtype)
        gamma = 1 + 0.1 * randn(c)
        wqkv = (randn(c, 3 * hd) / c ** 0.5).to(dtype)
        wout = (randn(hd, c) / hd ** 0.5).to(dtype)
        bias = A.build_bias_flat(pos_bias, 2, F_FRAMES, torch.tensor([True, False], device=dev))
        cos_t, sin_t = A.rotary_tables(F_FRAMES, HEADS, DH, DH ** -0.5, dtype, dev)
        args = (x, gamma, wqkv, wout, bias, cos_t, sin_t, HEADS, DH)
        out = A.fused_temporal_layer(*args)
        res = compare(out, A.fused_temporal_layer_plain(*args), TOL[dname])
        same = bool(torch.equal(out, A.fused_temporal_layer(*args)))
        res["ok"] = res["ok"] and same
        record("fused_temporal_layer", [2, F_FRAMES, hw, c, "focus"], dname, res, 0,
               bit_identical_twice=same)

        # the serving shapes, then HW = 48 and 100 (off the path: short last tiles)
        for (c, n), n_eval in [*LINEAR_SHAPES.items(), ((64, 48), 0), ((128, 100), 0)]:
            x = randn(1, F_FRAMES, n, c)
            gamma = 1 + 0.1 * randn(c)
            wqkv = (randn(c, 3 * hd) / c ** 0.5).to(dtype)
            wout = randn(hd, c) / hd ** 0.5
            bout = 0.1 * randn(c)
            args = (x.to(dtype), gamma, wqkv, wout.to(dtype), bout, HEADS, DH)
            call = lambda: A.fused_spatial_linear_layer(*args)
            out = call()
            res = compare(out, A.fused_spatial_linear_layer_plain(*args), TOL[dname])
            same = bool(torch.equal(out, call()))  # no atomics: the same bits when run again
            # With these inputs the attention term W_out·o is ~0.2/sqrt(HW), under one
            # bf16 ulp of the residual: a fault in the context would pass. Again with
            # that term O(1) and the residual small (x/16: the LayerNorm does not see
            # the scale; W_out * 2 sqrt(HW)), so that the gate holds the branch itself,
            # whose rms must be ten times the gate's atol or more
            bargs = ((x / 16).to(dtype), gamma, wqkv, (2 * n ** 0.5 * wout).to(dtype), bout, HEADS, DH)
            bref = A.fused_spatial_linear_layer_plain(*bargs)
            branch = compare(A.fused_spatial_linear_layer(*bargs), bref, TOL[dname])
            branch_rms = float((bref.float() - bargs[0].float()).pow(2).mean().sqrt())
            res["ok"] = (res["ok"] and same and branch["ok"] and branch["finite"]
                         and branch_rms >= 10 * TOL[dname]["atol"])
            times = None
            if timed and n_eval:
                times = {"kernel_ms": median_ms(call),
                         "plain_ms": median_ms(lambda: A.fused_spatial_linear_layer_plain(*args), reps=5),
                         "library_ms": None,
                         "kernel_device_ms": device_ms(call, launches=2), "library_device_ms": None}
            nbytes = (2 * x.numel() + wqkv.numel() + wout.numel()) * esz + 2 * c * 4
            flops = 2 * F_FRAMES * n * c * 4 * hd + 4 * F_FRAMES * HEADS * n * DH * DH
            record("fused_spatial_linear_layer", [1, F_FRAMES, n, c], dname, res,
                   n_eval * DDIM_STEPS, times, nbytes, flops, bit_identical_twice=same,
                   branch_max_abs_err=branch["max_abs_err"], branch_rms=branch_rms,
                   **({"device_launches_per_call": 2} if times else {}))

        for (h, c), per_video in WARP_SHAPES.items():
            src = randn(1, h, h, c).to(dtype)
            lin = torch.linspace(-1, 1, h, device=dev)
            ident = torch.stack(torch.meshgrid(lin, lin, indexing="xy"), -1)
            grid = (ident[None, None] + 0.3 * randn(1, F_FRAMES, h, h, 2)).contiguous()
            call = lambda: W.warp_video(src, grid)
            out, ref = call(), W.warp_video_plain(src, grid)
            res = compare(out, ref, WARP_TOL[dname])
            # the kernel rounds every step as the plain version does: the same values
            equal = bool(torch.equal(out, ref))
            res["ok"] = res["ok"] and equal
            dev_ms, launches, other = device_reading(call, kernel="warp_blend_kernel")
            res["ok"] = res["ok"] and one_launch(launches, other)
            times = None
            if timed:
                src_nchw = src.permute(0, 3, 1, 2)
                g4 = grid.reshape(1, F_FRAMES * h, h, 2).to(dtype)
                gs = lambda: F.grid_sample(src_nchw, g4, mode="bilinear", padding_mode="zeros",
                                           align_corners=False)
                times = {"kernel_ms": median_ms(call),
                         "plain_ms": median_ms(lambda: W.warp_video_plain(src, grid), reps=5),
                         "library_ms": median_ms(gs), "kernel_device_ms": dev_ms,
                         "library_device_ms": device_ms(gs)}
            nbytes = src.numel() * esz + grid.numel() * 4 + F_FRAMES * src.numel() * esz
            flops = 8 * F_FRAMES * src.numel()
            record("warp_video", [1, F_FRAMES, h, h, c], dname, res, per_video, times,
                   nbytes, flops, FP32_FLOPS, bit_equal_to_plain=equal,
                   device_launches_per_call=launches, other_device_launches_per_call=other)
    return totals


# ---------------------------------------------------------------- phases 3-4


@contextlib.contextmanager
def plain_ops():
    """Test hook for the parity phases: route the ops to their plain
    versions for the duration of one run (the port itself has no switch)."""
    from cvpr23_lfdm_torch.ops import attention as A
    from cvpr23_lfdm_torch.ops import warp as W

    saved = (A.fused_temporal_layer, A.fused_spatial_linear_layer, W.warp_video,
             A.headpacked_temporal_attention)
    A.fused_temporal_layer = A.fused_temporal_layer_plain
    A.fused_spatial_linear_layer = A.fused_spatial_linear_layer_plain
    W.warp_video = W.warp_video_plain
    A.headpacked_temporal_attention = A.headpacked_temporal_attention_plain
    try:
        yield
    finally:
        (A.fused_temporal_layer, A.fused_spatial_linear_layer, W.warp_video,
         A.headpacked_temporal_attention) = saved


NEW_KERNELS = ("packed_temporal_attention", "groupnorm_film_silu", "warp_onehot", "warp_gather",
               "fused_temporal_layer_ablate")


def counters() -> dict:
    from cvpr23_lfdm_torch.ops import read_counters

    return read_counters()


def reset_counters() -> None:
    from cvpr23_lfdm_torch import ops

    ops.reset_counters()


def serving_model(dtype: str, frames: int = F_FRAMES, impl: str = "pallas3"):
    import dataclasses

    from cvpr23_lfdm_torch.config import mug_config
    from cvpr23_lfdm_torch.utils.bench_ckpt import apply_bench_ckpt

    cfg = mug_config()
    cfg = cfg.replace(
        diffusion=dataclasses.replace(cfg.diffusion, sampling_timesteps=DDIM_STEPS,
                                      num_frames=frames, compute_dtype=dtype,
                                      temporal_attn_impl=impl),
        lfae=dataclasses.replace(cfg.lfae, compute_dtype=dtype),
    )
    return apply_bench_ckpt(os.path.join(ROOT, "assets", "bench_ckpt"), cfg)


def injected_noise(cfg, seed: int):
    """`[1, F, s, s, 3]` init and `[steps, 1, F, s, s, 3]` step noise from a
    legacy numpy RandomState (the stream `tests/test_torch_slice.py` uses)."""
    import torch

    d = cfg.diffusion
    shape = (1, d.num_frames, d.img_size, d.img_size, 3)
    rng = np.random.RandomState(seed)
    init = rng.standard_normal(shape).astype(np.float32)
    noise = rng.standard_normal((d.sampling_timesteps,) + shape).astype(np.float32)
    return torch.from_numpy(init).cuda(), torch.from_numpy(noise).cuda()


def run_serving(failures: list, timed_runs: int = 3, impl: str = "pallas3",
                phase: str = "serving", profiled: bool = False) -> tuple[dict, float]:
    """The video at B=1 under one UNet form: gates, launch counts, frames/s;
    with `profiled`, one more video under torch.profiler for its device busy
    time and the packed-attention kernel's share of it."""
    import torch

    cfg, model, cond, ref, meta = serving_model("bfloat16", impl=impl)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    sample = lambda: model.sample_video(ref, cond, 1.0, generator=gen)
    sample()  # warm-up: cuDNN autotuning, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    out = sample()
    torch.cuda.synchronize()
    launches = counters()
    want = {"fused_temporal_layer": 10 * DDIM_STEPS, "fused_spatial_linear_layer": 8 * DDIM_STEPS,
            "warp_video": 3, "headpacked_attention_fwd": 0, "headpacked_attention_bwd": 0,
            **dict.fromkeys(NEW_KERNELS, 0)}
    if impl != "pallas3":  # the other forms launch no fused layer
        want.update(fused_temporal_layer=0, fused_spatial_linear_layer=0,
                    packed_temporal_attention=10 * DDIM_STEPS if impl == "pallas" else 0)
    shapes = {k: list(v.shape) for k, v in out.items()}
    ov = out["out_vid"]
    s, h = cfg.diffusion.img_size, cfg.lfae.frame_shape
    checks = {
        "shapes_ok": shapes["out_vid"] == [1, F_FRAMES, h, h, 3]
        and shapes["vid_grid"] == [1, F_FRAMES, s, s, 2],
        "finite": all(torch_isfinite(v) for v in out.values()),
        "out_vid_in_unit_range": bool((ov >= 0).all() and (ov <= 1).all()),
        "launches_ok": launches == want,
    }
    lat = []
    for _ in range(timed_runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample()
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    med = float(np.median(lat))
    busy = {}
    if profiled:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sample()
            torch.cuda.synchronize()
        device = [r for r in profile_rows(prof) if r["on_device"]]
        busy = {"device_busy_ms": sum(r["device_ms"] for r in device),
                "packed_attention_device_ms": sum(r["device_ms"] for r in device
                                                  if "packed_attention" in r["name"])}
    emit({"phase": phase, "temporal_attn_impl": impl, "objective": meta["objective"], "dtype": "bfloat16",
          "shapes": shapes, "launches": launches, "launches_expected": want, **checks,
          "latency_s": lat, "median_latency_s": med, "frames_per_s": F_FRAMES / med, **busy,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30, "gpu": gpu_line()})
    for k, v in checks.items():
        if not v:
            failures.append(f"{phase} {impl} {k}")
    del model
    torch.cuda.empty_cache()
    return launches, med


def run_parity(failures: list) -> None:
    import torch

    cfg, model, cond, ref, _ = serving_model("float32")
    init, noise = injected_noise(cfg, seed=7)
    kern = model.sample_video(ref, cond, 1.0, init_img=init, noise_seq=noise)
    with plain_ops():
        plain = model.sample_video(ref, cond, 1.0, init_img=init, noise_seq=noise)
    line = {"phase": "parity", "what": "fp32 kernels vs plain on the card", "tol": PATH_TOL}
    for key in ("vid_grid", "vid_conf", "out_vid", "warped_vid"):
        line[f"{key}_max_abs"] = float((kern[key] - plain[key]).abs().max())
    line["ok"] = all(line[f"{k}_max_abs"] <= PATH_TOL for k in ("vid_grid", "vid_conf", "out_vid"))
    emit(line)
    if not line["ok"]:
        failures.append("parity kernels vs plain")
    del model, kern, plain

    golden = np.load(os.path.join(ROOT, "tests", "golden", "torch_port_mug_ddim10.npz"))
    frames = int(golden["num_frames"])
    cfg, model, cond, ref, _ = serving_model("float32", frames=frames)
    init, noise = injected_noise(cfg, seed=int(golden["seed"]))
    out = model.sample_video(ref, cond, 1.0, init_img=init, noise_seq=noise)
    keep = [int(i) for i in golden["frames"]]
    got = {"vid_grid": out["vid_grid"], "vid_conf": out["vid_conf"],
           "out_vid_frames": out["out_vid"][:, keep]}
    line = {"phase": "parity", "what": "fp32 on the card vs the JAX golden", "frames": frames,
            "tol": GOLDEN_TOL}
    for key, val in got.items():
        line[f"{key}_max_abs"] = float(np.abs(val.cpu().numpy() - golden[key]).max())
    line["ok"] = all(line[f"{k}_max_abs"] <= GOLDEN_TOL for k in got)
    emit(line)
    if not line["ok"]:
        failures.append("parity vs JAX golden")


def is_linear_layer(kernel_name: str) -> bool:
    """A device kernel of `csrc/fused_spatial_linear_layer.cu` (bf16 and fp32,
    and the names the file's kernels had before the bf16 ones were written
    for tensor cores)."""
    return any(k in kernel_name for k in ("linear_context_mma_kernel", "linear_output_mma_kernel",
                                          "context_kernel<", "output_kernel<"))


def run_profile(latency_s: float) -> None:
    """One serving video under torch.profiler: device time by kernel, and
    its sum over the unprofiled median latency of the serving phase."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    _, model, cond, ref, _ = serving_model("bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    model.sample_video(ref, cond, 1.0, generator=gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.sample_video(ref, cond, 1.0, generator=gen)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = profile_rows(prof)
    device = [r for r in rows if r["on_device"]]
    busy = sum(r["device_ms"] for r in device)
    report = {"phase": "profile", "wall_ms": wall_ms, "device_busy_ms": busy,
              "serving_latency_ms": latency_s * 1e3,
              "device_busy_share": busy / (latency_s * 1e3),
              "fused_temporal_layer_device_ms": sum(
                  r["device_ms"] for r in device if "fused_temporal_layer" in r["name"]),
              "fused_spatial_linear_layer_device_ms": sum(
                  r["device_ms"] for r in device if is_linear_layer(r["name"])),
              "top": device[:25]}
    os.makedirs(os.path.join(ROOT, "chip_smoke_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chip_smoke_out", "profile_serving.json"), "w") as f:
        json.dump({**report, "all": rows}, f, indent=1)
    emit({**report, "top": device[:12]})
    del model


# ---------------------------------------------------------------- training


def check_headpacked(failures: list) -> dict:
    """The head-packed attention kernels against the plain forward and
    backward at the training step's shapes; per-kernel totals over the
    calls of one step (bf16 times)."""
    import torch
    import torch.nn.functional as F

    from cvpr23_lfdm_torch.ops import attention as A

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)
    names = ("headpacked_attention_fwd", "headpacked_attention_bwd")
    totals = {n: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                  "device_ms": 0.0, "library_device_ms": 0.0,
                  "max_abs_err": 0.0, "bytes": 0.0, "flops": 0.0} for n in names}
    hd = HEADS * DH
    b, f = TRAIN_BATCH, F_FRAMES
    pos_bias = randn(HEADS, f, f)

    def run(fn, qkv, bias, cos_t, sin_t, do):
        q, bb = qkv.detach().requires_grad_(), bias.detach().requires_grad_()
        out = fn(q, bb, cos_t, sin_t, HEADS, DH)
        out.backward(do)
        return out.detach(), q.grad, bb.grad

    def emit_case(hw, dname, tag, res, times, bounds, per_step):
        for name in names:
            r = res[name]
            line = {"phase": "kernel", "name": name, "shape": [b, f, hw, 3 * hd] + tag,
                    "dtype": dname, **r}
            if not (r["ok"] and r["finite"]):
                failures.append(f"{name} {hw} {dname} {tag}")
            if times is not None:
                nbytes, flops = bounds[name]
                b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
                line.update(times[name], bound_ms=b_ms, bound_by=b_by, calls_per_step=per_step)
                t = totals[name]
                for key, src in (("ms", "kernel_ms"), ("plain_ms", "plain_ms"), ("library_ms", "library_ms"),
                                 ("device_ms", "kernel_device_ms"), ("library_device_ms", "library_device_ms")):
                    t[key] += per_step * times[name][src]
                t["bound_ms"] += per_step * b_ms
                t["bytes"] += per_step * nbytes
                t["flops"] += per_step * flops
                t["max_abs_err"] = max(t["max_abs_err"], r["max_abs_err"])
            emit(line)

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        timed = dtype == torch.bfloat16
        esz = 2 if timed else 4
        cos_t, sin_t = A.rotary_tables(f, HEADS, DH, DH ** -0.5, dtype, dev)
        cases = [(hw, n, False) for hw, n in HEADPACKED_SHAPES.items()] + [(256, 0, True)]
        for hw, per_step, focus in cases:
            qkv = randn(b, f, hw, 3 * hd).to(dtype)
            do = randn(b, f, hw, hd).to(dtype)
            mask = torch.tensor([True, False, True, False, False], device=dev) if focus else None
            bias = A.build_bias_flat(pos_bias, b, f, mask)
            out, dq, db = run(A.headpacked_temporal_attention, qkv, bias, cos_t, sin_t, do)
            pout, pdq, pdb = run(A.headpacked_temporal_attention_plain, qkv, bias, cos_t, sin_t, do)
            res = {names[0]: compare(out, pout, TOL[dname]),
                   names[1]: compare(dq, pdq, TOL[dname])}
            dtol = dict(DBIAS_TOL[dname])
            if dtype == torch.bfloat16:
                dtol["atol"] *= hw ** 0.5
            dbias = compare(db, pdb, dtol)
            res[names[1]].update(dbias_max_abs_err=dbias["max_abs_err"], dbias_tol=dtol,
                                 ok=res[names[1]]["ok"] and dbias["ok"],
                                 finite=res[names[1]]["finite"] and dbias["finite"])
            del pout, pdq, pdb, out, dq, db
            times = bounds = None
            if timed and not focus:
                units = b * hw * HEADS
                bounds = {names[0]: (b * f * hw * 4 * hd * esz + bias.numel() * 4, units * 4 * f * f * DH),
                          names[1]: (b * f * hw * 7 * hd * esz + 2 * bias.numel() * 4, units * 10 * f * f * DH)}
                # kernel and plain: forward alone; backward alone on a kept graph;
                # with `device`, also the device time alone of each (profiler)
                def timer(fn, reps, device=False):
                    q, bb = qkv.detach().requires_grad_(), bias.detach().requires_grad_()
                    fwd_fn = lambda: fn(q, bb, cos_t, sin_t, HEADS, DH)
                    with torch.no_grad():
                        fwd = median_ms(fwd_fn, reps=reps)
                        fwd_dev = device_ms(fwd_fn, reps) if device else None
                    o = fn(q, bb, cos_t, sin_t, HEADS, DH)
                    bwd_fn = lambda: torch.autograd.grad(o, (q, bb), do, retain_graph=True)
                    bwd = median_ms(bwd_fn, reps=reps)
                    return fwd, bwd, fwd_dev, device_ms(bwd_fn, reps) if device else None
                k_fwd, k_bwd, kd_fwd, kd_bwd = timer(A.headpacked_temporal_attention, 10, device=True)
                p_fwd, p_bwd, _, _ = timer(A.headpacked_temporal_attention_plain, 3)
                # library yardstick: SDPA on pre-rotated q, k, v [B*HW, heads, F, d],
                # the bias as an additive mask (the q-scale is in q already)
                with torch.no_grad():
                    x = qkv.float()
                    blk = (x * cos_t.float()[None, :, None]
                           + A.rotate_pairs(x) * sin_t.float()[None, :, None]).to(dtype)
                    q4, k4, v4 = (blk[..., i * hd:(i + 1) * hd].reshape(b, f, hw, HEADS, DH)
                                  .permute(0, 2, 3, 1, 4).reshape(b * hw, HEADS, f, DH).contiguous()
                                  for i in range(3))
                    m4 = (bias.reshape(b, 1, f, HEADS, f).permute(0, 1, 3, 2, 4)
                          .expand(b, hw, HEADS, f, f).reshape(b * hw, HEADS, f, f).to(dtype).contiguous())
                    do4 = do.reshape(b, f, hw, HEADS, DH).permute(0, 2, 3, 1, 4).reshape(
                        b * hw, HEADS, f, DH).contiguous()
                    del x, blk
                    sdpa = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4, scale=1.0)
                    l_fwd, ld_fwd = median_ms(sdpa, reps=10), device_ms(sdpa)
                qg, kg, vg = (t.requires_grad_() for t in (q4, k4, v4))
                o4 = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=m4, scale=1.0)
                sdpa_bwd = lambda: torch.autograd.grad(o4, (qg, kg, vg), do4, retain_graph=True)
                l_bwd, ld_bwd = median_ms(sdpa_bwd, reps=10), device_ms(sdpa_bwd)
                lib_err = float((o4.detach().permute(0, 2, 1, 3).reshape(b, hw, f, hd).transpose(1, 2).float()
                                 - A.headpacked_temporal_attention(qkv, bias, cos_t, sin_t, HEADS, DH).float()
                                 ).abs().max())
                del o4, qg, kg, vg, q4, k4, v4, m4, do4
                times = {names[0]: {"kernel_ms": k_fwd, "plain_ms": p_fwd, "library_ms": l_fwd,
                                    "kernel_device_ms": kd_fwd, "library_device_ms": ld_fwd,
                                    "library_max_abs_diff": lib_err},
                         names[1]: {"kernel_ms": k_bwd, "plain_ms": p_bwd, "library_ms": l_bwd,
                                    "kernel_device_ms": kd_bwd, "library_device_ms": ld_bwd}}
            emit_case(hw, dname, ["focus"] if focus else [], res, times, bounds, per_step)
            torch.cuda.empty_cache()
    return totals


def training_setup(dtype: str, batch: int, seed: int = 0):
    """The MUG trainer at full width on the bench checkpoint (UNet and
    generator encoder; seeded motion modules), a seeded batch and one fixed
    draw of (t, noise, null mask)."""
    import dataclasses

    import torch

    from cvpr23_lfdm_torch.config import mug_config
    from cvpr23_lfdm_torch.train.dm_trainer import DMTrainer
    from cvpr23_lfdm_torch.utils.bench_ckpt import apply_bench_ckpt

    cfg = mug_config()
    cfg = cfg.replace(diffusion=dataclasses.replace(cfg.diffusion, compute_dtype=dtype,
                                                    temporal_attn_impl="pallas2"))
    cfg, model, _, _, meta = apply_bench_ckpt(
        os.path.join(ROOT, "assets", "bench_ckpt"), cfg, training=True, lfae_seed=seed)
    trainer = DMTrainer(cfg, steps_per_epoch=93, model=model)
    rng = np.random.RandomState(seed + 1)
    d, s = cfg.diffusion, cfg.lfae.frame_shape
    vid = rng.uniform(size=(batch, d.num_frames, s, s, 3)).astype(np.float32)
    data = {"ref_img": vid[:, 0].copy(), "real_vid": vid,
            "cond": rng.standard_normal((batch, d.cond_dim)).astype(np.float32),
            "none_cond_mask": np.zeros(batch, bool)}
    data = {k: torch.from_numpy(v).cuda() for k, v in data.items()}
    draws = {
        "t": torch.from_numpy(rng.randint(0, d.timesteps, size=batch)).cuda(),
        "noise": torch.from_numpy(rng.standard_normal(
            (batch, d.num_frames, d.img_size, d.img_size, 3)).astype(np.float32)).cuda(),
        "null_mask": torch.from_numpy(rng.uniform(size=batch) < d.null_cond_prob).cuda(),
    }
    return cfg, trainer, data, draws, meta


def run_training(failures: list) -> tuple[dict, float]:
    import torch

    batch = TRAIN_BATCH
    cfg, trainer, data, draws, meta = training_setup("bfloat16", batch)
    unet = trainer.model.unet
    before = {n: p.detach().clone() for n, p in unet.named_parameters()}
    state = trainer.init_state()
    torch.cuda.reset_peak_memory_stats()
    losses, grad_norms, secs = [], [], []
    launches = None
    for i in range(7):  # 2 warm-up + 5 timed; the first timed step is the counted one
        if i == 2:
            reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, None, data, **draws)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if i == 2:
            launches = counters()
        losses.append(float(m["loss"]))
        grad_norms.append(float(m["grad_norm"]))
        if i >= 2:
            secs.append(dt)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    bad_grads = [n for n, p in unet.named_parameters() if p.requires_grad and (
        p.grad is None or not torch_isfinite(p.grad) or float(p.grad.abs().max()) == 0.0)]
    unmoved = [n for n, p in unet.named_parameters() if torch.equal(p.detach(), before[n])]
    want = {"fused_temporal_layer": 0, "fused_spatial_linear_layer": 0, "warp_video": 1,
            "headpacked_attention_fwd": 10, "headpacked_attention_bwd": 10,
            **dict.fromkeys(NEW_KERNELS, 0)}
    checks = {
        "finite": bool(np.isfinite(losses).all() and np.isfinite(grad_norms).all()),
        "launches_ok": launches == want,
        "every_parameter_has_a_gradient": not bad_grads,
        "parameters_moved": not unmoved,
        "null_cond_emb_only_if_learned": hasattr(unet, "null_cond_emb") == cfg.diffusion.learn_null_cond,
    }
    med = float(np.median(secs))
    emit({"phase": "train", "config": "mug", "objective": meta["objective"], "dtype": "bfloat16",
          "lfae_dtype": cfg.lfae.compute_dtype, "batch": batch, "frames": F_FRAMES,
          "lr": cfg.dm_train.lr, "betas": list(cfg.dm_train.adam_betas),
          "launches_per_step": launches, "launches_expected": want, **checks,
          "bad_grads": bad_grads[:5], "unmoved": unmoved[:5],
          "loss_fixed_batch_7_steps": losses, "grad_norm_7_steps": grad_norms,
          "step_s": secs, "median_step_s": med, "videos_per_s": batch / med,
          "peak_mem_gb": peak, "gpu": gpu_line()})
    for k, v in checks.items():
        if not v:
            failures.append(f"train {k}")

    # one monitoring step: adds the decode of the predicted x0 (3 warps) and
    # the pseudo-ground-truth reconstruction (3 warps)
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = trainer.train_step(state, None, data, with_monitoring=True, **draws)
    torch.cuda.synchronize()
    mon = {"phase": "train", "what": "monitoring step", "step_s": time.perf_counter() - t0,
           "launches": counters(), "rec_loss": float(m["rec_loss"]),
           "rec_warp_loss": float(m["rec_warp_loss"]), "loss": float(m["loss"])}
    mon["ok"] = bool(np.isfinite([mon["rec_loss"], mon["rec_warp_loss"], mon["loss"]]).all()
                     and mon["launches"]["warp_video"] == 7
                     and mon["launches"]["headpacked_attention_fwd"] == 10)
    emit(mon)
    if not mon["ok"]:
        failures.append("train monitoring step")

    train_breakdown(trainer, data, draws, med)
    del trainer
    torch.cuda.empty_cache()
    return launches, med


def train_breakdown(trainer, data, draws, step_s: float) -> None:
    """Where one step's time goes: its parts timed with CUDA events (a
    synchronise between parts), then one step under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cvpr23_lfdm_torch.train.dm_trainer import DMTrainState

    model = trainer.model

    def timed(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    parts = {k: [] for k in ("pseudo_gt_ms", "unet_forward_loss_ms", "backward_ms", "adam_ms")}
    for _ in range(3):
        trainer.optimizer.zero_grad()
        gt, ms = timed(lambda: model.pseudo_ground_truth(data["ref_img"], data["real_vid"], with_decode=False))
        parts["pseudo_gt_ms"].append(ms)
        x_start = model.encode_latent(gt["vid_grid"], gt["vid_conf"])
        (loss, _), ms = timed(lambda: model.diffusion.p_losses(
            model.denoise, x_start, gt["ref_fea"], data["cond"], data["none_cond_mask"], **draws))
        parts["unet_forward_loss_ms"].append(ms)
        _, ms = timed(loss.backward)
        parts["backward_ms"].append(ms)
        _, ms = timed(lambda: trainer.optimizer.step(0))
        parts["adam_ms"].append(ms)
    line = {"phase": "train", "what": "parts of one step (CUDA events, median of 3)",
            **{k: float(np.median(v)) for k, v in parts.items()}, "median_step_ms": step_s * 1e3}
    emit(line)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(DMTrainState(step=0), None, data, **draws)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = profile_rows(prof)
    device = [r for r in rows if r["on_device"]]
    busy = sum(r["device_ms"] for r in device)
    report = {"phase": "profile", "what": "one training step", "wall_ms": wall_ms,
              "device_busy_ms": busy, "step_ms": step_s * 1e3,
              "device_busy_share": busy / (step_s * 1e3), "top": device[:25]}
    os.makedirs(os.path.join(ROOT, "chip_smoke_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chip_smoke_out", "profile_train.json"), "w") as f:
        json.dump({**report, "all": rows}, f, indent=1)
    emit({**report, "top": device[:14]})


def profile_rows(prof) -> list:
    from cvpr23_lfdm_torch.utils.profiling import profile_rows as rows

    return rows(prof)


def run_train_parity(failures: list) -> None:
    """One fp32 step (B=2) with the kernels and with the plain versions from
    the same weights and draws; and the kernel step twice, bit for bit."""
    import torch

    from cvpr23_lfdm_torch.train.dm_trainer import DMTrainState

    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        _, trainer, data, draws, _ = training_setup("float32", 2, seed=3)
        weights = {k: v.detach().clone() for k, v in trainer.model.unet.state_dict().items()}

        def step():
            trainer.model.unet.load_state_dict(weights)
            trainer.init_state()
            _, m = trainer.train_step(DMTrainState(step=0), None, data, **draws)
            grads = {n: p.grad.detach().clone() for n, p in trainer.model.unet.named_parameters()}
            return float(m["loss"]), float(m["grad_norm"]), grads

        loss_a, norm_a, grads_a = step()
        loss_b, norm_b, grads_b = step()
        with plain_ops():
            loss_p, norm_p, grads_p = step()
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    identical = loss_a == loss_b and all(torch.equal(grads_a[n], grads_b[n]) for n in grads_a)
    scale = max(float(g.abs().max()) for g in grads_p.values())
    worst = max(float((grads_a[n] - grads_p[n]).abs().max()) for n in grads_a)
    tol = TRAIN_PARITY_TOL
    line = {"phase": "train parity", "what": "fp32 step, kernels vs plain on the card", "batch": 2,
            "loss": loss_a, "loss_plain": loss_p, "grad_norm": norm_a, "grad_norm_plain": norm_p,
            "grad_max_abs_diff": worst, "grad_max_abs": scale, "tol": tol,
            "bit_identical_twice": bool(identical)}
    line["ok"] = bool(
        abs(loss_a - loss_p) <= tol["loss_rel"] * abs(loss_p)
        and abs(norm_a - norm_p) <= tol["grad_norm_rel"] * norm_p
        and worst <= tol["grad_max_abs_rel"] * scale and identical)
    emit(line)
    if not line["ok"]:
        failures.append("train parity")
    del trainer
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- LFAE (stage-1) training


def lfae_trainer(seed: int = 0):
    """`LFAETrainer` at the MUG config's full widths (fp32), the three nets
    from `seed_lfae_weights(seed)`, the VGG19 from `seed_vgg_weights(seed)`."""
    from cvpr23_lfdm_torch.config import mug_config
    from cvpr23_lfdm_torch.train.lfae_trainer import LFAETrainer

    cfg = mug_config()
    trainer = LFAETrainer(cfg, steps_per_epoch=LFAE_STEPS_PER_EPOCH, device="cuda", vgg_seed=seed)
    return cfg, trainer, trainer.init_state(seed=seed)


def lfae_batch(cfg, batch: int, seed: int) -> dict:
    import torch

    rng = np.random.RandomState(seed)
    s = cfg.lfae.frame_shape
    return {k: torch.from_numpy(rng.uniform(size=(batch, s, s, 3)).astype(np.float32)).cuda()
            for k in ("source", "driving")}


KERNEL_GROUPS = (  # (group, parts of device kernel names), first match wins
    ("grid_sample", ("grid_sampler",)),
    ("conv_gemm", ("xmma", "cudnn", "fft", "implicit_gemm", "region_transform", "gemm", "gemv",
                   "dgrad", "wgrad", "cutlass", "flip_filter", "nchwToNhwc", "nhwcToNchw")),
    ("adam", ("multi_tensor", "foreach", "adam")),
    ("reduction", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("copy", ("Memcpy", "Memset", "copy")),
)


def device_groups(rows) -> dict:
    """Device ms and launches of a profile's device rows by kind of kernel
    (`KERNEL_GROUPS`; `other` for the rest)."""
    out = {}
    for r in rows:
        name = next((g for g, keys in KERNEL_GROUPS if any(k in r["name"] for k in keys)), "other")
        entry = out.setdefault(name, {"device_ms": 0.0, "launches": 0})
        entry["device_ms"] += r["device_ms"]
        entry["launches"] += r["count"]
    return out


def run_lfae_train(failures: list) -> None:
    """`LFAETrainer.train_step` at the recipe's batch: timed steps, gates,
    a profiled step, the training warp's two candidates at the step's
    shapes, then `reconstruct` (eval) on the same batch through row 3."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cvpr23_lfdm_torch.scripts import bench_train_warp
    from cvpr23_lfdm_torch.train.dm_trainer import step_generator

    batch = LFAE_BATCH
    cfg, trainer, state = lfae_trainer()
    data = lfae_batch(cfg, batch, seed=1)
    model = trainer.model
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: b.detach().clone() for n, b in model.named_buffers()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, secs, launches = [], [], None
    for i in range(7):  # 2 warm-up + 5 timed; the first timed step is the counted one
        if i == 2:
            reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, step_generator(0, state.step, trainer.device), data)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if i == 2:
            launches = counters()
        metrics.append({k: float(v) for k, v in m.items()})
        if i >= 2:
            secs.append(dt)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    unmoved = [n for n, p in model.named_parameters() if torch.equal(p.detach(), params0[n])]
    stats_unmoved = [n for n, b in model.named_buffers() if torch.equal(b, stats0[n])]
    checks = {
        "finite": bool(np.isfinite([v for m in metrics for v in m.values()]).all()),
        "every_parameter_moved": not unmoved,
        "batch_stats_moved": not stats_unmoved,
        "step_counter": state.step == 7,
        # training warps by path: no forward-only kernel runs in a train step
        "no_kernel_launch_in_train_mode": launches is not None and not any(launches.values()),
    }
    med = float(np.median(secs))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = trainer.train_step(state, step_generator(0, state.step, trainer.device), data)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = profile_rows(prof)
    device = [r for r in rows if r["on_device"]]
    busy = sum(r["device_ms"] for r in device)
    os.makedirs(os.path.join(ROOT, "chip_smoke_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chip_smoke_out", "profile_lfae_train.json"), "w") as f:
        json.dump({"wall_ms": wall_ms, "device_busy_ms": busy, "all": rows}, f, indent=1)
    emit({"phase": "lfae train", "config": "mug", "dtype": "float32 (TF32 off)", "batch": batch,
          "frame": cfg.lfae.frame_shape, "regions": cfg.lfae.num_regions,
          "lr": cfg.lfae_train.lr, "scales": list(cfg.lfae_train.scales), **checks,
          "unmoved": unmoved[:5], "stats_unmoved": stats_unmoved[:5],
          "kernel_launches_per_step": launches, "losses_7_steps": metrics,
          "step_s": secs, "median_step_s": med, "frames_per_s": batch / med, "peak_mem_gb": peak,
          "profiled_step": {"wall_ms": wall_ms, "device_busy_ms": busy,
                            "device_busy_share_of_its_wall": busy / wall_ms,
                            "device_launches": sum(r["count"] for r in device),
                            "by_group": device_groups(device), "top": device[:10]},
          "gpu": gpu_line()})
    for k, v in checks.items():
        if not v:
            failures.append(f"lfae train {k}")

    # the differentiable warp's two candidates at the step's shapes (forward + backward)
    total = {"plain": 0.0, "train_warp": 0.0}
    for case in bench_train_warp.STEP_WARPS:
        row = bench_train_warp.run_case(batch, case, torch.device("cuda"), iters=5)
        for key in total:
            total[key] += row.get(f"{key}_fwd_bwd_ms", row[f"{key}_fwd_ms"])
        emit({"phase": "lfae train", "what": "training warp", **row})
        torch.cuda.empty_cache()
    emit({"phase": "lfae train", "what": "training warp per step (ms, CUDA events)", "batch": batch,
          "per_step_ms": total, "used": "train_warp", "gpu": gpu_line()})

    # eval reconstruction on the same batch: row 3 in the generator's decode
    # and the pixelwise predictor's deformed source
    reset_counters()
    out = trainer.reconstruct(state, data["source"], data["driving"])
    torch.cuda.synchronize()
    rec_launches = counters()
    with plain_ops():
        plain = trainer.reconstruct(state, data["source"], data["driving"])
    err = float((out["prediction"] - plain["prediction"]).abs().max())
    rec_ms = median_ms(lambda: trainer.reconstruct(state, data["source"], data["driving"]), reps=5)
    line = {"phase": "lfae train", "what": "reconstruct (eval) on the same batch", "batch": batch,
            "warp_video_launches_per_call": rec_launches["warp_video"],
            "launches": rec_launches, "prediction_max_abs_vs_plain": err, "tol": RECON_TOL,
            "finite": torch_isfinite(out["prediction"]), "ms": rec_ms}
    line["ok"] = bool(rec_launches["warp_video"] >= 1 and err <= RECON_TOL and line["finite"])
    emit(line)
    if not line["ok"]:
        failures.append("lfae reconstruct")
    del trainer, model, out, plain
    torch.cuda.empty_cache()


def run_lfae_parity(failures: list) -> None:
    """One fp32 step (B=2, TF32 off) from the golden's seeded weights, batch
    and TPS parameters, held against the JAX package's run of the same
    (`tests/golden/torch_port_lfae_step.npz`): the train-mode forward's
    prediction and region parameters, the losses of step 1 and of the
    forward after one Adam update."""
    import torch

    from cvpr23_lfdm_torch.train.losses import TPSTransform

    g = np.load(LFAE_GOLDEN)
    cfg, trainer, state = lfae_trainer(seed=int(g["weight_seed"]))
    cuda = lambda k: torch.from_numpy(g[k]).cuda()
    data = {"source": cuda("source"), "driving": cuda("driving")}
    transform = TPSTransform.from_params(cuda("theta"), cuda("control_params"),
                                         cfg.lfae_train.points_tps)
    trainer.model.train()
    with torch.no_grad():
        _, out = trainer.losses(None, data["source"], data["driving"], transform)
        out["source_region_params"] = trainer.model.region_predictor(data["source"])
    tol = LFAE_GOLDEN_TOL
    got = {k: (out[k], tol[k]) for k in ("prediction", "optical_flow", "occlusion_map")}
    for who in ("source", "driving", "transformed"):
        for k in ("shift", "affine"):
            got[f"{who}_{k}"] = (out[f"{who}_region_params"][k], tol["region"])
    state, m1 = trainer.train_step(state, None, data, transform=transform)
    state, m2 = trainer.train_step(state, None, data, transform=transform)
    line = {"phase": "lfae train", "what": "fp32 step on the card vs the JAX golden", "batch": 2,
            "tol": tol}
    ok = True
    for k, (v, atol) in got.items():
        err = float(np.abs(v.cpu().numpy() - g[k]).max())
        line[f"{k}_max_abs"] = err
        ok &= err <= atol
    for step, m in (("step1", m1), ("step2", m2)):
        for k, v in m.items():
            want = float(g[f"{step}_{k}"])
            rel = abs(float(v) - want) / abs(want)
            line[f"{step}_{k}"] = [float(v), want, rel]
            ok &= rel <= (tol["step1_rel"] if step == "step1" else tol["step2_rel"][k])
    line["ok"] = bool(ok)
    emit(line)
    if not ok:
        failures.append("lfae parity vs JAX golden")
    del trainer
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- UNet forms and bench scripts


def check_new_kernels(failures: list) -> dict:
    """The packed attention, the fused norm and the warp+blend against
    their plain versions; per-kernel totals (bf16 times; the warp in fp32,
    the type its kernel works in): the packed attention over the calls of
    one serving video, the norm over the calls of one UNet eval. The
    warp+blend calls here (three blends, two shapes) are lines of their own;
    that kernel's totals are the folded calls of `check_folded_warps`."""
    import torch
    import torch.nn.functional as F

    from cvpr23_lfdm_torch.ops import attention as A
    from cvpr23_lfdm_torch.ops import norm as N
    from cvpr23_lfdm_torch.ops import warp as W
    from cvpr23_lfdm_torch.scripts.bench_norm import NORM_SHAPES, device_reading, one_launch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)
    rand = lambda *s: torch.rand(*s, generator=gen, device=dev)
    totals = _totals(("packed_temporal_attention", "groupnorm_film_silu", "warp_onehot", "warp_gather"))
    hd, f = HEADS * DH, F_FRAMES
    pos_bias = randn(HEADS, f, f)

    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            timed = dtype == torch.bfloat16
            esz = 2 if timed else 4

            # ---- row 6: packed attention at the serving shapes (B=1) + a focus case
            cases = [(1, hw, n, False) for hw, n in HEADPACKED_SHAPES.items()] + [(2, 256, 0, True)]
            for b, hw, n_eval, focus in cases:
                qkv = randn(b, hw, f, 3 * hd).to(dtype)
                pack = A.pick_pack(hw, f)
                mask = torch.tensor([True, False], device=dev) if focus else None
                bias = A.build_bias(pos_bias, b, pack, f, mask)
                args = (qkv, bias, HEADS, DH, pack)
                call = lambda: A.packed_temporal_attention(*args)
                out = call()
                res = compare(out, A.packed_temporal_attention_plain(*args), TOL[dname])
                same = bool(torch.equal(out, call()))  # no atomics: the same bits when run again
                res["ok"] = res["ok"] and same
                times, extra = None, {"bit_identical_twice": same}
                if timed and not focus:
                    q4, k4, v4 = (qkv[..., i * hd:(i + 1) * hd].reshape(b * hw, f, HEADS, DH)
                                  .transpose(1, 2).contiguous() for i in range(3))
                    m4 = pos_bias[None].to(dtype).contiguous()  # [1, heads, F, F], broadcast
                    sdpa = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4, scale=1.0)
                    times = {"kernel_ms": median_ms(call),
                             "plain_ms": median_ms(lambda: A.packed_temporal_attention_plain(*args), reps=5),
                             "library_ms": median_ms(sdpa),
                             "kernel_device_ms": device_ms(call, launches=1),
                             "library_device_ms": device_ms(sdpa)}
                    lib = sdpa().transpose(1, 2).reshape(b, hw, f, hd)
                    extra["library_max_abs_diff"] = float((lib.float() - out.float()).abs().max())
                    del q4, k4, v4, lib
                # of the bias the function needs the [heads, F, F] table and one focus flag per
                # batch entry, not the packed [B, heads, P*F, P*F] tensor that carries them
                nbytes = (qkv.numel() + out.numel()) * esz + HEADS * f * f * 4 + b
                flops = b * hw * HEADS * 4 * f * f * DH
                _record(totals, failures, "packed_temporal_attention",
                        [b, hw, f, 3 * hd] + (["focus"] if focus else []), dname, res,
                        n_eval * DDIM_STEPS, times, nbytes, flops, **extra)
                del qkv, bias, out

            # ---- row 7: fused norm at every Block shape of a serving eval, FiLM and none;
            # then B=8 at (32², 64), whose 42 MB do not fit the blocks' shared memory
            # (read twice; off the B=1 eval, a line of its own)
            cases = [(1, h, c, film, n_eval) for (h, c), counts in NORM_SHAPES.items()
                     for film, n_eval in zip((True, False), counts)]
            for b, h, c, film, n_eval in cases + [(8, 32, 64, True, 0)]:
                x = (1.5 * randn(b, f, h, h, c) + 0.3).to(dtype)
                gamma, beta = 1 + 0.3 * randn(c), 0.2 * randn(c)
                # the FiLM pair as the UNet passes it: halves of one [B, 1, 1, 1, 2C] tensor
                ss = randn(b, 1, 1, 1, 2 * c).to(dtype).chunk(2, dim=-1) if film else ()
                call = lambda: N.groupnorm_film_silu(x, gamma, beta, *ss)
                out = call()
                res = compare(out, N.groupnorm_film_silu_plain(x, gamma, beta, *ss), TOL[dname])
                same = bool(torch.equal(out, call()))
                dev_ms, launches, other = device_reading(call)
                res["ok"] = res["ok"] and same and one_launch(launches, other)
                times = None
                if timed:
                    times = {"kernel_ms": median_ms(call),
                             "plain_ms": median_ms(lambda: N.groupnorm_film_silu_plain(
                                 x, gamma, beta, *ss), reps=5),
                             "library_ms": None, "kernel_device_ms": dev_ms, "library_device_ms": None}
                nbytes = 2 * x.numel() * esz + 2 * c * 4 + 2 * b * c * film * esz
                _record(totals, failures, "groupnorm_film_silu", [b, f, h, h, c], dname, res,
                        n_eval, times, nbytes, 10 * x.numel(), FP32_FLOPS,
                        film=film, bit_identical_twice=same, device_launches_per_call=launches,
                        other_device_launches_per_call=other)
                del x, out

            # ---- rows 8+9: warp + blend, both names, three blends, two shapes
            for name, fn in (("warp_onehot", W.warp_onehot), ("warp_gather", W.warp_gather)):
                for b, h, w, c in BLEND_SHAPES:
                    img = randn(b, h, w, c).to(dtype)
                    lin_x, lin_y = torch.linspace(-1, 1, w, device=dev), torch.linspace(-1, 1, h, device=dev)
                    ident = torch.stack(torch.meshgrid(lin_x, lin_y, indexing="xy"), -1)
                    grid = (ident[None] + 0.3 * randn(b, h, w, 2)).contiguous()
                    occ, prev = rand(b, h, w, 1).to(dtype), randn(b, h, w, c).to(dtype)
                    for blend, extra_args in (("none", ()), ("occlusion", (occ,)), ("previous", (occ, prev))):
                        args = (img, grid, *extra_args)
                        res = compare(fn(*args), W.warp_blend_plain(*args), WARP_TOL["float32"])
                        times = None
                        if not timed:  # the kernel works in fp32: time it there, without the casts
                            times = {"kernel_ms": median_ms(lambda: fn(*args)),
                                     "plain_ms": median_ms(lambda: W.warp_blend_plain(*args), reps=5),
                                     "library_ms": None,
                                     "kernel_device_ms": device_ms(lambda: fn(*args), launches=1),
                                     "library_device_ms": None}
                            if blend == "none":
                                nchw = img.permute(0, 3, 1, 2)
                                gs = lambda: F.grid_sample(
                                    nchw, grid, mode="bilinear", padding_mode="zeros", align_corners=False)
                                times.update(library_ms=median_ms(gs), library_device_ms=device_ms(gs, launches=1))
                        n_in = img.numel() + grid.numel() + sum(t.numel() for t in extra_args)
                        _record(totals, failures, name, [b, h, w, c], dname, res, 0, times,
                                (n_in + img.numel()) * 4, (8 + 3 * len(extra_args)) * img.numel(),
                                FP32_FLOPS, blend=blend)
                    del img, grid, occ, prev
            torch.cuda.empty_cache()
    return totals


def run_forms_parity(failures: list) -> None:
    from cvpr23_lfdm_torch.scripts import check_kernel_parity

    res = check_kernel_parity.run("float32", ("xla", "pallas", "pallas3"))
    emit({"phase": "forms parity", "what": "fp32 video (TF32 off) under xla, pallas, pallas3: "
          "same weights, same injected noise, max-abs per output against xla", **res})
    if not res["ok"]:
        failures.append("forms parity")


def norm_calls(net, inputs) -> list:
    """The arguments of every fused-norm call of one eval of `net`."""
    import torch

    from cvpr23_lfdm_torch.ops import norm as N

    calls, real = [], N.groupnorm_film_silu

    def recorded(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    # the UNet's Blocks call it through the module, and it counts its launches on
    # the module's name: the recorder carries the count while it stands there
    recorded.launches = real.launches
    N.groupnorm_film_silu = recorded
    try:
        with torch.no_grad():
            net(**inputs)
    finally:
        N.groupnorm_film_silu = real
        real.launches = recorded.launches
    return calls


def run_fused_norm(failures: list) -> dict:
    """One full-width UNet eval (bench checkpoint, bf16, `pallas3`) with and
    without the fused norm, through the port's `bench_unet`; returns the
    launch counts of one fused eval at B=1."""
    import torch

    from cvpr23_lfdm_torch.ops import norm as N
    from cvpr23_lfdm_torch.scripts import bench_unet
    from cvpr23_lfdm_torch.scripts.bench_norm import BLOCKS_PER_EVAL, device_reading, one_launch

    dev = torch.device("cuda")
    nets = {fused: bench_unet.make_unet("pallas3", fused, "bfloat16", dev) for fused in (False, True)}
    launches = None
    for b in FUSED_NORM_BATCHES:
        inputs = bench_unet.make_inputs(nets[True], b, F_FRAMES, 32, dev)
        reset_counters()
        with torch.no_grad():
            out_fused = nets[True](**inputs)
        counted = counters()
        # every device launch of the eval's norm calls, casts and copies included:
        # the recorded calls replayed under the profiler (which late in a long
        # process loses some kernels, never adds one)
        calls = norm_calls(nets[True], inputs)
        with torch.no_grad():
            replay_ms, norm_launches, other = device_reading(
                lambda: [N.groupnorm_film_silu(*a, **k) for a, k in calls], reps=3)
        del calls
        if b == 1:
            launches = counted
        # read in turns: unfused, fused, fused, unfused
        readings = {False: [], True: []}
        for fused in (False, True, True, False):
            res, out = bench_unet.bench(nets[fused], inputs, dev)
            readings[fused].append(res)
            if not fused:
                out_plain = out
        plain, fused = readings[False][-1], readings[True][-1]
        # the kernel's own device time in one eval (the per-call timings above
        # it include the wrapper's host work, which is larger at these sizes)
        rows = bench_unet.trace(nets[True], inputs, top=10 ** 6)
        gn_device_ms = sum(r["device_ms"] for r in rows if "groupnorm_film_silu_kernel" in r["name"])
        diff = (out_fused - out_plain).abs()
        scale = float(out_plain.abs().max())
        tol = FUSED_NORM_TOL
        checks = {
            "finite": torch_isfinite(out_fused) and torch_isfinite(out_plain),
            "launches_ok": counted["groupnorm_film_silu"] == BLOCKS_PER_EVAL
            and fused["launches_per_eval"]["groupnorm_film_silu"] == BLOCKS_PER_EVAL
            and plain["launches_per_eval"]["groupnorm_film_silu"] == 0
            and counted["fused_temporal_layer"] == 10 and counted["fused_spatial_linear_layer"] == 8
            and one_launch(norm_launches, other, BLOCKS_PER_EVAL),
            "norm_device_time_read": bool(gn_device_ms),
            "close": float(diff.max()) <= tol["max_rel"] * scale
            and float(diff.mean()) <= tol["mean_rel"] * scale,
        }
        emit({"phase": "fused norm", "batch": b, "dtype": "bfloat16", "attn": "pallas3",
              "unet_eval_ms_fused": [r["median_ms"] for r in readings[True]],
              "unet_eval_ms_unfused": [r["median_ms"] for r in readings[False]],
              "groupnorm_device_ms_per_eval": gn_device_ms,
              "norm_calls_replayed": {"device_ms_per_eval": replay_ms, "device_launches_per_eval": norm_launches,
                                      "other_device_launches_per_eval": other},
              "max_abs_diff": float(diff.max()), "mean_abs_diff": float(diff.mean()),
              "out_max_abs": scale, "tol": tol, "launches_per_eval": counted, **checks,
              "gpu": gpu_line()})
        for k, v in checks.items():
            if not v:
                failures.append(f"fused norm B={b} {k}")
    del nets
    return launches


def run_ablate(failures: list) -> tuple[dict, dict]:
    """The port's `bench_attn_ablate` at the serving hot shape; `full` held
    against the plain layer. Returns the launch counts and `full`'s entry
    for the `kernels` line."""
    import torch

    from cvpr23_lfdm_torch.ops import attention as A
    from cvpr23_lfdm_torch.scripts import bench_attn_ablate

    reset_counters()
    rows = bench_attn_ablate.run(shape=ABLATE_SHAPE)
    launches = counters()
    full = rows[0]
    args = bench_attn_ablate.make_args(ABLATE_SHAPE)
    with torch.no_grad():
        res = compare(A.fused_temporal_layer_ablated("full", *args),
                      A.fused_temporal_layer_plain(*args), TOL["bfloat16"])
        plain_ms = median_ms(lambda: A.fused_temporal_layer_plain(*args), reps=3, warmup=1)
    b, f, hw, c = ABLATE_SHAPE
    hd = HEADS * DH
    x, _, wqkv, wout, bias, cos_t = args[:6]
    nbytes = (2 * x.numel() + wqkv.numel() + wout.numel() + 2 * cos_t.numel()) * 2 + (c + bias.numel()) * 4
    flops = b * (2 * f * hw * c * 4 * hd + 4 * hw * HEADS * f * f * DH)
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
    ok = bool(full["bit_equal_to_serving_kernel"] and res["ok"] and res["finite"]
              and launches["fused_temporal_layer_ablate"] > 0)
    emit({"phase": "ablate", "shape": list(ABLATE_SHAPE), "dtype": "bfloat16", "variants": rows,
          "full_vs_plain": res, "launches": launches["fused_temporal_layer_ablate"], "ok": ok,
          "gpu": gpu_line()})
    if not ok:
        failures.append("ablate")
    entry = {"ms": full["layer_ms"], "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": None, "max_abs_err": res["max_abs_err"]}
    return launches, entry


def check_folded_warps(failures: list, totals: dict) -> None:
    """The folded warp+blend calls of the `bench_warp` run (phase 12:
    `warp_onehot` at the three decode scales, `warp_gather` at the largest;
    blend none, the shared source repeated over the frames), made from the
    script's seeded inputs: elementwise against the plain version on the bf16
    inputs, timed on their fp32 casts beside the plain version and
    `F.grid_sample` on the same repeated source, with the device times alone
    of the kernel and `F.grid_sample`. These calls are the two kernels'
    totals. (Run early: in the last phase of a full run the profiler has
    lost kernels.)"""
    import torch
    import torch.nn.functional as F

    from cvpr23_lfdm_torch.ops import warp as W
    from cvpr23_lfdm_torch.scripts import bench_warp

    dev = torch.device("cuda")
    b, f = BLEND_SHAPES[0][0], F_FRAMES
    big = bench_warp.DECODE_SCALES[-1]
    with torch.no_grad():
        for s, c in bench_warp.DECODE_SCALES:
            image, grid5 = bench_warp.make_case(b, f, s, c, torch.bfloat16, dev)
            img, grid = image.repeat_interleave(f, dim=0), grid5.reshape(b * f, s, s, 2)
            ref = W.warp_blend_plain(img, grid)
            img32 = img.float()
            nchw = img32.permute(0, 3, 1, 2)
            gs = lambda: F.grid_sample(nchw, grid, mode="bilinear", padding_mode="zeros", align_corners=False)
            shared = {"plain_ms": median_ms(lambda: W.warp_blend_plain(img32, grid), reps=3, warmup=1),
                      "library_ms": median_ms(gs, reps=5),
                      "library_device_ms": device_ms(gs, reps=5, launches=1)}
            names = [("warp_onehot", W.warp_onehot)] + ([("warp_gather", W.warp_gather)] if (s, c) == big else [])
            for name, fn in names:
                res = compare(fn(img, grid), ref, WARP_TOL["float32"])
                times = {"kernel_ms": median_ms(lambda: fn(img32, grid), reps=10), **shared,
                         "kernel_device_ms": device_ms(lambda: fn(img32, grid), launches=1)}
                _record(totals, failures, name, [b * f, s, s, c], "float32", res, 1, times,
                        (2 * img.numel() + grid.numel()) * 4, 8 * img.numel(), FP32_FLOPS, blend="none",
                        what="folded call of the bench_warp run: compared on its bf16 inputs, "
                             "timed on their fp32 casts")
            del image, grid5, img, grid, ref, img32, nchw
            torch.cuda.empty_cache()


def run_bench_warp(failures: list) -> dict:
    """The port's `bench_warp`: the variants at the largest decode warp and
    the per-scale table; returns that run's launch counts (its folded
    warp+blend calls are timed in `check_folded_warps`)."""
    import torch

    from cvpr23_lfdm_torch.scripts import bench_warp

    dev = torch.device("cuda")
    reset_counters()
    b, f = BLEND_SHAPES[0][0], F_FRAMES
    big = bench_warp.DECODE_SCALES[-1]
    image, grid5 = bench_warp.make_case(b, f, *big, torch.bfloat16, dev)
    rows = bench_warp.sweep(("plain", "grid_sample", "warp_video", "warp_gather"), image, grid5, dev)
    del image, grid5
    per_scale = {}
    for s, c in bench_warp.DECODE_SCALES:
        image, grid5 = bench_warp.make_case(b, f, s, c, torch.bfloat16, dev)
        per_scale[f"{s}x{c}"] = bench_warp.sweep(("warp_video", "grid_sample", "warp_onehot"),
                                                 image, grid5, dev, device_time=("warp_video", "grid_sample"))
        del image, grid5
    launches = counters()
    every = rows + [r for v in per_scale.values() for r in v]
    # `val_drift` (a difference of whole-tensor means) is information; the gate on the
    # values is the elementwise comparison in `check_folded_warps`
    ok = bool(all(np.isfinite(r["ms"]) for r in every)
              and launches["warp_onehot"] > 0 and launches["warp_gather"] > 0)
    emit({"phase": "bench warp", "shape": [b, f, big[0], big[0], big[1]], "dtype": "bfloat16",
          "variants": rows, "per_scale": per_scale, "launches": launches, "ok": ok, "gpu": gpu_line()})
    if not ok:
        failures.append("bench warp")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "cvpr23_lfdm_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from cvpr23_lfdm_torch.ops import _build

    # fp32 comparisons run in full fp32 (bf16 work is unaffected)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    from cvpr23_lfdm_torch.ops import attention as A

    names = ["fused_temporal_layer", "fused_spatial_linear_layer", "warp_blend"]
    new_sources = ["packed_attention", "groupnorm_film_silu"]
    variants = [("fused_temporal_layer", A.ablation_defines(v)) for v in A.ABLATIONS]
    built = _build.build(names + ["headpacked_attention"] + new_sources + variants)
    ptxas = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for n, log in built["logs"].items()}
    row1_bf16 = {k: v for k, v in ptxas_report(built["logs"]["fused_temporal_layer"]).items()
                 if "fused_temporal_layer_mma_kernel" in k}
    row2_bf16 = {k: v for k, v in ptxas_report(built["logs"]["fused_spatial_linear_layer"]).items()
                 if "linear_context_mma_kernel" in k or "linear_output_mma_kernel" in k}
    failures: list[str] = []
    if not row1_bf16 or any(v["spill_stores"] or v["spill_loads"] for v in row1_bf16.values()):
        failures.append("fused_temporal_layer bf16: ptxas reports a spill (or no kernel)")
    if len(row2_bf16) != 2 or any(v["spill_stores"] or v["spill_loads"] for v in row2_bf16.values()):
        failures.append("fused_spatial_linear_layer bf16: ptxas reports a spill (or a kernel is missing)")
    emit({"phase": "env", "gpu": gpu_line(), "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "build_s": built["seconds"], "ptxas": ptxas,
          "ptxas_fused_temporal_layer_bf16": {
              f"fused_temporal_layer_mma_kernel<NT={k.split('kernelILi')[1].split('E')[0]}>": v
              for k, v in row1_bf16.items()},
          "ptxas_fused_spatial_linear_layer_bf16": {
              ("linear_context_mma_kernel" if "context" in k else "linear_output_mma_kernel"): v
              for k, v in row2_bf16.items()}})

    totals = check_kernels(failures)
    totals.update(check_headpacked(failures))
    totals.update(check_new_kernels(failures))
    check_folded_warps(failures, totals)
    launches, latency_s = run_serving(failures)
    run_parity(failures)
    run_profile(latency_s)
    train_launches, step_s = run_training(failures)
    run_train_parity(failures)
    run_lfae_train(failures)
    run_lfae_parity(failures)
    pallas_launches, _ = run_serving(failures, impl="pallas", phase="serving forms", profiled=True)
    run_serving(failures, impl="xla", phase="serving forms")
    run_forms_parity(failures)
    norm_launches = run_fused_norm(failures)
    ablate_launches, ablate_entry = run_ablate(failures)
    warp_launches = run_bench_warp(failures)
    totals["fused_temporal_layer_ablate"] = ablate_entry

    csrc = "cvpr23_lfdm_torch/csrc/"
    jops = "cvpr23_lfdm_tpu/ops/"
    # name: (source, TPU kernel it replaces, launches of its main path's run, what ms sums over)
    table = {
        "fused_temporal_layer": ("fused_temporal_layer.cu", jops + "attention_pallas.py:590",
                                 launches, "serving video (pallas3)"),
        "fused_spatial_linear_layer": ("fused_spatial_linear_layer.cu", jops + "attention_pallas.py:745",
                                       launches, "serving video (pallas3)"),
        "warp_video": ("warp_blend.cu", jops + "warp_pallas.py:440", launches, "serving video (pallas3)"),
        "headpacked_attention_fwd": ("headpacked_attention.cu", jops + "attention_pallas.py:311",
                                     train_launches, "training step"),
        "headpacked_attention_bwd": ("headpacked_attention.cu", jops + "attention_pallas.py:366",
                                     train_launches, "training step"),
        "packed_temporal_attention": ("packed_attention.cu", jops + "attention_pallas.py:105",
                                      pallas_launches, "serving video (pallas)"),
        "groupnorm_film_silu": ("groupnorm_film_silu.cu", jops + "norm_pallas.py:98",
                                norm_launches, "UNet eval (fused_norm, B=1)"),
        "warp_onehot": ("warp_blend.cu", jops + "warp_pallas.py:121", warp_launches,
                        "bench_warp run: one folded call (B*F = 320, blend none) at each decode scale, fp32"),
        "warp_gather": ("warp_blend.cu", jops + "warp_pallas.py:587", warp_launches,
                        "bench_warp run: one folded call (B*F = 320, blend none) at 128x128x67, fp32"),
        "fused_temporal_layer_ablate": ("fused_temporal_layer.cu", "scripts/bench_attn_ablate.py:150",
                                        ablate_launches, "bench_attn_ablate run; ms: the full build, one layer at [8,40,1024,64]"),
    }
    fp32_bound = ("warp_video", "groupnorm_film_silu", "warp_onehot", "warp_gather")
    kernels = []
    for name, (src, replaces, counted, per) in table.items():
        t = totals[name]
        # the sum of the per-call bounds, named by the larger side of the sums
        b_by = t.get("bound_by") or bound(
            t["bytes"], t["flops"], FP32_FLOPS if name in fp32_bound else BF16_FLOPS)[1]
        if counted[name] < 1:
            failures.append(f"{name}: no launch on its main path")
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + src, "replaces": replaces,
            "launches": counted[name], "per": per, "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": b_by,
            "library_ms": t["library_ms"],
            **({"device_ms": t["device_ms"], "library_device_ms": t["library_device_ms"]}
               if "device_ms" in t else {}),
        })
    emit({"kernels": kernels,
          "per": "ms, plain_ms, bound_ms, library_ms: sums over the calls named in each kernel's `per` "
                 "(B=1 serving, B=5 training), bf16 unless said",
          "total_s": time.perf_counter() - t0})
    if failures:
        print(f"chip_smoke: FAILED: {failures}", file=sys.stderr)
        return 1
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
