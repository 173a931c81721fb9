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
              bit-identity, each case also on inputs whose attention
              branch is O(1) and residual small (x / 16, W_out * 3), so
              that the gate holds the branch (`branch_max_abs_err`,
              `branch_rms`); the linear layer likewise (two kernels per
              call), and at HW = 48 and 100 (short last tiles, off the
              path), each also on its `branch` inputs. Likewise the packed attention at the
              four B=1 serving shapes and a focus case (library: SDPA on
              pre-permuted q, k, v; device times alone of both; run twice
              for bit-identity), the fused GroupNorm+FiLM+SiLU at every
              `Block` shape of a serving eval, at B=8 (32², 64) and at
              every `Block` shape at B=32 (the benchmark's serving batch),
              with the FiLM pair as the UNet passes it and without and the
              conv bias as a Block passes it (`pre_bias` in bf16), run twice
              for bit-identity, with its device time alone and its device
              launches per call (gated: one; no single library call), and the
              fused warp+blend under both of its names for the three blends
              at `[8, 32, 32, 256]` and `[8, 128, 128, 67]` (library:
              `F.grid_sample` for blend none; device times alone of both);
              these warp+blend calls are lines of their own and enter no
              total.
2b. kernel B=16 — rows 1-3 against their plain versions at the serving
              shapes of a batch of 16 requests (the largest of the batch
              sweep: `[16, 40, HW, C]` for rows 1 and 2, `[16, 40, s, s, C]`
              for row 3), bf16, at the tolerances of phase 2 (row 3 bit-equal,
              one device launch per call), with their device time alone per
              call and bound; lines of their own, in no total.
3. serving  — the MUG serving path at full width on the bench checkpoint
              (128² frames, 40 frames, DDIM-10, B=1, cond_scale 1, bf16
              compute): output shapes, finite values, `out_vid` in [0, 1],
              the kernel launch counts of one video (each counter set to 0
              just before, read just after; row 7 once per `Block` of each
              eval: 400), and frames/s over timed runs.
4. parity   — the same path in fp32 with the kernels against the plain
              versions on the card (a test hook swaps the ops, row 7's
              among them, for this run only), under the same injected noise; and an fp32 run with
              the kernels against the JAX package's golden
              (`tests/golden/torch_port_mug_ddim10.npz`, 8 frames).

5. profile  — one serving video under torch.profiler: device time by
              kernel (and each fused layer's sum over its 100 or 80 calls) and
              its share of the serving latency; the full table
              goes to `chip_smoke_out/profile_serving.json`.
5b. bf16 reading — one full-width `pallas3` UNet eval on the bench
              checkpoint (B=1, F=40, 32², t = 909, the seeded input of
              `tests/test_torch_bf16_mug.py`) in bf16 against fp32 (TF32
              off): max and mean abs over the fp32 output's scale, gated at
              `BF16_READING_MARGIN` times the CPU reading
              (`BF16_CPU_READING`), and each top-level block's distance.
5c. profile sampler — `scripts/profile_sampler.py` at B=1 and 8, one
              profiled video each: device ms and launches per call by op
              group (rows 1-9 each a group of their own), device busy share;
              gated: rows 1-3 in their groups with (0, n] launches per call
              (`chip_smoke_out/profile_sampler_b{1,8}.json`).
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
              launches; `chip_smoke_out/profile_lfae_train.json`; gated:
              finite losses and parameters after it); per step, the
              train-mode covariances' smallest eigenvalue, smallest ratio
              of the two and count of thin ones; `sqrt_psd_2x2`'s
              backward on the covariances the card recorded where a thin
              region's fp32 eigenvalue once rounded to 0
              (`tests/golden/lfae_nan_sqrt_psd.npz`; gated: finite, and
              within 1e-5 of the float64 closed form computed here in the
              thin region, 1e-4 elsewhere); the
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
13b. bench scripts — the port's measurement scripts through their
              `main`: `bench_attention` at `[1, 40, 1024, 64]` (the four
              forms; finite), `bench_attn_fused` at `[8, 40, 1024, 64]` under
              its plan and every cluster size (each fused variant within
              phase 2's tolerance of the plain layer), `bench_batch_sweep
              --batches 1 16 --iters 1 --pipe-depth 2` (gated: 100 / 80 / 3
              launches of rows 1-3 per call at both batches, finite outputs,
              `out_vid` in [0, 1], and no host sync in a pipelined run under
              `torch.cuda.set_sync_debug_mode`), `bench_train --stage dm
              --iters 3` (gated: finite, rows 4-5's FLOPs counted, a share of
              the peak, device busy).
14. resume  — train -> `CheckpointManager.save` -> a new trainer restored
              from it -> resume. DM at the MUG widths, B=5, fp32 (TF32 off,
              cuDNN deterministic): 2 steps straight through against 1 step
              + save + restore + 1 step on the same batch and draws; gated:
              every UNet parameter and Adam moment `torch.equal`, equal
              steps. LFAE at the MUG widths, the `lfae train` phase's weights
              and B=100 batch, fp32: the same, gated finite and at
              `LFAE_RESUME_TOL` (the training warp's backward adds with
              atomics). Bytes, save and restore seconds of each.
15. lfae eval — `eval/flowautoenc.py::evaluate`, the reference protocol (10
              videos x 40 frames per batch, 128², `frame_chunk` 8, MUG
              widths, seeded weights, 20 smooth seeded videos): out_loss,
              warp_loss, s per batch, frames/s, peak memory, row 3's launches
              (gated: 4 per `FlowAE` call x 5 chunks = 20 per batch, no other
              kernel), and the same evaluation with the plain warp (gated:
              1e-5 relative).
16. metrics — I3D (features, FVD) and LPIPS on the committed fixture weights
              against `tests/golden/metrics_golden.npz` at the JAX tests'
              tolerances (gated); then at the published scale, seeded
              weights (not comparable with published numbers): 16 real and
              16 fake videos, 40 x 128² resized to 224², FVD, cFVD, sFVD (4
              class / 4 subject groups), LPIPS, SSIM and PSNR over their
              frames, seconds and videos/s each, peak memory; gated: finite,
              |FVD(real, real)| <= 1e-5 FVD(real, fake).
Phases 28-30 (dp, tp, sp) run after phase 13b and before phase 17: their
kernel checks read torch.profiler, which loses kernels late in a long
process (PERF.md §7); phases 17-27 gate on launch counters only.
17. text    — the user entry points, in one scratch directory: a
              seeded HF checkpoint at `bert-base-cased` widths (12 x 768,
              vocab 28996 holding the class words), `TextEmbedder.build`
              for MUG, MHAD and NATOPS on the card and on the CPU (fp32,
              TF32 off; gated at `TEXT_TOL`), seconds per table, peak
              memory.
18. cli demo — `python -m cvpr23_lfdm_torch.scripts.demo --bert-path ...`
              in a subprocess (bench checkpoint, bundled PNG, 7 classes;
              gated: exit 0, 7 GIF89a files); `demo.run` in process for
              `DEMO_CLASSES` (gated: 100 / 80 / 3 / 400 launches of rows 1-3
              and 7 per class video, `out_vid` equal to a direct `sample_video` with
              the same generator); seconds per class video and per direct
              `sample_video`.
19. cli test_dm — `test_dm.main(["--synthetic", "--num-videos", "4",
              "--random-metric-weights", "--bench-ckpt", ...])` (gated:
              finite losses, PSNR, SSIM, LPIPS, FVD, cFVD, sFVD; 110 / 88 /
              10 launches per video).
20. cli eval_flowautoenc — on the same synthetic corpus (gated: finite
              losses, 20 row-3 launches per batch); then with
              `--save-video --num-batches 1 --batch-size 4` (gated: one GIF89a per video,
              the warp lattices drawn without matplotlib; 20 row-3
              launches).
21. interpolate — `GaussianDiffusion.interpolate` on the bench checkpoint:
              bf16 at t = 20 (finite, 10 / 8 launches per step), fp32 at t
              = 3 against the plain versions within `PATH_TOL`.

22. corpus  — the training entry points, in one scratch directory: one
              synthetic MUG corpus, 40 frames at 128², two train and two
              test subjects, two takes of two classes (8 training videos:
              800 LFAE pairs, B=5 clips).
23. cli train_dm — `python -m cvpr23_lfdm_torch.scripts.train_dm` in a
              subprocess, B=5, 4 steps, `--save-img-freq 2 --save-vid-freq 3
              --sample-vid-freq 4 --sampling-steps 10` (the sampled video at
              DDIM-10), then `--resume` to 6 (gated: exit 0, the PNGs and GIFs
              written, the resumed run starts at step 4 and ends at 6); `train_dm.run` in
              this process, 4 steps, still grid every 2, sample at 4 with
              the preset's kind of sampler, the ancestral `p_sample_loop`,
              over a schedule cut to 20 timesteps (counters set to 0 just
              before; gated: rows 4 / 5 at 10 per step plus 10 per
              monitoring forward and 200 per sampled video, one
              `p_sample_loop` call with a finite output, row 3 counted, no
              row 1, 2 or other launch); seconds per step with and without the hooks;
              host seconds per training GIF (80 `grid2fig` renders).
24. cli train_lfae — the CLI in a subprocess, B=100, 2 steps,
              `--save-img-freq 2`, then `--resume` to 4 (gated: exit 0, the
              boards written, resumed at 2); `train_lfae.run` in this
              process, 4 steps (fp32, TF32 off; gated: finite losses, the
              board, row 3 at 4 per `reconstruct`, no other launch); seconds
              per step; the loader's seconds per batch of 100 pairs (thread
              loader, 6 threads, as the CLI).
25. cli make_bench_ckpt — `make_bench_ckpt.main` in this process, 2 + 2
              steps, one probe video, `--out` in the scratch directory
              (gated: every file written, rows 1 / 2 / 3 / 7 at 100 / 80 / 3 /
              400 per probe video plus row 3 once per DM step, rows 4 / 5 at
              10 per DM step); bytes and seconds of the save; then
              `apply_bench_ckpt` of the new directory and one `pallas3`
              serving video on it (gated: finite, 100 / 80 / 3 / 400).
26. loader grain — `GrainLoader` (8 worker processes) on the DM dataset,
              B=5: seconds per batch against the thread loader's (16
              threads); `train_dm --loader grain` for 3 steps, then resumed
              to 5 (gated: the batch each `train_step` is given equal to a
              straight stream's; `fit` reads a batch ahead on the card).
27. preprocess — which host libraries the installation has; `preprocess
              --dataset mug` on the corpus (gated: a split); `mhad` and
              `natops` on a raw tree (gated, without `cv2`: each raises the
              `ImportError` naming the AVI decoder, nothing else is caught;
              with `cv2`: the frame folders of MJPG AVIs it writes, 4 and 3 +
              4 frames).

28. dp       — data parallelism through `init_distributed`, in rank
              subprocesses (`dp_worker`). NCCL at world size 1 on cuda:0:
              an all-reduce; `sample_video_sharded` (bf16, `pallas3`, B=2)
              bit-equal to a direct `sample_video` from the same generator,
              100 / 80 / 3 launches of rows 1 / 2 / 3; one bf16 `DMTrainer`
              step on the `data` mesh (B=2), 10 + 10 of rows 4 / 5. Then two
              ranks sharing cuda:0 over gloo (NCCL refuses two ranks on one
              GPU), fp32 with TF32 off, each its contiguous rows, against
              one process: the B=2 video (`PATH_TOL`), one DM step at global
              B=4 before Adam (loss and all-reduced gradients,
              `TRAIN_PARITY_TOL`), one LFAE step at global B=8 with the
              BatchNorm statistics over both ranks (losses and statistics
              of the recipe, gradients of its smooth part, `DP_LFAE_TOL`);
              `states_agree` after each step; rows 1-5 launched on each
              rank, counted. Each rank's seconds per video and per step are
              records, not gates.
29. tp       — tensor parallelism over the `model` axis. First, in this
              process, the kernels at every shape a tp=2 run gives them
              (gated against their plain versions at the row 1 / row 2
              tolerances): rows 1 and 2 in their head-shard mode
              (`partial=True`, 4 heads, the serving shapes C 64-512, bf16
              and fp32, unit and `branch` inputs, the same bits twice; bf16
              timed: the `kernels` line's `_partial` entries), rows 4-5 at
              4 heads (B=2), row 7 on a channel shard (C / 2, 4 groups,
              FiLM and the conv bias as the tp UNet passes them). Then two rank subprocesses
              sharing cuda:0 over gloo, a `data` x `model` mesh of 1 x 2,
              the MUG config at full width: the bf16 `pallas3` video at B=1
              (gated: finite, 100 / 80 / 3 launches of rows 1 / 2 / 3 on
              each rank, rows 1 and 2 all in the head-shard mode; recorded:
              its distance from a one-process bf16 video, each rank's
              seconds), the fp32 video at B=1 (TF32 off) against one
              process (`PATH_TOL`), one fp32 DM step at B=2 against one
              process before Adam (loss and gathered gradients,
              `TRAIN_PARITY_TOL`; 10 + 10 launches of rows 4 / 5 per rank;
              `states_agree` within the model group), and each rank's UNet
              parameter bytes (gated at `TP_PARAM_SHARE` of one process's).
30. sp       — spatial partitioning over the `space` axis. First, in this
              process, row 3 on a band of output rows at each band shape
              that sp=2 gives the MUG decode (sources 32²x256, 64²x128,
              128²x67, `Ho` = 16, 32, 64 of their rows, B=1, F=40), bf16
              and fp32: each band bit-equal to its plain version and to
              those rows of the whole-height call, one device launch per
              call (gated); bf16 timed with its device time alone and
              `F.grid_sample` on the band's grid (the `kernels` line's
              `warp_video_band` entry). Then two rank subprocesses sharing
              cuda:0 over gloo, a `data` x `space` mesh of 1 x 2, the MUG
              config at full width, the LFAE's encoder and decoder of each
              rank on its 64 rows: the video at B=1 from injected gaussians
              in fp32 (TF32 off) and in bf16, gated equal on both ranks,
              finite, 100 / 80 / 3 launches of rows 1 / 2 / 3 per rank (all
              three warps on a band), the fp32 video within `PATH_TOL` of
              one process, the bf16 video no further from the one-process
              fp32 video than `SP_BF16_OF_WITNESS` times the one-process
              bf16 video is; recorded: each rank's seconds per video and
              the decode's peak allocated memory against one process's.

Every phase line carries `clock_s`, the seconds since the script started.
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
# the fused GroupNorm+FiLM+SiLU's Block shapes per UNet eval, and so its calls
# per eval (`norm_per_eval`): `cvpr23_lfdm_torch/scripts/bench_norm.py::NORM_SHAPES`
# row 7 also at the benchmark's serving batch (`portbench`'s `mug-serve-b32`)
NORM_CELL_BATCH = 32
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
THIN_REGION = os.path.join(ROOT, "tests", "golden", "lfae_nan_sqrt_psd.npz")
# |grad - float64 grad| / (|float64 grad| + 1e-3 max |float64 grad|): the thin
# region (sample 3, region 1), and the other 159, which keep the fp32 closed
# form and its rounding (2.4e-5 on a CPU)
THIN_REGION_TOL, FP32_FORM_TOL = 1e-5, 1e-4
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
# LFAE resume on the card: two runs of the same steps part where the training
# warp's atomics round a gradient otherwise. Adam (betas 0.5, 0.999) moves a
# parameter by at most 1.06 lr a step, so two runs whose gradient signs differ
# part by at most 2.12 lr per step (2 steps); most entries move together
RESUME_LFAE_BATCH = LFAE_BATCH
LFAE_RESUME_TOL = {"param_max_abs": 2.12 * 2e-4 * 2, "param_share_over_1e-5": 0.01,
                   "batch_stats_max_rel": 1e-2}  # stats: |diff| / (1 + |value|)
# the LFAE eval: the reference protocol (10 videos x 40 frames per batch, 128²,
# frame_chunk 8) over two batches; row 3 is bit-equal to plain, the other
# convolutions the same calls: the summed L1 losses within 1e-5 relative
EVAL_VIDEOS, EVAL_BATCH, EVAL_CHUNK = 20, 10, 8
EVAL_PLAIN_TOL = 1e-5
# the metrics: goldens at the JAX tests' tolerances (tests/test_metrics.py)
METRICS_GOLDEN = os.path.join(ROOT, "tests", "golden", "metrics_golden.npz")
METRICS_GOLDEN_TOL = {"i3d_feats": {"rtol": 1e-3, "atol": 0.5}, "i3d_fvd_rtol": 1e-2,
                      "lpips": {"rtol": 1e-4, "atol": 1e-6}}
# published scale: 16 + 16 videos, 4 groups; FVD(real, real) is 0 up to
# scipy's sqrtm of a rank-15 covariance (~2e-7 of the trace on a CPU)
METRIC_VIDEOS, METRIC_GROUPS, METRIC_FRAME = 16, 4, 128
FVD_SELF_EPS = 1e-5  # |FVD(real, real)| <= eps * FVD(real, fake)


_T0 = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "clock_s": time.perf_counter() - _T0}
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


def temporal_branch_check(A, args, x, wout, tol) -> tuple[dict, float]:
    """Row 1 again on inputs whose attention branch is O(1): with unit inputs
    the branch's rms is ~0.34 against the residual's 1, ten times the bf16
    gate's atol at most; x / 16 (the LayerNorm does not see the scale) and
    W_out * 3 make it ~1.0 and the residual ~0.06, so that the gate holds
    the branch itself, as row 2's `branch` inputs do. Returns the comparison
    and the branch's rms (gated at ten times the atol or more)."""
    bargs = ((x.float() / 16).to(x.dtype), *args[1:3], (3 * wout.float()).to(wout.dtype), *args[4:])
    bref = A.fused_temporal_layer_plain(*bargs)
    rms = float((bref.float() - bargs[0].float()).pow(2).mean().sqrt())
    return compare(A.fused_temporal_layer(*bargs), bref, tol), rms


def check_kernels(failures: list, batch: int = 1, dtypes=("float32", "bfloat16")) -> dict:
    """Each kernel against its plain version at every serving shape; returns
    per-kernel totals over the calls of one video (bf16 times). With
    `batch` > 1 (the serving shapes of a batch of `batch` requests, off the
    B=1 path): no focus case and no off-path shape, each call a line of its
    own that enters no total, row 3's plain version taken four videos at a
    time."""
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
    b, on_path = batch, batch == 1
    weight = lambda n: n if on_path else 0  # noqa: E731

    pos_bias = randn(HEADS, F_FRAMES, F_FRAMES)
    for dname in dtypes:
        dtype = getattr(torch, dname)
        timed = dtype == torch.bfloat16
        esz = 2 if timed else 4
        for (c, hw), n_eval in TEMPORAL_SHAPES.items():
            x = randn(b, F_FRAMES, hw, c).to(dtype)
            gamma = 1 + 0.1 * randn(c)
            wqkv = (randn(c, 3 * hd) / c ** 0.5).to(dtype)
            wout = (randn(hd, c) / hd ** 0.5).to(dtype)
            bias = A.build_bias_flat(pos_bias, b, F_FRAMES)
            cos_t, sin_t = A.rotary_tables(F_FRAMES, HEADS, DH, DH ** -0.5, dtype, dev)
            args = (x, gamma, wqkv, wout, bias, cos_t, sin_t, HEADS, DH)
            call = lambda: A.fused_temporal_layer(*args)
            out = call()
            res = compare(out, A.fused_temporal_layer_plain(*args), TOL[dname])
            same = bool(torch.equal(out, call()))  # no atomics: the same bits when run again
            branch, branch_rms = temporal_branch_check(A, args, x, wout, TOL[dname])
            res["ok"] = res["ok"] and same and branch["ok"] and branch["finite"] \
                and branch_rms >= 10 * TOL[dname]["atol"]
            times = None
            if timed:
                times = {"kernel_ms": median_ms(call),
                         "plain_ms": median_ms(lambda: A.fused_temporal_layer_plain(*args), reps=5),
                         "library_ms": None,
                         "kernel_device_ms": device_ms(call, launches=1), "library_device_ms": None}
            nbytes = (2 * x.numel() + wqkv.numel() + wout.numel() + 2 * cos_t.numel()) * esz \
                + (gamma.numel() + bias.numel()) * 4
            flops = b * (2 * F_FRAMES * hw * c * 4 * hd + 4 * hw * HEADS * F_FRAMES * F_FRAMES * DH)
            record("fused_temporal_layer", [b, F_FRAMES, hw, c], dname, res,
                   weight(n_eval * DDIM_STEPS), times, nbytes, flops, bit_identical_twice=same,
                   branch_max_abs_err=branch["max_abs_err"], branch_rms=branch_rms,
                   **({"device_launches_per_call": 1} if timed else {}))
        if on_path:
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
            branch, branch_rms = temporal_branch_check(A, args, x, wout, TOL[dname])
            res["ok"] = res["ok"] and same and branch["ok"] and branch["finite"] \
                and branch_rms >= 10 * TOL[dname]["atol"]
            record("fused_temporal_layer", [2, F_FRAMES, hw, c, "focus"], dname, res, 0,
                   bit_identical_twice=same, branch_max_abs_err=branch["max_abs_err"], branch_rms=branch_rms)

        # the serving shapes, then HW = 48 and 100 (off the path: short last tiles)
        off_path = [((64, 48), 0), ((128, 100), 0)] if on_path else []
        for (c, n), n_eval in [*LINEAR_SHAPES.items(), *off_path]:
            x = randn(b, F_FRAMES, n, c)
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
            flops = b * (2 * F_FRAMES * n * c * 4 * hd + 4 * F_FRAMES * HEADS * n * DH * DH)
            record("fused_spatial_linear_layer", [b, F_FRAMES, n, c], dname, res,
                   weight(n_eval * DDIM_STEPS), times, nbytes, flops, bit_identical_twice=same,
                   branch_max_abs_err=branch["max_abs_err"], branch_rms=branch_rms,
                   **({"device_launches_per_call": 2} if times else {}))

        for (h, c), per_video in WARP_SHAPES.items():
            src = randn(b, h, h, c).to(dtype)
            lin = torch.linspace(-1, 1, h, device=dev)
            ident = torch.stack(torch.meshgrid(lin, lin, indexing="xy"), -1)
            grid = (ident[None, None] + 0.3 * randn(b, F_FRAMES, h, h, 2)).contiguous()
            call = lambda: W.warp_video(src, grid)
            out = call()
            ref = torch.cat([W.warp_video_plain(src[i:i + 4], grid[i:i + 4]) for i in range(0, b, 4)])
            res = compare(out, ref, WARP_TOL[dname])
            # the kernel rounds every step as the plain version does: the same values
            equal = bool(torch.equal(out, ref))
            res["ok"] = res["ok"] and equal
            dev_ms, launches, other = device_reading(call, kernel="warp_blend_kernel")
            res["ok"] = res["ok"] and one_launch(launches, other)
            times = None
            if timed:
                src_nchw = src.permute(0, 3, 1, 2)
                g4 = grid.reshape(b, F_FRAMES * h, h, 2).to(dtype)
                gs = lambda: F.grid_sample(src_nchw, g4, mode="bilinear", padding_mode="zeros",
                                           align_corners=False)
                times = {"kernel_ms": median_ms(call),
                         "plain_ms": median_ms(lambda: W.warp_video_plain(src, grid), reps=5),
                         "library_ms": median_ms(gs), "kernel_device_ms": dev_ms,
                         "library_device_ms": device_ms(gs)}
            nbytes = src.numel() * esz + grid.numel() * 4 + F_FRAMES * src.numel() * esz
            flops = 8 * F_FRAMES * src.numel()
            record("warp_video", [b, F_FRAMES, h, h, c], dname, res, weight(per_video), times,
                   nbytes, flops, FP32_FLOPS, bit_equal_to_plain=equal,
                   device_launches_per_call=launches, other_device_launches_per_call=other)
    torch.cuda.empty_cache()
    return totals


# ---------------------------------------------------------------- phases 3-4


@contextlib.contextmanager
def plain_ops():
    """Test hook for the parity phases: route the ops to their plain
    versions for the duration of one run (the port itself has no switch)."""
    from cvpr23_lfdm_torch.ops import attention as A
    from cvpr23_lfdm_torch.ops import norm as N
    from cvpr23_lfdm_torch.ops import warp as W

    saved = (A.fused_temporal_layer, A.fused_spatial_linear_layer, W.warp_video,
             A.headpacked_temporal_attention, N.groupnorm_film_silu)
    A.fused_temporal_layer = A.fused_temporal_layer_plain
    A.fused_spatial_linear_layer = A.fused_spatial_linear_layer_plain
    W.warp_video = W.warp_video_plain
    A.headpacked_temporal_attention = A.headpacked_temporal_attention_plain
    N.groupnorm_film_silu = N.groupnorm_film_silu_plain
    try:
        yield
    finally:
        (A.fused_temporal_layer, A.fused_spatial_linear_layer, W.warp_video,
         A.headpacked_temporal_attention, N.groupnorm_film_silu) = saved


NEW_KERNELS = ("packed_temporal_attention", "groupnorm_film_silu", "warp_onehot", "warp_gather",
               "fused_temporal_layer_ablate", "fused_temporal_layer_partial",
               "fused_spatial_linear_layer_partial", "warp_video_band")


def counters() -> dict:
    from cvpr23_lfdm_torch.ops import read_counters

    return read_counters()


def reset_counters() -> None:
    from cvpr23_lfdm_torch import ops

    ops.reset_counters()


def norm_per_eval() -> int:
    """Fused-norm launches of one serving UNet eval: one per `Block`, as
    the shape table counts them."""
    from cvpr23_lfdm_torch.scripts.bench_norm import NORM_SHAPES

    return sum(sum(counts) for counts in NORM_SHAPES.values())


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
    # serving builds every Block fused: one norm launch per Block of each eval
    want = {"fused_temporal_layer": 10 * DDIM_STEPS, "fused_spatial_linear_layer": 8 * DDIM_STEPS,
            "warp_video": 3, "headpacked_attention_fwd": 0, "headpacked_attention_bwd": 0,
            **dict.fromkeys(NEW_KERNELS, 0), "groupnorm_film_silu": norm_per_eval() * DDIM_STEPS}
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


def run_profile(latency_s: float) -> None:
    """One serving video under torch.profiler: device time by kernel, and
    its sum over the unprofiled median latency of the serving phase."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cvpr23_lfdm_torch.utils.profiling import group_name

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
              **{f"{g}_device_ms": sum(r["device_ms"] for r in device if group_name(r["name"]) == g)
                 for g in ("fused_temporal_layer", "fused_spatial_linear_layer")},
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


def training_setup(dtype: str, batch: int, seed: int = 0, mesh=None):
    """The MUG trainer at full width on the bench checkpoint (UNet and
    generator encoder; seeded motion modules), on `mesh` (None: this
    process alone), a seeded batch and one fixed draw of (t, noise, null
    mask)."""
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
    trainer = DMTrainer(cfg, steps_per_epoch=93, model=model, mesh=mesh)
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


def lfae_trainer(seed: int = 0, mesh=None):
    """`LFAETrainer` at the MUG config's full widths (fp32), the three nets
    from `seed_lfae_weights(seed)`, the VGG19 from `seed_vgg_weights(seed)`,
    on `mesh` (None: this process alone)."""
    from cvpr23_lfdm_torch.config import mug_config
    from cvpr23_lfdm_torch.train.lfae_trainer import LFAETrainer

    cfg = mug_config()
    trainer = LFAETrainer(cfg, steps_per_epoch=LFAE_STEPS_PER_EPOCH, device="cuda", vgg_seed=seed,
                          mesh=mesh)
    return cfg, trainer, trainer.init_state(seed=seed)


def lfae_batch(cfg, batch: int, seed: int) -> dict:
    import torch

    rng = np.random.RandomState(seed)
    s = cfg.lfae.frame_shape
    return {k: torch.from_numpy(rng.uniform(size=(batch, s, s, 3)).astype(np.float32)).cuda()
            for k in ("source", "driving")}


def run_lfae_train(failures: list) -> None:
    """`LFAETrainer.train_step` at the recipe's batch: timed steps, gates,
    a profiled step, the training warp's two candidates at the step's
    shapes, then `reconstruct` (eval) on the same batch through row 3."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cvpr23_lfdm_torch.scripts import bench_train_warp
    from cvpr23_lfdm_torch.utils.profiling import device_groups
    from cvpr23_lfdm_torch.train.dm_trainer import step_generator

    batch = LFAE_BATCH
    cfg, trainer, state = lfae_trainer()
    data = lfae_batch(cfg, batch, seed=1)
    model = trainer.model
    # each region-predictor call's smallest eigenvalue, its smallest ratio to
    # the larger one, and its count of thin covariances (`ops/eig2x2.py`)
    eig_seen = []
    eig_hook = model.region_predictor.register_forward_hook(lambda mod, inp, out: eig_seen.append(
        eig_stats(out["covar"].detach())))
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
        state, profiled_m = trainer.train_step(state, step_generator(0, state.step, trainer.device), data)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    eig_hook.remove()
    eig = [[float(x) for x in call] for call in eig_seen]  # 3 calls per step, 8 steps
    per_step = [eig[i:i + 3] for i in range(0, len(eig), 3)]
    eigen = {"min_small_eigenvalue_per_step": [min(c[0] for c in st) for st in per_step],
             "min_ratio_per_step": [min(c[1] for c in st) for st in per_step],
             "thin_covariances_per_step": [int(sum(c[2] for c in st)) for st in per_step],
             "covariances_per_step": 3 * batch * cfg.lfae.num_regions}
    profiled = {k: float(v) for k, v in profiled_m.items()}
    checks["profiled_step_finite"] = bool(np.isfinite(list(profiled.values())).all()) and all(
        torch_isfinite(p) for p in model.parameters())
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
          "kernel_launches_per_step": launches, "losses_7_steps": metrics, "losses_profiled_step": profiled,
          "train_mode_covariances": eigen,
          "step_s": secs, "median_step_s": med, "frames_per_s": batch / med, "peak_mem_gb": peak,
          "profiled_step": {"wall_ms": wall_ms, "device_busy_ms": busy,
                            "device_busy_share_of_its_wall": busy / wall_ms,
                            "device_launches": sum(r["count"] for r in device),
                            "by_group": device_groups(device), "top": device[:10]},
          "gpu": gpu_line()})
    for k, v in checks.items():
        if not v:
            failures.append(f"lfae train {k}")
    check_thin_region(failures)

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


def eig_stats(covar):
    """The smallest eigenvalue of `covar [..., 2, 2]`, the smallest ratio of
    the two, and how many are thin (`ops/eig2x2.py::_THIN`): device
    tensors, read after the timed steps."""
    import torch

    from cvpr23_lfdm_torch.ops import eig2x2

    s = eig2x2.eigh_2x2(covar)[1]
    ratio = s[..., 1] / s[..., 0]
    return torch.stack([s[..., 1].min(), ratio.min(), (ratio < eig2x2._THIN).sum().to(s.dtype)])


def sqrt_psd_2x2_f64(covar):
    """The JAX package's closed form of `U sqrt(S)` (`ops/eig2x2.py`), written
    out here in float64, where `tr / 2 - rad` does not cancel."""
    import torch

    a, c = covar[..., 0, 0], covar[..., 1, 1]
    b = 0.5 * (covar[..., 0, 1] + covar[..., 1, 0])
    half_tr = 0.5 * (a + c)
    rad = torch.sqrt(torch.clamp_min(0.25 * (a - c) ** 2 + b * b, 0.0))
    s1, s2 = half_tr + rad, half_tr - rad
    v1a, v1b = torch.stack([b, s1 - a], -1), torch.stack([s1 - c, b], -1)
    v1 = torch.where(((v1a * v1a).sum(-1) >= (v1b * v1b).sum(-1))[..., None], v1a, v1b)
    v1 = v1 / torch.sqrt((v1 * v1).sum(-1, keepdim=True))

    def lead_sign(v):
        lead = torch.where(v[..., 0].abs() >= v[..., 1].abs(), v[..., 0], v[..., 1])
        return torch.where(lead < 0, -1.0, 1.0).to(v.dtype)[..., None]

    v1 = v1 * lead_sign(v1)
    v2 = torch.stack([-v1[..., 1], v1[..., 0]], -1)
    v2 = v2 * lead_sign(v2)
    u = torch.stack([v1, v2], -1)
    return u * torch.sqrt(torch.clamp_min(torch.stack([s1, s2], -1), 0.0))[..., None, :]


def check_thin_region(failures: list) -> None:
    """`sqrt_psd_2x2`'s backward on the card, on the covariances a B=16 LFAE
    run recorded where a thin region (variances 6.1e-9 and 0.35) had its
    smaller eigenvalue rounded to 0 by the fp32 closed form: finite, and
    within `THIN_REGION_TOL` of the float64 closed form's gradient there
    (`FP32_FORM_TOL` elsewhere)."""
    import torch

    from cvpr23_lfdm_torch.ops.eig2x2 import eigh_2x2, sqrt_psd_2x2

    rec = np.load(THIN_REGION)
    covar = torch.from_numpy(rec["covar"]).cuda().requires_grad_(True)
    cot = torch.from_numpy(rec["out_grad"]).cuda()
    sqrt_psd_2x2(covar).backward(cot)
    c64 = covar.detach().double().requires_grad_(True)
    sqrt_psd_2x2_f64(c64).backward(cot.double())
    got, want = covar.grad.double(), c64.grad
    rel = ((got - want).abs() / (want.abs() + 1e-3 * float(want.abs().max()))).amax(dim=(-2, -1))
    thin_rel = float(rel[3, 1])
    rel[3, 1] = 0.0
    s_thin = eigh_2x2(covar.detach())[1][3, 1].tolist()
    line = {"phase": "lfae train", "what": "sqrt_psd_2x2 backward on the recorded thin region",
            "finite": torch_isfinite(covar.grad), "eigenvalues_thin_region": s_thin,
            "thin_grad_rel_vs_float64": thin_rel, "tol": THIN_REGION_TOL,
            "other_grad_max_rel_vs_float64": float(rel.max()), "other_tol": FP32_FORM_TOL}
    line["ok"] = bool(line["finite"] and s_thin[1] > 0 and thin_rel <= THIN_REGION_TOL
                      and line["other_grad_max_rel_vs_float64"] <= FP32_FORM_TOL)
    emit({**line, "gpu": gpu_line()})
    if not line["ok"]:
        failures.append("lfae train thin region")


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


# ---------------------------------------------------------------- phases 14-16: resume, eval, metrics


def save_and_restore(ckpt, trainer, state, fresh):
    """`CheckpointManager.save` of `trainer`'s state (step snapshot + rolling
    latest), then `restore` into the new trainer `fresh` on the card; the
    seconds of each and the bytes on disk."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = ckpt.save(trainer.state_dict(state), step=state.step)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = fresh.load_state_dict(ckpt.restore(map_location=fresh.device))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    return restored, {"save_s": save_s, "restore_s": restore_s, "file_bytes": os.path.getsize(path)}


def run_resume(failures: list) -> None:
    """Train -> checkpoint -> resume on the card. DM (MUG widths, B=5, fp32,
    TF32 off, cuDNN deterministic): 2 steps straight through against 1 step,
    `CheckpointManager.save`, a new `DMTrainer` restored from it and 1 more
    step, on the same batch and draws: every UNet parameter and Adam moment
    equal (`torch.equal`) and equal steps. LFAE (MUG widths, the `lfae
    train` phase's weights and B=100 batch, fp32): the same experiment, held
    to `LFAE_RESUME_TOL`, because the training warp's backward adds with
    atomics; every parameter and statistic finite."""
    import tempfile

    import torch

    from cvpr23_lfdm_torch.train.dm_trainer import step_generator
    from cvpr23_lfdm_torch.train.lfae_trainer import LFAETrainer
    from cvpr23_lfdm_torch.utils.checkpoint import CheckpointManager

    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    os.makedirs(os.path.join(ROOT, "chip_smoke_out"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="lfdm_resume_", dir=os.path.join(ROOT, "chip_smoke_out"))
    try:
        cfg, trainer, data, draws, _ = training_setup("float32", TRAIN_BATCH)
        initial = {k: v.detach().clone() for k, v in trainer.model.unet.state_dict().items()}
        state = trainer.init_state()
        for _ in range(2):
            state, _ = trainer.train_step(state, None, data, **draws)
        straight = {k: v.detach().clone() for k, v in trainer.state_dict(state)["unet"].items()}
        straight_opt = trainer.optimizer.state_dict()["state"]
        straight_opt = {i: {k: v.clone() for k, v in s.items()} for i, s in straight_opt.items()}
        trainer.model.unet.load_state_dict(initial)
        state = trainer.init_state()
        state, _ = trainer.train_step(state, None, data, **draws)
        ckpt = CheckpointManager(os.path.join(tmp, "dm"))
        _, fresh, _, _, _ = training_setup("float32", TRAIN_BATCH)
        fresh.init_state(seed=7)  # other UNet weights: the restore must replace them
        state, io = save_and_restore(ckpt, trainer, state, fresh)
        del trainer
        torch.cuda.empty_cache()
        state, _ = fresh.train_step(state, None, data, **draws)
        got = fresh.state_dict(state)
        params_equal = all(torch.equal(got["unet"][k], v) for k, v in straight.items())
        moments = got["optimizer"]["state"]
        moments_equal = set(moments) == set(straight_opt) and all(
            torch.equal(moments[i][k], straight_opt[i][k]) for i in straight_opt
            for k in ("exp_avg", "exp_avg_sq", "step"))
        line = {"phase": "resume", "what": "DM train -> checkpoint -> new trainer -> resume",
                "config": "mug", "dtype": "float32 (TF32 off, cuDNN deterministic)",
                "batch": TRAIN_BATCH, "steps": "2 straight vs 1 + save + restore + 1",
                "step": state.step, **io,
                "unet_parameters_equal": params_equal, "adam_moments_equal": moments_equal}
        line["ok"] = bool(params_equal and moments_equal and state.step == 2)
        emit({**line, "gpu": gpu_line()})
        if not line["ok"]:
            failures.append("resume dm")
        del fresh, got, straight, straight_opt, initial
        torch.cuda.empty_cache()

        cfg, trainer, state = lfae_trainer()  # the `lfae train` phase's weights and batch
        data = lfae_batch(cfg, RESUME_LFAE_BATCH, seed=1)
        initial = {k: v.detach().clone() for k, v in trainer.state_dict(state)["model"].items()}
        for i in range(2):
            state, _ = trainer.train_step(state, step_generator(0, i, trainer.device), data)
        straight = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
        trainer.model.load_state_dict(initial)
        state = trainer.init_state()
        state, _ = trainer.train_step(state, step_generator(0, 0, trainer.device), data)
        fresh = LFAETrainer(cfg, steps_per_epoch=LFAE_STEPS_PER_EPOCH, device="cuda", vgg_seed=0)
        fresh.init_state(seed=5)  # other weights: the restore must replace them
        ckpt = CheckpointManager(os.path.join(tmp, "lfae"))
        state, io = save_and_restore(ckpt, trainer, state, fresh)
        del trainer
        torch.cuda.empty_cache()
        state, _ = fresh.train_step(state, step_generator(0, 1, fresh.device), data)
        got = fresh.model.state_dict()
        tol = LFAE_RESUME_TOL
        param_names = {n for n, _ in fresh.model.named_parameters()}
        finite = all(bool(torch.isfinite(t).all()) for t in (*got.values(), *straight.values()))
        p_diff = torch.cat([(got[k] - v).abs().flatten() for k, v in straight.items() if k in param_names])
        s_rel = max(float(((got[k] - v).abs() / (1 + v.abs())).max())
                    for k, v in straight.items() if k not in param_names)
        line = {"phase": "resume", "what": "LFAE train -> checkpoint -> new trainer -> resume",
                "config": "mug", "dtype": "float32 (TF32 off)", "batch": RESUME_LFAE_BATCH,
                "steps": "2 straight vs 1 + save + restore + 1", "step": state.step,
                **io, "tol": tol,
                "param_max_abs_diff": float(p_diff.max()),
                "param_share_over_1e-5": float((p_diff > 1e-5).float().mean()),
                "param_entries_equal_share": float((p_diff == 0).float().mean()),
                "batch_stats_max_rel_diff": s_rel, "finite": finite}
        line["ok"] = bool(finite and state.step == 2 and line["param_max_abs_diff"] <= tol["param_max_abs"]
                          and line["param_share_over_1e-5"] <= tol["param_share_over_1e-5"]
                          and s_rel <= tol["batch_stats_max_rel"])
        emit({**line, "gpu": gpu_line()})
        if not line["ok"]:
            failures.append("resume lfae")
        del fresh, got, straight, initial
        torch.cuda.empty_cache()
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)


def smooth_videos(n: int, f: int, s: int, seed: int) -> np.ndarray:
    """Seeded smooth videos `[n, f, s, s, 3]` in [0, 1]: an 8x8 colour field
    per video, moving a little from frame to frame, bilinearly upsampled."""
    import torch
    import torch.nn.functional as F

    rng = np.random.RandomState(seed)
    coarse = rng.uniform(0.1, 0.9, size=(n, 1, 8, 8, 3)) + 0.05 * rng.standard_normal((n, f, 8, 8, 3))
    x = torch.from_numpy(coarse.astype(np.float32)).reshape(n * f, 8, 8, 3).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(s, s), mode="bilinear", align_corners=False)
    return x.permute(0, 2, 3, 1).reshape(n, f, s, s, 3).clamp(0, 1).contiguous().numpy()


class VideoSet:
    """An in-memory dataset: `[i] -> {"video": [F, H, W, 3], "name"}`."""

    def __init__(self, videos: np.ndarray):
        self.videos = videos

    def __len__(self) -> int:
        return len(self.videos)

    def __getitem__(self, i: int) -> dict:
        return {"video": self.videos[i], "name": f"v{i:02d}"}


def run_lfae_eval(failures: list) -> None:
    """`eval/flowautoenc.py::evaluate`, the reference protocol: MUG widths,
    128², 40 frames, batch 10 videos, `frame_chunk` 8, seeded LFAE weights,
    `EVAL_VIDEOS` smooth seeded videos; after one warm-up batch: the losses,
    s per batch, frames/s, peak memory and row 3's launches (counters set to
    0 just before, read just after; 4 per `FlowAE` call x 5 chunks per
    batch). Then the same evaluation with the plain warp swapped in (the test
    hook), within `EVAL_PLAIN_TOL` relative."""
    import torch

    from cvpr23_lfdm_torch.config import mug_config
    from cvpr23_lfdm_torch.eval.flowautoenc import evaluate
    from cvpr23_lfdm_torch.models.flow_autoenc import FlowAE, seed_lfae_weights

    cfg = mug_config().lfae
    fae = FlowAE(cfg)
    seed_lfae_weights([fae.region_predictor, fae.bg_predictor, fae.generator], 0)
    state = fae.state_dict()
    videos = smooth_videos(EVAL_VIDEOS, F_FRAMES, cfg.frame_shape, seed=4)
    kw = dict(batch_size=EVAL_BATCH, image_size=cfg.frame_shape, frame_chunk=EVAL_CHUNK)
    evaluate(state, cfg, VideoSet(videos[:EVAL_BATCH]), **kw)  # warm-up
    batches = -(-EVAL_VIDEOS // EVAL_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    res = evaluate(state, cfg, VideoSet(videos), **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = counters()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with plain_ops():
        plain = evaluate(state, cfg, VideoSet(videos), **kw)
    rel = max(abs(res[k] - plain[k]) / abs(plain[k]) for k in res)
    want = 4 * -(-F_FRAMES // EVAL_CHUNK) * batches
    others = {k: v for k, v in launches.items() if k != "warp_video" and v}
    line = {"phase": "lfae eval", "config": "mug", "dtype": "float32 (TF32 off)",
            "videos": EVAL_VIDEOS, "frames": F_FRAMES, "frame": cfg.frame_shape,
            "batch": EVAL_BATCH, "frame_chunk": EVAL_CHUNK, "weights": "seeded (seed_lfae_weights(0))",
            **res, "plain_warp": plain, "max_rel_diff_vs_plain": rel, "tol": EVAL_PLAIN_TOL,
            "s": secs, "s_per_batch": secs / batches, "frames_per_s": EVAL_VIDEOS * F_FRAMES / secs,
            "peak_mem_gb": peak, "warp_video_launches": launches["warp_video"],
            "warp_video_launches_per_batch": launches["warp_video"] / batches,
            "warp_video_launches_expected": want, "other_kernel_launches": others}
    line["ok"] = bool(np.isfinite(list(res.values())).all() and launches["warp_video"] == want
                      and not others and rel <= EVAL_PLAIN_TOL)
    emit({**line, "gpu": gpu_line()})
    if not line["ok"]:
        failures.append("lfae eval")
    del fae
    torch.cuda.empty_cache()


# numpy builders of the metric goldens' weights and inputs, draw for draw those
# of tests/metrics_fixtures.py, which reaches the JAX package for its channel
# table (tests/test_torch_eval.py holds the two equal)
LPIPS_VGG_PLAN = {
    0: (3, 64), 2: (64, 64), 5: (64, 128), 7: (128, 128),
    10: (128, 256), 12: (256, 256), 14: (256, 256),
    17: (256, 512), 19: (512, 512), 21: (512, 512),
    24: (512, 512), 26: (512, 512), 28: (512, 512),
}


def _unit3d_sd(rng, prefix, cin, cout, k, bn=True, bias=False) -> dict:
    sd = {f"{prefix}.conv3d.weight": rng.standard_normal((cout, cin, k, k, k)).astype("float32") * 0.1}
    if bias:
        sd[f"{prefix}.conv3d.bias"] = rng.standard_normal(cout).astype("float32")
    if bn:
        sd[f"{prefix}.bn.weight"] = 1.0 + 0.1 * rng.standard_normal(cout).astype("float32")
        sd[f"{prefix}.bn.bias"] = 0.1 * rng.standard_normal(cout).astype("float32")
        sd[f"{prefix}.bn.running_mean"] = 0.1 * rng.standard_normal(cout).astype("float32")
        sd[f"{prefix}.bn.running_var"] = (1.0 + 0.1 * rng.random(cout)).astype("float32")
    return sd


def i3d_fixture_sd(seed: int = 0) -> dict:
    """The golden's pytorch_i3d-layout state dict (numpy leaves)."""
    from cvpr23_lfdm_torch.eval.i3d import _MIXED

    rng = np.random.default_rng(seed)
    sd = {}
    sd.update(_unit3d_sd(rng, "Conv3d_1a_7x7", 3, 64, 7))
    sd.update(_unit3d_sd(rng, "Conv3d_2b_1x1", 64, 64, 1))
    sd.update(_unit3d_sd(rng, "Conv3d_2c_3x3", 64, 192, 3))
    cin = 192
    for name, c in _MIXED:
        sd.update(_unit3d_sd(rng, f"{name}.b0", cin, c[0], 1))
        sd.update(_unit3d_sd(rng, f"{name}.b1a", cin, c[1], 1))
        sd.update(_unit3d_sd(rng, f"{name}.b1b", c[1], c[2], 3))
        sd.update(_unit3d_sd(rng, f"{name}.b2a", cin, c[3], 1))
        sd.update(_unit3d_sd(rng, f"{name}.b2b", c[3], c[4], 3))
        sd.update(_unit3d_sd(rng, f"{name}.b3b", cin, c[5], 1))
        cin = c[0] + c[2] + c[4] + c[5]
    sd.update(_unit3d_sd(rng, "logits", cin, 400, 1, bn=False, bias=True))
    return sd


def lpips_fixture_sds(seed: int = 2):
    """The golden's (vgg16 features sd, lin sd, a, b)."""
    from cvpr23_lfdm_torch.eval.lpips import LPIPS_CHANNELS

    rng = np.random.default_rng(seed)
    feat_sd = {}
    for idx, (cin, cout) in LPIPS_VGG_PLAN.items():
        feat_sd[f"{idx}.weight"] = rng.standard_normal((cout, cin, 3, 3)).astype("float32") * 0.05
        feat_sd[f"{idx}.bias"] = 0.1 * rng.standard_normal(cout).astype("float32")
    lin_sd = {f"lin{i}.model.1.weight": rng.random((1, c, 1, 1)).astype("float32")
              for i, c in enumerate(LPIPS_CHANNELS)}
    a = rng.random((2, 32, 32, 3)).astype(np.float32)
    b = rng.random((2, 32, 32, 3)).astype(np.float32)
    return feat_sd, lin_sd, a, b


def golden_i3d_inputs():
    rng = np.random.default_rng(7)
    real = rng.random((4, 9, 32, 32, 3)).astype(np.float32)
    fake = (rng.random((4, 9, 32, 32, 3)).astype(np.float32)) ** 2
    return real, fake


def timed(fn):
    """`(fn(), seconds)`, host clock ending in a synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_metrics(failures: list) -> None:
    """The metrics on the card. Goldens: I3D features and FVD, and LPIPS, on
    the fixture weights and inputs against `tests/golden/metrics_golden.npz`
    at the JAX tests' tolerances (`METRICS_GOLDEN_TOL`). At the published
    scale: `METRIC_VIDEOS` real and as many fake smooth seeded videos, 40 x
    128², resized to 224² through the full seeded I3D: FVD, cFVD and sFVD
    (4 class and 4 subject groups) and FVD(real, real); LPIPS (seeded VGG16),
    SSIM and PSNR over their frames; seconds and videos/s each, peak memory.
    Seeded weights: the values are not comparable with published ones."""
    import torch

    from cvpr23_lfdm_torch.eval import i3d, lpips, metrics

    golden = np.load(METRICS_GOLDEN)
    tol = METRICS_GOLDEN_TOL
    extract = i3d.i3d_extractor(i3d.convert_i3d_checkpoint(i3d_fixture_sd()), resize_to=None)
    real, fake = golden_i3d_inputs()
    feats = extract(real).cpu().numpy()
    fvd = metrics.FVD(extract)(real, fake)
    feat_sd, lin_sd, a, b = lpips_fixture_sds()
    lp = lpips.make_lpips(lpips.convert_vgg16_features(feat_sd), lpips.convert_lpips_lin(lin_sd))(a, b)
    lp = lp.cpu().numpy()
    want_fvd = float(golden["i3d_fvd"])
    line = {"phase": "metrics", "what": "goldens (tests/golden/metrics_golden.npz)", "tol": tol,
            "i3d_feats_max_abs_err": float(np.abs(feats - golden["i3d_feats_real"]).max()),
            "i3d_fvd": [fvd, want_fvd], "lpips": [lp.tolist(), golden["lpips_vals"].tolist()]}
    line["ok"] = bool(
        np.allclose(feats, golden["i3d_feats_real"], **tol["i3d_feats"])
        and abs(fvd - want_fvd) <= tol["i3d_fvd_rtol"] * abs(want_fvd)
        and np.allclose(lp, golden["lpips_vals"], **tol["lpips"]))
    emit(line)
    if not line["ok"]:
        failures.append("metrics goldens")

    n, g = METRIC_VIDEOS, METRIC_GROUPS
    s = METRIC_FRAME
    real = torch.from_numpy(smooth_videos(n, F_FRAMES, s, seed=5)).cuda()
    fake = torch.from_numpy(smooth_videos(n, F_FRAMES, s, seed=6)).cuda()
    classes = [f"class{i % g}" for i in range(n)]
    subjects = [f"subject{i // (n // g)}" for i in range(n)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fvd = metrics.FVD(i3d.i3d_extractor(i3d.random_i3d_vars(0)))
    rf, rf_s = timed(lambda: fvd(real, fake))
    (cfvd, per_class), c_s = timed(lambda: fvd.grouped(real, fake, classes, classes))
    (sfvd, per_subject), s_s = timed(lambda: fvd.grouped(real, fake, subjects, subjects[::-1]))
    rr, _ = timed(lambda: fvd(real, real))
    lp_fn = lpips.random_lpips_for_testing(0)
    ra, fa = real.reshape(-1, s, s, 3), fake.reshape(-1, s, s, 3)
    lp, lp_s = timed(lambda: torch.cat([lp_fn(ra[i: i + 64], fa[i: i + 64]) for i in range(0, len(ra), 64)]))
    ss, ss_s = timed(lambda: float(metrics.ssim(real, fake)))
    ps, ps_s = timed(lambda: float(metrics.psnr(real, fake)))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    values = {"fvd": rf, "cfvd": cfvd, "sfvd": sfvd, "fvd_real_real": rr,
              "lpips_mean": float(lp.mean()), "ssim": ss, "psnr": ps}
    line = {"phase": "metrics", "what": "published scale, seeded weights: not comparable with published numbers",
            "videos": [n, n], "frames": F_FRAMES, "frame": s, "i3d_input": 224, "groups": g, **values,
            "per_class": per_class, "per_subject": per_subject, "fvd_self_eps": FVD_SELF_EPS,
            "seconds": {"fvd": rf_s, "cfvd": c_s, "sfvd": s_s, "lpips": lp_s, "ssim": ss_s, "psnr": ps_s},
            "videos_per_s": {"fvd": 2 * n / rf_s, "cfvd": 2 * n / c_s, "sfvd": 2 * n / s_s,
                             "lpips": n / lp_s, "ssim": n / ss_s, "psnr": n / ps_s},
            "lpips_frames": len(ra), "peak_mem_gb": peak}
    line["ok"] = bool(np.isfinite(list(values.values())).all()
                      and abs(rr) <= FVD_SELF_EPS * rf and rf > 0)
    emit({**line, "gpu": gpu_line()})
    if not line["ok"]:
        failures.append("metrics published scale")
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

    from cvpr23_lfdm_torch.models.blocks import split_bias
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
            # (read twice), and every Block shape with FiLM at the benchmark's serving
            # batch (off the B=1 eval, lines of their own). The conv bias as a Block
            # passes it: after the product in bf16 (`pre_bias`), inside it in fp32
            cases = [(1, h, c, film, n_eval) for (h, c), counts in NORM_SHAPES.items()
                     for film, n_eval in zip((True, False), counts)]
            cases += [(8, 32, 64, True, 0)] + [(NORM_CELL_BATCH, h, c, True, 0) for (h, c) in NORM_SHAPES]
            for b, h, c, film, n_eval in cases:
                x = (1.5 * randn(b, f, h, h, c) + 0.3).to(dtype)
                gamma, beta = 1 + 0.3 * randn(c), 0.2 * randn(c)
                # the FiLM pair as the UNet passes it: halves of one [B, 1, 1, 1, 2C] tensor
                ss = randn(b, 1, 1, 1, 2 * c).to(dtype).chunk(2, dim=-1) if film else ()
                pre = {"pre_bias": split_bias(0.5 * randn(c), dtype)[1]}
                call = lambda: N.groupnorm_film_silu(x, gamma, beta, *ss, **pre)
                out = call()
                res = compare(out, N.groupnorm_film_silu_plain(x, gamma, beta, *ss, **pre), TOL[dname])
                same = bool(torch.equal(out, call()))
                dev_ms, launches, other = device_reading(call)
                res["ok"] = res["ok"] and same and one_launch(launches, other)
                times = None
                if timed:
                    times = {"kernel_ms": median_ms(call),
                             "plain_ms": median_ms(lambda: N.groupnorm_film_silu_plain(
                                 x, gamma, beta, *ss, **pre), reps=5),
                             "library_ms": None, "kernel_device_ms": dev_ms, "library_device_ms": None}
                nbytes = 2 * x.numel() * esz + 2 * c * 4 + 2 * b * c * film * esz
                _record(totals, failures, "groupnorm_film_silu", [b, f, h, h, c], dname, res,
                        n_eval, times, nbytes, 10 * x.numel(), FP32_FLOPS,
                        film=film, pre_bias=pre["pre_bias"] is not None, bit_identical_twice=same,
                        device_launches_per_call=launches, other_device_launches_per_call=other)
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
    from cvpr23_lfdm_torch.scripts.bench_norm import device_reading, one_launch

    dev = torch.device("cuda")
    nets = {fused: bench_unet.make_unet("pallas3", fused, "bfloat16", dev) for fused in (False, True)}
    blocks = norm_per_eval()
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
            "launches_ok": counted["groupnorm_film_silu"] == blocks
            and fused["launches_per_eval"]["groupnorm_film_silu"] == blocks
            and plain["launches_per_eval"]["groupnorm_film_silu"] == 0
            and counted["fused_temporal_layer"] == 10 and counted["fused_spatial_linear_layer"] == 8
            and one_launch(norm_launches, other, blocks),
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


# --------------------------------------------- the bf16 reading and the measurement scripts

SERVE_BATCH = 16  # the sweep's largest batch: rows 1-3 at 16x the B=1 pixels, frames and images
# the port's bf16 UNet eval from its fp32 one on the CPU (`pallas3`, plain versions;
# max and mean abs over the fp32 output's scale), at this phase's input:
# `tests/test_torch_bf16_mug.py`'s full reading (RUN_TORCH_BF16_MUG=1)
BF16_CPU_READING = {"max": 1.562e-2, "mean": 2.862e-3}
# the card's reading may sit this far above the CPU's: its kernels round at
# their own points (rows 1-2's bf16 kernels against the plain versions)
BF16_READING_MARGIN = 1.5
BF16_T = 909  # the first step of DDIM-10 over 1000 steps
# `bench_attention`: each form's max-abs from `xla` on its bf16 input, as
# `tests/test_torch_bench_scripts.py` holds it on the CPU
BENCH_ATTN_TOL = 0.05


def run_bf16_reading(failures: list) -> None:
    """One full-width `pallas3` UNet eval (the bench checkpoint, B=1, F=40,
    32², the input of `tests/test_torch_bf16_mug.py`) in bf16 against fp32
    (TF32 off) on the card: the output's distance, gated at
    `BF16_READING_MARGIN` times the CPU reading, and each top-level block's
    distance over its fp32 output's largest value."""
    import torch

    from cvpr23_lfdm_torch.scripts.bench_unet import make_unet

    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, F_FRAMES, 32, 32, 3)).astype(np.float32)
    fea = rng.standard_normal((1, 1, 32, 32, 256)).astype(np.float32)
    cond = np.load(os.path.join(ROOT, "assets", "bench_ckpt", "cond.npy")).astype(np.float32)[None]
    inputs = [torch.from_numpy(a).cuda() for a in (x, np.array([BF16_T]), cond, fea)]
    outs, blocks = {}, {}
    for dname in ("float32", "bfloat16"):
        unet = make_unet("pallas3", None, dname, "cuda")
        seen = blocks[dname] = {}
        for name, mod in unet.named_children():
            mod.register_forward_hook(lambda m, i, o, name=name: seen.__setitem__(name, o.float())
                                      if torch.is_tensor(o) else None)
        with torch.no_grad():
            outs[dname] = unet(*inputs[:3], fea=inputs[3]).float()
        del unet
    scale = float(outs["float32"].abs().max())
    diff = (outs["bfloat16"] - outs["float32"]).abs()
    got = {"max": float(diff.max()) / scale, "mean": float(diff.mean()) / scale}
    per_block = {n: float((blocks["bfloat16"][n] - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
                 for n, ref in blocks["float32"].items()}
    line = {"phase": "bf16 reading", "what": "pallas3 UNet eval, bf16 vs fp32 (TF32 off), bench checkpoint, "
                                             f"B=1, F={F_FRAMES}, 32², t={BF16_T}",
            "scale": scale, "of_scale": got, "cpu_reading": BF16_CPU_READING, "margin": BF16_READING_MARGIN,
            "per_block_of_block_scale": per_block, "finite": torch_isfinite(outs["bfloat16"])}
    line["ok"] = bool(line["finite"] and all(got[k] <= BF16_READING_MARGIN * BF16_CPU_READING[k] for k in got))
    emit({**line, "gpu": gpu_line()})
    if not line["ok"]:
        failures.append("bf16 reading")
    del outs, blocks
    torch.cuda.empty_cache()


def run_profile_sampler(failures: list) -> None:
    """`scripts/profile_sampler.py` at B=1 and 8, one profiled video each:
    rows 1-3 in their own groups with a device launch count in (0, n] per
    call (the profiler may lose kernels, never add one), no port kernel in
    `other`, device busy above 0."""
    from cvpr23_lfdm_torch.scripts import profile_sampler

    out = os.path.join(ROOT, "chip_smoke_out")
    records = profile_sampler.main(["--batch", "1", "8", "--iters", "1", "--top", "15", "--out", out])
    want = {"fused_temporal_layer": TEMPORAL_PER_EVAL * DDIM_STEPS,
            "fused_spatial_linear_layer": 2 * LINEAR_PER_EVAL * DDIM_STEPS, "warp_blend": 3}
    for rec in records:
        groups = rec["groups"]
        counts = {g: groups.get(g, {}).get("launches", 0) for g in want}
        line = {"phase": "profile sampler", "batch": rec["batch"], "wall_ms_per_call": rec["wall_ms_per_call"],
                "frames_per_s": rec["frames_per_s"], "device_busy_ms_per_call": rec["device_busy_ms_per_call"],
                "device_busy_share": rec["device_busy_share"],
                "device_launches_per_call": rec["device_launches_per_call"], "groups": groups,
                "port_kernel_launches": counts, "port_kernel_launches_at_most": want}
        line["ok"] = bool(rec["device_busy_ms_per_call"] > 0 and all(0 < counts[g] <= n for g, n in want.items()))
        emit({**line, "gpu": gpu_line()})
        if not line["ok"]:
            failures.append(f"profile sampler B={rec['batch']}")


def run_bench_scripts(failures: list) -> None:
    """The measurement scripts of the port, each through its `main`:
    `bench_attention` at one shape, `bench_attn_fused` at its hot shape
    under every cluster size, `bench_batch_sweep` at B=1 and 16 and
    `bench_train --stage dm`."""
    import torch

    from cvpr23_lfdm_torch.scripts import bench_attention, bench_attn_fused, bench_batch_sweep, bench_train

    recs = bench_attention.run(shapes=[(1, 1024, 64)], impls=("xla", "pallas", "pallas2", "pallas3"))
    line = {"phase": "bench attention", **recs[0], "tol": BENCH_ATTN_TOL}
    line["ok"] = bool(all(np.isfinite(v) for v in line["ms"].values())
                      and all(v <= BENCH_ATTN_TOL for v in line["max_abs_vs_xla"].values()))
    emit({**line, "gpu": gpu_line()})
    if not line["ok"]:
        failures.append("bench attention")

    recs = bench_attn_fused.main(["--cluster", "1", "2", "4", "8"])
    line = {"phase": "bench attn fused", "shape": [8, F_FRAMES, 1024, 64], "variants": recs}
    line["ok"] = bool(all(np.isfinite(r["layer_ms"]) and r["within_tol"] is not False for r in recs))
    emit({**line, "gpu": gpu_line()})
    if not line["ok"]:
        failures.append("bench attn fused")
    torch.cuda.empty_cache()

    recs = bench_batch_sweep.main(["--batches", "1", str(SERVE_BATCH), "--iters", "1", "--pipe-depth", "2"])
    *per_batch, summary = recs
    rows = ("fused_temporal_layer", "fused_spatial_linear_layer", "warp_video")
    want = {"fused_temporal_layer": TEMPORAL_PER_EVAL * DDIM_STEPS,
            "fused_spatial_linear_layer": LINEAR_PER_EVAL * DDIM_STEPS, "warp_video": 3}
    line = {"phase": "bench batch sweep", "batches": [r["batch"] for r in per_batch],
            "percall_fps": {r["batch"]: r["percall_fps"] for r in per_batch},
            "pipelined_fps": {r["batch"]: r["pipelined_fps"] for r in per_batch},
            "peak_mem_gb": {r["batch"]: r["peak_mem_gb"] for r in per_batch},
            "launches_per_call": {r["batch"]: {k: r["launches_per_call"][k] for k in rows} for r in per_batch},
            "launches_expected": want, "winner": summary["winner"], "pipelined": summary["pipelined"],
            "host_syncs": summary["host_syncs"], "sync_error": summary["sync_error"]}
    line["ok"] = bool(summary["pipelined"] and all(
        r["finite"] and r["out_vid_in_unit_range"] and {k: r["launches_per_call"][k] for k in rows} == want
        for r in per_batch))
    emit({**line, "gpu": gpu_line()})
    if not line["ok"]:
        failures.append("bench batch sweep")
    torch.cuda.empty_cache()

    recs = bench_train.main(["--stage", "dm", "--iters", "3"])
    line = {"phase": "bench train", **{k: v for k, v in recs[0].items() if k != "card"}}
    line["ok"] = bool(np.isfinite(line["value"]) and line["flops_kernels"] > 0 and line["mfu"] > 0
                      and line["device_busy_ms"] > 0)
    emit({**line, "gpu": gpu_line()})
    if not line["ok"]:
        failures.append("bench train")
    torch.cuda.empty_cache()


# ------------------------------------------------------- the user entry points

TEXT_TOL = 1e-4  # BERT class tables, the card's fp32 (TF32 off) against the CPU's
DEMO_CLASSES = ("anger", "happiness")  # the in-process demo run (the subprocess runs all 7)
DM_TEST_VIDEOS = 4
INTERP_T, INTERP_PARITY_T = 20, 3
# per video of `test_dm`: the sampled video's 10 UNet evals and 3 decode warps,
# and `loss`'s one UNet eval, pseudo-ground-truth decode (4) and x0 decode (3)
DM_TEST_LAUNCHES = {"fused_temporal_layer": 10 * (DDIM_STEPS + 1),
                    "fused_spatial_linear_layer": 8 * (DDIM_STEPS + 1), "warp_video": 10}


def hf_bert_state(spec, seed: int) -> dict:
    """Seeded weights of a `BertModel` under the HF names (kernels N(0,
    1/fan_in), LayerNorm scales 1 + N(0, 0.01), biases N(0, 0.01))."""
    import torch

    g = torch.Generator().manual_seed(seed)
    h, i = spec.hidden_size, spec.intermediate_size
    dense = lambda o, k: torch.randn(o, k, generator=g) / k ** 0.5  # noqa: E731
    small = lambda n: 0.1 * torch.randn(n, generator=g)  # noqa: E731

    def ln(p):
        return {p + ".weight": 1 + small(h), p + ".bias": small(h)}

    sd = {"embeddings.word_embeddings.weight": dense(spec.vocab_size, h),
          "embeddings.position_embeddings.weight": dense(spec.max_position_embeddings, h),
          "embeddings.token_type_embeddings.weight": dense(spec.type_vocab_size, h),
          **ln("embeddings.LayerNorm")}
    for n in range(spec.num_layers):
        p = f"encoder.layer.{n}."
        for name, (o, k) in {"attention.self.query": (h, h), "attention.self.key": (h, h),
                             "attention.self.value": (h, h), "attention.output.dense": (h, h),
                             "intermediate.dense": (i, h), "output.dense": (h, i)}.items():
            sd[p + name + ".weight"], sd[p + name + ".bias"] = dense(o, k), small(o)
        sd.update(ln(p + "attention.output.LayerNorm"))
        sd.update(ln(p + "output.LayerNorm"))
    return sd


def write_bert_checkpoint(path: str, seed: int = 0) -> None:
    """A seeded HF checkpoint directory at `bert-base-cased` widths:
    `config.json`, `vocab.txt` (28996 entries: the special tokens, every word
    and punctuation mark of the three datasets' class texts, then fillers)
    and `model.safetensors`."""
    from cvpr23_lfdm_torch.models.bert import BertSpec
    from cvpr23_lfdm_torch.models.text import DATASET_CLASSES
    from cvpr23_lfdm_torch.utils.safetensors import save_file

    spec = BertSpec()
    words = sorted({w for classes in DATASET_CLASSES.values() for t in classes
                    for w in t.replace("(", " ( ").replace(")", " ) ").split()})
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words
    vocab += [f"[unused{k}]" for k in range(spec.vocab_size - len(vocab))]
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"vocab_size": spec.vocab_size, "hidden_size": spec.hidden_size,
                   "num_hidden_layers": spec.num_layers, "num_attention_heads": spec.num_heads,
                   "intermediate_size": spec.intermediate_size,
                   "max_position_embeddings": spec.max_position_embeddings,
                   "type_vocab_size": spec.type_vocab_size, "layer_norm_eps": spec.layer_norm_eps}, f)
    save_file(hf_bert_state(spec, seed), os.path.join(path, "model.safetensors"))


def run_text(failures: list, work: str) -> str:
    """`TextEmbedder.build` for MUG, MHAD and NATOPS at `bert-base-cased`
    widths from a seeded HF directory, on the card and on the CPU (fp32, TF32
    off), within `TEXT_TOL`; seconds per table and peak memory. Returns the
    checkpoint directory."""
    import torch

    from cvpr23_lfdm_torch.models import text as T

    bert = os.path.join(work, "bert")
    _, write_s = timed(lambda: write_bert_checkpoint(bert))
    saved = T._CACHE_DIR
    try:
        for dataset in ("mug", "mhad", "natops"):
            T._CACHE_DIR = os.path.join(work, "cache_cuda")
            torch.cuda.reset_peak_memory_stats()
            card, card_s = timed(lambda: T.TextEmbedder.build(dataset, model_name_or_path=bert))
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            T._CACHE_DIR = os.path.join(work, "cache_cpu")
            cpu, cpu_s = timed(lambda: T.TextEmbedder.build(dataset, model_name_or_path=bert, device="cpu"))
            err = float(np.abs(card.table - cpu.table).max())
            line = {"phase": "text", "dataset": dataset, "classes": len(card.classes),
                    "table": list(card.table.shape), "dtype": "float32 (TF32 off)",
                    "weights": "seeded, bert-base-cased widths (12 x 768, vocab 28996)",
                    "checkpoint_write_s": write_s, "card_s_per_table": card_s, "cpu_s_per_table": cpu_s,
                    "peak_mem_gb": peak, "max_abs_card_vs_cpu": err, "tol": TEXT_TOL,
                    "ok": bool(np.isfinite(card.table).all() and err <= TEXT_TOL)}
            emit({**line, "gpu": gpu_line()})
            if not line["ok"]:
                failures.append(f"text {dataset}")
    finally:
        T._CACHE_DIR = saved
    return bert


def run_cli_demo(failures: list, work: str, bert: str) -> None:
    """`python -m cvpr23_lfdm_torch.scripts.demo` in a subprocess on the bench
    checkpoint, the bundled PNG and the seeded BERT (all 7 MUG classes; gated:
    exit 0, one GIF89a per class); then `demo.run` in this process for
    `DEMO_CLASSES`, the launch counters set to 0 just before and read just
    after (gated: 100 / 80 / 3 per class video), and its `out_vid` against a
    direct `sample_video` with the same generator (gated: torch.equal, cuDNN
    deterministic), whose time is the class video's time without the host's
    panels and GIF."""
    import torch

    from cvpr23_lfdm_torch.models import text as T
    from cvpr23_lfdm_torch.scripts import demo
    from cvpr23_lfdm_torch.scripts._common import load_text_embedder

    log = os.path.join(work, "demo_cli")
    cache = T.TextEmbedder.cache_path("mug")
    had_cache = os.path.exists(cache)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, "-m", "cvpr23_lfdm_torch.scripts.demo", "--bert-path", bert,
                               "--log-dir", log], cwd=ROOT, capture_output=True, text=True, timeout=600,
                              env={**os.environ, "PYTHONPATH": ROOT})
    finally:
        if not had_cache and os.path.exists(cache):  # the CLI caches the table in assets/
            os.remove(cache)
    secs = time.perf_counter() - t0
    gif_dir = os.path.join(log, "demo")
    gifs = sorted(os.listdir(gif_dir)) if os.path.isdir(gif_dir) else []
    heads = []
    for g in gifs:
        with open(os.path.join(gif_dir, g), "rb") as f:
            heads.append(f.read(6) == b"GIF89a")
    line = {"phase": "cli demo", "how": "subprocess, 7 MUG classes", "exit": proc.returncode,
            "gifs": gifs, "gif_bytes": sum(os.path.getsize(os.path.join(gif_dir, g)) for g in gifs),
            "s": secs, "stdout_tail": proc.stdout.strip().splitlines()[-2:],
            "stderr_tail": proc.stderr.strip().splitlines()[-3:] if proc.returncode else []}
    line["ok"] = proc.returncode == 0 and len(gifs) == 7 and all(heads)
    emit({**line, "gpu": gpu_line()})
    if not line["ok"]:
        failures.append("cli demo subprocess")

    saved = T._CACHE_DIR, torch.backends.cudnn.deterministic
    T._CACHE_DIR, torch.backends.cudnn.deterministic = os.path.join(work, "cache_demo"), True
    try:
        args = demo.parser().parse_args(["--bert-path", bert, "--log-dir", os.path.join(work, "demo_run"),
                                         "--classes", *DEMO_CLASSES])
        cfg = demo.build_config(args)
        demo.run(cfg, args)  # warm-up; builds the table
        torch.cuda.synchronize()
        reset_counters()
        res, secs = timed(lambda: demo.run(cfg, args))
        launches = counters()
        n = len(DEMO_CLASSES)
        want = {"fused_temporal_layer": 10 * DDIM_STEPS * n, "fused_spatial_linear_layer": 8 * DDIM_STEPS * n,
                "warp_video": 3 * n, "groupnorm_film_silu": norm_per_eval() * DDIM_STEPS * n}
        _, model = demo.build_model(cfg, args)
        ref = torch.from_numpy(demo.reference_image(args, cfg.lfae.frame_shape))[None].cuda()
        table = load_text_embedder(args)
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        equal, diff, sample_s = True, 0.0, 0.0
        for text in DEMO_CLASSES:
            cond = torch.from_numpy(table([text])[0]).cuda()
            direct, s_video = timed(lambda: model.sample_video(ref, cond, args.cond_scale, generator=gen))
            direct, sample_s = direct["out_vid"].float().cpu(), sample_s + s_video
            got = torch.from_numpy(res["outputs"][text]["out_vid"])
            equal &= torch.equal(got, direct)
            diff = max(diff, float((got - direct).abs().max()))
        finite = all(np.isfinite(v).all() for o in res["outputs"].values() for v in o.values())
        line = {"phase": "cli demo", "how": f"demo.run in process, classes {list(DEMO_CLASSES)}",
                "launches": {k: launches[k] for k in want}, "launches_expected": want,
                "other_kernel_launches": {k: v for k, v in launches.items() if k not in want and v},
                "s": secs, "s_per_class_video": secs / n, "sample_video_s_per_video": sample_s / n,
                "out_vid_equal_direct": equal,
                "out_vid_max_abs_vs_direct": diff, "finite": finite}
        line["ok"] = bool(equal and finite and not line["other_kernel_launches"]
                          and all(launches[k] == v for k, v in want.items()))
        emit({**line, "gpu": gpu_line()})
        if not line["ok"]:
            failures.append("cli demo in process")
        del model
    finally:
        T._CACHE_DIR, torch.backends.cudnn.deterministic = saved
    torch.cuda.empty_cache()


def run_cli_eval(failures: list, work: str) -> None:
    """`test_dm --synthetic --num-videos 4 --random-metric-weights
    --bench-ckpt assets/bench_ckpt` and `eval_flowautoenc --synthetic` in this
    process through their `main(argv)`, the launch counters set to 0 just
    before each and read just after. Gated: returned without an exit,
    finite metrics, rows 1-3 launched `DM_TEST_LAUNCHES` per video; the
    eval's losses finite and 20 row-3 launches per batch."""
    import torch

    from cvpr23_lfdm_torch.data import DMVideoDataset, get_spec
    from cvpr23_lfdm_torch.scripts import eval_flowautoenc, test_dm

    root = os.path.join(work, "corpus")
    argv = ["--synthetic", "--data-root", root, "--num-videos", str(DM_TEST_VIDEOS), "--random-metric-weights",
            "--bench-ckpt", os.path.join(ROOT, "assets", "bench_ckpt"), "--log-dir", os.path.join(work, "dm")]
    reset_counters()
    try:
        res, secs = timed(lambda: test_dm.main(argv))
    except SystemExit as e:
        res, secs = {"exit": str(e)}, 0.0
    launches = counters()
    want = {k: v * DM_TEST_VIDEOS for k, v in DM_TEST_LAUNCHES.items()}
    keys = ("rec_loss", "warp_loss", "psnr", "ssim", "lpips", "fvd", "cfvd", "sfvd")
    finite = all(k in res and np.isfinite(res[k]) for k in keys)
    line = {"phase": "cli test_dm", "argv": argv, **res, "launches": {k: launches[k] for k in want},
            "launches_expected": want, "s": secs, "s_per_video_setup_included": secs / DM_TEST_VIDEOS,
            "finite": finite, "weights": "bench checkpoint (region/bg predictors seeded); seeded I3D, LPIPS"}
    line["ok"] = bool(finite and all(launches[k] == v for k, v in want.items()))
    emit({**line, "gpu": gpu_line()})
    if not line["ok"]:
        failures.append("cli test_dm")
    torch.cuda.empty_cache()

    argv = ["--synthetic", "--data-root", root, "--log-dir", os.path.join(work, "eval")]
    videos = len(DMVideoDataset(get_spec("mug"), root, "test"))
    batches = -(-videos // 10)
    reset_counters()
    try:
        res, secs = timed(lambda: eval_flowautoenc.main(argv))
    except SystemExit as e:
        res, secs = {"exit": str(e)}, 0.0
    launches = counters()
    want = 4 * -(-F_FRAMES // 8) * batches  # 4 per FlowAE call x 5 chunks of 8 frames
    finite = all(k in res and np.isfinite(res[k]) for k in ("out_loss", "warp_loss"))
    line = {"phase": "cli eval_flowautoenc", "argv": argv, **res, "videos": videos, "batches": batches,
            "warp_video_launches": launches["warp_video"], "warp_video_launches_expected": want,
            "s": secs, "s_per_batch": secs / batches, "weights": "seeded (seed_lfae_weights(0))",
            "finite": finite}
    line["ok"] = bool(finite and launches["warp_video"] == want)
    emit({**line, "gpu": gpu_line()})
    if not line["ok"]:
        failures.append("cli eval_flowautoenc")
    torch.cuda.empty_cache()

    # --save-video: the warp lattices, drawn without matplotlib
    log = os.path.join(work, "eval_video")
    argv = ["--synthetic", "--data-root", root, "--log-dir", log, "--save-video", "--num-batches", "1",
            "--batch-size", "4"]
    reset_counters()
    try:
        res, secs = timed(lambda: eval_flowautoenc.main(argv))
    except SystemExit as e:
        res, secs = {"exit": str(e)}, 0.0
    launches = counters()
    gif_dir = os.path.join(log, "eval_videos")
    gifs = sorted(os.listdir(gif_dir)) if os.path.isdir(gif_dir) else []
    heads = []
    for g in gifs:
        with open(os.path.join(gif_dir, g), "rb") as f:
            heads.append(f.read(6) == b"GIF89a")
    want_gifs = min(4, videos)
    line = {"phase": "cli eval_flowautoenc", "how": "--save-video, one batch", "argv": argv, **res,
            "gifs": len(gifs), "gifs_expected": want_gifs,
            "gif_bytes": sum(os.path.getsize(os.path.join(gif_dir, g)) for g in gifs),
            "warp_video_launches": launches["warp_video"], "warp_video_launches_expected": 20,
            "s": secs, "lattice_renders": want_gifs * F_FRAMES}
    line["ok"] = bool(len(gifs) == want_gifs and all(heads) and launches["warp_video"] == 20
                      and all(np.isfinite(res.get(k, np.nan)) for k in ("out_loss", "warp_loss")))
    emit({**line, "gpu": gpu_line()})
    if not line["ok"]:
        failures.append("cli eval_flowautoenc --save-video")
    torch.cuda.empty_cache()


def run_interpolate(failures: list) -> None:
    """`GaussianDiffusion.interpolate` at MUG width on the bench checkpoint:
    bf16, t = `INTERP_T`, two seeded latent volumes, finite, rows 1 and 2
    launched 10 and 8 per step (counters set to 0 just before, read just
    after); then fp32 at t = `INTERP_PARITY_T` with injected noise, the
    kernels against the plain versions (the test hook) within `PATH_TOL`."""
    import torch

    for dtype, t in (("bfloat16", INTERP_T), ("float32", INTERP_PARITY_T)):
        cfg, model, cond, ref, _ = serving_model(dtype)
        d = cfg.diffusion
        shape = (1, d.num_frames, d.img_size, d.img_size, 3)
        rng = np.random.RandomState(9)
        draws = [torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)).cuda() for _ in range(2)]
        noise = [torch.from_numpy(rng.standard_normal((k,) + shape).astype(np.float32)).cuda() for k in (1, 1, t)]

        def interp():
            with torch.no_grad():
                fea = model.generator.compute_fea(ref)
                return model.diffusion.interpolate(model.denoise, draws[0], draws[1], fea, cond, 1.0, t=t,
                                                   lam=0.5, noise1=noise[0][0], noise2=noise[1][0],
                                                   noise_seq=noise[2])

        interp()  # warm-up
        reset_counters()
        out, secs = timed(interp)
        launches = counters()
        want = {"fused_temporal_layer": 10 * t, "fused_spatial_linear_layer": 8 * t}
        line = {"phase": "interpolate", "dtype": dtype, "t": t, "shape": list(out.shape),
                "finite": torch_isfinite(out), "launches": {k: launches[k] for k in want},
                "launches_expected": want, "s": secs}
        ok = line["finite"] and all(launches[k] == v for k, v in want.items())
        if dtype == "float32":
            with plain_ops():
                plain = interp()
            line["max_abs_vs_plain"] = float((out - plain).abs().max())
            line["tol"] = PATH_TOL
            ok = ok and line["max_abs_vs_plain"] <= PATH_TOL
        line["ok"] = bool(ok)
        emit({**line, "gpu": gpu_line()})
        if not ok:
            failures.append(f"interpolate {dtype}")
        del model
        torch.cuda.empty_cache()


# ------------------------------------------------------- the training entry points

TRAIN_CLI_SEED = 1234
TRAIN_SIZE = 128  # the MUG config's frames
# layers per UNet evaluation of the MUG config: temporal (rows 1, 4, 5) and linear attention (row 2)
TEMPORAL_PER_EVAL, LINEAR_PER_EVAL = 10, 8
HEADPACKED_PER_EVAL = TEMPORAL_PER_EVAL
# the in-process `train_dm.run`'s diffusion schedule (phase 23): the preset's
# ancestral sampler (timesteps == sampling_timesteps) at a cut depth
ANCESTRAL_STEPS = 20


def cli(module: str, argv: list, timeout: int = 600):
    """`python -m cvpr23_lfdm_torch.scripts.<module> argv` in a subprocess:
    `(CompletedProcess, seconds)`."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"cvpr23_lfdm_torch.scripts.{module}", *argv], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout, env={**os.environ, "PYTHONPATH": ROOT})
    return proc, time.perf_counter() - t0


def tails(proc) -> dict:
    return {"exit": proc.returncode, "stdout_tail": proc.stdout.strip().splitlines()[-3:],
            "stderr_tail": proc.stderr.strip().splitlines()[-4:] if proc.returncode else []}


def listing(path: str) -> list:
    return sorted(os.listdir(path)) if os.path.isdir(path) else []


@contextlib.contextmanager
def step_clock(trainer_cls):
    """Seconds of each `trainer_cls.train_step` inside the block (host
    clock ending in a synchronize, the batch's transfer included), with each
    step's metrics as floats in `trainer_cls.metrics_seen`."""
    import torch

    step, times = trainer_cls.train_step, []
    trainer_cls.metrics_seen = []

    def timed_step(self, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(self, *a, **k)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        trainer_cls.metrics_seen.append({n: float(v) for n, v in m.items()})
        return state, m

    trainer_cls.train_step = timed_step
    try:
        yield times
    finally:
        trainer_cls.train_step = step


@contextlib.contextmanager
def samplers_seen():
    """The samplers `GaussianDiffusion.sample` took inside the block, as
    (name, finite output) per call."""
    from cvpr23_lfdm_torch.diffusion.gaussian_diffusion import GaussianDiffusion

    seen, saved = [], {n: getattr(GaussianDiffusion, n) for n in ("p_sample_loop", "ddim_sample")}

    def recorded(name, fn):
        def call(self, *a, **k):
            out = fn(self, *a, **k)
            seen.append((name, torch_isfinite(out)))
            return out
        return call

    for name, fn in saved.items():
        setattr(GaussianDiffusion, name, recorded(name, fn))
    try:
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(GaussianDiffusion, name, fn)


def run_train_corpus(work: str) -> str:
    """Phase 22: the synthetic MUG corpus every training phase reads."""
    from cvpr23_lfdm_torch.data.specs import get_spec
    from cvpr23_lfdm_torch.data.synthetic import make_synthetic_corpus

    root = os.path.join(work, "train_corpus")
    spec = get_spec("mug")
    subjects = list(spec.train_subjects[:2]) + list(spec.test_subjects[:2])
    t0 = time.perf_counter()
    make_synthetic_corpus(root, "mug", num_frames=F_FRAMES, size=TRAIN_SIZE, seed=TRAIN_CLI_SEED,
                          subjects=subjects, classes=None, takes=2)
    emit({"phase": "corpus", "root_files": sum(len(f) for _, _, f in os.walk(root)), "frames": F_FRAMES,
          "size": TRAIN_SIZE, "subjects": subjects, "s": time.perf_counter() - t0})
    return root


def run_cli_train_dm(failures: list, work: str, root: str) -> None:
    """Phase 23: the DM training CLI in a subprocess (4 steps, every hook,
    the sampled video at DDIM-10, then resumed to 6) and `train_dm.run` in
    this process with the launch counters, its sample hook on the preset's
    sampler kind (ancestral, `p_sample_loop`) over a schedule cut to
    `ANCESTRAL_STEPS`."""
    import dataclasses

    import torch

    from cvpr23_lfdm_torch.scripts import train_dm
    from cvpr23_lfdm_torch.train import dm_trainer
    from cvpr23_lfdm_torch.utils import viz
    from cvpr23_lfdm_torch.utils.checkpoint import CheckpointManager

    log = os.path.join(work, "train_dm_cli")
    base = ["--synthetic", "--data-root", root, "--log-dir", log, "--save-img-freq", "2", "--save-vid-freq", "3",
            "--sample-vid-freq", "4", "--sampling-steps", str(DDIM_STEPS)]
    first, first_s = cli("train_dm", base + ["--num-steps", "4"])
    resumed, resumed_s = cli("train_dm", base + ["--num-steps", "6", "--resume"])
    imgs, shots = listing(os.path.join(log, "dm_imgs")), listing(os.path.join(log, "dm_vidshots"))
    samples = listing(os.path.join(log, "dm_samples"))
    latest = CheckpointManager(os.path.join(log, "dm_ckpt")).latest_step() if os.path.isdir(
        os.path.join(log, "dm_ckpt")) else None
    want = {"imgs": [f"step_{k:07d}.png" for k in (2, 4, 6)],
            "vidshots": ["B0005_S000003.gif", "B0005_S000006.gif"], "samples": ["B0005_S000004.gif"]}
    line = {"phase": "cli train_dm", "how": f"subprocess, B=5, 4 steps (sample at DDIM-{DDIM_STEPS}) then --resume "
                                           "to 6", "first": tails(first),
            "resumed": tails(resumed), "first_s": first_s, "resumed_s": resumed_s, "imgs": imgs,
            "vidshots": shots, "samples": samples, "latest_step": latest,
            "resumed_at_4": "resumed at step 4" in resumed.stdout}
    line["ok"] = bool(first.returncode == 0 and resumed.returncode == 0 and line["resumed_at_4"] and latest == 6
                      and imgs == want["imgs"] and shots == want["vidshots"] and samples == want["samples"])
    emit({**line, "gpu": gpu_line()})
    if not line["ok"]:
        failures.append("cli train_dm subprocess")

    # in process, counted: 4 steps, still grid at 2 and 4, GIF and sample at 4;
    # timesteps == sampling_timesteps, so the hook's sampler is the ancestral one
    steps, ancestral = 4, ANCESTRAL_STEPS
    args = train_dm.parser().parse_args(["--synthetic", "--data-root", root, "--log-dir", os.path.join(work, "dm_run"),
                                         "--num-steps", str(steps), "--save-img-freq", "2", "--save-vid-freq",
                                         str(10 * steps), "--sample-vid-freq", "4"])
    cfg = train_dm.build_config(args)
    cfg = cfg.replace(diffusion=dataclasses.replace(cfg.diffusion, timesteps=ancestral, sampling_timesteps=ancestral))
    torch.cuda.synchronize()
    reset_counters()
    with step_clock(dm_trainer.DMTrainer) as step_s, samplers_seen() as sampled_by:
        res = train_dm.run(cfg, args)
    launches = counters()
    monitors, sampled = 3, 1  # viz at 2 and 4, the sample hook's own monitor; one sampled video
    want = {"headpacked_attention_fwd": HEADPACKED_PER_EVAL * (steps + monitors + ancestral * sampled),
            "headpacked_attention_bwd": HEADPACKED_PER_EVAL * steps}
    others = {k: v for k, v in launches.items() if k not in want and k != "warp_video" and v}
    finite = all(bool(torch.isfinite(p).all()) for p in res["trainer"].model.unet.parameters())
    line = {"phase": "cli train_dm", "how": f"train_dm.run in process, {steps} steps, grid at 2/4, sample at 4 "
                                           f"(p_sample_loop, {ancestral} timesteps)",
            "samplers": sampled_by, "launches": {k: launches[k] for k in (*want, "warp_video")},
            "launches_expected": want,
            "other_kernel_launches": others, "fit_s": res["fit_s"], "hook_s": res["hook_s"],
            "hooks_s": res["hooks_s"], "step_s": step_s, "s_per_step_after_the_first": float(np.median(step_s[1:])),
            "s_per_step_with_hooks": res["fit_s"] / steps,
            "s_per_step_without_hooks": (res["fit_s"] - res["hook_s"]) / steps, "finite": finite}
    line["ok"] = bool(finite and not others and launches["warp_video"] > 0 and sampled_by == [("p_sample_loop", True)]
                      and all(launches[k] == v for k, v in want.items()))
    emit({**line, "gpu": gpu_line()})
    if not line["ok"]:
        failures.append("cli train_dm in process")
    del res
    torch.cuda.empty_cache()

    # host seconds of one training GIF's panels: 40 frames, 2 lattices each
    rng = np.random.default_rng(0)
    lin = np.linspace(-1, 1, 32, dtype=np.float32)
    ident = np.stack(np.meshgrid(lin, lin, indexing="xy"), -1)
    vid = rng.random((F_FRAMES, TRAIN_SIZE, TRAIN_SIZE, 3)).astype(np.float32)
    grids = ident + 0.02 * rng.standard_normal((F_FRAMES, 32, 32, 2)).astype(np.float32)
    conf = rng.random((F_FRAMES, 32, 32, 1)).astype(np.float32)
    t0 = time.perf_counter()
    frames = viz.dm_training_gif(vid[0], vid, vid, vid, vid, vid, grids, grids, conf, conf, img_size=TRAIN_SIZE)
    gif_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    viz.save_gif(os.path.join(work, "panel.gif"), frames)
    emit({"phase": "cli train_dm", "how": "one training GIF on the host (40 frames, 80 grid2fig renders)",
          "panels_s": gif_s, "grid2fig_ms": 1e3 * gif_s / (2 * F_FRAMES), "gif_write_s": time.perf_counter() - t0,
          "frames": list(frames.shape), "gpu": gpu_line()})


def run_cli_train_lfae(failures: list, work: str, root: str) -> None:
    """Phase 24: the LFAE training CLI in a subprocess (2 steps, then
    resumed to 4) and `train_lfae.run` in this process with the counters;
    the thread loader's seconds per batch."""
    import torch

    from cvpr23_lfdm_torch.data import ClipAugment, DatasetRepeater, LFAEPairDataset, PrefetchLoader, get_spec
    from cvpr23_lfdm_torch.scripts import train_lfae
    from cvpr23_lfdm_torch.train import lfae_trainer

    log = os.path.join(work, "train_lfae_cli")
    base = ["--synthetic", "--data-root", root, "--log-dir", log, "--save-img-freq", "2"]
    first, first_s = cli("train_lfae", base + ["--num-steps", "2"])
    resumed, resumed_s = cli("train_lfae", base + ["--num-steps", "4", "--resume"])
    boards = listing(os.path.join(log, "lfae_imgs"))
    line = {"phase": "cli train_lfae", "how": "subprocess, B=100, 2 steps then --resume to 4",
            "first": tails(first), "resumed": tails(resumed), "first_s": first_s, "resumed_s": resumed_s,
            "boards": boards, "resumed_at_2": "resumed at step 2" in resumed.stdout}
    line["ok"] = bool(first.returncode == 0 and resumed.returncode == 0 and line["resumed_at_2"]
                      and boards == [f"step_{k:07d}.png" for k in (2, 4)])
    emit({**line, "gpu": gpu_line()})
    if not line["ok"]:
        failures.append("cli train_lfae subprocess")

    steps = 4
    args = train_lfae.parser().parse_args(["--synthetic", "--data-root", root, "--log-dir",
                                           os.path.join(work, "lfae_run"), "--num-steps", str(steps),
                                           "--save-img-freq", "2"])
    torch.cuda.synchronize()
    reset_counters()
    with step_clock(lfae_trainer.LFAETrainer) as step_s:
        res = train_lfae.run(train_lfae.build_config(args), args)
    launches = counters()
    losses = lfae_trainer.LFAETrainer.metrics_seen
    boards = listing(os.path.join(work, "lfae_run", "lfae_imgs"))
    want = 4 * len(boards)  # four decode warps per reconstruct
    others = {k: v for k, v in launches.items() if k != "warp_video" and v}
    finite = all(np.isfinite(v) for m in losses for v in m.values()) and len(losses) == steps
    line = {"phase": "cli train_lfae", "how": f"train_lfae.run in process, {steps} steps, board at 2 and 4",
            "losses": losses, "finite": finite, "boards": boards, "warp_video_launches": launches["warp_video"],
            "warp_video_launches_expected": want, "other_kernel_launches": others, "fit_s": res["fit_s"],
            "hook_s": res["hook_s"], "step_s": step_s, "s_per_step_after_the_first": float(np.median(step_s[1:])),
            "s_per_step_without_hooks": (res["fit_s"] - res["hook_s"]) / steps,
            "s_per_step_with_hooks": res["fit_s"] / steps, "dtype": "float32 (TF32 off)",
            "avd_params": res["avd_params"]}
    line["ok"] = bool(finite and len(boards) == 2 and launches["warp_video"] == want and not others)
    emit({**line, "gpu": gpu_line()})
    if not line["ok"]:
        failures.append("cli train_lfae in process")
    del res
    torch.cuda.empty_cache()

    # the loader the CLI runs: 100 pairs per batch, 6 threads
    ds = DatasetRepeater(LFAEPairDataset(get_spec("mug"), root, "train", frame_shape=TRAIN_SIZE, augment=ClipAugment(),
                                         seed=TRAIN_CLI_SEED), 100)
    it = iter(PrefetchLoader(ds, 100, num_workers=6, seed=TRAIN_CLI_SEED))
    next(it)
    t0 = time.perf_counter()
    for _ in range(3):
        next(it)
    emit({"phase": "cli train_lfae", "how": "the thread loader alone (6 threads), 3 batches after the first",
          "loader_s_per_batch": (time.perf_counter() - t0) / 3, "pairs_per_batch": 100, "gpu": gpu_line()})


def run_cli_make_bench_ckpt(failures: list, work: str) -> None:
    """Phase 25: `make_bench_ckpt.main` in this process (2 + 2 steps, one
    probe video) with the counters, then one serving video on the new
    checkpoint."""
    import dataclasses

    import torch

    from cvpr23_lfdm_torch.config import mug_config
    from cvpr23_lfdm_torch.scripts import make_bench_ckpt
    from cvpr23_lfdm_torch.utils.bench_ckpt import apply_bench_ckpt

    out = os.path.join(work, "bench_ckpt")
    dm_steps = 2
    argv = ["--lfae-steps", "2", "--dm-steps", str(dm_steps), "--probe-videos", "1", "--out", out,
            "--data-root", os.path.join(work, "bench_corpus"), "--log-dir", os.path.join(work, "bench_log")]
    torch.cuda.synchronize()
    reset_counters()
    res, secs = timed(lambda: make_bench_ckpt.main(argv))
    launches = counters()
    want = {"fused_temporal_layer": TEMPORAL_PER_EVAL * DDIM_STEPS,
            "fused_spatial_linear_layer": LINEAR_PER_EVAL * DDIM_STEPS, "warp_video": 3 + dm_steps,
            "headpacked_attention_fwd": HEADPACKED_PER_EVAL * dm_steps,
            "headpacked_attention_bwd": HEADPACKED_PER_EVAL * dm_steps,
            "groupnorm_film_silu": norm_per_eval() * DDIM_STEPS}  # the probe's serving video
    files = listing(out)
    need = [".lock", "cond.npy", "fit_report.json", "generator.msgpack", "meta.json", "ref.npy", "unet.msgpack"]
    report = res["report"]
    finite = all(np.isfinite(v) for d in report["disp_p99_px"] for v in d.values())
    others = {k: v for k, v in launches.items() if k not in want and v}
    line = {"phase": "cli make_bench_ckpt", "argv": argv, "files": files, "bytes": res["bytes"],
            "save_s": res["save_s"], "lfae_s": res["lfae_s"], "dm_s": res["dm_s"], "probe_s": res["probe_s"],
            "s": secs, "disp_p99_px": report["disp_p99_px"], "fit_rate_in_report": "fit_rate" in report,
            "launches": {k: launches[k] for k in want}, "launches_expected": want, "other_kernel_launches": others}
    line["ok"] = bool(files == need and finite and "fit_rate" not in report and not others
                      and all(launches[k] == v for k, v in want.items()))
    emit({**line, "gpu": gpu_line()})
    if not line["ok"]:
        failures.append("cli make_bench_ckpt")
    torch.cuda.empty_cache()

    cfg = mug_config()
    cfg = cfg.replace(diffusion=dataclasses.replace(cfg.diffusion, temporal_attn_impl="pallas3",
                                                    sampling_timesteps=DDIM_STEPS))
    try:
        cfg, model, cond, ref, meta = apply_bench_ckpt(out, cfg)
        gen = torch.Generator(device="cuda").manual_seed(0)
        model.sample_video(ref, cond, 1.0, generator=gen)  # warm-up
        torch.cuda.synchronize()
        reset_counters()
        video, secs = timed(lambda: model.sample_video(ref, cond, 1.0, generator=gen))
        launches = counters()
        want = {"fused_temporal_layer": TEMPORAL_PER_EVAL * DDIM_STEPS,
                "fused_spatial_linear_layer": LINEAR_PER_EVAL * DDIM_STEPS, "warp_video": 3,
                "groupnorm_film_silu": norm_per_eval() * DDIM_STEPS}
        line = {"phase": "cli make_bench_ckpt", "how": "apply_bench_ckpt of the new directory, one pallas3 video",
                "objective": meta["objective"], "shape": list(video["out_vid"].shape),
                "finite": all(torch_isfinite(v) for v in video.values()), "launches": {k: launches[k] for k in want},
                "launches_expected": want, "s": secs}
        line["ok"] = bool(line["finite"] and all(launches[k] == v for k, v in want.items()))
        del model
    except (OSError, RuntimeError, KeyError) as e:
        line = {"phase": "cli make_bench_ckpt", "how": "apply_bench_ckpt of the new directory", "error": str(e)[:300],
                "ok": False}
    emit({**line, "gpu": gpu_line()})
    if not line["ok"]:
        failures.append("cli make_bench_ckpt serving")
    torch.cuda.empty_cache()


def run_loader_grain(failures: list, work: str, root: str) -> None:
    """Phase 26: `GrainLoader` against the thread loader on the DM dataset,
    and `train_dm --loader grain` for 3 steps, then resumed to 5, each
    step's batch against a straight stream's."""
    import torch

    from cvpr23_lfdm_torch.config import mug_config
    from cvpr23_lfdm_torch.data import DMVideoDataset, PrefetchLoader, get_spec
    from cvpr23_lfdm_torch.data.grain_loader import GrainLoader
    from cvpr23_lfdm_torch.scripts import train_dm
    from cvpr23_lfdm_torch.train.dm_trainer import DMTrainer

    cfg = mug_config()
    ds = DMVideoDataset(get_spec("mug"), root, "train", num_frames=F_FRAMES, image_size=TRAIN_SIZE,
                        sampling=cfg.dm_train.frame_sampling, seed=TRAIN_CLI_SEED)

    def per_batch(loader, n: int = 5):
        it = iter(loader)
        got = [next(it)]
        t0 = time.perf_counter()
        got += [next(it) for _ in range(n - 1)]
        return got, (time.perf_counter() - t0) / (n - 1)

    grain = GrainLoader(ds, 5, num_workers=8, seed=TRAIN_CLI_SEED)
    straight, grain_s = per_batch(grain)
    grain.close()
    _, threads_s = per_batch(PrefetchLoader(ds, 5, num_workers=16, seed=TRAIN_CLI_SEED))

    seen, train_step = [], DMTrainer.train_step

    def recorded(self, state, rng, batch, *a, **k):  # the batch each step trains on
        seen.append(torch.as_tensor(batch["real_vid"]).cpu().numpy())
        return train_step(self, state, rng, batch, *a, **k)

    log = os.path.join(work, "grain_dm")
    base = ["--synthetic", "--data-root", root, "--log-dir", log, "--loader", "grain"]
    DMTrainer.train_step = recorded
    try:
        first = train_dm.main(base + ["--num-steps", "3"])
        second = train_dm.main(base + ["--num-steps", "5", "--resume"])
    finally:
        DMTrainer.train_step = train_step
    equal = [bool(np.array_equal(a, b["video"])) for a, b in zip(seen, straight)]
    line = {"phase": "loader grain", "batch": 5, "frames": F_FRAMES, "grain_workers": 8, "thread_workers": 16,
            "grain_s_per_batch": grain_s, "threads_s_per_batch": threads_s,
            "steps": [first["start_step"], first["state"].step, second["start_step"], second["state"].step],
            "batches_equal_straight": equal}
    line["ok"] = bool(len(equal) == 5 and all(equal) and line["steps"] == [0, 3, 3, 5])
    emit({**line, "gpu": gpu_line()})
    if not line["ok"]:
        failures.append("loader grain")
    del first, second
    torch.cuda.empty_cache()


HOST_LIBRARIES = ("cv2", "imageio", "PIL", "matplotlib", "grain", "transformers", "flax", "jax", "orbax")


def host_libraries() -> dict:
    """Which of the host libraries the JAX package leans on this
    installation has (found, not imported)."""
    import importlib.util

    return {m: importlib.util.find_spec(m) is not None for m in HOST_LIBRARIES}


def write_avi(path: str, frames: int, size) -> None:
    """An MJPG AVI of seeded frames (`tests/test_preprocess_video.py`'s)."""
    import cv2

    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 20, size)
    rng = np.random.default_rng(0)
    for i in range(frames):
        frame = np.full((size[1], size[0], 3), i * 10 % 255, np.uint8)
        frame[:4, :4] = rng.integers(0, 255, (4, 4, 3), np.uint8)
        writer.write(frame)
    writer.release()


def run_preprocess(failures: list, work: str, root: str) -> None:
    """Phase 27: `preprocess --dataset mug` on the corpus; then `mhad` and
    `natops` on a raw tree. Where this installation has no `cv2`, each must
    raise the ImportError that names the AVI decoder (only that error is
    caught); where it has one, the tree holds MJPG AVIs it writes and each
    must cut them into the frame folders `tests/test_preprocess_video.py`
    expects."""
    from cvpr23_lfdm_torch.scripts import preprocess

    libs = host_libraries()
    res = preprocess.main(["--dataset", "mug", "--data-root", root])
    raw = os.path.join(work, "raw")
    mhad, natops = os.path.join(raw, "mhad"), os.path.join(raw, "natops")
    for d in ("RGB", "Depth"):
        os.makedirs(os.path.join(mhad, d), exist_ok=True)
    os.makedirs(os.path.join(natops, "gesture01"), exist_ok=True)
    avis = {os.path.join(mhad, "RGB", "a1_s1_t1_color.avi"): (4, (640, 480)),
            os.path.join(natops, "gesture01", "g01s01.avi"): (10, (32, 24))}
    for path, (frames, size) in avis.items():
        if libs["cv2"]:
            write_avi(path, frames, size)
        else:
            open(path, "wb").close()  # never decoded: reading it raises first
    open(os.path.join(mhad, "Depth", "a1_s1_t1_depth.mat"), "wb").close()  # only its presence is read
    lines = []
    for subject in range(1, 21):
        lines.append(f"// Subject {subject}")
        for action in range(1, 25):
            lines.append(f"{subject},{action},2")
            if (subject, action) == (1, 1):
                lines += ["1:2,4", "2:6,9"]
    with open(os.path.join(natops, "segmentation.txt"), "w") as f:
        f.write("\n".join(lines))
    outcome = {}
    for dataset, path in (("mhad", mhad), ("natops", natops)):
        out = os.path.join(raw, dataset + "_out")
        try:
            preprocess.main(["--dataset", dataset, "--data-root", path, "--out-dir", out])
            outcome[dataset] = {d: len(os.listdir(os.path.join(out, d))) for d in listing(out)}
        except ImportError as e:
            if libs["cv2"]:
                raise
            outcome[dataset] = str(e)
    if libs["cv2"]:
        ok = outcome == {"mhad": {"a1_s1_t1": 4}, "natops": {"g01s01p01": 3, "g01s01p02": 4}}
    else:
        ok = all(isinstance(e, str) and "AVI" in e and "cv2" in e for e in outcome.values())
    line = {"phase": "preprocess", "host_libraries": libs, "mug_train": len(res["train"]),
            "mug_test": len(res["test"]), "mhad": outcome["mhad"], "natops": outcome["natops"]}
    line["ok"] = bool(res["train"] and ok)
    emit({**line, "gpu": gpu_line()})
    if not line["ok"]:
        failures.append("preprocess")


def run_training_entry_points(failures: list, work: str) -> None:
    """Phases 22-27, on one corpus in `work`."""
    root = run_train_corpus(work)
    run_cli_train_dm(failures, work, root)
    run_cli_train_lfae(failures, work, root)
    run_cli_make_bench_ckpt(failures, work)
    run_loader_grain(failures, work, root)
    run_preprocess(failures, work, root)


def run_entry_points(failures: list) -> None:
    """The phases of the user entry points, in one scratch directory."""
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        bert = run_text(failures, work)
        run_cli_demo(failures, work, bert)
        run_cli_eval(failures, work)
        run_interpolate(failures)
        run_training_entry_points(failures, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------- data parallel (phase 28)

DP_SEED = 20231018
DP_VIDEO_BATCH = 2   # the sharded video: one row per rank of the gloo pair
DP_DM_BATCH = 4      # the gloo pair's global DM batch (2 rows per rank)
DP_LFAE_BATCH = 8    # the gloo pair's global LFAE batch (4 rows per rank)
DP_TIMEOUT_S = 420   # each rank subprocess; its process group times out at 300 s
DP_GROUP_TIMEOUT_S = 300
DP_LFAE_TOL = {"loss_rel": 1e-4, "stats_rel": 1e-4, "grad_max_abs_rel": 2e-3}
DP_VIDEO_LAUNCHES = {"fused_temporal_layer": TEMPORAL_PER_EVAL * DDIM_STEPS,
                     "fused_spatial_linear_layer": LINEAR_PER_EVAL * DDIM_STEPS, "warp_video": 3}
DP_STEP_LAUNCHES = {"headpacked_attention_fwd": HEADPACKED_PER_EVAL,
                    "headpacked_attention_bwd": HEADPACKED_PER_EVAL}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dp_ranks(mode: str, world: int) -> list:
    """`dp_worker(mode, rank, ...)` in `world` subprocesses at once, joined
    by a process group on a free localhost port: their results, rank 0
    first, or the exit codes and error tails of a failed run."""
    import tempfile

    port, out = _free_port(), tempfile.mkdtemp(prefix="chip_smoke_dp_")
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import sys, chip_smoke; sys.exit(chip_smoke.dp_worker("
                               f"{mode!r}, {r}, {world}, {port}, {out!r}))"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT}, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DP_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        path = os.path.join(out, f"rank{r}.json")
        if p.returncode != 0 or not os.path.exists(path):
            results.append({"rank": r, "exit": p.returncode, "stderr_tail": err.strip().splitlines()[-8:]})
        else:
            with open(path) as f:
                results.append(json.load(f))
    return results


def dp_worker(mode: str, rank: int, world: int, port: int, out: str) -> int:
    """One rank of the `dp`, `tp` or `sp` phase: joins the group through
    `init_distributed` (NCCL for `nccl`, else gloo, on cuda:0), runs
    `dp_nccl`, `dp_gloo`, `tp_gloo` or `sp_gloo` and writes its result to
    `<out>/rank<r>.json`."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    from cvpr23_lfdm_torch.parallel import distributed as D

    D.init_distributed(f"127.0.0.1:{port}", world, rank, backend="nccl" if mode == "nccl" else "gloo",
                       device="cuda:0", timeout_s=DP_GROUP_TIMEOUT_S)
    try:
        result = {"nccl": dp_nccl, "gloo": dp_gloo, "tp": tp_gloo, "sp": sp_gloo}[mode](rank)
    finally:
        D.shutdown_distributed()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    return 0


def _synced(fn):
    """`(fn(), seconds)`, the clock read after a synchronize on both sides."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _dp_requests(ref, cond):
    """The request batch of the dp videos: the bench reference image twice,
    with the class embedding and half of it."""
    import torch

    return ref.expand(DP_VIDEO_BATCH, -1, -1, -1), torch.cat([cond, 0.5 * cond])


def dp_nccl(rank: int) -> dict:
    """World size 1 over NCCL: an all-reduce; `sample_video_sharded` (bf16,
    `pallas3`, B=2) against a direct `sample_video` from the same generator
    (gated bit-equal), with the launches of rows 1-3; one bf16 `DMTrainer`
    step on the `data` mesh (B=2), with the launches of rows 4 and 5."""
    import torch
    import torch.distributed as dist

    from cvpr23_lfdm_torch.parallel.mesh import make_mesh
    from cvpr23_lfdm_torch.parallel.serving import sample_video_sharded
    from cvpr23_lfdm_torch.train.dm_trainer import step_generator

    mesh = make_mesh()
    one = torch.ones(1, device="cuda")
    dist.all_reduce(one)
    res = {"rank": rank, "backend": dist.get_backend(), "mesh": [mesh.size, mesh.rank, str(mesh.device)],
           "all_reduce": float(one)}
    _, model, cond, ref, _ = serving_model("bfloat16")
    refs, conds = _dp_requests(ref, cond)
    gen = lambda: torch.Generator(device="cuda").manual_seed(DP_SEED)  # noqa: E731
    sample_video_sharded(model, mesh, refs, conds, 1.0, generator=gen())  # warm-up
    reset_counters()
    out, res["video_s"] = _synced(lambda: sample_video_sharded(model, mesh, refs, conds, 1.0, generator=gen()))
    res["video_launches"] = counters()
    direct = model.sample_video(refs, conds, 1.0, generator=gen())
    res["video_bit_equal"] = all(torch.equal(out[k], direct[k]) for k in direct)
    res["video_finite"] = all(torch_isfinite(v) for v in out.values())
    del model, out, direct
    torch.cuda.empty_cache()
    _, trainer, data, _, _ = training_setup("bfloat16", DP_VIDEO_BATCH, mesh=mesh)
    state = trainer.init_state()
    trainer.train_step(state, step_generator(DP_SEED, 0, "cuda"), data)  # warm-up
    reset_counters()
    (_, m), res["step_s"] = _synced(lambda: trainer.train_step(state, step_generator(DP_SEED, 1, "cuda"), data))
    res["step_launches"] = counters()
    res["step_loss"] = float(m["loss"])
    return res


def _grad_gap(a: dict, b: dict) -> tuple:
    """(largest |a - b| over every gradient, largest |b|)."""
    return (max(float((a[n] - b[n]).abs().max()) for n in b), max(float(g.abs().max()) for g in b.values()))


def dp_gloo(rank: int) -> dict:
    """Two ranks sharing cuda:0 over gloo (NCCL refuses two ranks on one
    card), fp32 with TF32 off, each rank its contiguous rows; rank 0 then
    runs the same work in one process for the comparison while rank 1
    waits at a barrier.

    * `sample_video_sharded` at B=2 (one row per rank) against one
      process's B=2 video from the same generator (gated at `PATH_TOL`).
    * One DM step at global B=4 (`step_generator` draws at the global
      shape): the all-reduced gradients and the loss against one process's
      step on the 4 rows, before Adam (`TRAIN_PARITY_TOL`).
    * One LFAE step at global B=8, the BatchNorm statistics over both
      ranks, against one process (`DP_LFAE_TOL`): the recipe's losses and
      running statistics, and the gradients of the step's smooth part (the
      equivariance losses; perceptual weights 0). The recipe's gradient
      is recorded, not gated: in one process, the same batch in another
      row order moves it by ~2% of its largest value (a CPU reading at a
      small config), so two runs that sum in another order differ there.
    * `states_agree` after each step; the launches of rows 1-5 per rank."""
    import dataclasses

    import torch

    from cvpr23_lfdm_torch.parallel import distributed as D
    from cvpr23_lfdm_torch.parallel.mesh import make_mesh, shard_batch, states_agree
    from cvpr23_lfdm_torch.parallel.serving import sample_video_sharded
    from cvpr23_lfdm_torch.train.dm_trainer import DMTrainer, DMTrainState, step_generator
    from cvpr23_lfdm_torch.train.lfae_trainer import LFAETrainer, LFAETrainState

    mesh = make_mesh()
    res = {"rank": rank, "mesh": [mesh.size, mesh.rank, str(mesh.device)]}
    gen = lambda: torch.Generator(device="cuda").manual_seed(DP_SEED)  # noqa: E731
    grads_of = lambda net: {n: p.grad.detach().clone() for n, p in net.named_parameters()  # noqa: E731
                            if p.grad is not None}

    # the fp32 video
    _, model, cond, ref, _ = serving_model("float32")
    refs, conds = _dp_requests(ref, cond)
    reset_counters()
    out, res["video_s"] = _synced(lambda: sample_video_sharded(model, mesh, refs, conds, 1.0, generator=gen()))
    res["video_launches"] = counters()
    if rank == 0:
        one = model.sample_video(refs, conds, 1.0, generator=gen())
        res["video_max_abs"] = {k: float((out[k] - one[k]).abs().max()) for k in one}
    D.barrier()
    del model, out
    torch.cuda.empty_cache()

    # one DM step
    cfg, trainer, data, _, _ = training_setup("float32", DP_DM_BATCH, seed=3, mesh=mesh)
    trainer.init_state()
    weights = {k: v.detach().clone() for k, v in trainer.model.unet.state_dict().items()}
    local = shard_batch(data, mesh, DP_DM_BATCH)
    reset_counters()
    (_, m), res["dm_step_s"] = _synced(lambda: trainer.train_step(
        DMTrainState(0), step_generator(DP_SEED, 0, "cuda"), local))
    res["dm_launches"] = counters()
    res["dm_agree"] = states_agree(trainer.model.unet, mesh)
    if rank == 0:
        grads = grads_of(trainer.model.unet)
        trainer.model.unet.load_state_dict(weights)
        single = DMTrainer(cfg, steps_per_epoch=93, model=trainer.model)
        single.init_state()
        _, m1 = single.train_step(DMTrainState(0), step_generator(DP_SEED, 0, "cuda"), data)
        gap, scale = _grad_gap(grads, grads_of(trainer.model.unet))
        res["dm"] = {"loss": float(m["loss"]), "loss_one": float(m1["loss"]), "grad_norm": float(m["grad_norm"]),
                     "grad_norm_one": float(m1["grad_norm"]), "grad_max_abs_diff": gap, "grad_max_abs": scale}
        del single, grads
    D.barrier()
    del trainer, weights
    torch.cuda.empty_cache()

    # one LFAE step: the recipe (losses, statistics), then its smooth part alone (gradients)
    cfg, trainer, _ = lfae_trainer(seed=0, mesh=mesh)
    smooth = cfg.replace(lfae_train=dataclasses.replace(
        cfg.lfae_train, perceptual_weights=(0.0,) * len(cfg.lfae_train.perceptual_weights)))
    weights = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    batch = lfae_batch(cfg, DP_LFAE_BATCH, seed=4)
    local = shard_batch(batch, mesh, DP_LFAE_BATCH)

    def lfae_step(tr, recipe, rows):
        tr.model.load_state_dict(weights)
        tr.init_state()
        tr.cfg = cfg if recipe else smooth
        _, m = tr.train_step(LFAETrainState(0), step_generator(DP_SEED, 0, "cuda"), rows)
        stats = {k: v.clone() for k, v in tr.model.state_dict().items() if "running" in k}
        return {k: float(v) for k, v in m.items()}, stats, grads_of(tr.model)

    (losses, stats, recipe_grads), res["lfae_step_s"] = _synced(lambda: lfae_step(trainer, True, local))
    _, _, grads = lfae_step(trainer, False, local)
    res["lfae_agree"] = states_agree(trainer.model, mesh)
    if rank == 0:
        single = LFAETrainer(cfg, steps_per_epoch=LFAE_STEPS_PER_EPOCH, device="cuda")
        losses1, stats1, recipe_grads1 = lfae_step(single, True, batch)
        _, _, grads1 = lfae_step(single, False, batch)
        gap, scale = _grad_gap(grads, grads1)
        res["lfae"] = {
            "losses": losses, "losses_one": losses1,
            "stats_max_abs_diff": max(float((stats[k] - stats1[k]).abs().max()) for k in stats),
            "stats_max_abs": max(float(v.abs().max()) for v in stats1.values()),
            "grad_max_abs_diff": gap, "grad_max_abs": scale,
            "recipe_grad_max_abs_diff_and_max_abs": _grad_gap(recipe_grads, recipe_grads1)}
    D.barrier()
    return res


def run_dp(failures: list) -> None:
    """Phase 28: data parallelism through `init_distributed` in rank
    subprocesses (the card has one GPU): NCCL at world size 1, then two
    gloo ranks sharing it (`dp_nccl`, `dp_gloo`)."""
    (r,) = dp_ranks("nccl", 1)
    line = {"phase": "dp", "what": "NCCL, world size 1, cuda:0", **r}
    if "exit" not in r:
        checks = {
            "nccl_ok": r["backend"] == "nccl" and r["all_reduce"] == 1.0 and r["mesh"][:2] == [1, 0],
            "video_bit_equal": r["video_bit_equal"] and r["video_finite"],
            "video_launches_ok": all(r["video_launches"][k] == v for k, v in DP_VIDEO_LAUNCHES.items()),
            "step_launches_ok": all(r["step_launches"][k] == v for k, v in DP_STEP_LAUNCHES.items()),
            "step_loss_finite": bool(np.isfinite(r["step_loss"])),
        }
        line.update(checks, ok=all(checks.values()))
    emit({**line, "gpu": gpu_line()})
    if not line.get("ok"):
        failures.append("dp nccl world 1")

    ranks = dp_ranks("gloo", 2)
    line = {"phase": "dp", "what": "gloo, 2 ranks on cuda:0, fp32", "ranks": ranks,
            "tol": {"video": PATH_TOL, "dm": TRAIN_PARITY_TOL, "lfae": DP_LFAE_TOL}}
    if all("exit" not in r for r in ranks):
        r0, dm, lf = ranks[0], ranks[0]["dm"], ranks[0]["lfae"]
        tol, ltol = TRAIN_PARITY_TOL, DP_LFAE_TOL
        checks = {
            "meshes_ok": [r["mesh"][:2] for r in ranks] == [[2, 0], [2, 1]],
            "video_ok": all(v <= PATH_TOL for v in r0["video_max_abs"].values()),
            "dm_ok": abs(dm["loss"] - dm["loss_one"]) <= tol["loss_rel"] * abs(dm["loss_one"])
            and abs(dm["grad_norm"] - dm["grad_norm_one"]) <= tol["grad_norm_rel"] * dm["grad_norm_one"]
            and dm["grad_max_abs_diff"] <= tol["grad_max_abs_rel"] * dm["grad_max_abs"],
            "lfae_ok": all(abs(v - lf["losses_one"][k]) <= ltol["loss_rel"] * abs(lf["losses_one"][k])
                           for k, v in lf["losses"].items())
            and lf["stats_max_abs_diff"] <= ltol["stats_rel"] * lf["stats_max_abs"]
            and lf["grad_max_abs_diff"] <= ltol["grad_max_abs_rel"] * lf["grad_max_abs"],
            "states_agree": all(r["dm_agree"] and r["lfae_agree"] for r in ranks),
            "launches_ok": all(
                all(r["video_launches"][k] == v for k, v in DP_VIDEO_LAUNCHES.items())
                and all(r["dm_launches"][k] == v for k, v in DP_STEP_LAUNCHES.items())
                and r["dm_launches"]["warp_video"] >= 1 for r in ranks),
        }
        line.update(checks, ok=all(checks.values()))
    emit({**line, "gpu": gpu_line()})
    if not line.get("ok"):
        failures.append("dp gloo 2 ranks")


# ---------------------------------------------------------------- tensor parallel (phase 29)

TP = 2                 # the model axis of the phase: two gloo ranks on cuda:0
TP_HEADS = HEADS // TP
TP_DM_BATCH = 2        # the tp DM step's batch (a cut from the recipe's 5: two ranks share the card)
TP_PARAM_SHARE = 0.55  # a rank's UNet parameter bytes over one process's, at most
# bf16 under tp: its distance from the one-process fp32 result over the
# one-process bf16 result's distance from it (the bf16 rounding), at most
TP_BF16_OF_WITNESS = 2.0
TP_VIDEO_LAUNCHES = {"fused_temporal_layer": TEMPORAL_PER_EVAL * DDIM_STEPS,
                     "fused_temporal_layer_partial": TEMPORAL_PER_EVAL * DDIM_STEPS,
                     "fused_spatial_linear_layer": LINEAR_PER_EVAL * DDIM_STEPS,
                     "fused_spatial_linear_layer_partial": LINEAR_PER_EVAL * DDIM_STEPS, "warp_video": 3}


def check_tp_kernels(failures: list) -> dict:
    """The kernels at the shapes a tp=2 run gives them, against their plain
    versions: rows 1 and 2 in the head-shard mode (4 heads; bf16 timed,
    per-kernel totals over the calls of one rank's video), rows 4-5 at 4
    heads (B=2) and row 7 on a channel shard (C / 2, 4 groups)."""
    import torch

    from cvpr23_lfdm_torch.models.blocks import split_bias
    from cvpr23_lfdm_torch.ops import attention as A
    from cvpr23_lfdm_torch.ops import norm as N
    from cvpr23_lfdm_torch.scripts._common import LINEAR_SHAPES, TEMPORAL_SHAPES
    from cvpr23_lfdm_torch.scripts.bench_norm import NORM_SHAPES

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(29)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)
    names = ("fused_temporal_layer_partial", "fused_spatial_linear_layer_partial")
    totals = _totals(names)
    h, f, hd = TP_HEADS, F_FRAMES, TP_HEADS * DH
    pos_bias = randn(h, f, f)

    def held(call, plain, dname, unit_args, branch_args):
        """Kernel against plain on unit and on `branch` inputs (x / 16, W_out
        scaled: the partial is the attention term itself, O(1)), and the
        same bits twice."""
        out = call(*unit_args)
        res = compare(out, plain(*unit_args), TOL[dname])
        same = bool(torch.equal(out, call(*unit_args)))
        branch = compare(call(*branch_args), plain(*branch_args), TOL[dname])
        res.update(ok=res["ok"] and same and branch["ok"] and branch["finite"],
                   fp32_out=out.dtype == torch.float32)
        res["ok"] = res["ok"] and res["fp32_out"]
        return res, same, branch

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        timed = dtype == torch.bfloat16
        esz = 2 if timed else 4
        cos_t, sin_t = A.rotary_tables(f, h, DH, DH ** -0.5, dtype, dev)
        bias = A.build_bias_flat(pos_bias, 1, f)
        for (c, hw), n_eval in TEMPORAL_SHAPES.items():
            x = randn(1, f, hw, c)
            gamma = 1 + 0.1 * randn(c)
            wqkv = (randn(c, 3 * hd) / c ** 0.5).to(dtype)
            wout = randn(hd, c) / (HEADS * DH) ** 0.5
            rest = (bias, cos_t, sin_t, h, DH)
            unit = (x.to(dtype), gamma, wqkv, wout.to(dtype), *rest)
            br = ((x / 16).to(dtype), gamma, wqkv, (3 * wout).to(dtype), *rest)
            call = lambda *a: A.fused_temporal_layer(*a, partial=True)
            plain = lambda *a: A.fused_temporal_layer_plain(*a, partial=True)
            res, same, branch = held(call, plain, dname, unit, br)
            times = None
            if timed:
                times = {"kernel_ms": median_ms(lambda: call(*unit)), "plain_ms": median_ms(lambda: plain(*unit), reps=5),
                         "library_ms": None, "kernel_device_ms": device_ms(lambda: call(*unit), launches=1),
                         "library_device_ms": None}
            nbytes = (x.numel() + wqkv.numel() + wout.numel() + 2 * cos_t.numel()) * esz \
                + (gamma.numel() + bias.numel() + x.numel()) * 4
            flops = 2 * f * hw * c * 4 * hd + 4 * hw * h * f * f * DH
            _record(totals, failures, names[0], [1, f, hw, c, f"{h} heads"], dname, res, n_eval * DDIM_STEPS,
                    times, nbytes, flops, bit_identical_twice=same, branch_max_abs_err=branch["max_abs_err"])
        for (c, n), n_eval in LINEAR_SHAPES.items():
            x = randn(1, f, n, c)
            gamma = 1 + 0.1 * randn(c)
            wqkv = (randn(c, 3 * hd) / c ** 0.5).to(dtype)
            wout = randn(hd, c) / (HEADS * DH) ** 0.5
            bout = 0.1 * randn(c)
            unit = (x.to(dtype), gamma, wqkv, wout.to(dtype), bout, h, DH)
            br = ((x / 16).to(dtype), gamma, wqkv, (2 * n ** 0.5 * wout).to(dtype), bout, h, DH)
            call = lambda *a: A.fused_spatial_linear_layer(*a, partial=True)
            plain = lambda *a: A.fused_spatial_linear_layer_plain(*a, partial=True)
            res, same, branch = held(call, plain, dname, unit, br)
            times = None
            if timed:
                times = {"kernel_ms": median_ms(lambda: call(*unit)), "plain_ms": median_ms(lambda: plain(*unit), reps=5),
                         "library_ms": None, "kernel_device_ms": device_ms(lambda: call(*unit), launches=2),
                         "library_device_ms": None}
            nbytes = (x.numel() + wqkv.numel() + wout.numel()) * esz + 2 * c * 4 + x.numel() * 4
            flops = 2 * f * n * c * 4 * hd + 4 * f * h * n * DH * DH
            _record(totals, failures, names[1], [1, f, n, c, f"{h} heads"], dname, res, n_eval * DDIM_STEPS,
                    times, nbytes, flops, bit_identical_twice=same, branch_max_abs_err=branch["max_abs_err"])

        # rows 4-5 at the tp DM step's 4 heads per rank (B=2), forward and both gradients
        b = TP_DM_BATCH
        cos4, sin4 = A.rotary_tables(f, h, DH, DH ** -0.5, dtype, dev)
        bias4 = A.build_bias_flat(pos_bias, b, f)
        for hw in HEADPACKED_SHAPES:
            qkv, do = randn(b, f, hw, 3 * hd).to(dtype), randn(b, f, hw, hd).to(dtype)
            outs = []
            for fn in (A.headpacked_temporal_attention, A.headpacked_temporal_attention_plain):
                q, bb = qkv.detach().requires_grad_(), bias4.detach().requires_grad_()
                o = fn(q, bb, cos4, sin4, h, DH)
                o.backward(do)
                outs.append((o.detach(), q.grad, bb.grad))
            dtol = dict(DBIAS_TOL[dname])
            if timed:
                dtol["atol"] *= hw ** 0.5
            parts = {"fwd": compare(outs[0][0], outs[1][0], TOL[dname]),
                     "dqkv": compare(outs[0][1], outs[1][1], TOL[dname]),
                     "dbias": compare(outs[0][2], outs[1][2], dtol)}
            ok = all(r["ok"] and r["finite"] for r in parts.values())
            emit({"phase": "kernel", "name": "headpacked_attention_fwd+bwd", "shape": [b, f, hw, 3 * hd, f"{h} heads"],
                  "dtype": dname, "ok": ok, **{k: r["max_abs_err"] for k, r in parts.items()}})
            if not ok:
                failures.append(f"headpacked {h} heads {hw} {dname}")
            del qkv, do, outs

        # row 7 on a channel shard: C / 2 channels in 4 whole groups, the FiLM halves of the
        # rank's [B, 1, 1, 1, 2 (C / 2)] mlp output, the rank's half of the conv bias
        # (after the product in bf16, as `split_bias` gives it; none in fp32)
        for (hh, c), _ in NORM_SHAPES.items():
            cs = c // TP
            x = (1.5 * randn(1, f, hh, hh, cs) + 0.3).to(dtype)
            gamma, beta = (1 + 0.3 * randn(c)).narrow(0, cs, cs), (0.2 * randn(c)).narrow(0, cs, cs)
            ss = randn(1, 1, 1, 1, 2 * cs).to(dtype).chunk(2, dim=-1)
            after = split_bias(0.5 * randn(c), dtype)[1]
            kw = {"groups": 8 // TP, "pre_bias": None if after is None else after.narrow(0, cs, cs)}
            call = lambda: N.groupnorm_film_silu(x, gamma, beta, *ss, **kw)
            out = call()
            res = compare(out, N.groupnorm_film_silu_plain(x, gamma, beta, *ss, **kw), TOL[dname])
            res["ok"] = res["ok"] and bool(torch.equal(out, call()))
            emit({"phase": "kernel", "name": "groupnorm_film_silu", "shape": [1, f, hh, hh, cs, "channel shard"],
                  "dtype": dname, "groups": 8 // TP, "pre_bias": after is not None, **res})
            if not (res["ok"] and res["finite"]):
                failures.append(f"groupnorm_film_silu channel shard {hh} {cs} {dname}")
            del x, out
        torch.cuda.empty_cache()
    return totals


def tp_gloo(rank: int) -> dict:
    """One rank of the `tp` phase: a `data` x `model` mesh of 1 x 2 over gloo
    on cuda:0 (fp32 with TF32 off where fp32), the MUG config at full
    width. Rank 0 then runs the same work in one process for the
    comparisons while rank 1 waits at a barrier.

    * The bf16 `pallas3` video at B=1 (`sample_video_sharded` shards the
      UNet): finite, the launches of rows 1-3, seconds; rank 0 its
      distance from the one-process bf16 and fp32 videos, and from the
      one-process bf16 video the distance of each UNet eval's output (the
      first eval's input is the same in every run).
    * The fp32 video at B=1 against one process (gated at `PATH_TOL`), the
      same per-eval distances.
    * One DM step at B=2 in fp32 and in bf16 (the same injected draws on
      both ranks): the loss and the gathered gradients against one
      process's step before Adam in the same dtype, and the bf16 ones also
      against the fp32 one-process step; the launches of rows 4 and 5,
      `states_agree` within the model group for the replicated parameters.
    * The UNet's parameter bytes on each rank and in one process."""
    import torch

    from cvpr23_lfdm_torch.models.unet3d import shard_unet, tp_parameters
    from cvpr23_lfdm_torch.parallel import distributed as D
    from cvpr23_lfdm_torch.parallel.mesh import gather_variables, make_mesh, states_agree
    from cvpr23_lfdm_torch.parallel.serving import sample_video_sharded
    from cvpr23_lfdm_torch.train.dm_trainer import DMTrainState

    mesh = make_mesh((1, TP), ("data", "model"))
    res = {"rank": rank, "mesh": [mesh.size, mesh.rank, mesh.model_size, mesh.model_rank, str(mesh.device)]}
    gen = lambda: torch.Generator(device="cuda").manual_seed(DP_SEED)  # noqa: E731
    nbytes = lambda net: sum(p.numel() * p.element_size() for p in net.parameters())  # noqa: E731
    host = lambda d: {k: v.detach().float().cpu() for k, v in d.items()}  # noqa: E731
    gap = lambda a, b: {k: float((a[k] - b[k]).abs().max()) for k in b}  # noqa: E731

    def sample(model, call):
        """The video of `call()` and each UNet eval's output, on the host."""
        evals = []
        hook = model.unet.register_forward_hook(lambda m, i, o: evals.append(o.detach().float().cpu()))
        out, sec = _synced(call)
        hook.remove()
        return host(out), evals, sec

    videos = {}  # rank 0: (dtype, "tp" | "one") -> (video, evals)
    for dname in ("bfloat16", "float32"):
        _, model, cond, ref, _ = serving_model(dname)
        one_bytes = nbytes(model.unet)
        shard_unet(model.unet, mesh)
        if dname == "bfloat16":
            res["unet_param_bytes"], res["unet_param_bytes_one"] = nbytes(model.unet), one_bytes
        reset_counters()
        out, evals, res[f"video_{dname}_s"] = sample(
            model, lambda: sample_video_sharded(model, mesh, ref, cond, 1.0, generator=gen()))
        res[f"video_{dname}_launches"] = counters()
        res[f"video_{dname}_finite"] = all(torch_isfinite(v) for v in out.values())
        videos[dname, "tp"] = out, evals
        del model
        torch.cuda.empty_cache()
        if rank == 0:
            _, one_model, _, _, _ = serving_model(dname)
            videos[dname, "one"] = sample(one_model, lambda: one_model.sample_video(ref, cond, 1.0,
                                                                                   generator=gen()))[:2]
            res[f"video_{dname}_max_abs"] = gap(out, videos[dname, "one"][0])
            res[f"video_{dname}_eval_max_abs"] = [float((a - b).abs().max())
                                                  for a, b in zip(evals, videos[dname, "one"][1])]
            del one_model
        D.barrier()
        torch.cuda.empty_cache()
    if rank == 0:  # the bf16 videos' and first evals' distances from the fp32 one-process ones
        ref32, eval32 = videos["float32", "one"]
        for who in ("tp", "one"):
            vid, evals = videos["bfloat16", who]
            res[f"video_bf16_{who}_vs_fp32_one"] = gap(vid, ref32)
            res[f"eval0_bf16_{who}_vs_fp32_one"] = float((evals[0] - eval32[0]).abs().max())
    del videos

    grads = {}  # rank 0: (dtype, "tp" | "one") -> gathered gradients, on the host
    for dname in ("float32", "bfloat16"):
        _, trainer, data, draws, _ = training_setup(dname, TP_DM_BATCH, seed=3, mesh=mesh)
        trainer.init_state()
        reset_counters()
        (_, m), res[f"dm_{dname}_s"] = _synced(lambda: trainer.train_step(DMTrainState(0), None, data, **draws))
        res[f"dm_{dname}_launches"] = counters()
        unet = trainer.model.unet
        tp_grads = host(gather_variables({n: p.grad for n, p in unet.named_parameters() if p.grad is not None},
                                         mesh, unet.tp_shapes))
        _, partial, whole = tp_parameters(unet)
        res[f"dm_{dname}_agree"] = states_agree(partial + whole, mesh, axis="model")
        res[f"dm_{dname}_finite"] = all(bool(torch.isfinite(m[k])) for k in ("loss", "grad_norm")) \
            and all(torch_isfinite(g) for g in tp_grads.values())
        del trainer, unet
        torch.cuda.empty_cache()
        if rank == 0:
            _, single, data1, draws1, _ = training_setup(dname, TP_DM_BATCH, seed=3)
            single.init_state()
            _, m1 = single.train_step(DMTrainState(0), None, data1, **draws1)
            one = host({n: p.grad for n, p in single.model.unet.named_parameters() if p.grad is not None})
            grads[dname, "tp"], grads[dname, "one"] = tp_grads, one
            g, scale = _grad_gap(tp_grads, one)
            res[f"dm_{dname}"] = {"loss": float(m["loss"]), "loss_one": float(m1["loss"]),
                                  "grad_norm": float(m["grad_norm"]), "grad_norm_one": float(m1["grad_norm"]),
                                  "grad_max_abs_diff": g, "grad_max_abs": scale, "same_names": set(tp_grads) == set(one)}
            del single
        del tp_grads
        D.barrier()
    if rank == 0:  # the bf16 steps' distances from the fp32 one-process step
        d16, d32 = res["dm_bfloat16"], res["dm_float32"]
        for who, suffix in (("tp", ""), ("one", "_one")):
            d16[f"{who}_vs_fp32_one"] = {
                "loss": abs(d16["loss" + suffix] - d32["loss_one"]),
                "grad_norm": abs(d16["grad_norm" + suffix] - d32["grad_norm_one"]),
                "grad_max_abs_diff": _grad_gap(grads["bfloat16", who], grads["float32", "one"])[0]}
    return res


def run_tp(failures: list) -> tuple[dict, dict]:
    """Phase 29: the kernels at the tp shapes here, then `tp_gloo` on two
    rank subprocesses. Returns the kernel totals and rank 0's launches of
    its bf16 video."""
    totals = check_tp_kernels(failures)
    ranks = dp_ranks("tp", TP)
    tol = TRAIN_PARITY_TOL
    line = {"phase": "tp", "what": f"gloo, {TP} ranks on cuda:0, a 1 x {TP} data x model mesh", "ranks": ranks,
            "tol": {"video_fp32": PATH_TOL, "dm_fp32": tol, "bf16_of_witness": TP_BF16_OF_WITNESS,
                    "param_share": TP_PARAM_SHARE},
            "cuts": {"dm_batch": TP_DM_BATCH}}
    launches = {}
    if all("exit" not in r for r in ranks):
        r0, dm, dm16 = ranks[0], ranks[0]["dm_float32"], ranks[0]["dm_bfloat16"]
        # bf16: the tp result no further from the one-process fp32 one than
        # TP_BF16_OF_WITNESS times the one-process bf16 result is
        witnessed = lambda tp, one: tp <= TP_BF16_OF_WITNESS * one  # noqa: E731
        checks = {
            "meshes_ok": [r["mesh"][:4] for r in ranks] == [[1, 0, TP, m] for m in range(TP)],
            "video_finite": all(r["video_bfloat16_finite"] and r["video_float32_finite"] for r in ranks),
            "video_launches_ok": all(r[f"video_{d}_launches"][k] == v for r in ranks
                                     for d in ("bfloat16", "float32") for k, v in TP_VIDEO_LAUNCHES.items()),
            "video_fp32_ok": all(v <= PATH_TOL for v in r0["video_float32_max_abs"].values()),
            "video_bf16_ok": witnessed(r0["eval0_bf16_tp_vs_fp32_one"], r0["eval0_bf16_one_vs_fp32_one"])
            and all(witnessed(v, r0["video_bf16_one_vs_fp32_one"][k])
                    for k, v in r0["video_bf16_tp_vs_fp32_one"].items()),
            "dm_ok": dm["same_names"]
            and abs(dm["loss"] - dm["loss_one"]) <= tol["loss_rel"] * abs(dm["loss_one"])
            and abs(dm["grad_norm"] - dm["grad_norm_one"]) <= tol["grad_norm_rel"] * dm["grad_norm_one"]
            and dm["grad_max_abs_diff"] <= tol["grad_max_abs_rel"] * dm["grad_max_abs"],
            "dm_bf16_ok": dm16["same_names"] and all(r["dm_bfloat16_finite"] for r in ranks)
            and witnessed(dm16["tp_vs_fp32_one"]["grad_max_abs_diff"], dm16["one_vs_fp32_one"]["grad_max_abs_diff"]),
            "dm_launches_ok": all(r[f"dm_{d}_launches"][k] == HEADPACKED_PER_EVAL for r in ranks
                                  for d in ("float32", "bfloat16")
                                  for k in ("headpacked_attention_fwd", "headpacked_attention_bwd")),
            "states_agree": all(r[f"dm_{d}_agree"] for r in ranks for d in ("float32", "bfloat16")),
            "param_share_ok": all(r["unet_param_bytes"] <= TP_PARAM_SHARE * r["unet_param_bytes_one"]
                                  for r in ranks),
        }
        line.update(checks, ok=all(checks.values()),
                    param_share=[r["unet_param_bytes"] / r["unet_param_bytes_one"] for r in ranks])
        launches = r0["video_bfloat16_launches"]
    emit({**line, "gpu": gpu_line()})
    if not line.get("ok"):
        failures.append("tp gloo 2 ranks")
    return totals, launches


# ---------------------------------------------------------------- spatial partitioning (phase 30)

SP = 2                  # the space axis of the phase: two gloo ranks on cuda:0
SP_SEED = 30            # the injected gaussians of the phase's videos
# bf16 under sp: its distance from the one-process fp32 video over the
# one-process bf16 video's distance from it, at most (the tp phase's rule)
SP_BF16_OF_WITNESS = 2.0
SP_VIDEO_LAUNCHES = {"fused_temporal_layer": TEMPORAL_PER_EVAL * DDIM_STEPS,
                     "fused_spatial_linear_layer": LINEAR_PER_EVAL * DDIM_STEPS, "warp_video": 3,
                     "warp_video_band": 3}


def check_sp_kernels(failures: list) -> dict:
    """Row 3 on a band of output rows at the shapes an sp=2 decode gives it:
    each rank's band of the three decode scales' grids (B=1, F=40) against
    the plain version and against those rows of the whole-height call, bit
    for bit, one device launch per call; bf16 timed, per-kernel totals over
    the three calls of one rank's video."""
    import torch
    import torch.nn.functional as F

    from cvpr23_lfdm_torch.ops import warp as W
    from cvpr23_lfdm_torch.scripts.bench_norm import device_reading, one_launch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(30)
    totals = _totals(("warp_video_band",))
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        timed = dtype == torch.bfloat16
        esz = 2 if timed else 4
        for (h, c), per_video in WARP_SHAPES.items():
            src = torch.randn(1, h, h, c, generator=gen, device=dev).to(dtype)
            lin = torch.linspace(-1, 1, h, device=dev)
            ident = torch.stack(torch.meshgrid(lin, lin, indexing="xy"), -1)
            grid = (ident[None, None] + 0.3 * torch.randn(1, F_FRAMES, h, h, 2, generator=gen,
                                                          device=dev)).contiguous()
            whole = W.warp_video(src, grid)
            ho = h // SP
            for r in range(SP):
                band = grid[:, :, r * ho:(r + 1) * ho].contiguous()
                call = lambda: W.warp_video(src, band)  # noqa: E731
                out, ref = call(), W.warp_video_plain(src, band)
                res = compare(out, ref, WARP_TOL[dname])
                equal, rows = bool(torch.equal(out, ref)), bool(torch.equal(out, whole[:, :, r * ho:(r + 1) * ho]))
                dev_ms, launches, other = device_reading(call, kernel="warp_blend_kernel")
                res["ok"] = res["ok"] and equal and rows and one_launch(launches, other)
                times = None
                if timed and r == 0:
                    src_nchw = src.permute(0, 3, 1, 2)
                    g4 = band.reshape(1, F_FRAMES * ho, h, 2).to(dtype)
                    gs = lambda: F.grid_sample(src_nchw, g4, mode="bilinear", padding_mode="zeros",  # noqa: E731
                                               align_corners=False)
                    # one launch per call: a profile late in the run that lost it reads None
                    times = {"kernel_ms": median_ms(call),
                             "plain_ms": median_ms(lambda: W.warp_video_plain(src, band), reps=5),
                             "library_ms": median_ms(gs), "kernel_device_ms": dev_ms,
                             "library_device_ms": device_ms(gs, launches=1)}
                nbytes = src.numel() * esz + band.numel() * 4 + out.numel() * esz
                flops = 8 * out.numel()
                shape = [1, F_FRAMES, ho, h, c, f"rows {r * ho}-{(r + 1) * ho - 1}"]
                _record(totals, failures, "warp_video_band", shape, dname, res, per_video if times else 0,
                        times, nbytes, flops, FP32_FLOPS,
                        bit_equal_to_plain=equal, bit_equal_to_whole_rows=rows,
                        device_launches_per_call=launches, other_device_launches_per_call=other)
            del src, grid, whole
    torch.cuda.empty_cache()
    return totals


def sp_gloo(rank: int) -> dict:
    """One rank of the `sp` phase: a `data` x `space` mesh of 1 x 2 over gloo
    on cuda:0, the MUG config at full width, the video at B=1 from the
    injected gaussians of `SP_SEED` in bf16 and in fp32 (TF32 off):
    finite, the launches of rows 1-3, seconds, the decode's peak allocated
    memory (a second decode of the sampled flow, band mode), and whether
    both ranks' videos are equal (gathered over the group). Rank 0 then
    runs the same videos and decode in one process while rank 1 waits:
    the distances of the sp videos from them, and the one-process decode's
    peak memory."""
    import torch
    import torch.distributed as dist

    from cvpr23_lfdm_torch.parallel import distributed as D
    from cvpr23_lfdm_torch.parallel.mesh import _all_gather, make_mesh
    from cvpr23_lfdm_torch.parallel.serving import sample_video_sharded

    mesh = make_mesh((1, SP), ("data", "space"))
    res = {"rank": rank, "mesh": [mesh.size, mesh.rank, mesh.space_size, mesh.space_rank, str(mesh.device)]}
    host = lambda d: {k: v.detach().float().cpu() for k, v in d.items()}  # noqa: E731
    gap = lambda a, b: {k: float((a[k] - b[k]).abs().max()) for k in b}  # noqa: E731

    def decode_peak_mb(model, ref, out):
        """Peak allocated memory above the start of one decode of `out`'s flow."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        model.decode_flow_video(ref, out["vid_grid"], out["vid_conf"])
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 2 ** 20

    videos = {}  # rank 0: (dtype, "sp" | "one") -> video on the host
    for dname in ("bfloat16", "float32"):
        cfg, model, cond, ref, _ = serving_model(dname)
        init, noise = injected_noise(cfg, SP_SEED)
        def call():
            return sample_video_sharded(model, mesh, ref, cond, 1.0, init_img=init, noise_seq=noise)

        call()  # warm-up: cuDNN autotuning, allocator, the band-mode generator
        reset_counters()
        out, res[f"video_{dname}_s"] = _synced(call)
        res[f"video_{dname}_launches"] = counters()
        res[f"video_{dname}_finite"] = all(torch_isfinite(v) for v in out.values())
        res[f"video_{dname}_ranks_equal"] = all(
            all(torch.equal(p, v) for p in _all_gather(v, dist.group.WORLD, SP)) for v in out.values())
        res[f"decode_{dname}_peak_mb"] = decode_peak_mb(model, ref, out)
        videos[dname, "sp"] = host(out)
        del model, out
        torch.cuda.empty_cache()
        if rank == 0:
            _, one, _, _, _ = serving_model(dname)
            one.sample_video(ref, cond, 1.0, init_img=init, noise_seq=noise)  # warm-up
            out, res[f"video_{dname}_one_s"] = _synced(
                lambda: one.sample_video(ref, cond, 1.0, init_img=init, noise_seq=noise))
            res[f"decode_{dname}_one_peak_mb"] = decode_peak_mb(one, ref, out)
            videos[dname, "one"] = host(out)
            res[f"video_{dname}_max_abs"] = gap(videos[dname, "sp"], videos[dname, "one"])
            del one, out
            torch.cuda.empty_cache()
        D.barrier()
    if rank == 0:  # the bf16 videos' distances from the fp32 one-process video
        for who in ("sp", "one"):
            res[f"video_bf16_{who}_vs_fp32_one"] = gap(videos["bfloat16", who], videos["float32", "one"])
    return res


def run_sp(failures: list) -> tuple[dict, dict]:
    """Phase 30: row 3's band mode here, then `sp_gloo` on two rank
    subprocesses. Returns the kernel totals and rank 0's launches of its
    bf16 video."""
    t0 = time.perf_counter()
    totals = check_sp_kernels(failures)
    ranks = dp_ranks("sp", SP)
    line = {"phase": "sp", "what": f"gloo, {SP} ranks on cuda:0, a 1 x {SP} data x space mesh", "ranks": ranks,
            "tol": {"video_fp32": PATH_TOL, "bf16_of_witness": SP_BF16_OF_WITNESS}}
    launches = {}
    if all("exit" not in r for r in ranks):
        r0 = ranks[0]
        dtypes = ("bfloat16", "float32")
        checks = {
            "meshes_ok": [r["mesh"][:4] for r in ranks] == [[1, 0, SP, s] for s in range(SP)],
            "video_finite": all(r[f"video_{d}_finite"] for r in ranks for d in dtypes),
            "video_ranks_equal": all(r[f"video_{d}_ranks_equal"] for r in ranks for d in dtypes),
            "video_launches_ok": all(r[f"video_{d}_launches"][k] == v for r in ranks for d in dtypes
                                     for k, v in SP_VIDEO_LAUNCHES.items()),
            "video_fp32_ok": all(v <= PATH_TOL for v in r0["video_float32_max_abs"].values()),
            "video_bf16_ok": all(v <= SP_BF16_OF_WITNESS * r0["video_bf16_one_vs_fp32_one"][k]
                                 for k, v in r0["video_bf16_sp_vs_fp32_one"].items()),
        }
        line.update(checks, ok=all(checks.values()),
                    decode_peak_mb={d: {"sp": [r[f"decode_{d}_peak_mb"] for r in ranks],
                                        "one": r0[f"decode_{d}_one_peak_mb"]} for d in dtypes},
                    video_s={d: {"sp": [r[f"video_{d}_s"] for r in ranks], "one": r0[f"video_{d}_one_s"]}
                             for d in dtypes})
        launches = r0["video_bfloat16_launches"]
    emit({**line, "phase_s": time.perf_counter() - t0, "gpu": gpu_line()})
    if not line.get("ok"):
        failures.append("sp gloo 2 ranks")
    return totals, launches


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
    check_kernels(failures, batch=SERVE_BATCH, dtypes=("bfloat16",))
    launches, latency_s = run_serving(failures)
    run_parity(failures)
    run_profile(latency_s)
    run_bf16_reading(failures)
    run_profile_sampler(failures)
    train_launches, step_s = run_training(failures)
    run_train_parity(failures)
    run_lfae_train(failures)
    run_lfae_parity(failures)
    run_resume(failures)
    run_lfae_eval(failures)
    run_metrics(failures)
    pallas_launches, _ = run_serving(failures, impl="pallas", phase="serving forms", profiled=True)
    run_serving(failures, impl="xla", phase="serving forms")
    run_forms_parity(failures)
    norm_launches = run_fused_norm(failures)
    ablate_launches, ablate_entry = run_ablate(failures)
    warp_launches = run_bench_warp(failures)
    run_bench_scripts(failures)
    totals["fused_temporal_layer_ablate"] = ablate_entry
    # dp, tp and sp before the entry points: their kernel checks read torch.profiler, which
    # loses kernels late in a long process; the entry points gate on launch counters only
    run_dp(failures)
    tp_totals, tp_launches = run_tp(failures)
    totals.update(tp_totals)
    sp_totals, sp_launches = run_sp(failures)
    totals.update(sp_totals)
    run_entry_points(failures)

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
        "fused_temporal_layer_partial": ("fused_temporal_layer.cu", jops + "attention_pallas.py:590",
                                         tp_launches, "one rank's tp=2 serving video (pallas3, head-shard mode, 4 heads)"),
        "fused_spatial_linear_layer_partial": ("fused_spatial_linear_layer.cu", jops + "attention_pallas.py:745",
                                               tp_launches, "one rank's tp=2 serving video (pallas3, head-shard mode, 4 heads)"),
        "warp_video_band": ("warp_blend.cu", jops + "warp_pallas.py:440", sp_launches,
                            "one rank's sp=2 serving video (band mode: 16, 32, 64 output rows of the 32², "
                            "64², 128² sources)"),
    }
    fp32_bound = ("warp_video", "groupnorm_film_silu", "warp_onehot", "warp_gather", "warp_video_band")
    kernels = []
    for name, (src, replaces, counted, per) in table.items():
        t = totals[name]
        # the sum of the per-call bounds, named by the larger side of the sums
        b_by = t.get("bound_by") or bound(
            t["bytes"], t["flops"], FP32_FLOPS if name in fp32_bound else BF16_FLOPS)[1]
        if counted.get(name, 0) < 1:
            failures.append(f"{name}: no launch on its main path")
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + src, "replaces": replaces,
            "launches": counted.get(name, 0), "per": per, "max_abs_err": t["max_abs_err"], "ms": t["ms"],
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
