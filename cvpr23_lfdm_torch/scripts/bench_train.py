"""Training-step throughput on the card (compute only, a seeded batch).

Counterpart of the JAX package's `scripts/bench_train.py`: times the DM
training step (the frozen fp32 LFAE's pseudo ground truth, the bf16 UNet's
forward and backward in the `pallas2` form: rows 4 and 5,
`csrc/headpacked_attention.cu`, and Adam) at the MUG recipe's B=5 on the
bench checkpoint's UNet and encoder (seeded motion predictors), and the
LFAE step (stage 1) at the recipe's B=100 in fp32 with TF32 off, which runs
no port kernel, as the JAX step runs no Pallas kernel. One JSON line per
stage:

  * seconds per step: median of `--iters` steps after two warm-ups, each
    ended by `torch.cuda.synchronize()`;
  * the device busy ms and device launches of one step under torch.profiler,
    its device time by group (`utils/profiling.py::KERNEL_GROUPS`) and the
    device ms and launches of each of the program's `lfdm::` spans
    (`spans`: the DM step's `train_step`, `pseudo_ground_truth`, `forward`,
    `backward`, `optimizer`; `utils/profiling.py::span_table`);
  * peak allocated memory;
  * FLOPs per step and their share of the card's peak: PyTorch's
    `FlopCounterMode` over one step (matrix products, convolutions, in the
    forward and the backward) plus rows 4 and 5's products, which run in
    hand-written kernels it cannot see (`headpacked_flops`, the counts
    `chip_smoke.py`'s kernel lines take for their bounds). Like the
    counter, they leave out elementwise work (row 3's interpolation among
    it). The peaks are one H100 SXM's, 989 TFLOP/s dense bf16 (the DM step)
    and 67 TFLOP/s fp32 outside the tensor cores (the LFAE step, TF32
    off), named beside the card's name and power limit. The JAX script's
    v5e figures and XLA byte counts have no counterpart.

With `--device cpu` (a rehearsal at a tiny config in the tests) the clock
is the host's, nothing is profiled on a device and no share of a peak is
given. `--bench-ckpt ''` seeds the DM step's UNet and encoder as well.

Usage: python -m cvpr23_lfdm_torch.scripts.bench_train [--stage dm|lfae|both]
           [--attn-impl pallas2] [--iters 6] [--trace DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time

import numpy as np
import torch

from cvpr23_lfdm_torch.scripts._common import BENCH_CKPT, add_device_arg, card_line, emit

BF16_PEAK_TFLOPS = 989.0  # H100 SXM, dense bf16 tensor cores
FP32_PEAK_TFLOPS = 67.0   # H100 SXM, fp32 outside the tensor cores
SEED = 0                  # weights, batch and draws


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage", default="dm", choices=["dm", "lfae", "both"])
    ap.add_argument("--attn-impl", default="pallas2", help="the DM step's UNet form (xla | pallas2)")
    ap.add_argument("--lfae-dtype", default="float32", choices=["float32", "bfloat16"],
                    help="the frozen pseudo-ground-truth LFAE's compute dtype (dm stage)")
    ap.add_argument("--trace", default="",
                    help="directory for each stage's profiled step, every device kernel (JSON)")
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--bench-ckpt", default=BENCH_CKPT,
                    help="bench checkpoint directory ('' or absent: seeded weights)")
    add_device_arg(ap)
    return ap


def headpacked_flops(b: int, f: int, hw: int, heads: int, d: int) -> tuple[int, int]:
    """Products of rows 4 and 5 on `qkv [B, F, HW, 3*heads*d]`: the forward's
    scores and probabilities x values (2 x 2 F² d per pixel and head), the
    backward's recomputed scores, dp, dq, dk and dv (5 x 2 F² d)."""
    units = b * hw * heads
    return 4 * units * f * f * d, 10 * units * f * f * d


@contextlib.contextmanager
def kernel_flops(unet):
    """Counts rows 4 and 5's products in the body: a hook on each `pallas2`
    temporal-attention layer adds a forward's, and a backward's when the
    layer's parameters take a gradient, for each call on the card (on the
    CPU its plain version runs, which `FlopCounterMode` sees)."""
    from cvpr23_lfdm_torch.models.unet3d import TemporalAttention

    total = {"flops": 0}

    def hook(m, args):
        x = args[0]
        if x.device.type == "cpu":
            return
        b, f, h, w, _ = x.shape
        fwd, bwd = headpacked_flops(b, f, h * w, m.heads, m.dim_head)
        grads = torch.is_grad_enabled() and m.to_qkv.weight.requires_grad
        total["flops"] += fwd + (bwd if grads else 0)

    handles = [m.register_forward_pre_hook(hook) for m in unet.modules()
               if isinstance(m, TemporalAttention) and m.impl == "pallas2"]
    try:
        yield total
    finally:
        for h in handles:
            h.remove()


def measure(step, device, iters: int, unet=None, trace: str = "") -> dict:
    """Seconds per step, peak memory, a profiled step's device busy time,
    launches, groups and spans (every row into the file `trace`, if
    named), and the FLOPs of one step."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from cvpr23_lfdm_torch.utils.profiling import device_groups, profile_rows, span_table

    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    step()
    step()
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    secs = []
    for _ in range(iters):
        t0 = time.perf_counter()
        step()
        sync()
        secs.append(time.perf_counter() - t0)
    out = {"value": float(np.median(secs)), "step_s": secs,
           "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 2 ** 30 if on_card else None,
           "clock": "cuda_sync" if on_card else "host"}
    counted = contextlib.nullcontext({"flops": 0}) if unet is None else kernel_flops(unet)
    with FlopCounterMode(display=False) as fc, counted as kern:
        step()
        sync()
    out["flops_counted"] = int(fc.get_total_flops())
    out["flops_kernels"] = int(kern["flops"])
    out["step_tflop"] = (out["flops_counted"] + out["flops_kernels"]) / 1e12
    out["achieved_tflops"] = out["step_tflop"] / out["value"] if on_card else None
    if on_card:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            sync()
        rows = [r for r in profile_rows(prof) if r["on_device"]]
        if trace:
            os.makedirs(os.path.dirname(trace), exist_ok=True)
            with open(trace, "w") as f:
                json.dump(rows, f, indent=1)
        out.update(device_busy_ms=sum(r["device_ms"] for r in rows),
                   device_launches=sum(r["count"] for r in rows), by_group=device_groups(rows),
                   spans=span_table(prof))
    else:
        out.update(device_busy_ms=None, device_launches=None, by_group={}, spans={})
    return out


def trace_file(args, stage: str) -> str:
    return os.path.join(args.trace, f"bench_train_{stage}.json") if args.trace else ""


def share(out: dict, peak_tflops: float, on_card: bool) -> dict:
    """The achieved rate over the peak (None off the card)."""
    return {"peak_tflops": peak_tflops,
            "mfu": out["achieved_tflops"] / peak_tflops if on_card else None}


def bench_dm(cfg, args, device) -> dict:
    """The DM step at the config's batch (the MUG recipe's 5), one fixed
    batch and draws."""
    from cvpr23_lfdm_torch.diffusion.flow_diffusion import FlowDiffusion
    from cvpr23_lfdm_torch.train.dm_trainer import DMTrainer
    from cvpr23_lfdm_torch.utils.bench_ckpt import apply_bench_ckpt

    cfg = cfg.replace(
        diffusion=dataclasses.replace(cfg.diffusion, temporal_attn_impl=args.attn_impl,
                                      compute_dtype="bfloat16"),
        lfae=dataclasses.replace(cfg.lfae, compute_dtype=args.lfae_dtype))
    if args.bench_ckpt and os.path.isdir(args.bench_ckpt):
        cfg, model, _, _, _ = apply_bench_ckpt(args.bench_ckpt, cfg, device=device, training=True,
                                               lfae_seed=SEED)
        weights = "trained-synthetic"
    else:
        from cvpr23_lfdm_torch.models.flow_autoenc import seed_lfae_weights

        model = FlowDiffusion(cfg.lfae, cfg.diffusion, device=device, training=True)
        seed_lfae_weights([model.region_predictor, model.bg_predictor, model.generator], SEED)
        weights = "random"
    trainer = DMTrainer(cfg, steps_per_epoch=93, model=model)
    b = cfg.dm_train.batch_size
    d, s = cfg.diffusion, cfg.lfae.frame_shape
    rng = np.random.RandomState(SEED + 1)
    vid = rng.uniform(size=(b, d.num_frames, s, s, 3)).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(device)
    data = {"ref_img": to(vid[:, 0].copy()), "real_vid": to(vid),
            "cond": to(rng.standard_normal((b, d.cond_dim)).astype(np.float32)),
            "none_cond_mask": to(np.zeros(b, bool))}
    draws = {"t": to(rng.randint(0, d.timesteps, size=b)),
             "noise": to(rng.standard_normal((b, d.num_frames, d.img_size, d.img_size, 3))
                         .astype(np.float32)),
             "null_mask": to(rng.uniform(size=b) < d.null_cond_prob)}
    box = {"state": trainer.init_state()}

    def step():
        box["state"], m = trainer.train_step(box["state"], None, data, **draws)
        return m["loss"]

    out = measure(step, device, args.iters, unet=trainer.model.unet, trace=trace_file(args, "dm"))
    return {"metric": "dm_train_step_seconds", **out, "batch_size": b, "frames": d.num_frames,
            "attn_impl": args.attn_impl, "lfae_dtype": args.lfae_dtype, "weights": weights,
            **share(out, BF16_PEAK_TFLOPS, device.type == "cuda")}


def bench_lfae(cfg, args, device) -> dict:
    """The LFAE step at the config's batch (the MUG recipe's 100), fp32 (TF32
    off on the card)."""
    from cvpr23_lfdm_torch.train.dm_trainer import step_generator
    from cvpr23_lfdm_torch.train.lfae_trainer import LFAETrainer

    trainer = LFAETrainer(cfg, steps_per_epoch=93, device=device, vgg_seed=SEED)
    box = {"state": trainer.init_state(seed=SEED)}
    rng = np.random.RandomState(SEED + 1)
    s, b = cfg.lfae.frame_shape, cfg.lfae_train.batch_size
    data = {k: torch.from_numpy(rng.uniform(size=(b, s, s, 3)).astype(np.float32)).to(device)
            for k in ("source", "driving")}

    def step():
        state = box["state"]
        box["state"], m = trainer.train_step(state, step_generator(SEED, state.step, device), data)
        return m["total"]

    out = measure(step, device, args.iters, trace=trace_file(args, "lfae"))
    return {"metric": "lfae_train_step_seconds", **out, "batch_size": b, "dtype": "float32",
            "tf32": torch.backends.cudnn.allow_tf32 if device.type == "cuda" else None,
            **share(out, FP32_PEAK_TFLOPS, device.type == "cuda")}


def run(cfg, args) -> list:
    """One record per stage."""
    from cvpr23_lfdm_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    card = card_line(device)
    records = []
    for stage, fn in (("dm", bench_dm), ("lfae", bench_lfae)):
        if args.stage in (stage, "both"):
            rec = {**fn(cfg, args, device), "card": card}
            records.append(rec)
            emit(rec)
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return records


def main(argv=None) -> list:
    from cvpr23_lfdm_torch.config import mug_config

    # the LFAE step's fp32 is full fp32 on the card, as the recipe's
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return run(mug_config(), parser().parse_args(argv))


if __name__ == "__main__":
    main()
