"""Device-time breakdown of the serving graph by op group.

Counterpart of the JAX package's `scripts/profile_sampler.py`: runs
`FlowDiffusion.sample_video` at the MUG config (the bench checkpoint,
DDIM-10, bf16, `pallas3`; `bench_batch_sweep.serving_model`) at each batch
size of `--batch`, first `--iters` videos for the wall clock, then `--iters`
videos under torch.profiler (`utils/profiling.py::profile_rows`), and
reports per call (one `sample_video` call: B videos): the device time and device launches of each op group
(`utils/profiling.py::KERNEL_GROUPS`: each of the port's own kernels, rows 1-9 of the kernel
table, in a group of its own, then the library's kinds of kernel), the device time and
launches of each of the program's `lfdm::` spans (`spans`: `sample_video`, `encode`,
`sample`, `sampler_step`, `denoise`, `threshold`, `decode`; `utils/profiling.py::span_table`),
the top `--top` device kernels, the wall ms and the device-busy share of it.

With `--device cpu` (a rehearsal on the kernels' plain versions) nothing
runs on a device: the groups are empty and the clock is the host's.

Usage: python -m cvpr23_lfdm_torch.scripts.profile_sampler [--batch 1 8] [--iters 3]
           [--top 40] [--out DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from cvpr23_lfdm_torch.scripts._common import BENCH_CKPT, add_device_arg, card_line, emit
from cvpr23_lfdm_torch.utils.profiling import device_groups, span_table

def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--out", default="", help="directory for each batch's full table (JSON)")
    ap.add_argument("--bench-ckpt", default=BENCH_CKPT,
                    help="bench checkpoint directory ('' or absent: seeded weights)")
    add_device_arg(ap)
    return ap


def run(cfg, args) -> list:
    """One record per batch size."""
    from torch.profiler import ProfilerActivity, profile

    from cvpr23_lfdm_torch.scripts.bench_batch_sweep import SEED, serving_model
    from cvpr23_lfdm_torch.utils.device import resolve_device
    from cvpr23_lfdm_torch.utils.profiling import profile_rows

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    cfg, model, cond1, ref1, weights = serving_model(cfg, args.bench_ckpt, device)
    card = card_line(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    records = []
    for b in args.batch:
        ref, cond = ref1.expand(b, *ref1.shape[1:]).contiguous(), cond1.expand(b, -1).contiguous()
        gen = torch.Generator(device=device).manual_seed(SEED)
        sample = lambda: model.sample_video(ref, cond, 1.0, generator=gen)
        sample()
        sample()
        sync()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            sample()
        sync()
        wall_ms = (time.perf_counter() - t0) / args.iters * 1e3
        with profile(activities=activities) as prof:
            for _ in range(args.iters):
                sample()
            sync()
        rows = profile_rows(prof)
        device_rows = [r for r in rows if r["on_device"]]
        busy = sum(r["device_ms"] for r in device_rows) / args.iters
        rec = {"batch": b, "weights": weights, "iters": args.iters, "wall_ms_per_call": wall_ms,
               "frames_per_s": b * cfg.diffusion.num_frames / wall_ms * 1e3,
               "device_busy_ms_per_call": busy, "device_busy_share": busy / wall_ms,
               "device_launches_per_call": sum(r["count"] for r in device_rows) / args.iters,
               "groups": device_groups(device_rows, args.iters),
               "spans": span_table(prof, args.iters),
               "top": [{**r, "device_ms": r["device_ms"] / args.iters, "count": r["count"] / args.iters}
                       for r in device_rows[:args.top]],
               "clock": "cuda_sync" if on_card else "host", "card": card}
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, f"profile_sampler_b{b}.json"), "w") as f:
                json.dump({**rec, "all": rows}, f, indent=1)
        records.append(rec)
        emit(rec)
    return records


def main(argv=None) -> list:
    from cvpr23_lfdm_torch.config import mug_config

    return run(mug_config(), parser().parse_args(argv))


if __name__ == "__main__":
    main()
