"""UNet3D eval micro-bench: one step of the DDIM loop in isolation.

Counterpart of the JAX package's `scripts/bench_unet.py`: times ONE `Unet3D`
eval at the MUG serving width (dim 64, mults (1,2,4,8), 8x32 heads, 40
frames, 32² latent, bf16 compute) for each batch size, in the UNet form
named by `--attn` and with or without the fused GroupNorm+FiLM+SiLU kernel
(`--fused-norm`), so that a kernel change can be read without a whole
sampling run. Weights come from the bench checkpoint, inputs from a seed.
The kernel launch counters of one
eval are printed beside the time; `--trace` adds a torch.profiler table of
one eval (device time by kernel).

Usage: python -m cvpr23_lfdm_torch.scripts.bench_unet [--batch 1 8]
           [--attn pallas3] [--fused-norm true] [--trace]
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from cvpr23_lfdm_torch.config import mug_config
from cvpr23_lfdm_torch.diffusion.flow_diffusion import build_unet
from cvpr23_lfdm_torch.ops import read_counters
from cvpr23_lfdm_torch.scripts._common import (
    BENCH_CKPT, DTYPES, add_device_arg, card_line, emit)
from cvpr23_lfdm_torch.utils.bench_ckpt import from_jax_params, load_bench_ckpt
from cvpr23_lfdm_torch.utils.device import resolve_device
from cvpr23_lfdm_torch.utils.profiling import profile_rows, time_fn

def make_unet(attn: str, fused_norm, dtype: str, device):
    """The MUG UNet in the form `attn` with the bench checkpoint's weights,
    in eval mode without gradients, on `device`."""
    cfg = mug_config()
    dcfg = dataclasses.replace(cfg.diffusion, temporal_attn_impl=attn, compute_dtype=dtype)
    unet = build_unet(cfg.lfae, dcfg, training=False, fused_norm=fused_norm)
    unet.load_state_dict(from_jax_params(load_bench_ckpt(BENCH_CKPT).unet_vars))
    return unet.to(device).eval().requires_grad_(False)


def make_inputs(unet, batch: int, frames: int, size: int, device, seed: int = 0) -> dict:
    """One seeded sample broadcast over the batch, as the JAX bench does."""
    g = torch.Generator().manual_seed(seed)
    rep = lambda t: t.expand(batch, *t.shape[1:]).contiguous().to(device)
    fea_channels = unet.init_conv_fea.conv.weight.shape[1]
    return {"x": rep(torch.randn(1, frames, size, size, 3, generator=g)),
            "time": torch.zeros(batch, dtype=torch.long, device=device),
            "cond": rep(torch.randn(1, unet.cond_dim, generator=g)),
            "fea": rep(torch.randn(1, 1, size, size, fea_channels, generator=g))}


def bench(unet, inputs: dict, device, iters: int = 10, warmup: int = 3) -> tuple[dict, torch.Tensor]:
    """Time one eval; returns the timing with the launch counts of one eval,
    and that eval's output."""
    with torch.no_grad():
        res = time_fn(lambda: unet(**inputs), iters=iters, warmup=warmup, device=device)
        before = read_counters()
        out = unet(**inputs)
    res["launches_per_eval"] = {k: n - before[k] for k, n in read_counters().items()}
    return res, out


def trace(unet, inputs: dict, top: int) -> list:
    """Device time by kernel of one eval under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        unet(**inputs)
        torch.cuda.synchronize()
    return [r for r in profile_rows(prof) if r["on_device"]][:top]


def _flag(s: str) -> bool:
    return s.lower() in ("1", "true", "yes")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--attn", default="pallas3", help="xla | pallas | pallas2 | pallas3")
    ap.add_argument("--dtype", default="bfloat16", choices=list(DTYPES))
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--fused-norm", default=None, type=_flag,
                    help="true: every Block is one GroupNorm+FiLM+SiLU kernel; false: the unfused "
                         "chain; default: serving's form (fused)")
    ap.add_argument("--trace", action="store_true",
                    help="profile one eval and print the top device kernels")
    ap.add_argument("--top", type=int, default=30)
    add_device_arg(ap)
    args = ap.parse_args()

    device = resolve_device(args.device)
    unet = make_unet(args.attn, args.fused_norm, args.dtype, device)
    for b in args.batch:
        inputs = make_inputs(unet, b, args.frames, args.size, device)
        res, _ = bench(unet, inputs, device)
        if args.trace and device.type == "cuda":
            for r in trace(unet, inputs, args.top):
                print(f"  {r['device_ms']:8.3f}  x{r['count']:<4d} {r['name']}")
        emit({"batch": b, "attn": args.attn, "fused_norm": unet.fused_norm,
              "dtype": args.dtype, "unet_eval_ms": res["median_ms"],
              "ms_per_sample": res["median_ms"] / b, "clock": res["clock"],
              "launches_per_eval": res["launches_per_eval"], "card": card_line(device)})


if __name__ == "__main__":
    main()
