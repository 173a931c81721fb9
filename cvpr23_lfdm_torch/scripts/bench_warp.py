"""Variant sweep for the decode warp and the fused warp+blend kernel.

Counterpart of the JAX package's `scripts/bench_warp.py`, with the
formulations that make sense on the card, at the serving decode's largest
warp (one `[B, 128, 128, 67]` source per video sampled at 40 per-frame
grids, bf16), on smooth near-identity flows:

  plain        the port's plain gather warp (`ops.warp.warp_video_plain`)
  grid_sample  one `F.grid_sample` call on the NCHW source (a yardstick:
               the port never calls it)
  warp_video   the decode warp (`csrc/warp_blend.cu`, frame axis, bf16)
  warp_gather  the fused warp+blend kernel (`csrc/warp_blend.cu`), frames
               folded into the batch and the shared source repeated, as the
               JAX script probes its lane-gather kernel; fp32 in and out

`--per-scale` times `warp_video`, `F.grid_sample` and `warp_onehot`
(folded over frames as above, blend none) at every decode scale of the
generator (32² x 256, 64² x 128, 128² x 67 channels), and reads the
device time alone of `warp_video` and `F.grid_sample` (torch.profiler,
`device_ms`). Every variant's mean is held against the first one's
(`val_drift`). The script uses only public functions, so it can time
another checkout of the package (`PYTHONPATH=<checkout> python <this
file> --per-scale`).

Usage: python -m cvpr23_lfdm_torch.scripts.bench_warp [--batch 8] [--per-scale]
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from cvpr23_lfdm_torch.ops import warp as warp_ops
from cvpr23_lfdm_torch.scripts._common import DTYPES, add_device_arg, card_line, emit
from cvpr23_lfdm_torch.utils.device import resolve_device
from cvpr23_lfdm_torch.utils.profiling import device_ms, time_fn

DECODE_SCALES = ((32, 256), (64, 128), (128, 67))


def make_case(b: int, f: int, s: int, c: int, dtype, device, seed: int = 0):
    """A seeded source `[B, s, s, C]` and smooth near-identity grids
    `[B, F, s, s, 2]` (an 8x8 field of displacements, resized), the kind of
    flow the decode warps."""
    g = torch.Generator().manual_seed(seed)
    image = torch.randn(b, s, s, c, generator=g).to(device=device, dtype=dtype)
    lin = torch.linspace(-1.0, 1.0, s)
    base = torch.stack(torch.meshgrid(lin, lin, indexing="xy"), -1)
    coarse = 0.03 * torch.randn(b * f, 2, 8, 8, generator=g)
    disp = F.interpolate(coarse, size=(s, s), mode="bilinear", align_corners=False)
    grid5 = base[None, None] + disp.permute(0, 2, 3, 1).reshape(b, f, s, s, 2)
    return image, grid5.to(device).contiguous()


def variants(image, grid5) -> dict:
    """name -> function of no arguments returning `[B, F, s, s, C]`."""
    b, f, s, _, _ = grid5.shape
    c = image.shape[-1]
    nchw = image.permute(0, 3, 1, 2)
    g4 = grid5.reshape(b, f * s, s, 2).to(image.dtype)
    folded = grid5.reshape(b * f, s, s, 2)

    def library():
        out = F.grid_sample(nchw, g4, mode="bilinear", padding_mode="zeros", align_corners=False)
        return out.permute(0, 2, 3, 1).reshape(b, f, s, s, c)

    def fold(fn):
        return lambda: fn(image.repeat_interleave(f, dim=0), folded).reshape(b, f, s, s, c)

    return {
        "plain": lambda: warp_ops.warp_video_plain(image, grid5),
        "grid_sample": library,
        "warp_video": lambda: warp_ops.warp_video(image, grid5),
        "warp_gather": fold(warp_ops.warp_gather),
        "warp_onehot": fold(warp_ops.warp_onehot),
    }


def sweep(names, image, grid5, device, iters: int = 8, warmup: int = 2, device_time=()) -> list:
    """Time the named variants on one case; `val_drift` is each mean's
    distance from the first variant's. The variants named in `device_time`
    also get `device_ms`, their device time alone (None: the profiler lost
    kernels)."""
    fns = variants(image, grid5)
    rows, ref = [], None
    with torch.no_grad():
        for name in names:
            val = float(fns[name]().float().mean())
            ref = val if ref is None else ref
            res = time_fn(fns[name], iters=iters, warmup=warmup, device=device)
            rows.append({"variant": name, "ms": res["median_ms"], "clock": res["clock"],
                         "val_drift": abs(val - ref)})
            if name in device_time:
                rows[-1]["device_ms"] = device_ms(fns[name], launches=1 if name == "warp_video" else None)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--ch", type=int, default=67)
    ap.add_argument("--dtype", default="bfloat16", choices=list(DTYPES))
    ap.add_argument("--per-scale", action="store_true",
                    help="warp_video, F.grid_sample and warp_onehot at every decode scale")
    add_device_arg(ap)
    args = ap.parse_args()
    device = resolve_device(args.device)
    card = card_line(device)
    dtype = DTYPES[args.dtype]
    if args.per_scale:
        for s, c in DECODE_SCALES:
            image, grid5 = make_case(args.batch, args.frames, s, c, dtype, device)
            for row in sweep(("warp_video", "grid_sample", "warp_onehot"), image, grid5, device,
                             device_time=("warp_video", "grid_sample") if device.type == "cuda" else ()):
                emit({"scale": s, "ch": c, **row, "card": card})
        return
    image, grid5 = make_case(args.batch, args.frames, args.size, args.ch, dtype, device)
    for row in sweep(("plain", "grid_sample", "warp_video", "warp_gather"), image, grid5, device):
        emit({**row, "shape": [args.batch, args.frames, args.size, args.size, args.ch],
              "dtype": args.dtype, "card": card})


if __name__ == "__main__":
    main()
