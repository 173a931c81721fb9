"""The two candidates for the differentiable warp of an LFAE training step,
timed at the step's shapes, forward and backward.

The JAX package warps with its XLA `grid_sample` whenever `train` is set;
the port's counterpart is one of

  plain        `ops.warp.grid_sample`, the plain version written out (four
               corner gathers; autograd's backward scatters each corner)
  train_warp   `ops.warp.train_warp`: one `F.grid_sample` call on an NCHW
               view of the channel-last image (one kernel forward, one
               backward)

The calls of one MUG training step at batch B (128² frames, 10 regions):
the pixelwise flow predictor's deformed source (`[B, 32, 32, 3]` sampled at
the K+1 = 11 grids of each pair, `[B, 11*32, 32, 2]`, gradient to the grid)
and the generator's decode warps (`[B, 32, 32, 256]`, `[B, 64, 64, 128]`,
`[B, 128, 128, 64+3]`, gradient to the features and the grid); and the TPS
transform of the driving frame (`[B, 128, 128, 3]`, reflection padding,
forward only). Each call: median CUDA-event ms of the forward alone and of
forward + backward; the largest difference of the two candidates' outputs
and gradients. The last line sums each candidate over the step.

Usage: python -m cvpr23_lfdm_torch.scripts.bench_train_warp [--batch 100]
"""

from __future__ import annotations

import argparse

import torch

from cvpr23_lfdm_torch.ops import warp as warp_ops
from cvpr23_lfdm_torch.scripts._common import add_device_arg, card_line, emit
from cvpr23_lfdm_torch.utils.device import resolve_device
from cvpr23_lfdm_torch.utils.profiling import time_fn

# (name, image [H, W, C], grid [Hg, Wg], image needs a gradient, padding, backward)
STEP_WARPS = (
    ("pixelwise_deformed_source", (32, 32, 3), (11 * 32, 32), False, "zeros", True),
    ("decode_32", (32, 32, 256), (32, 32), True, "zeros", True),
    ("decode_64", (64, 64, 128), (64, 64), True, "zeros", True),
    ("decode_128", (128, 128, 67), (128, 128), True, "zeros", True),
    ("tps_transform_frame", (128, 128, 3), (128, 128), False, "reflection", False),
)


def make_case(b: int, image_shape, grid_shape, device, seed: int = 0):
    """A seeded image and a grid of near-identity coordinates with a tenth
    of them pushed outside [-1, 1], as the step's flows have some."""
    g = torch.Generator().manual_seed(seed)
    h, w, c = image_shape
    gh, gw = grid_shape
    image = torch.randn(b, h, w, c, generator=g)
    ys = torch.linspace(-1.0, 1.0, gh)
    xs = torch.linspace(-1.0, 1.0, gw)
    base = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), -1)
    grid = base[None] + 0.05 * torch.randn(b, gh, gw, 2, generator=g)
    grid = grid * (1.0 + 0.1 * (torch.rand(b, gh, gw, 1, generator=g) < 0.1))
    return image.to(device), grid.to(device)


def candidates(padding: str) -> dict:
    if padding == "zeros":
        return {"plain": warp_ops.grid_sample, "train_warp": warp_ops.train_warp}
    lib = lambda img, grid: torch.nn.functional.grid_sample(
        img.permute(0, 3, 1, 2), grid, mode="bilinear", padding_mode=padding,
        align_corners=False).permute(0, 2, 3, 1)
    return {"plain": lambda img, grid: warp_ops.grid_sample(img, grid, padding_mode=padding),
            "train_warp": lib}


def run_case(b: int, case, device, iters: int) -> dict:
    name, image_shape, grid_shape, image_grad, padding, backward = case
    image, grid = make_case(b, image_shape, grid_shape, device)
    image.requires_grad_(image_grad and backward)
    grid.requires_grad_(backward)
    g = torch.Generator().manual_seed(1)
    cot = torch.randn(b, *grid_shape, image_shape[2], generator=g).to(device)
    row = {"call": name, "image": [b, *image_shape], "grid": [b, *grid_shape, 2],
           "padding": padding}
    results = {}
    for key, fn in candidates(padding).items():
        def fwd():
            with torch.no_grad():
                return fn(image, grid)

        def fwd_bwd():
            image.grad = grid.grad = None
            out = fn(image, grid)
            out.backward(cot)
            return out

        row[f"{key}_fwd_ms"] = time_fn(fwd, iters=iters, warmup=2, device=device)["median_ms"]
        if backward:
            row[f"{key}_fwd_bwd_ms"] = time_fn(fwd_bwd, iters=iters, warmup=2,
                                               device=device)["median_ms"]
            out = fwd_bwd()
            results[key] = [out.detach(), grid.grad.clone()] + (
                [image.grad.clone()] if image_grad else [])
        else:
            results[key] = [fwd()]
    diffs = [float((a - p).abs().max()) for a, p in zip(results["train_warp"], results["plain"])]
    row["max_abs_diff"] = dict(zip(["out", "d_grid", "d_image"], diffs))
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=100)
    ap.add_argument("--iters", type=int, default=10)
    add_device_arg(ap)
    args = ap.parse_args()
    device = resolve_device(args.device)
    card = card_line(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    total = {"plain": 0.0, "train_warp": 0.0}
    for case in STEP_WARPS:
        row = run_case(args.batch, case, device, args.iters)
        for key in total:
            total[key] += row.get(f"{key}_fwd_bwd_ms", row[f"{key}_fwd_ms"])
        emit({**row, "card": card, "clock": "host" if device.type == "cpu" else "cuda_events"})
        if device.type == "cuda":
            torch.cuda.empty_cache()
    emit({"per_step_ms": total, "batch": args.batch,
          "what": "sum over the step's warps of forward + backward (forward alone for the TPS "
                  "transform)", "card": card})


if __name__ == "__main__":
    main()
