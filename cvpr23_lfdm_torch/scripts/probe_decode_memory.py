"""Which convolution sets the peak allocated memory of the MUG decode.

One process decodes a seeded 40-frame flow (the bench checkpoint's
generator, B=1, 128² frames) through `FlowDiffusion.decode_flow_video`,
and each `Conv2d` of the generator reports the peak allocated memory
during its call above the memory allocated when it started (its output
and any workspace of the library's convolution), largest first, beside
the decode's own peak. One JSON line per dtype. Card only: the readings
are the CUDA caching allocator's.

Usage: python -m cvpr23_lfdm_torch.scripts.probe_decode_memory [--dtype float32 bfloat16] [--top 5]
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from cvpr23_lfdm_torch.scripts._common import card_line, emit

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MB = 2 ** 20


def decode_memory(dtype: str, top: int, frames: int = 40, seed: int = 0) -> dict:
    from cvpr23_lfdm_torch.config import mug_config
    from cvpr23_lfdm_torch.models.blocks import Conv2d
    from cvpr23_lfdm_torch.ops.grid import identity_flow_volume
    from cvpr23_lfdm_torch.utils.bench_ckpt import apply_bench_ckpt

    cfg = mug_config()
    cfg = cfg.replace(diffusion=dataclasses.replace(cfg.diffusion, num_frames=frames, compute_dtype=dtype),
                      lfae=dataclasses.replace(cfg.lfae, compute_dtype=dtype))
    _, model, _, ref, _ = apply_bench_ckpt(os.path.join(_REPO_ROOT, "assets", "bench_ckpt"), cfg)
    s = cfg.diffusion.img_size
    g = torch.Generator(device=ref.device).manual_seed(seed)
    grid = identity_flow_volume(1, frames, s, s, torch.float32, ref.device) \
        + 0.05 * torch.randn(1, frames, s, s, 2, generator=g, device=ref.device)
    conf = torch.rand(1, frames, s, s, 1, generator=g, device=ref.device)
    rows, start = [], {}

    def before(module, args):
        torch.cuda.synchronize()
        start[module] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    def after(module, args, out):
        torch.cuda.synchronize()
        rows.append({"conv": module.probe_name, "input": list(args[0].shape),
                     "transient_mb": (torch.cuda.max_memory_allocated() - start[module]) / MB,
                     "output_mb": out.numel() * out.element_size() / MB})

    model.decode_flow_video(ref, grid, conf)  # warm-up: cuDNN's algorithm choice, the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model.decode_flow_video(ref, grid, conf)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / MB
    hooks = []
    for name, module in model.generator.named_modules():
        if isinstance(module, Conv2d):
            module.probe_name = name
            hooks += [module.register_forward_pre_hook(before), module.register_forward_hook(after)]
    model.decode_flow_video(ref, grid, conf)
    for h in hooks:
        h.remove()
    return {"dtype": dtype, "frames": frames, "decode_peak_mb": peak,
            "largest_conv_transients": sorted(rows, key=lambda r: -r["transient_mb"])[:top]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", nargs="+", default=["float32", "bfloat16"], choices=["float32", "bfloat16"])
    ap.add_argument("--top", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("probe_decode_memory reads the CUDA allocator; needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line(torch.device("cuda", torch.cuda.current_device()))
    for dtype in args.dtype:
        emit({**decode_memory(dtype, args.top), "card": card})
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
