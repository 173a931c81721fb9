"""Demo / sampling entry point: the serving path (counterpart of
`scripts/demo.py`).

Given one reference image, sample a 40-frame video for every class text and
write one GIF per class (ref demo_mug.py:107-146): the reference, the
sampled video, the warped video, the flow and the confidence, side by side.

Without `--lfae-ckpt` / `--dm-ckpt` (smoke mode) the MUG demo runs on the
committed bench checkpoint (`assets/bench_ckpt`, through
`utils/bench_ckpt.py::apply_bench_ckpt`) with the bundled example image and,
when no BERT table can be built, the seeded random class table. `.pth`
weights load through `utils/checkpoint.py::load_{lfae,unet}_from_torch`, a
directory through `CheckpointManager`. Sampling draws from one
`torch.Generator` seeded by `--seed`, class after class.

`--mesh dp=N` (N processes: `--coordinator`, `--num-processes`,
`--process-id`, or torchrun): every class in one request batch, sharded
over the processes (`parallel/serving.py::sample_video_sharded`); rank 0
writes the GIFs. `--mesh dp=N,tp=M` (N * M processes) shards the UNet of
each over M ranks as well (its heads and channels; M divides 8), and
`sp=K` (N * M * K processes) the LFAE's encoder and decoder over K ranks
by image height (whole even bands, `models/generator.py::check_sp`).

Usage: python -m cvpr23_lfdm_torch.scripts.demo [--device cpu] [--classes ...]
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from cvpr23_lfdm_torch.scripts._common import (
    BENCH_CKPT, apply_lfae_dtype, base_parser, load_model_weights, load_text_embedder,
    process_group, rank_device, resolve_attn_impl, setup,
)


def parser():
    p = base_parser("Sample videos from a reference image (demo)")
    p.add_argument("--ref-image", default="", help="path to reference image")
    p.add_argument("--lfae-ckpt", default="")
    p.add_argument("--dm-ckpt", default="")
    p.add_argument("--cond-scale", type=float, default=1.0)
    p.add_argument("--sampling-steps", type=int, default=10, help="DDIM steps")
    p.add_argument("--classes", nargs="*", default=None, help="subset of class texts")
    p.add_argument("--mean", type=float, nargs=3, default=(0.0, 0.0, 0.0),
                   help="per-channel pixel mean subtracted from the ref image, 0-255 "
                        "scale (demo_mug.py:116: ref_img - MEAN, MEAN=(0,0,0))")
    return p


def build_config(args):
    from cvpr23_lfdm_torch.config import PRESETS

    cfg = PRESETS[args.dataset]()
    cfg = cfg.replace(diffusion=dataclasses.replace(
        cfg.diffusion, sampling_timesteps=args.sampling_steps,
        temporal_attn_impl=resolve_attn_impl(args)))
    return apply_lfae_dtype(cfg, args)


def reference_image(args, size: int) -> np.ndarray:
    """`[H, W, 3]` float32: `--ref-image`, else the bundled example of the
    dataset, else a synthetic blob frame."""
    from cvpr23_lfdm_torch.data.io import pad_resize, read_image
    from cvpr23_lfdm_torch.parallel.serving import demo_asset_path

    path = args.ref_image
    if not path and os.path.exists(demo_asset_path(args.dataset)):
        path = demo_asset_path(args.dataset)
        print(f"using bundled example image {path}")
    if path:
        img = pad_resize(read_image(path), size).astype(np.float32) / 255.0
        return img - np.asarray(args.mean, np.float32) / 255.0
    print("warning: no --ref-image; using a synthetic blob frame")
    from cvpr23_lfdm_torch.data.synthetic import _blob_video

    return _blob_video(np.random.default_rng(0), 1, size, (0.9, 0.6, 0.4))[0].astype(np.float32) / 255.0


def build_model(cfg, args):
    """`(cfg, FlowDiffusion)` in serving form on `args.device`."""
    from cvpr23_lfdm_torch.diffusion.flow_diffusion import FlowDiffusion
    from cvpr23_lfdm_torch.utils.bench_ckpt import apply_bench_ckpt

    smoke = not (args.lfae_ckpt or args.dm_ckpt)
    if smoke:
        args.allow_random_text = True
    device = rank_device(args)
    if smoke and args.dataset == "mug" and os.path.isdir(BENCH_CKPT):
        cfg, model, _, _, _ = apply_bench_ckpt(BENCH_CKPT, cfg, device=device)
        print(f"smoke mode: trained-synthetic weights from {BENCH_CKPT}")
        return cfg, model
    torch.manual_seed(args.seed)
    model = FlowDiffusion(cfg.lfae, cfg.diffusion, device=device)
    load_model_weights(model, args.lfae_ckpt, args.dm_ckpt)
    return cfg, model


def panels(img: np.ndarray, out: dict, bi: int, id_grid: np.ndarray, size: int) -> np.ndarray:
    """`[F, H, 5W, 3]` uint8: ref | out | warped | flow | confidence."""
    from cvpr23_lfdm_torch.utils.viz import conf2fig, flow2fig, to_uint8

    frames = []
    for fi in range(out["out_vid"].shape[1]):
        frames.append(np.concatenate([
            to_uint8(img),
            to_uint8(out["out_vid"][bi, fi]),
            to_uint8(out["warped_vid"][bi, fi]),
            flow2fig(out["vid_grid"][bi, fi], id_grid, size),
            np.repeat(conf2fig(out["vid_conf"][bi, fi], size)[..., None], 3, -1),
        ], axis=1))
    return np.stack(frames)


def run(cfg, args) -> dict:
    """Sample and write one GIF per class. Returns `{"gifs": [paths],
    "outputs": {class: sample_video output as CPU numpy}}` (with `--mesh`:
    every rank has the outputs, rank 0 the GIFs)."""
    from cvpr23_lfdm_torch.ops.grid import make_coordinate_grid
    from cvpr23_lfdm_torch.parallel.distributed import is_primary
    from cvpr23_lfdm_torch.parallel.mesh import replicate
    from cvpr23_lfdm_torch.parallel.serving import sample_video_sharded, serving_mesh
    from cvpr23_lfdm_torch.utils.viz import save_gif

    cfg, model = build_model(cfg, args)
    mesh = serving_mesh(args.mesh, device=model.device, frame_shape=cfg.lfae.frame_shape,
                        num_down_blocks=cfg.lfae.generator.num_down_blocks)
    if mesh is not None:
        replicate(model, mesh)
    size = cfg.lfae.frame_shape
    img = reference_image(args, size)
    ref_img = torch.from_numpy(img)[None].to(model.device)
    embedder = load_text_embedder(args)
    classes = args.classes or list(embedder.classes)
    out_dir = os.path.join(args.log_dir, "demo")
    os.makedirs(out_dir, exist_ok=True)
    h = cfg.diffusion.img_size
    id_grid = make_coordinate_grid((h, h)).numpy()
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    result = {"gifs": [], "outputs": {}}

    def write(text, out, bi):
        result["outputs"][text] = {k: v[bi:bi + 1] for k, v in out.items()}
        if not is_primary():
            return
        name = text.replace(" ", "_").replace("(", "").replace(")", "")
        path = os.path.join(out_dir, f"{name}.gif")
        save_gif(path, panels(img, out, bi, id_grid, size))
        print(f"sampled {text!r} -> {path}")
        result["gifs"].append(path)

    if mesh is not None:  # every class in one request batch, sharded over the ranks
        conds = torch.from_numpy(embedder(classes)[0]).to(model.device)
        out = sample_video_sharded(model, mesh, ref_img.expand(len(classes), -1, -1, -1), conds,
                                   args.cond_scale, generator=gen)
        out = {k: v.float().cpu().numpy() for k, v in out.items()}
        print(f"sampled {len(classes)} classes on mesh {args.mesh}")
        for bi, text in enumerate(classes):
            write(text, out, bi)
        return result
    for text in classes:
        cond, _ = embedder([text])
        out = model.sample_video(ref_img, torch.from_numpy(cond).to(model.device),
                                 args.cond_scale, generator=gen)
        write(text, {k: v.float().cpu().numpy() for k, v in out.items()}, 0)
    return result


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    setup(args, multi_device=True, serving=True)
    with process_group(args):
        return run(build_config(args), args)


if __name__ == "__main__":
    main()
