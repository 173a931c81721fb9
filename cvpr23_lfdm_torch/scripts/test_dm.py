"""DM held-out evaluation entry point (counterpart of `scripts/test_dm.py`).

For held-out subjects (the test split, one take per subject and class):
the pseudo-ground-truth forward with its reconstruction monitoring losses
(`FlowDiffusion.loss` under `torch.no_grad()`: the serving form's kernels
refuse a gradient), conditional sampling, PSNR and SSIM, and, enabled by
their weights, FVD / cFVD / sFVD (I3D) and LPIPS through the port's
`eval/{i3d,lpips,metrics}.py`. `--random-metric-weights` runs the metric
protocol with seeded extractor weights. `--save-video` writes
real | sampled GIFs.

The JAX CLI's report of which tiled-warp branch each decode took has no
counterpart: the port's decode warp (row 3) is exact at every scale and has
no windows to fit.

`--mesh dp=N` (N processes: `--coordinator`, `--num-processes`,
`--process-id`, or torchrun): every evaluated video is sampled in one
request batch sharded over the processes
(`parallel/serving.py::sample_video_sharded`), first, from the generator of
`--seed`; rank 0 then runs the monitoring forwards and the metrics and
writes the GIFs, the other ranks return `{}`. `--mesh dp=N,tp=M` (N * M
processes) shards the UNet of each over M ranks as well (its heads and
channels; M divides 8), and `sp=K` (N * M * K processes) the LFAE's
encoder and decoder over K ranks by image height (whole even bands,
`models/generator.py::check_sp`); the ranks of data index 0 (its model
and space groups) then run the monitoring forwards together.

Usage: python -m cvpr23_lfdm_torch.scripts.test_dm [--device cpu] [--synthetic]
       [--random-metric-weights] [--num-videos 4]
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from cvpr23_lfdm_torch.scripts._common import (
    apply_lfae_dtype, base_parser, load_model_weights, load_text_embedder, process_group,
    rank_device, resolve_attn_impl, resolve_data_root, setup,
)


def parser():
    p = base_parser("Evaluate the flow diffusion model on held-out subjects")
    p.add_argument("--lfae-ckpt", default="")
    p.add_argument("--dm-ckpt", default="")
    p.add_argument("--bench-ckpt", default="",
                   help="assets/bench_ckpt-style directory: the trained UNet + LFAE generator "
                        "(the region and background predictors seeded), the sampler objective "
                        "from its meta. Overrides --lfae-ckpt/--dm-ckpt")
    p.add_argument("--cond-scale", type=float, default=1.0)
    p.add_argument("--sampling-steps", type=int, default=0,
                   help="0 = reference per-dataset default: DDIM 10 for MUG/MHAD "
                        "(test_video_flow_diffusion_mug.py:28-33), 200 for NATOPS")
    p.add_argument("--num-videos", type=int, default=4)
    p.add_argument("--save-video", action="store_true")
    p.add_argument("--i3d-weights", default="",
                   help="pytorch_i3d rgb_imagenet.pt for published-scale FVD (eval/i3d.py); "
                        "omitted = FVD skipped")
    p.add_argument("--lpips-weights", default="",
                   help="official LPIPS checkpoint dir (vgg16_features.pth + lpips_vgg_lin.pth) "
                        "or one .pth holding {features, lin}; omitted = LPIPS skipped")
    p.add_argument("--random-metric-weights", action="store_true",
                   help="run the FULL metric protocol (FVD/cFVD/sFVD + LPIPS) with SEEDED "
                        "RANDOM extractor weights; values reproducible but NOT comparable to "
                        "published numbers")
    p.add_argument("--mean", type=float, nargs=3, default=(0.0, 0.0, 0.0),
                   help="per-channel pixel mean, 0-255 scale (every reference script uses (0,0,0))")
    p.add_argument("--objective", choices=("eps", "x0", "v"), default="eps",
                   help="denoiser parameterization; must match what --dm-ckpt was trained with")
    return p


def build_config(args):
    from cvpr23_lfdm_torch.config import PRESETS

    cfg = PRESETS[args.dataset]()
    steps = args.sampling_steps or (200 if args.dataset == "natops" else 10)
    cfg = cfg.replace(diffusion=dataclasses.replace(
        cfg.diffusion, sampling_timesteps=steps, temporal_attn_impl=resolve_attn_impl(args),
        objective=args.objective))
    return apply_lfae_dtype(cfg, args)


def build_model(cfg, args):
    """`(cfg, FlowDiffusion)` with the frozen LFAE's predictors (the
    pseudo-ground truth needs them), the UNet in the form `cfg` names, no
    parameter requiring a gradient."""
    from cvpr23_lfdm_torch.diffusion.flow_diffusion import FlowDiffusion
    from cvpr23_lfdm_torch.utils.bench_ckpt import apply_bench_ckpt

    device = rank_device(args)
    if args.bench_ckpt:
        try:
            cfg, model, _, _, meta = apply_bench_ckpt(args.bench_ckpt, cfg, device=device,
                                                      training=True)
        except FileNotFoundError as e:
            raise SystemExit(f"--bench-ckpt {args.bench_ckpt}: {e}") from None
        print(f"bench checkpoint loaded (objective {meta['objective']})")
    else:
        torch.manual_seed(args.seed)
        model = FlowDiffusion(cfg.lfae, cfg.diffusion, device=device, training=True)
        load_model_weights(model, args.lfae_ckpt, args.dm_ckpt)
    model.eval().requires_grad_(False)
    return cfg, model


def metric_fns(args, device):
    """`(fvd extractor or None, lpips fn or None)` from the weight flags."""
    from cvpr23_lfdm_torch.eval import i3d, lpips

    fvd_extract = lpips_fn = None
    load = lambda path: torch.load(path, map_location="cpu", weights_only=True)  # noqa: E731
    if args.i3d_weights:
        fvd_extract = i3d.i3d_extractor(i3d.convert_i3d_checkpoint(load(args.i3d_weights)),
                                        device=device)
    if args.lpips_weights:
        lp = args.lpips_weights
        if os.path.isdir(lp):
            feat_sd = load(os.path.join(lp, "vgg16_features.pth"))
            lin_sd = load(os.path.join(lp, "lpips_vgg_lin.pth"))
        else:
            both = load(lp)
            feat_sd, lin_sd = both["features"], both["lin"]
        lpips_fn = lpips.make_lpips(lpips.convert_vgg16_features(feat_sd),
                                    lpips.convert_lpips_lin(lin_sd), device=device)
    if args.random_metric_weights:
        if fvd_extract is None:
            fvd_extract = i3d.i3d_extractor(i3d.random_i3d_vars(1234), device=device)
        if lpips_fn is None:
            lpips_fn = lpips.random_lpips_for_testing(1235, device=device)
        print("metric extractors: SEEDED RANDOM weights (protocol smoke; values "
              "reproducible, NOT comparable to published numbers)")
    return fvd_extract, lpips_fn


def run(cfg, args) -> dict:
    """Evaluate `--num-videos` held-out videos; returns the means
    (`rec_loss`, `warp_loss`, `psnr`, `ssim`, and with their extractors
    `lpips`, `fvd`, `cfvd`, `sfvd`) and `videos` (with `--mesh`, on rank
    0; `{}` on the others)."""
    from cvpr23_lfdm_torch.data import DMVideoDataset, get_spec
    from cvpr23_lfdm_torch.eval.metrics import FVD, psnr, ssim
    from cvpr23_lfdm_torch.parallel.distributed import is_primary
    from cvpr23_lfdm_torch.parallel.mesh import replicate
    from cvpr23_lfdm_torch.parallel.serving import sample_video_sharded, serving_mesh
    from cvpr23_lfdm_torch.utils.viz import save_gif, to_uint8

    cfg, model = build_model(cfg, args)
    dev = model.device
    mesh = serving_mesh(args.mesh, device=dev, frame_shape=cfg.lfae.frame_shape,
                        num_down_blocks=cfg.lfae.generator.num_down_blocks)
    if mesh is not None:
        replicate(model, mesh)
    root = resolve_data_root(args, cfg.lfae.frame_shape)
    embedder = load_text_embedder(args)
    dataset = DMVideoDataset(
        get_spec(args.dataset), root, "test", combos=True,
        num_frames=cfg.diffusion.num_frames, image_size=cfg.lfae.frame_shape,
        color_jitter=False, sampling="uniform", mean=tuple(args.mean), seed=args.seed,
    )
    fvd_extract, lpips_fn = metric_fns(args, dev)
    out_dir = os.path.join(args.log_dir, "dm_test")
    os.makedirs(out_dir, exist_ok=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rec, warp, psnrs, ssims, lpips_vals = [], [], [], [], []
    real_set, fake_set, classes, subjects = [], [], [], []
    n = min(args.num_videos, len(dataset))
    sharded = None
    if mesh is not None:  # every video in one request batch, sharded over the ranks
        items = [dataset[i] for i in range(n)]
        refs = torch.from_numpy(np.stack([it["video"][0] for it in items])).to(dev)
        conds = torch.from_numpy(np.concatenate([embedder([it["text"]])[0] for it in items])).to(dev)
        sharded = sample_video_sharded(model, mesh, refs, conds, args.cond_scale, generator=gen)
        print(f"sampled {n} videos on mesh {args.mesh}")
        if mesh.rank != 0:  # the monitoring forwards run on the ranks of data index 0 only
            return {}
    log = print if is_primary() else (lambda *a: None)
    for i in range(n):
        item = dataset[i]
        vid = torch.from_numpy(item["video"])[None].to(dev)
        ref = vid[:, 0]
        cond = torch.from_numpy(embedder([item["text"]])[0]).to(dev)
        with torch.no_grad():
            loss, aux = model.loss(ref, vid, cond, generator=gen)
        if sharded is not None:
            out = {k: v[i:i + 1] for k, v in sharded.items()}
        else:
            out = model.sample_video(ref, cond, args.cond_scale, generator=gen)
        fake = out["out_vid"].float()
        rec.append(float(aux["rec_loss"]))
        warp.append(float(aux["rec_warp_loss"]))
        psnrs.append(float(psnr(vid, fake)))
        ssims.append(float(ssim(vid, fake)))
        if lpips_fn is not None:  # frame-wise LPIPS averaged over the video
            lpips_vals.append(float(lpips_fn(vid[0], fake[0]).mean()))
        if fvd_extract is not None:
            real_set.append(item["video"])
            fake_set.append(fake[0].cpu().numpy())
            classes.append(item["text"])
            subjects.append(item["subject"])
        log(f"[{i + 1}/{n}] {item['name']}: loss {float(loss):.4f} rec {rec[-1]:.4f} "
              f"warp {warp[-1]:.4f} psnr {psnrs[-1]:.2f} ssim {ssims[-1]:.3f}")
        if args.save_video and is_primary():
            rows = np.concatenate([to_uint8(item["video"]), to_uint8(fake[0].cpu().numpy())], axis=2)
            save_gif(os.path.join(out_dir, f"{item['name']}.gif"), rows)
    result = {"videos": n, "rec_loss": float(np.mean(rec)), "warp_loss": float(np.mean(warp)),
              "psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims))}
    line = (f"mean rec {result['rec_loss']:.4f} mean warp {result['warp_loss']:.4f} "
            f"mean psnr {result['psnr']:.2f} mean ssim {result['ssim']:.3f}")
    if lpips_vals:
        result["lpips"] = float(np.mean(lpips_vals))
        line += f" mean lpips {result['lpips']:.4f}"
    if fvd_extract is not None and real_set:
        fvd = FVD(fvd_extract)
        real_arr, fake_arr = np.stack(real_set), np.stack(fake_set)
        result["fvd"] = float(fvd(real_arr, fake_arr))
        # the paper's conditional variants (arXiv:2303.13744): FVD within each
        # class (cFVD) / each subject (sFVD), averaged over conditions
        result["cfvd"] = fvd.grouped(real_arr, fake_arr, classes, classes)[0]
        result["sfvd"] = fvd.grouped(real_arr, fake_arr, subjects, subjects)[0]
        line += f" fvd {result['fvd']:.4g} cfvd {result['cfvd']:.4g} sfvd {result['sfvd']:.4g}"
    log(line)
    return result if is_primary() else {}


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    setup(args, multi_device=True, serving=True)
    with process_group(args):
        return run(build_config(args), args)


if __name__ == "__main__":
    main()
