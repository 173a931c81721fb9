"""Train trained-regime weights for the serving bench (counterpart of
`scripts/make_bench_ckpt.py`).

With random weights the DM samples noise flows; a bench checkpoint holds
weights whose sampled flows are smooth and near the identity, as a trained
deployment's are. This script runs the product trainers on a synthetic
MUG-layout corpus (40-frame videos at 128², blobs moving by
`--motion-scale`) at the full MUG serving config: stage 1, `LFAETrainer.fit`
(`--lfae-steps`, `--lfae-batch`); then its memory freed, stage 2,
`DMTrainer.fit` on the stage-1 LFAE (`--dm-steps`, `--dm-batch`, the UNet's
training form, `--objective`, default x0). Sample quality does not matter;
the flow statistics do, and the probe reports them.

It writes, through `utils/bench_ckpt.py::save_bench_ckpt`, the files the
JAX package's `save_bench_ckpt` writes (`unet.msgpack` in full, the LFAE
generator without its pixelwise flow predictor as `generator.msgpack`, both
float16; `cond.npy`, `ref.npy`, `meta.json` with the objective), which
both packages' `load_bench_ckpt` read; `--save-every N` rewrites them every
N DM steps. **`--out` defaults to `<log-dir>/bench_ckpt`**, not the JAX
CLI's `assets/bench_ckpt`: the committed checkpoint belongs to the JAX
package and is never overwritten.

**The fit probe has no counterpart.** The JAX script checks the TPU tiled
decode warp's window fit (`warp_pallas.tiled_fit`) on probe videos; the
port's decode warp (row 3) has no windows. The probe here samples
`--probe-videos` videos with the serving form (`pallas3`: rows 1, 2 and 3
on the card) and reports, as the JAX script does, the 99th percentile of
the sampled flow's displacement `|grid - identity| * res / 2` in pixels at
32², 64² and 128² (the grid resized by `ops/resize.py::resize_bilinear`).
`fit_report.json` keeps every other field of the JAX report and leaves out
`fit_rate`.

Usage: python -m cvpr23_lfdm_torch.scripts.make_bench_ckpt [--device cpu]
       [--lfae-steps 400] [--dm-steps 400] [--out DIR]
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time

import numpy as np
import torch

from cvpr23_lfdm_torch.scripts._common import (
    apply_lfae_dtype, base_parser, load_text_embedder, resolve_attn_impl, setup,
)

PROBE_RES = (32, 64, 128)


def parser():
    p = base_parser("Train trained-regime weights for the serving bench")
    p.add_argument("--lfae-steps", type=int, default=400)
    p.add_argument("--dm-steps", type=int, default=400)
    p.add_argument("--lfae-batch", type=int, default=8)
    p.add_argument("--dm-batch", type=int, default=4)
    p.add_argument("--probe-videos", type=int, default=4)
    p.add_argument("--motion-scale", type=float, default=0.2,
                   help="synthetic-corpus travel scale (1.0 = 30%% of frame; 0.2 matches real MUG "
                        "facial-motion magnitude)")
    p.add_argument("--no-augment", action="store_true",
                   help="drop clip augmentation + color jitter: this checkpoint's job is to "
                        "OVERFIT the corpus flow statistics")
    p.add_argument("--save-every", type=int, default=0,
                   help="overwrite-save the bench ckpt every N DM steps (a killed run keeps its "
                        "latest weights)")
    p.add_argument("--objective", choices=("eps", "x0", "v"), default="x0",
                   help="denoiser parameterization for THIS checkpoint (recorded in meta.json; "
                        "the sampler that loads it is built to match)")
    p.add_argument("--out", default="",
                   help="checkpoint directory (default <log-dir>/bench_ckpt; never the committed "
                        "assets/bench_ckpt, which belongs to the JAX package)")
    return p


def build_config(args):
    from cvpr23_lfdm_torch.config import mug_config

    cfg = apply_lfae_dtype(mug_config(), args)
    return cfg.replace(diffusion=dataclasses.replace(
        cfg.diffusion, objective=args.objective,
        temporal_attn_impl=resolve_attn_impl(args, training=True)))


def flow_displacement_p99(grid: torch.Tensor) -> dict:
    """The 99th percentile of `|grid - identity| * res / 2` (pixels) of
    sampled grids `[B, F, h, w, 2]` in [-1, 1], resized bilinearly to each
    probe resolution."""
    from cvpr23_lfdm_torch.ops.resize import resize_bilinear

    b, f, gh, gw, _ = grid.shape
    out = {}
    for res in PROBE_RES:
        g = resize_bilinear(grid.reshape(b * f, gh, gw, 2).float(), (res, res))
        lin = np.linspace(-1.0, 1.0, res, dtype=np.float32)
        ident = np.stack(np.meshgrid(lin, lin, indexing="xy"), -1)
        out[str(res)] = float(np.percentile(np.abs(g.cpu().numpy() - ident) * (res / 2.0), 99.0))
    return out


def run(cfg, args) -> dict:
    """Both stages, the probe and the checkpoint; returns `{"out",
    "report", "lfae_s", "dm_s", "probe_s", "save_s", "bytes"}`."""
    from cvpr23_lfdm_torch.data import (
        ClipAugment, DMVideoDataset, LFAEPairDataset, PrefetchLoader, get_spec,
    )
    from cvpr23_lfdm_torch.data.synthetic import make_synthetic_corpus
    from cvpr23_lfdm_torch.diffusion.flow_diffusion import FlowDiffusion
    from cvpr23_lfdm_torch.scripts.train_dm import dm_batches
    from cvpr23_lfdm_torch.train.dm_trainer import DMTrainer
    from cvpr23_lfdm_torch.train.lfae_trainer import LFAETrainer
    from cvpr23_lfdm_torch.utils.bench_ckpt import save_bench_ckpt
    from cvpr23_lfdm_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    spec = get_spec("mug")
    out_dir = args.out or os.path.join(args.log_dir, "bench_ckpt")
    root = args.data_root or tempfile.mkdtemp(prefix="bench_ckpt_corpus_")
    if not (os.path.isdir(root) and os.listdir(root)):
        os.makedirs(root, exist_ok=True)
        make_synthetic_corpus(root, "mug", num_frames=cfg.diffusion.num_frames,
                              size=cfg.lfae.frame_shape, seed=args.seed,
                              subjects=list(spec.train_subjects[:2]), classes=None, takes=2,
                              motion_scale=args.motion_scale)
    print(f"corpus at {root}")

    # ---------------------------------------------------------- stage 1
    t0 = time.perf_counter()
    lfae_ds = LFAEPairDataset(spec, root, "train", frame_shape=cfg.lfae.frame_shape,
                              augment=None if args.no_augment else ClipAugment(), seed=args.seed)
    lfae_trainer = LFAETrainer(cfg, steps_per_epoch=10_000, device=device)
    state = lfae_trainer.init_state(args.seed)
    loader = PrefetchLoader(lfae_ds, args.lfae_batch, num_workers=6, seed=args.seed)
    lfae_trainer.fit(state, iter(loader), args.lfae_steps, args.seed, log_every=50)
    lfae_state = {k: v.detach().clone() for k, v in lfae_trainer.model.state_dict().items()}
    # free stage 1 (the nets, Adam's moments, the VGG19) before stage 2
    del loader, state, lfae_trainer
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    lfae_s = time.perf_counter() - t0

    # ---------------------------------------------------------- stage 2
    t0 = time.perf_counter()
    embedder = load_text_embedder("mug", allow_random=True)
    dm_ds = DMVideoDataset(spec, root, "train", num_frames=cfg.diffusion.num_frames,
                           image_size=cfg.lfae.frame_shape, color_jitter=not args.no_augment,
                           sampling=cfg.dm_train.frame_sampling, seed=args.seed)
    model = FlowDiffusion(cfg.lfae, cfg.diffusion, device=device, training=True)
    for name in ("region_predictor", "bg_predictor", "generator"):
        module = getattr(model, name)
        module.load_state_dict({k: lfae_state[f"{name}.{k}"] for k in module.state_dict()})
    dm_trainer = DMTrainer(cfg, steps_per_epoch=10_000, model=model)
    dm_state = dm_trainer.init_state(args.seed + 1)
    dm_loader = PrefetchLoader(dm_ds, args.dm_batch, num_workers=8, seed=args.seed)
    cond_vec = embedder([spec.classes[0]])[0][0]
    # an in-distribution reference frame: serving conditions on compute_fea(ref)
    ref_frame = np.asarray(dm_ds[0]["video"][0], np.float32)
    meta = {"objective": args.objective}

    def save(st=None):
        save_bench_ckpt(out_dir, model.unet.state_dict(), lfae_state, cond_vec, ref=ref_frame, meta=meta)
        if st is not None:
            print(f"snapshot saved at step {st.step}", flush=True)

    dm_trainer.fit(dm_state, dm_batches(dm_loader, embedder), args.dm_steps, args.seed + 2,
                   log_every=50, checkpoint_fn=save if args.save_every else None,
                   checkpoint_every=max(1, args.save_every))
    if device.type == "cuda":
        torch.cuda.synchronize()
    dm_s = time.perf_counter() - t0

    # ------------------------------------------------ flow probe (serving form)
    t0 = time.perf_counter()
    probe_cfg = cfg.replace(diffusion=dataclasses.replace(
        cfg.diffusion, temporal_attn_impl="pallas3", sampling_timesteps=10))
    probe = FlowDiffusion(probe_cfg.lfae, probe_cfg.diffusion, device=device)
    probe.unet.load_state_dict(model.unet.state_dict())
    probe.generator.load_state_dict(
        {k: lfae_state[f"generator.{k}"] for k in probe.generator.state_dict()})
    del dm_trainer, dm_loader
    ref = torch.from_numpy(ref_frame)[None].to(device)
    cond = torch.from_numpy(cond_vec)[None].to(device)
    disp = []
    for i in range(args.probe_videos):
        gen = torch.Generator(device=device).manual_seed(1000 + i)
        grid = probe.sample_video(ref, cond, 1.0, generator=gen)["vid_grid"]
        disp.append(flow_displacement_p99(grid))
        print(f"probe {i}: disp_p99(px)={ {r: round(v, 2) for r, v in disp[-1].items()} }")
    probe_s = time.perf_counter() - t0

    report = {
        "probe_videos": args.probe_videos,
        "disp_p99_px": disp,
        "lfae_steps": args.lfae_steps,
        "dm_steps": args.dm_steps,
        "no_augment": bool(args.no_augment),
        "motion_scale": args.motion_scale,
        "objective": args.objective,
        "provenance": "product trainers on synthetic MUG-layout corpus, "
                      f"seed {args.seed}; see cvpr23_lfdm_torch/scripts/make_bench_ckpt.py",
    }
    t0 = time.perf_counter()
    save()
    with open(os.path.join(out_dir, "fit_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    save_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(out_dir, n)) for n in os.listdir(out_dir))
    print(f"saved {out_dir} ({nbytes} bytes, {save_s:.2f} s)")
    return {"out": out_dir, "report": report, "lfae_s": lfae_s, "dm_s": dm_s, "probe_s": probe_s,
            "save_s": save_s, "bytes": nbytes}


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    args.synthetic = True  # this script is synthetic-corpus by definition
    setup(args)
    return run(build_config(args), args)


if __name__ == "__main__":
    main()
