"""Stage-2 DM training entry point (counterpart of `scripts/train_dm.py`).

`DMTrainer.fit` on the dataset's training split, the UNet in its training
form (`--attn-impl auto`: `pallas2`, the head-packed attention with its
backward, rows 4 and 5 on the card), the frozen LFAE in eval mode (row 3
decodes). `--lfae-ckpt` takes a reference `.pth` or a port checkpoint
directory that `train_lfae` wrote (`<log-dir>/lfae_ckpt`, the LFAE
trainer's state); the JAX CLI's Orbax directory has no counterpart (the
card has no `orbax`). Without it the LFAE weights are seeded (smoke mode).

Three hooks, each drawing from a generator of `--seed` and the step
(`step_generator`): the 5x2 still grid (`--save-img-freq`,
`<log-dir>/dm_imgs`), the training-batch GIF (`--save-vid-freq`,
`dm_vidshots`, through `utils/viz.py::dm_training_gif`) and a sampled
video's GIF (`--sample-vid-freq`, `dm_samples`, `DMTrainer.sample_video`
at cond_scale 1, with the preset's sampler or, with `--sampling-steps N`,
DDIM-N). Checkpoints go to `<log-dir>/dm_ckpt`
(`CheckpointManager`: the trainer's state, the seed and with `--loader
grain` the loader's position); `--resume` continues from the latest at its
step, on the batch a straight run would take there.

Data parallel: N processes (`--coordinator host:port --num-processes N
--process-id i`, or `torchrun --nproc-per-node N`), one per device. Each
loads its `host_shard` of every global batch (`--batch-size`), the trainer
averages the gradients over the `data` mesh of all of them (`--mesh dp=N`
checks N), and only rank 0 writes checkpoints, images and GIFs.

Usage: python -m cvpr23_lfdm_torch.scripts.train_dm [--device cpu] [--synthetic]
       [--num-steps N] [--batch-size B] [--lfae-ckpt DIR|.pth] [--resume]
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from cvpr23_lfdm_torch.scripts._common import (
    apply_lfae_dtype, base_parser, lfae_state, load_text_embedder, loader_extra, process_group,
    rank_device, resolve_attn_impl, resolve_data_root, setup, train_loader, train_mesh,
)


def parser():
    p = base_parser("Train the flow diffusion model (stage 2)")
    p.add_argument("--lfae-ckpt", default="",
                   help="stage-1 weights: a reference .pth, or a port checkpoint directory "
                        "written by train_lfae (<log-dir>/lfae_ckpt)")
    p.add_argument("--batch-size", type=int, default=0)
    p.add_argument("--num-steps", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--save-img-freq", type=int, default=0, help="0 = preset")
    p.add_argument("--save-vid-freq", type=int, default=0, help="0 = preset")
    p.add_argument("--sample-vid-freq", type=int, default=0, help="0 = preset")
    p.add_argument("--sampling-steps", type=int, default=0,
                   help="DDIM steps of the sample hook's video (0 = the preset's sampler)")
    p.add_argument("--mean", type=float, nargs=3, default=(0.0, 0.0, 0.0),
                   help="per-channel pixel mean, 0-255 scale (reference MEAN constant; "
                        "every reference script uses (0,0,0))")
    p.add_argument("--objective", choices=("eps", "x0", "v"), default="eps",
                   help="denoiser parameterization (eps = reference parity); sampling must use "
                        "the objective the checkpoint trained with")
    return p


def build_config(args):
    from cvpr23_lfdm_torch.config import PRESETS

    cfg = PRESETS[args.dataset]()
    cfg = cfg.replace(diffusion=dataclasses.replace(
        cfg.diffusion, temporal_attn_impl=resolve_attn_impl(args, training=True),
        objective=args.objective,
        sampling_timesteps=args.sampling_steps or cfg.diffusion.sampling_timesteps))
    return apply_lfae_dtype(cfg, args)


def build_model(cfg, args, device):
    """The training `FlowDiffusion` with its frozen LFAE: `--lfae-ckpt`, or
    seeded weights (`seed_lfae_weights(0)`) with the JAX CLI's warning."""
    from cvpr23_lfdm_torch.diffusion.flow_diffusion import FlowDiffusion
    from cvpr23_lfdm_torch.models.flow_autoenc import seed_lfae_weights

    model = FlowDiffusion(cfg.lfae, cfg.diffusion, device=device, training=True)
    lfae = (model.region_predictor, model.bg_predictor, model.generator)
    state = lfae_state(args.lfae_ckpt, cfg.lfae)
    if state is None:
        print("warning: no --lfae-ckpt; stage-1 weights are RANDOM (smoke mode)")
        seed_lfae_weights(list(lfae), 0)
    else:
        for name, module in zip(("region_predictor", "bg_predictor", "generator"), lfae):
            module.load_state_dict({k: state[f"{name}.{k}"] for k in module.state_dict()})
    return model


def dm_batches(loader, embedder):
    """Loader batches -> `DMTrainer` batches (frame 0 as the reference, the
    class texts through the table)."""
    for batch in loader:
        cond, none_mask = embedder(batch["text"])
        yield {"ref_img": batch["video"][:, 0], "real_vid": batch["video"], "cond": cond,
               "none_cond_mask": none_mask}


def run(cfg, args) -> dict:
    """Train; returns `{"trainer", "state", "start_step", "steps",
    "fit_s", "hook_s", "hooks_s"}` (seconds of the whole `fit`, of its hooks,
    and of each hook and of the GIFs' panels inside them)."""
    from cvpr23_lfdm_torch.data import DMVideoDataset, get_spec
    from cvpr23_lfdm_torch.ops.grid import make_coordinate_grid
    from cvpr23_lfdm_torch.parallel.distributed import is_primary
    from cvpr23_lfdm_torch.train.dm_trainer import DMTrainer, step_generator
    from cvpr23_lfdm_torch.utils.checkpoint import CheckpointManager
    from cvpr23_lfdm_torch.utils.viz import (
        conf2fig, dm_training_gif, flow2fig, save_gif, save_image, tile_grid, to_uint8,
    )

    device = rank_device(args)
    tc = cfg.dm_train
    batch_size = args.batch_size or tc.batch_size
    root = resolve_data_root(args, cfg.lfae.frame_shape)
    embedder = load_text_embedder(args)
    dataset = DMVideoDataset(
        get_spec(args.dataset), root, "train", num_frames=cfg.diffusion.num_frames,
        image_size=cfg.lfae.frame_shape, sampling=tc.frame_sampling, mean=tuple(args.mean),
        seed=args.seed,
    )
    steps_per_epoch = max(1, len(dataset) // batch_size)
    num_steps = args.num_steps or steps_per_epoch * tc.max_epochs

    trainer = DMTrainer(cfg, steps_per_epoch, model=build_model(cfg, args, device),
                        mesh=train_mesh(args, device))
    state = trainer.init_state(args.seed)
    ckpt = CheckpointManager(os.path.join(args.log_dir, "dm_ckpt"))
    start_step = 0
    if args.resume and ckpt.has_latest():
        state = trainer.load_state_dict(ckpt.restore("latest", map_location=trainer.device))
        start_step = state.step
        print(f"resumed at step {start_step}")
    loader = train_loader(args, dataset, batch_size, start_step, ckpt, threads=16)

    size = cfg.lfae.frame_shape
    mid = cfg.diffusion.num_frames // 2
    id_grid = make_coordinate_grid((cfg.diffusion.img_size,) * 2).numpy()
    dirs = {k: os.path.join(args.log_dir, k) for k in ("dm_imgs", "dm_vidshots", "dm_samples")}
    hook_s = {"viz_fn": 0.0, "gif_fn": 0.0, "sample_fn": 0.0, "gif_panels": 0.0}

    def host(d: dict) -> dict:
        return {k: v.float().cpu().numpy() for k, v in d.items() if torch.is_tensor(v) and v.ndim}

    def monitored(cur_state, batch, step):
        small = {k: v[:1].cpu().numpy() if torch.is_tensor(v) else v[:1]
                 for k, v in batch.items() if hasattr(v, "ndim")}
        aux = host(trainer.monitor(cur_state, step_generator(args.seed, step, trainer.device), small))
        return small, aux

    def timed(fn, key=None):
        def hook(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            hook_s[key or fn.__name__] += time.perf_counter() - t0
            return out
        return hook

    gif_panels = timed(dm_training_gif, "gif_panels")

    @timed
    def viz_fn(cur_state, batch, step):
        """5x2 still grid (reference DM train :252-280): src/tar,
        real-out/real-warp, fake-out/fake-warp, flow/conf."""
        small, aux = monitored(cur_state, batch, step)
        rows = [
            [to_uint8(small["ref_img"][0]), to_uint8(small["real_vid"][0, mid])],
            [to_uint8(aux["out_vid"][0, mid]), to_uint8(aux["warped_vid"][0, mid])],
            [to_uint8(aux["fake_out_vid"][0, mid]), to_uint8(aux["fake_warped_vid"][0, mid])],
            [flow2fig(aux["vid_grid"][0, mid], id_grid, size),
             np.repeat(conf2fig(aux["vid_conf"][0, mid], size)[..., None], 3, -1)],
        ]
        os.makedirs(dirs["dm_imgs"], exist_ok=True)
        save_image(os.path.join(dirs["dm_imgs"], f"step_{step:07d}.png"), tile_grid(rows))

    @timed
    def gif_fn(cur_state, batch, step):
        """Training-batch GIF (reference :282-318)."""
        small, aux = monitored(cur_state, batch, step)
        frames = gif_panels(
            small["ref_img"][0], small["real_vid"][0], aux["out_vid"][0], aux["warped_vid"][0],
            aux["fake_out_vid"][0], aux["fake_warped_vid"][0], aux["vid_grid"][0],
            aux["fake_vid_grid"][0], aux["vid_conf"][0], aux["fake_vid_conf"][0], img_size=size)
        os.makedirs(dirs["dm_vidshots"], exist_ok=True)
        save_gif(os.path.join(dirs["dm_vidshots"], f"B{batch_size:04d}_S{step:06d}.gif"), frames)

    @timed
    def sample_fn(cur_state, batch, step):
        """Mid-training sampled video's GIF (reference :320-360)."""
        small, aux = monitored(cur_state, batch, step)
        out = host(trainer.sample_video(cur_state, step_generator(args.seed + 1, step, trainer.device),
                                        small["ref_img"], small["cond"], cond_scale=1.0))
        frames = gif_panels(
            small["ref_img"][0], small["real_vid"][0], aux["out_vid"][0], aux["warped_vid"][0],
            out["out_vid"][0], out["warped_vid"][0], aux["vid_grid"][0], out["vid_grid"][0],
            aux["vid_conf"][0], out["vid_conf"][0], img_size=size)
        os.makedirs(dirs["dm_samples"], exist_ok=True)
        save_gif(os.path.join(dirs["dm_samples"], f"B{batch_size:04d}_S{step:06d}.gif"), frames)

    def checkpoint_fn(s):  # every rank: the primary writes, the others wait for it
        ckpt.save(trainer.state_dict(s), step=s.step, extra=loader_extra(args, loader, s.step))

    primary = is_primary()  # images and GIFs: rank 0 only
    t0 = time.perf_counter()
    try:
        state = trainer.fit(
            state, dm_batches(loader, embedder), num_steps, args.seed,
            checkpoint_fn=checkpoint_fn, checkpoint_every=tc.update_ckpt_freq,
            viz_fn=viz_fn if primary else None, viz_every=args.save_img_freq or tc.save_img_freq,
            gif_fn=gif_fn if primary else None, gif_every=args.save_vid_freq or tc.save_vid_freq,
            sample_fn=sample_fn if primary else None,
            sample_every=args.sample_vid_freq or tc.sample_vid_freq,
            start_step=start_step,
        )
        if trainer.device.type == "cuda":
            torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        checkpoint_fn(state)
    finally:
        if hasattr(loader, "close"):
            loader.close()
    print("done")
    return {"trainer": trainer, "state": state, "start_step": start_step,
            "steps": state.step - start_step, "fit_s": fit_s,
            "hook_s": sum(v for k, v in hook_s.items() if k != "gif_panels"), "hooks_s": hook_s}


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    setup(args, multi_device=True)
    with process_group(args):
        return run(build_config(args), args)


if __name__ == "__main__":
    main()
