"""Stage-1 LFAE training entry point (counterpart of `scripts/train_lfae.py`).

`LFAETrainer.fit` on `DatasetRepeater(LFAEPairDataset(..., augment=
ClipAugment()), num_repeats)`, behind `PrefetchLoader` or, with `--loader
grain`, `GrainLoader`. The perceptual loss's VGG19 takes `--vgg-weights` (a
torchvision `vgg19` or `vgg19.features` state dict, `features.` prefixes
dropped, through `train/vgg.py::convert_torchvision_vgg19`), else seeded
weights with the JAX CLI's warning. `--warm-start <.pth>` starts from a
reference `RegionMM.pth` (`load_lfae_from_torch`). The AVD network is
built and its size printed, as the reference entry does, and not trained.

Every `--save-img-freq` steps the `Visualizer` board of `reconstruct` (eval
mode: on the card four row-3 warps per call) goes to `<log-dir>/lfae_imgs`.
Checkpoints go to `<log-dir>/lfae_ckpt` (`CheckpointManager`: the trainer's
state, the seed and with `--loader grain` the loader's position);
`--resume` continues from the latest at its step. `train_dm --lfae-ckpt
<log-dir>/lfae_ckpt` reads the result. One process holds the whole batch.

Usage: python -m cvpr23_lfdm_torch.scripts.train_lfae [--device cpu] [--synthetic]
       [--num-steps N] [--batch-size B] [--warm-start RegionMM.pth] [--resume]
"""

from __future__ import annotations

import os
import time

import torch

from cvpr23_lfdm_torch.scripts._common import (
    apply_lfae_dtype, base_parser, loader_extra, resolve_data_root, setup, train_loader,
)


def parser():
    p = base_parser("Train the LFAE (stage 1)")
    p.add_argument("--batch-size", type=int, default=0, help="0 = preset")
    p.add_argument("--num-steps", type=int, default=0, help="0 = preset epochs")
    p.add_argument("--warm-start", default="", help="reference RegionMM.pth to start from")
    p.add_argument("--vgg-weights", default="", help="torchvision vgg19 .pth")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--save-img-freq", type=int, default=0)
    return p


def build_config(args):
    from cvpr23_lfdm_torch.config import PRESETS

    return apply_lfae_dtype(PRESETS[args.dataset](), args)


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.float().cpu().numpy() if torch.is_tensor(tree) else tree


def run(cfg, args) -> dict:
    """Train; returns `{"trainer", "state", "start_step", "steps", "fit_s",
    "hook_s", "avd_params"}`."""
    from cvpr23_lfdm_torch.data import ClipAugment, DatasetRepeater, LFAEPairDataset, get_spec
    from cvpr23_lfdm_torch.models.avd_network import AVDNetwork
    from cvpr23_lfdm_torch.train.lfae_trainer import LFAETrainer
    from cvpr23_lfdm_torch.train.vgg import convert_torchvision_vgg19
    from cvpr23_lfdm_torch.utils.checkpoint import CheckpointManager, load_lfae_from_torch
    from cvpr23_lfdm_torch.utils.viz import Visualizer, save_image

    tc = cfg.lfae_train
    batch_size = args.batch_size or tc.batch_size
    root = resolve_data_root(args, cfg.lfae.frame_shape)
    dataset = DatasetRepeater(
        LFAEPairDataset(get_spec(args.dataset), root, "train", frame_shape=cfg.lfae.frame_shape,
                        augment=ClipAugment(), seed=args.seed),
        tc.num_repeats,
    )
    steps_per_epoch = max(1, len(dataset) // batch_size)
    num_steps = args.num_steps or steps_per_epoch * tc.max_epochs

    trainer = LFAETrainer(cfg, steps_per_epoch, device=args.device)
    if args.vgg_weights:
        sd = torch.load(args.vgg_weights, map_location="cpu", weights_only=True)
        trainer.vgg.load_state_dict(convert_torchvision_vgg19(
            {k.removeprefix("features."): v for k, v in sd.items()}))
    else:
        print("warning: no --vgg-weights; using random-projection perceptual features")

    # the reference entry builds the AVD network beside the stage-1 nets and
    # never trains it (run_mug.py:133-138)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        avd = AVDNetwork(num_regions=cfg.lfae.num_regions)
    avd_params = sum(v.numel() for v in avd.state_dict().values())
    print("avd params:", avd_params)

    if args.warm_start:
        trainer.model.load_state_dict(load_lfae_from_torch(args.warm_start, cfg.lfae))
        state = trainer.init_state(None)
    else:
        state = trainer.init_state(args.seed)
    ckpt = CheckpointManager(os.path.join(args.log_dir, "lfae_ckpt"))
    start_step = 0
    if args.resume and ckpt.has_latest():
        state = trainer.load_state_dict(ckpt.restore("latest", map_location=trainer.device))
        start_step = state.step
        print(f"resumed at step {start_step}")
    loader = train_loader(args, dataset, batch_size, start_step, ckpt, threads=6)

    viz_dir = os.path.join(args.log_dir, "lfae_imgs")
    viz = Visualizer()
    hook_s = [0.0]

    def viz_fn(cur_state, batch, step):
        t0 = time.perf_counter()
        out = _host(trainer.reconstruct(cur_state, batch["source"][:1], batch["driving"][:1]))
        os.makedirs(viz_dir, exist_ok=True)
        save_image(os.path.join(viz_dir, f"step_{step:07d}.png"),
                   viz.visualize(batch["source"], batch["driving"], out))
        hook_s[0] += time.perf_counter() - t0

    def checkpoint_fn(s):
        ckpt.save(trainer.state_dict(s), step=s.step, extra=loader_extra(args, loader))

    t0 = time.perf_counter()
    try:
        state = trainer.fit(
            state, iter(loader), num_steps, args.seed, checkpoint_fn=checkpoint_fn,
            checkpoint_every=tc.update_ckpt_freq, viz_fn=viz_fn,
            viz_every=args.save_img_freq or tc.save_img_freq, start_step=start_step,
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
            "steps": state.step - start_step, "fit_s": fit_s, "hook_s": hook_s[0],
            "avd_params": avd_params}


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    setup(args)
    return run(build_config(args), args)


if __name__ == "__main__":
    main()
