"""LFAE self-reconstruction evaluation entry point (counterpart of
`scripts/eval_flowautoenc.py`).

Reconstructs held-out videos from frame 0 through `eval/flowautoenc.py::
evaluate` and reports per-pixel L1 (`out_loss`, `warp_loss`) to stdout and
JSON (the reference's normalization, test_flowautoenc_mug.py:208-215).
`--save-video` writes one GIF per video (frame | prediction | deformed |
warp lattice | occlusion), its lattice drawn as matplotlib draws it by
`utils/viz.py::grid2fig`, which needs no matplotlib.

Usage: python -m cvpr23_lfdm_torch.scripts.eval_flowautoenc [--device cpu]
       [--synthetic] [--lfae-ckpt RegionMM.pth | checkpoint dir]
"""

from __future__ import annotations

import os

import torch

from cvpr23_lfdm_torch.scripts._common import (
    apply_lfae_dtype, base_parser, lfae_state, resolve_data_root, setup,
)


def parser():
    p = base_parser("Evaluate LFAE self-reconstruction")
    p.add_argument("--lfae-ckpt", default="", help="port checkpoint dir or reference .pth")
    p.add_argument("--batch-size", type=int, default=10)
    p.add_argument("--num-frames", type=int, default=40)
    p.add_argument("--num-batches", type=int, default=0, help="0 = full split")
    p.add_argument("--save-video", action="store_true")
    p.add_argument("--json-path", default="")
    return p


def build_config(args):
    from cvpr23_lfdm_torch.config import PRESETS

    return apply_lfae_dtype(PRESETS[args.dataset](), args)


def run(cfg, args) -> dict:
    """Returns `{"out_loss", "warp_loss"}` and writes them as JSON."""
    from cvpr23_lfdm_torch.data import DMVideoDataset, get_spec
    from cvpr23_lfdm_torch.eval import flowautoenc
    from cvpr23_lfdm_torch.models.flow_autoenc import FlowAE, seed_lfae_weights

    root = resolve_data_root(args, cfg.lfae.frame_shape)
    state = lfae_state(args.lfae_ckpt, cfg.lfae)
    if state is None:
        print("warning: no --lfae-ckpt; evaluating RANDOM weights (smoke mode)")
        torch.manual_seed(args.seed)
        lfae = FlowAE(cfg.lfae)
        seed_lfae_weights([lfae], 0)
        state = lfae.state_dict()
    dataset = DMVideoDataset(
        get_spec(args.dataset), root, "test",
        num_frames=args.num_frames, image_size=cfg.lfae.frame_shape,
        color_jitter=False, sampling="uniform", seed=args.seed,
    )
    result = flowautoenc.evaluate(
        state, cfg.lfae, dataset, batch_size=args.batch_size,
        num_batches=args.num_batches or None,
        save_video_dir=os.path.join(args.log_dir, "eval_videos") if args.save_video else None,
        image_size=cfg.lfae.frame_shape, device=args.device,
    )
    print("loss for prediction: %.5f" % result["out_loss"])
    print("loss for warping: %.5f" % result["warp_loss"])
    json_path = args.json_path or os.path.join(args.log_dir, "flowautoenc_eval.json")
    os.makedirs(os.path.dirname(json_path) or ".", exist_ok=True)
    flowautoenc.write_json(result, json_path)
    print(f"wrote {json_path}")
    return result


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    setup(args)
    return run(build_config(args), args)


if __name__ == "__main__":
    main()
