"""Raw-corpus preprocessing CLI (counterpart of `scripts/preprocess.py`):
`--dataset mug` prints the subject split of `--data-root`; `mhad` crops the
RGB AVIs of `--data-root` into frame folders, `natops` cuts its gesture
AVIs into repetition clips (`data/preprocess.py`). Decoding an AVI needs
`cv2`; without it (as on the card's machine) `mhad` and `natops` raise an
`ImportError` that names the decoder. No step runs on the card: `--device`
is accepted and unused.

Usage: python -m cvpr23_lfdm_torch.scripts.preprocess --dataset mug --data-root DIR
"""

from __future__ import annotations

from cvpr23_lfdm_torch.scripts._common import base_parser, check_unported


def parser():
    p = base_parser("Preprocess a raw corpus into frame folders")
    p.add_argument("--out-dir", default="")
    return p


def run(args) -> dict:
    """`{"train", "test"}` subject lists for MUG, `{"out_dir"}` otherwise."""
    from cvpr23_lfdm_torch.data import preprocess

    if args.dataset == "mug":
        train, test = preprocess.mug_split(args.data_root, args.seed)
        print("train:", train)
        print("test:", test)
        return {"train": train, "test": test}
    if args.dataset == "mhad":
        preprocess.mhad_crop_images(args.data_root, args.out_dir or None)
    else:
        preprocess.natops_split_videos(args.data_root, args.out_dir or None)
    return {"out_dir": args.out_dir}


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    check_unported(args)
    return run(args)


if __name__ == "__main__":
    main()
