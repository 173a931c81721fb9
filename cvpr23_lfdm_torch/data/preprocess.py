"""Raw-corpus preprocessing: MUG split, MHAD depth-bbox crop, NATOPS clips
(counterpart of `cvpr23_lfdm_tpu/data/preprocess.py`).

Ports of preprocessing/preprocess_{MUG,MHAD,NATOPS}.py. These run once on
the raw downloads to produce the frame-folder trees the datasets consume;
they need the licensed corpora (not in the repository) and are exposed
through `scripts/preprocess.py`. The frames are written as PNG by the
port's own writer (`data/io.py::write_png`). The AVI videos of MHAD and
NATOPS are decoded by `cv2.VideoCapture`; where `cv2` is not installed (as
on the card's machine) reading one raises an `ImportError` that names the
decoder, and a video it decodes no frame of raises a `ValueError`.
"""

from __future__ import annotations

import os
import random
import re

from cvpr23_lfdm_torch.data.io import write_png


# --------------------------------------------------------------------- MUG


def mug_split(root: str, seed: int = 1234) -> tuple[list[str], list[str]]:
    """Subject shuffle split (preprocess_MUG.py:7-18): 26 train / rest test.
    With the published corpus and seed this reproduces the hard-coded split
    lists in specs.py."""
    subs = sorted(os.listdir(root))
    random.seed(seed)
    random.shuffle(subs)
    train = sorted(subs[:26])
    test = sorted(subs[26:])
    return train, test


# -------------------------------------------------------------------- MHAD

# overall person bbox from summed depth maps (preprocess_MHAD.py:24-28),
# scaled x2 from depth (320x240) to RGB (640x480) resolution (:117-130)
MHAD_RGB_CROP = dict(y_min=0, y_max=480, x_min=156, x_max=492)


def _read_avi(path: str) -> list:
    try:
        import cv2
    except ImportError:
        raise ImportError(f"reading the AVI video {path} needs OpenCV (cv2.VideoCapture), "
                          f"which is not installed; the port has no AVI decoder of its own") from None
    cap = cv2.VideoCapture(path)
    frames = []
    while cap.isOpened():
        ret, frame = cap.read()
        if not ret:
            break
        frames.append(frame[:, :, ::-1])  # BGR -> RGB
    cap.release()
    if not frames:
        raise ValueError(f"{path}: OpenCV decoded no frame")
    return frames


def mhad_crop_images(root: str, out_dir: str | None = None) -> None:
    """preprocess_MHAD.py:110-148: crop each aX_sY_tZ_color.avi by the
    depth-derived person bbox, write per-frame PNGs under
    `<out>/aX_sY_tZ/aX_sY_tZ_###.png`."""
    rgb_dir = os.path.join(root, "RGB")
    depth_dir = os.path.join(root, "Depth")
    out_dir = out_dir or os.path.join(root, "crop_image")
    os.makedirs(out_dir, exist_ok=True)
    c = MHAD_RGB_CROP
    for action in range(1, 28):
        for subject in range(1, 9):
            for trial in range(1, 5):
                stem = f"a{action}_s{subject}_t{trial}"
                # reference gates on the depth file existing (:136-138)
                if not os.path.isfile(
                    os.path.join(depth_dir, f"{stem}_depth.mat")
                ):
                    continue
                avi = os.path.join(rgb_dir, f"{stem}_color.avi")
                if not os.path.isfile(avi):
                    continue
                frames = _read_avi(avi)
                vdir = os.path.join(out_dir, stem)
                os.makedirs(vdir, exist_ok=True)
                for i, frame in enumerate(frames):
                    crop = frame[c["y_min"] : c["y_max"], c["x_min"] : c["x_max"]]
                    write_png(os.path.join(vdir, f"{stem}_{i:03d}.png"), crop)


# ------------------------------------------------------------------ NATOPS


def natops_parse_segmentation(seg_txt_path: str) -> dict:
    """preprocess_NATOPS.py:14-54: parse segmentation.txt into
    {subject: {action: [(start, end), ...x20]}} (1-based frame numbers)."""
    with open(seg_txt_path) as f:
        lines = f.read().splitlines()
    starts = [i for i, line in enumerate(lines) if line.startswith("// Subject")]
    pat_action = re.compile(r"\d*,\d*,\d*")
    pat_clip = re.compile(r"\d*:\d*,\d*")
    split = {}
    for subject in range(1, 21):
        block = (
            lines[starts[subject - 1] : starts[subject]]
            if subject < 20
            else lines[starts[subject - 1] :]
        )
        action_starts = [i for i, line in enumerate(block) if pat_action.match(line)]
        split[subject] = {}
        for action in range(1, 25):
            seg = (
                block[action_starts[action - 1] : action_starts[action]]
                if action < 24
                else block[action_starts[action - 1] :]
            )
            clips = []
            for line in seg[1:]:
                if pat_clip.match(line):
                    parts = re.split(r"[:|,|]", line)
                    clips.append((int(parts[1]), int(parts[2])))
            split[subject][action] = clips
    return split


def natops_split_videos(root: str, out_dir: str | None = None) -> None:
    """preprocess_NATOPS.py:57-98: cut each gesture avi into its 20 repetition
    clips of per-frame PNGs named gXXsYYpZZ."""
    seg = natops_parse_segmentation(os.path.join(root, "segmentation.txt"))
    out_dir = out_dir or os.path.join(os.path.dirname(root), "split_img_data")
    os.makedirs(out_dir, exist_ok=True)
    for action in range(1, 25):
        for subject in range(1, 21):
            avi = os.path.join(
                root, f"gesture{action:02d}", f"g{action:02d}s{subject:02d}.avi"
            )
            if not os.path.isfile(avi):
                continue
            frames = _read_avi(avi)
            clips = seg[subject][action]
            for p, (start, end) in enumerate(clips, start=1):
                name = f"g{action:02d}s{subject:02d}p{p:02d}"
                vdir = os.path.join(out_dir, name)
                os.makedirs(vdir, exist_ok=True)
                for cnt, fi in enumerate(range(start - 1, end)):
                    write_png(os.path.join(vdir, f"{name}-{cnt:04d}-{fi:04d}.png"), frames[fi])
