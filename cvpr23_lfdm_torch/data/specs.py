"""Dataset specs: directory layouts, subject splits, class vocabularies
(a copy of `cvpr23_lfdm_tpu/data/specs.py`; the class tables come from the
port's `models/text.py`).

One declarative spec per corpus replaces the reference's 15 near-duplicate
Dataset classes (DM/datasets_{mug,mhad,natops}.py, LFAE/*_dataset.py).
Splits and naming rules are transcribed exactly:

  MUG:    root/<subject>/<expression>/<take>/frames; subjects "002"/"003"/
          "049" nest an extra session0 dir (datasets_mug.py:22-49).
  MHAD:   flat root/aXX_sYY_tZZ dirs; class aXX (1-based), subject sYY;
          train subjects [1,5,2,3], test [6,8,4,7] (datasets_mhad.py:54-68,175).
  NATOPS: flat root/gXXsYYtZZ-style dirs; class chars [1:3], subject [4:6];
          train subjects [3,4,8,9,12,13,15,17,19,20] (datasets_natops.py:56-66);
          crop box y[10:239] x[30:290] (datasets_natops.py:26-28).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

from cvpr23_lfdm_torch.models.text import MHAD_CLASSES, MUG_CLASSES, NATOPS_CLASSES

MUG_TRAIN_SUBJECTS = (
    "008", "017", "021", "028", "030", "031", "034", "036", "037",
    "038", "039", "042", "043", "044", "045", "055", "060", "061",
    "062", "063", "071", "075", "076", "077", "083", "084",
)
MUG_TEST_SUBJECTS = (
    "001", "002", "006", "007", "010", "013", "014", "020", "027", "032",
    "033", "040", "046", "048", "049", "052", "064", "065", "066", "070",
    "072", "073", "074", "078", "079", "082",
)
MUG_SESSION_SUBJECTS = ("002", "003", "049")

MHAD_TRAIN_SUBJECTS = (1, 5, 2, 3)
MHAD_TEST_SUBJECTS = (6, 8, 4, 7)

NATOPS_TRAIN_SUBJECTS = (3, 4, 8, 9, 12, 13, 15, 17, 19, 20)
# subject 1 is excluded from BOTH splits (datasets_natops.py:177,
# preprocess_NATOPS.py:111-114 "remove 1")
NATOPS_TEST_SUBJECTS = (2, 5, 6, 7, 10, 11, 14, 16, 18)


@dataclasses.dataclass(frozen=True)
class VideoEntry:
    path: str        # directory of frames
    name: str        # unique video name (reference naming scheme)
    class_name: str  # text label fed to the text encoder
    subject: str     # subject id as string


def list_mug_videos(root: str, subjects) -> list[VideoEntry]:
    """datasets_mug.py:30-49 + name scheme :56-58.

    The reference enumerates session subjects twice — literally
    `for session_name in ["session0", "session0"]` (datasets_mug.py:41,
    LFAE/mug_dataset.py:64) — doubling those videos' sampling/eval
    weight. Reproduced for protocol parity. The train split contains no
    session subjects (002/003/049 are all outside train_ID), so this
    only affects the test split (subjects 002 and 049)."""
    out = []
    for sub in subjects:
        levels = (
            ["session0", "session0"] if sub in MUG_SESSION_SUBJECTS else [None]
        )
        for session in levels:
            for exp in MUG_CLASSES:
                d = (
                    os.path.join(root, sub, session, exp)
                    if session
                    else os.path.join(root, sub, exp)
                )
                if not os.path.isdir(d):
                    continue
                for take in sorted(os.listdir(d)):
                    path = os.path.join(d, take)
                    parts = (sub, session, exp, take) if session else (sub, exp, take)
                    out.append(
                        VideoEntry(path, "_".join(parts), exp, sub)
                    )
    return out


def list_mhad_videos(root: str, subjects) -> list[VideoEntry]:
    """datasets_mhad.py:54-68 (+ class decode :76-77)."""
    subjects = {int(s) for s in subjects}
    out = []
    for name in sorted(os.listdir(root)):
        path = os.path.join(root, name)
        if not os.path.isdir(path):
            continue
        action_idx = int(name.split("_")[0][1:])
        subject = int(name.split("_")[1][1:])
        if subject in subjects:
            out.append(
                VideoEntry(path, name, MHAD_CLASSES[action_idx - 1], str(subject))
            )
    return out


def list_natops_videos(root: str, subjects) -> list[VideoEntry]:
    """datasets_natops.py:56-66 (+ class decode :74-75)."""
    subjects = {int(s) for s in subjects}
    out = []
    for name in sorted(os.listdir(root)):
        path = os.path.join(root, name)
        if not os.path.isdir(path):
            continue
        action_idx = int(name[1:3])
        subject = int(name[4:6])
        if subject in subjects:
            out.append(
                VideoEntry(path, name, NATOPS_CLASSES[action_idx - 1], str(subject))
            )
    return out


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    classes: tuple[str, ...]
    list_videos: Callable[[str, tuple], list[VideoEntry]]
    train_subjects: tuple
    test_subjects: tuple
    crop: tuple[int, int, int, int] | None = None  # (y0, y1, x0, x1)


SPECS = {
    "mug": DatasetSpec(
        "mug", MUG_CLASSES, list_mug_videos, MUG_TRAIN_SUBJECTS, MUG_TEST_SUBJECTS
    ),
    "mhad": DatasetSpec(
        "mhad", MHAD_CLASSES, list_mhad_videos, MHAD_TRAIN_SUBJECTS, MHAD_TEST_SUBJECTS
    ),
    "natops": DatasetSpec(
        "natops", NATOPS_CLASSES, list_natops_videos,
        NATOPS_TRAIN_SUBJECTS, NATOPS_TEST_SUBJECTS,
        crop=(10, 239, 30, 290),
    ),
}


def get_spec(name: str) -> DatasetSpec:
    return SPECS[name]
