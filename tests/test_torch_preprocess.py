"""The port's raw-corpus preprocessing (`data/preprocess.py`,
`scripts/preprocess.py`) against the JAX package's, on the fixtures of
`tests/test_preprocess_video.py` (MJPG AVIs written by cv2, a NATOPS
segmentation text, an MHAD depth `.mat`):

* `mhad_crop_images` and `natops_split_videos` write the same trees, file
  for file, with equal PNG pixels (the port's stdlib writer, imageio's on
  the JAX side; both read back with imageio);
* `natops_parse_segmentation` and `mug_split` give equal results;
* with `cv2` and `imageio` blocked, as on the card, both video paths raise
  an `ImportError` that names the AVI decoder, also through the CLI, and
  `mug_split` still works.
"""

import os
import sys

import imageio.v2 as imageio
import numpy as np
import pytest
import scipy.io

from cvpr23_lfdm_torch.data import preprocess as tpre
from cvpr23_lfdm_torch.scripts import preprocess as tcli
from cvpr23_lfdm_tpu.data import preprocess as jpre
from test_preprocess_video import _write_avi


def natops_root(tmp_path):
    root = tmp_path / "data"
    (root / "gesture01").mkdir(parents=True)
    (root / "gesture02").mkdir(parents=True)
    _write_avi(root / "gesture01" / "g01s01.avi", num_frames=10)
    _write_avi(root / "gesture02" / "g02s03.avi", num_frames=7, size=(40, 16))
    lines = []
    for s in range(1, 21):
        lines.append(f"// Subject {s}")
        for a in range(1, 25):
            lines.append(f"{s},{a},2")
            if (s, a) == (1, 1):
                lines += ["1:2,4", "2:6,9"]
            if (s, a) == (3, 2):
                lines += ["1:1,3", "2:5,7"]
    (root / "segmentation.txt").write_text("\n".join(lines))
    return root


def mhad_root(tmp_path):
    root = tmp_path / "mhad"
    (root / "RGB").mkdir(parents=True)
    (root / "Depth").mkdir()
    _write_avi(root / "RGB" / "a1_s1_t1_color.avi", num_frames=4, size=(640, 480))
    _write_avi(root / "RGB" / "a3_s2_t4_color.avi", num_frames=2, size=(640, 480))
    for stem in ("a1_s1_t1", "a3_s2_t4"):
        scipy.io.savemat(str(root / "Depth" / f"{stem}_depth.mat"), {"d_depth": np.zeros((240, 320, 4), np.uint16)})
    _write_avi(root / "RGB" / "a2_s1_t1_color.avi", num_frames=2, size=(640, 480))  # no depth: skipped
    return root


def assert_same_tree(ours, theirs):
    files = lambda d: sorted(os.path.relpath(os.path.join(p, f), d) for p, _, fs in os.walk(d) for f in fs)  # noqa: E731
    assert files(ours) == files(theirs) and files(ours)
    for rel in files(ours):
        np.testing.assert_array_equal(imageio.imread(os.path.join(ours, rel)),
                                      imageio.imread(os.path.join(theirs, rel)), err_msg=rel)


def test_natops_split_matches_jax(tmp_path):
    root = natops_root(tmp_path)
    seg = str(root / "segmentation.txt")
    assert tpre.natops_parse_segmentation(seg) == jpre.natops_parse_segmentation(seg)
    tpre.natops_split_videos(str(root), str(tmp_path / "ours"))
    jpre.natops_split_videos(str(root), str(tmp_path / "theirs"))
    assert sorted(os.listdir(tmp_path / "ours")) == ["g01s01p01", "g01s01p02", "g02s03p01", "g02s03p02"]
    assert_same_tree(str(tmp_path / "ours"), str(tmp_path / "theirs"))


def test_mhad_crop_matches_jax(tmp_path):
    root = mhad_root(tmp_path)
    tpre.mhad_crop_images(str(root), str(tmp_path / "ours"))
    jpre.mhad_crop_images(str(root), str(tmp_path / "theirs"))
    assert sorted(os.listdir(tmp_path / "ours")) == ["a1_s1_t1", "a3_s2_t4"]
    assert_same_tree(str(tmp_path / "ours"), str(tmp_path / "theirs"))
    assert tpre.MHAD_RGB_CROP == jpre.MHAD_RGB_CROP


def test_mug_split_matches_jax(tmp_path):
    for i in range(40):
        os.makedirs(tmp_path / f"{i:03d}")
    for seed in (0, 1234):
        assert tpre.mug_split(str(tmp_path), seed) == jpre.mug_split(str(tmp_path), seed)


def test_video_paths_name_the_missing_decoder(tmp_path, monkeypatch):
    nat, mhad = natops_root(tmp_path), mhad_root(tmp_path)
    for name in ("cv2", "imageio", "imageio.v2"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError, match="AVI.*cv2.VideoCapture"):
        tpre.natops_split_videos(str(nat), str(tmp_path / "n"))
    with pytest.raises(ImportError, match="AVI.*cv2.VideoCapture"):
        tpre.mhad_crop_images(str(mhad), str(tmp_path / "m"))
    for dataset, root in (("natops", nat), ("mhad", mhad)):
        with pytest.raises(ImportError, match="AVI"):
            tcli.main(["--dataset", dataset, "--data-root", str(root), "--out-dir", str(tmp_path / dataset)])
    for i in range(30):
        os.makedirs(tmp_path / "mug" / f"{i:03d}")
    res = tcli.main(["--dataset", "mug", "--data-root", str(tmp_path / "mug")])
    assert len(res["train"]) == 26 and len(res["test"]) == 4
