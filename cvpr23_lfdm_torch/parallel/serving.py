"""The demo's bundled inputs (the part of `cvpr23_lfdm_tpu/parallel/serving.py`
that single-device serving uses). Multi-device serving (`serving_mesh`,
`sample_video_sharded`, the CLIs' `--mesh`) is not ported yet."""

from __future__ import annotations

import os

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def demo_asset_path(dataset: str) -> str:
    """Bundled reference image for the argument-free demo (the reference
    ships demo/mug_examples/*.png; ours are synthetic, assets/demo/)."""
    return os.path.join(_REPO_ROOT, "assets", "demo", f"{dataset}_example.png")


def make_demo_assets(out_dir: str, size: int = 128, seed: int = 0) -> list[str]:
    """Write one synthetic example image per dataset (demo default inputs),
    as PNG through `data/io.py::write_png`."""
    from cvpr23_lfdm_torch.data.io import write_png
    from cvpr23_lfdm_torch.data.synthetic import _blob_video

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    colors = {"mug": (0.9, 0.6, 0.4), "mhad": (0.4, 0.7, 0.9), "natops": (0.5, 0.9, 0.5)}
    for ds, color in colors.items():
        frame = _blob_video(np.random.default_rng(seed), 1, size, color)[0]
        path = os.path.join(out_dir, f"{ds}_example.png")
        write_png(path, frame.astype(np.uint8))
        paths.append(path)
    return paths
