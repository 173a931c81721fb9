"""The port's warp lattice (`grid2fig`) and LFAE board (`Visualizer`) without
matplotlib or cv2, against the JAX package's, which draw with them.

* `grid2fig` against matplotlib's render (the JAX `grid2fig`) on the
  identity lattice and on lattices jittered by 0.02, 0.05 and 0.2, at 128²
  and 64². Tolerance (:func:`assert_lattice_close`): the mean absolute
  difference per channel is under half of what rolling matplotlib's own
  render by one pixel changes it by (the smaller of the two axes), and every
  pixel matplotlib leaves white is white.
* `gist_rainbow` against `matplotlib.colormaps["gist_rainbow"]` at 1,000
  points of [0, 1] (and its ends), within 1e-7.
* `Visualizer.visualize` bit-equal to the JAX one (uint8), with every key
  of `out` and with each optional key missing.
* `dm_training_gif`: the lattice panels within the `grid2fig` bound, every
  other panel bit-equal.
* The same calls in a fresh interpreter with `cv2`, `imageio`, `PIL`,
  `matplotlib`, `jax` and `flax` blocked in `sys.modules`.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cvpr23_lfdm_torch.utils import viz as tviz
from cvpr23_lfdm_tpu.utils import viz as jviz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_lattice_close(got: np.ndarray, want: np.ndarray) -> float:
    """`got` is a lattice render within half of the one-pixel roll of
    matplotlib's `want` (mean absolute difference per channel), and white
    wherever `want` is. Returns the mean absolute difference."""
    assert got.shape == want.shape and got.dtype == np.uint8
    got, want = got.astype(np.int64), want.astype(np.int64)
    roll = min(np.abs(np.roll(want, 1, axis) - want).mean() for axis in (0, 1))
    mad = np.abs(got - want).mean()
    assert mad < roll / 2, (mad, roll)
    white = (want == 255).all(-1)
    assert (got[white] == 255).all(), int((got[white] != 255).any(-1).sum())
    return mad


def identity_lattice(n: int = 32) -> np.ndarray:
    lin = np.linspace(-1, 1, n)
    gy, gx = np.meshgrid(lin, lin, indexing="ij")
    return np.stack((gx, gy), -1)


@pytest.mark.parametrize("img_size", [128, 64])
@pytest.mark.parametrize("jitter", [0.0, 0.02, 0.05, 0.2])
def test_grid2fig_draws_the_lattice_as_matplotlib(img_size, jitter):
    rng = np.random.default_rng(int(jitter * 100) + img_size)
    grid = identity_lattice() + jitter * rng.standard_normal((32, 32, 2))
    got = tviz.grid2fig(grid.astype(np.float32), img_size=img_size)
    mad = assert_lattice_close(got, jviz.grid2fig(grid.astype(np.float32), img_size=img_size))
    if jitter == 0.0:  # straight lines snap to whole pixels: the same pixels
        assert mad == 0.0


def test_grid2fig_with_repeated_and_collapsed_points():
    """Agg drops a point that repeats the one before it and draws nothing for
    a path left with one point; the port's outlines do the same."""
    grid = identity_lattice()
    grid[3, 4:9] = grid[3, 4]
    grid[10] = 0.3
    assert_lattice_close(tviz.grid2fig(grid), jviz.grid2fig(grid))
    flat = np.zeros((32, 32, 2))
    assert_lattice_close(tviz.grid2fig(flat), jviz.grid2fig(flat))


def test_gist_rainbow_matches_matplotlib():
    import matplotlib

    cmap = matplotlib.colormaps["gist_rainbow"]
    x = np.concatenate([[0.0, 1.0, 0.5, 1 / 256, 255 / 256], np.random.default_rng(3).random(1000)])
    np.testing.assert_allclose(tviz.gist_rainbow(x), cmap(x), rtol=0, atol=1e-7)
    for v in (0.0, 0.1, 0.3, 1.0):
        np.testing.assert_allclose(tviz.gist_rainbow(v), cmap(v), rtol=0, atol=1e-7)


def board_inputs(seed: int = 13):
    rng = np.random.default_rng(seed)
    out = {"driving_region_params": {"shift": rng.uniform(-1, 1, (1, 10, 2))},
           "source_region_params": {"shift": rng.uniform(-1, 1, (1, 10, 2))},
           "deformed": rng.random((1, 64, 64, 3)), "prediction": rng.random((1, 64, 64, 3)),
           "occlusion_map": rng.random((1, 32, 32, 1)).astype(np.float32)}
    return rng.random((2, 64, 64, 3)), rng.random((2, 64, 64, 3)), out


@pytest.mark.parametrize("missing", [None, "driving_region_params", "source_region_params",
                                     "deformed", "occlusion_map"])
def test_visualizer_matches_jax(missing):
    src, dri, out = board_inputs()
    if missing:
        del out[missing]
    got = tviz.Visualizer().visualize(src, dri, out)
    want = jviz.Visualizer().visualize(src, dri, out)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def training_gif_inputs(f: int = 3, size: int = 64, seed: int = 14):
    rng = np.random.default_rng(seed)
    vids = [rng.random((f, size, size, 3)).astype(np.float32) for _ in range(6)]
    grids = [np.stack([identity_lattice() + 0.05 * rng.standard_normal((32, 32, 2))
                       for _ in range(f)]).astype(np.float32) for _ in range(2)]
    confs = [rng.random((f, 32, 32, 1)).astype(np.float32) for _ in range(2)]
    return (vids[0][0], *vids[1:], *grids, *confs)


def test_dm_training_gif_matches_jax():
    size = 64
    got = tviz.dm_training_gif(*training_gif_inputs(size=size), img_size=size)
    want = jviz.dm_training_gif(*training_gif_inputs(size=size), img_size=size)
    assert got.shape == want.shape == (3, 2 * size, 5 * size, 3)
    lattice = np.zeros(want.shape[2], bool)
    lattice[3 * size: 4 * size] = True  # column 4: the real and generated lattices
    np.testing.assert_array_equal(got[:, :, ~lattice], want[:, :, ~lattice])
    for frame in range(got.shape[0]):
        for row in (0, 1):
            rows = slice(row * size, (row + 1) * size)
            assert_lattice_close(got[frame, rows, lattice], want[frame, rows, lattice])


CARD_INSTALL = """
import sys
for m in {blocked!r}:
    sys.modules[m] = None
import numpy as np
from cvpr23_lfdm_torch.utils import viz
rng = np.random.default_rng(0)
lin = np.linspace(-1, 1, 32)
grid = np.stack(np.meshgrid(lin, lin, indexing="xy"), -1) + 0.05 * rng.standard_normal((32, 32, 2))
img = viz.grid2fig(grid, img_size=64)
assert img.shape == (64, 64, 3) and (img != 255).any()
vid = rng.random((2, 64, 64, 3))
grids, confs = np.stack([grid, grid]), rng.random((2, 32, 32, 1))
frames = viz.dm_training_gif(vid[0], vid, vid, vid, vid, vid, grids, grids, confs, confs, img_size=64)
viz.save_gif({tmp!r} + "/a.gif", frames)
out = {{"driving_region_params": {{"shift": rng.uniform(-1, 1, (1, 10, 2))}},
       "source_region_params": {{"shift": rng.uniform(-1, 1, (1, 10, 2))}},
       "deformed": vid[:1], "prediction": vid[:1], "occlusion_map": rng.random((1, 32, 32, 1))}}
viz.save_image({tmp!r} + "/b.png", viz.Visualizer().visualize(vid, vid, out))
print("OK", sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r} and sys.modules[m] is not None))
"""


def test_viz_runs_without_matplotlib_or_cv2(tmp_path):
    blocked = ("cv2", "imageio", "PIL", "matplotlib", "jax", "flax")
    code = CARD_INSTALL.format(blocked=blocked, tmp=str(tmp_path))
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "OK []"
    assert os.path.getsize(tmp_path / "a.gif") > 0 and os.path.getsize(tmp_path / "b.png") > 0
