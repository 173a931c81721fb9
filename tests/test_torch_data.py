"""The port's data modules and viz panels against the JAX package and the
image libraries, on the CPU.

* `data/io.py`: `read_image` on the bundled PNGs, on PNGs written with
  each of the five filter types (rows filtered here, by the PNG spec), and
  on PNGs of every colour type written by `cv2` / PIL: pixels equal to
  `cv2.imread`'s; the PNG writer read back by `cv2` and `imageio`;
  `resize` / `pad_resize` against `cv2.resize` (the JAX `pad_resize`) at
  downscales, upscales and odd aspect ratios: uint8 within 1 LSB, float
  within 1e-5 (OpenCV keeps float32 coefficients); a JPEG without `cv2`
  and `imageio` raises an ImportError naming the format.
* `augment.resize_clip` (1e-5), `ClipAugment`, `sampling` on the same
  `np.random.Generator` draws; `native` against the JAX `native` (1e-6).
* `flow2fig` (1 LSB) and `conf2fig` (equal) against the JAX panels, and
  the ones JAX draws with matplotlib: `Visualizer` equal, `dm_training_gif`
  equal but for its lattice panels, held to `grid2fig`'s bound
  (`tests/test_torch_viz.py`);
  `save_gif` read back by `imageio`, equal to `viz.quantize` of the frames,
  with the loop and frame duration of `fps`.
* `DMVideoDataset` (train and test split, `combos`, `mean`, jitter) and
  `LFAEPairDataset` items against the JAX ones on one synthetic corpus (MUG
  spec, 8 frames, 64²): equal within 1e-6, pairs resized to 32² within one
  uint8 LSB scaled by the jitter (1.1³ / 255); the port's `make_synthetic_corpus` writes the JAX corpus's
  pixels.
"""

import os
import struct
import sys
import zlib

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from test_torch_viz import assert_lattice_close
from cvpr23_lfdm_tpu.data import augment as jaug
from cvpr23_lfdm_tpu.data import datasets as jds
from cvpr23_lfdm_tpu.data import io as jio
from cvpr23_lfdm_tpu.data import native as jnative
from cvpr23_lfdm_tpu.data import sampling as jsamp
from cvpr23_lfdm_tpu.data.specs import get_spec as jget_spec
from cvpr23_lfdm_tpu.data.synthetic import make_synthetic_corpus as jmake
from cvpr23_lfdm_tpu.utils import viz as jviz
from cvpr23_lfdm_torch.data import augment as taug
from cvpr23_lfdm_torch.data import datasets as tds
from cvpr23_lfdm_torch.data import io as tio
from cvpr23_lfdm_torch.data import native as tnative
from cvpr23_lfdm_torch.data import sampling as tsamp
from cvpr23_lfdm_torch.data.specs import get_spec as tget_spec
from cvpr23_lfdm_torch.data.synthetic import make_synthetic_corpus as tmake
from cvpr23_lfdm_torch.utils import viz as tviz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LSB = 1.0
FLOAT_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: as fast at these sizes, and the test processes
    that share the CPU do not oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cv2_rgb(path):
    return cv2.imread(path, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)[:, :, ::-1]


@pytest.mark.parametrize("name", ["mug", "mhad", "natops"])
def test_read_bundled_png_equals_cv2(name):
    path = os.path.join(ROOT, "assets", "demo", f"{name}_example.png")
    got = tio._read_image_uncached(path)
    assert got.shape == (128, 128, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, cv2_rgb(path))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered_png(img: np.ndarray, ftype: int) -> bytes:
    """An 8-bit RGB PNG whose every row uses filter `ftype` (PNG spec 9.2)."""
    h, w, c = img.shape
    rows, prev = [], [0] * (w * c)
    for y in range(h):
        cur = img[y].reshape(-1).tolist()
        out = []
        for i, x in enumerate(cur):
            a = cur[i - c] if i >= c else 0
            b = prev[i]
            cc = prev[i - c] if i >= c else 0
            pred = [0, a, b, (a + b) >> 1, _paeth(a, b, cc)][ftype]
            out.append((x - pred) & 0xFF)
        rows.append(bytes([ftype] + out))
        prev = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_read_png_filter_types_equal_cv2(tmp_path, ftype):
    rng = np.random.default_rng(ftype)
    img = np.cumsum(rng.integers(0, 40, (19, 23, 3)), axis=1).astype(np.uint8)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_filtered_png(img, ftype))
    np.testing.assert_array_equal(cv2_rgb(path), img)
    np.testing.assert_array_equal(tio._read_image_uncached(path), img)


@pytest.mark.parametrize("kind", ["grey", "grey16", "rgb", "rgba", "rgb16", "palette", "grey_alpha"])
def test_read_png_colour_types_equal_cv2(tmp_path, kind):
    from PIL import Image

    rng = np.random.default_rng(7)
    img = np.cumsum(rng.integers(0, 30, (21, 34, 4)), axis=0).astype(np.uint8)
    path = str(tmp_path / f"{kind}.png")
    if kind == "grey":
        cv2.imwrite(path, img[..., 0])
    elif kind == "grey16":
        cv2.imwrite(path, img[..., 0].astype(np.uint16) * 257 + 3)
    elif kind == "rgb":
        cv2.imwrite(path, img[..., :3])
    elif kind == "rgba":
        cv2.imwrite(path, img)
    elif kind == "rgb16":
        cv2.imwrite(path, img[..., :3].astype(np.uint16) * 200)
    elif kind == "palette":
        Image.fromarray(img[..., :3]).convert("P", palette=Image.ADAPTIVE, colors=64).save(path)
    else:
        Image.fromarray(img[..., :2], mode="LA").save(path)
    np.testing.assert_array_equal(tio._read_image_uncached(path), cv2_rgb(path))


@pytest.mark.parametrize("shape", [(17, 29), (20, 31, 1), (37, 53, 3), (20, 31, 4), (9, 5, 2)])
def test_png_writer_read_back_by_cv2_and_imageio(tmp_path, shape):
    rng = np.random.default_rng(1)
    img = np.cumsum(rng.integers(0, 50, shape), axis=0).astype(np.uint8)
    path = str(tmp_path / "w.png")
    tio.write_png(path, img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img.ndim == 3 and shape[-1] == 2:  # cv2 reads grey + alpha as BGRA
        back = back[..., [0, 3]]
    elif back.ndim == 3:  # BGR(A) -> RGB(A)
        back = np.concatenate([back[..., 2::-1], back[..., 3:]], axis=-1)
    np.testing.assert_array_equal(back.reshape(img.shape), img)
    np.testing.assert_array_equal(np.asarray(imageio.imread(path)).reshape(img.shape), img)
    tviz.save_image(path, img.astype(np.float32) / 255.0 if img.ndim == 3 and shape[-1] == 3 else img)
    assert os.path.getsize(path) > 0


RESIZE_CASES = [(128, 128, 64, 64), (320, 240, 128, 96), (100, 77, 128, 98), (32, 32, 128, 128),
                (229, 260, 113, 128), (50, 70, 64, 90), (90, 60, 45, 128), (64, 64, 64, 64)]


@pytest.mark.parametrize("interp", ["area", "linear", "nearest"])
def test_resize_matches_cv2(interp):
    code = {"area": cv2.INTER_AREA, "linear": cv2.INTER_LINEAR, "nearest": cv2.INTER_NEAREST}[interp]
    rng = np.random.default_rng(2)
    for sh, sw, h, w in RESIZE_CASES:
        u8 = (rng.random((sh, sw, 3)) * 255).astype(np.uint8)
        f32 = rng.random((sh, sw, 3)).astype(np.float32)
        got, want = tio.resize(u8, (h, w), interp), cv2.resize(u8, (w, h), interpolation=code)
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.abs(got.astype(int) - want).max() <= LSB, (sh, sw, h, w)
        got, want = tio.resize(f32, (h, w), interp), cv2.resize(f32, (w, h), interpolation=code)
        np.testing.assert_allclose(got, want, atol=FLOAT_ATOL, err_msg=str((sh, sw, h, w)))
        got = tio.resize(f32[..., 0], (h, w), interp)  # a 2-D image keeps its rank
        np.testing.assert_allclose(got, cv2.resize(f32[..., 0], (w, h), interpolation=code),
                                   atol=FLOAT_ATOL)


@pytest.mark.parametrize("size", [128, 64, 200])
def test_pad_resize_matches_jax(size):
    rng = np.random.default_rng(3)
    for sh, sw in ((240, 320), (229, 260), (128, 128), (77, 100), (30, 50)):
        u8 = (rng.random((sh, sw, 3)) * 255).astype(np.uint8)
        for interp in ("area", "linear", "nearest"):
            got, want = tio.pad_resize(u8, size, interp), jio.pad_resize(u8, size, interp)
            assert got.shape == want.shape == (size, size, 3)
            assert np.abs(got.astype(int) - want).max() <= LSB
        f32 = rng.random((sh, sw, 3)).astype(np.float32)
        np.testing.assert_allclose(tio.pad_resize(f32, size), jio.pad_resize(f32, size), atol=FLOAT_ATOL)


def test_resize_clip_matches_jax():
    rng = np.random.default_rng(4)
    clip = rng.random((3, 50, 70, 3)).astype(np.float32)
    for size in ((40, 50), (64, 90), (50, 70), (33, 99)):
        np.testing.assert_allclose(taug.resize_clip(clip, size), jaug.resize_clip(clip, size),
                                   atol=FLOAT_ATOL)


def test_read_jpeg_without_a_decoder_names_the_format(tmp_path, monkeypatch):
    path = str(tmp_path / "f.jpg")
    cv2.imwrite(path, np.zeros((8, 8, 3), np.uint8))
    np.testing.assert_array_equal(tio._read_image_uncached(path), cv2_rgb(path))
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    with pytest.raises(ImportError, match="JPG"):
        tio._read_image_uncached(path)


def test_read_image_cache_and_list_frames(tmp_path):
    for i in (2, 0, 1):
        tio.write_png(str(tmp_path / f"{i:04d}.png"), np.full((4, 4, 3), i, np.uint8))
    (tmp_path / "notes.txt").write_text("x")
    frames = tio.list_frames(str(tmp_path))
    assert frames == jio.list_frames(str(tmp_path))
    a = tio.read_image(frames[1])
    assert tio.read_image(frames[1]) is a and not a.flags.writeable
    assert int(a[0, 0, 0]) == 1


def test_sampling_matches_jax():
    for strategy in ("uniform", "random", "very_random"):
        for total, num in ((50, 40), (16, 40), (40, 40), (7, 3)):
            got = tsamp.sample_indices(np.random.default_rng(5), total, num, strategy)
            want = jsamp.sample_indices(np.random.default_rng(5), total, num, strategy)
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tsamp.pair_indices(np.random.default_rng(6), 30),
                                  jsamp.pair_indices(np.random.default_rng(6), 30))


def test_clip_augment_matches_jax():
    rng = np.random.default_rng(8)
    clip = rng.random((4, 40, 48, 3)).astype(np.float32)
    for aug in (dict(), dict(rotation_degrees=15.0, resize_ratio=(0.8, 1.2), crop_size=36)):
        for seed in range(4):
            got = taug.ClipAugment(**aug)(np.random.default_rng(seed), clip)
            want = jaug.ClipAugment(**aug)(np.random.default_rng(seed), clip)
            np.testing.assert_allclose(got, want, atol=FLOAT_ATOL)
    got = taug.color_jitter_clip(np.random.default_rng(9), clip, 0.2, 0.2, 0.2, 0.05, shuffle_order=False)
    want = jaug.color_jitter_clip(np.random.default_rng(9), clip, 0.2, 0.2, 0.2, 0.05, shuffle_order=False)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.fixture
def jax_native_lib(monkeypatch, tmp_path):
    """The JAX package's native library, built by its own `_build` (its
    flags) into this test's directory and loaded by its own `get_lib`. Its
    shared build (`native/liblfdm_data.so`, written in place) can be caught
    half-written by another worker building it at the same time, after
    which that process's `get_lib` gives up and takes numpy; a private
    build cannot."""
    monkeypatch.setattr(jnative, "_LIB_PATH", str(tmp_path / "liblfdm_data.so"))
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", False)
    lib = jnative.get_lib()
    assert lib is not None, "the JAX package's native library did not build"
    return lib


def test_native_matches_jax(jax_native_lib):
    assert tnative.available()
    assert tnative._lib_path().startswith(os.path.join(ROOT, "cvpr23_lfdm_torch", "build"))
    assert jnative.get_lib() is jax_native_lib
    rng = np.random.default_rng(10)
    u8 = (rng.random((3, 50, 70, 3)) * 255).astype(np.uint8)
    f32 = rng.random((3, 50, 70, 3)).astype(np.float32)
    # one source; the JAX build's -march=native may fuse multiply-adds: 1e-6
    np.testing.assert_allclose(tnative.pad_resize_batch(u8, 32), jnative.pad_resize_batch(u8, 32), atol=1e-6)
    np.testing.assert_allclose(tnative.pad_resize_batch_f32(f32, 64), jnative.pad_resize_batch_f32(f32, 64),
                               atol=1e-6)
    np.testing.assert_allclose(tnative.jitter_bcs(f32.copy(), 1.1, 0.9, 1.2),
                               jnative.jitter_bcs(f32.copy(), 1.1, 0.9, 1.2), atol=1e-6)


def test_native_numpy_path_matches_jax(monkeypatch):
    """With no native library (`LFDM_NATIVE=0`) both packages take numpy."""
    monkeypatch.setenv("LFDM_NATIVE", "0")
    rng = np.random.default_rng(11)
    f32 = rng.random((2, 50, 70, 3)).astype(np.float32)
    np.testing.assert_allclose(tnative.pad_resize_batch_f32(f32, 64), jnative.pad_resize_batch_f32(f32, 64),
                               atol=FLOAT_ATOL)
    np.testing.assert_allclose(tnative.jitter_bcs(f32, 1.1, 0.9, 1.2), jnative.jitter_bcs(f32, 1.1, 0.9, 1.2),
                               atol=1e-6)


def test_flow2fig_and_conf2fig_match_jax():
    rng = np.random.default_rng(12)
    lin = np.linspace(-1, 1, 32, dtype=np.float32)
    grid = np.stack(np.meshgrid(lin, lin, indexing="xy"), -1)
    for size in (128, 64, 45):
        flow = grid + 0.1 * rng.standard_normal(grid.shape).astype(np.float32)
        got, want = tviz.flow2fig(flow, grid, size), jviz.flow2fig(flow, grid, size)
        assert got.shape == want.shape and np.abs(got.astype(int) - want).max() <= LSB
        conf = rng.random((32, 32, 1)).astype(np.float32)
        np.testing.assert_array_equal(tviz.conf2fig(conf, size), jviz.conf2fig(conf, size))


def test_training_gif_and_visualizer_match_jax():
    """The panels the JAX package draws with matplotlib (warp lattice, colormap)."""
    rng = np.random.default_rng(13)
    lin = np.linspace(-1, 1, 16, dtype=np.float32)
    grid = np.stack(np.meshgrid(lin, lin, indexing="xy"), -1)
    f = 2
    vids = [rng.random((f, 32, 32, 3)).astype(np.float32) for _ in range(6)]
    grids = [np.stack([grid + 0.05 * rng.standard_normal(grid.shape).astype(np.float32)] * f) for _ in range(2)]
    confs = [rng.random((f, 16, 16, 1)).astype(np.float32) for _ in range(2)]
    args = (vids[0][0], *vids[1:], *grids, *confs)
    got, want = tviz.dm_training_gif(*args, img_size=32), jviz.dm_training_gif(*args, img_size=32)
    # the lattice panels (column 4) within the bound of a numpy render of
    # matplotlib's figure (tests/test_torch_viz.py), the others bit-equal
    lattice = np.zeros(want.shape[2], bool)
    lattice[3 * 32: 4 * 32] = True
    np.testing.assert_array_equal(got[:, :, ~lattice], want[:, :, ~lattice])
    for frame in range(f):
        for rows in (slice(0, 32), slice(32, 64)):
            assert_lattice_close(got[frame, rows, lattice], want[frame, rows, lattice])
    heat = rng.random((8, 8, 3)).astype(np.float32)
    cmap = lambda x: (x, 1 - x, 0.5, 1.0)  # noqa: E731
    np.testing.assert_allclose(tviz.draw_colored_heatmap(heat, cmap, (1, 1, 1)),
                               jviz.draw_colored_heatmap(heat, cmap, (1, 1, 1)))
    out = {"driving_region_params": {"shift": rng.uniform(-1, 1, (1, 3, 2))},
           "source_region_params": {"shift": rng.uniform(-1, 1, (1, 3, 2))},
           "deformed": rng.random((1, 32, 32, 3)), "prediction": rng.random((1, 32, 32, 3)),
           "occlusion_map": rng.random((1, 16, 16, 1)).astype(np.float32)}
    src, dri = rng.random((1, 32, 32, 3)), rng.random((1, 32, 32, 3))
    np.testing.assert_array_equal(tviz.Visualizer().visualize(src, dri, out),
                                  jviz.Visualizer().visualize(src, dri, out))


@pytest.mark.parametrize("fps", [10, 8])
def test_save_gif_round_trips_through_imageio(tmp_path, fps):
    from PIL import Image

    rng = np.random.default_rng(fps)
    frames = (rng.random((6, 33, 517, 3)) * 255).astype(np.uint8)  # > 254 codes per row
    path = str(tmp_path / "a.gif")
    tviz.save_gif(path, frames, fps=fps)
    back = np.asarray(imageio.mimread(path))
    assert back.shape[:4] == frames.shape
    np.testing.assert_array_equal(back[..., :3], tviz.quantize(frames))
    info = Image.open(path).info
    assert info["loop"] == 0 and info["duration"] == 10 * round(100 / fps)
    # float frames in [0, 1] are stored as to_uint8 of them
    tviz.save_gif(path, frames.astype(np.float32) / 255.0, fps=fps)
    back = np.asarray(imageio.mimread(path))
    np.testing.assert_array_equal(back[..., :3], tviz.quantize(tviz.to_uint8(frames.astype(np.float32) / 255.0)))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """One synthetic MUG corpus (8 frames, 64²) written by the JAX package,
    covering both splits; the session subject 002 is in the test split."""
    root = str(tmp_path_factory.mktemp("corpus"))
    spec = jget_spec("mug")
    jmake(root, "mug", subjects=list(spec.train_subjects[:2]) + ["001", "002"],
          classes=list(spec.classes[:2]), takes=2, num_frames=8, size=64, seed=3)
    return root


def test_synthetic_corpus_pixels_equal_jax(tmp_path, corpus):
    spec = tget_spec("mug")
    tmake(str(tmp_path), "mug", subjects=list(spec.train_subjects[:2]) + ["001", "002"],
          classes=list(spec.classes[:2]), takes=2, num_frames=8, size=64, seed=3)
    ours = sorted(os.path.relpath(os.path.join(d, n), tmp_path)
                  for d, _, names in os.walk(tmp_path) for n in names)
    theirs = sorted(os.path.relpath(os.path.join(d, n), corpus)
                    for d, _, names in os.walk(corpus) for n in names)
    assert ours == theirs and len(ours) == 4 * 2 * 2 * 8
    for rel in ours:
        np.testing.assert_array_equal(cv2_rgb(os.path.join(tmp_path, rel)), cv2_rgb(os.path.join(corpus, rel)))


@pytest.mark.parametrize("split,combos,mean,jitter,sampling", [
    ("train", False, (0.0, 0.0, 0.0), True, "random"),
    ("test", True, (0.0, 0.0, 0.0), False, "uniform"),
    ("test", False, (128.0, 100.0, 50.0), True, "very_random"),
])
def test_dm_video_dataset_matches_jax(corpus, split, combos, mean, jitter, sampling):
    kw = dict(split=split, num_frames=6, image_size=48, color_jitter=jitter, sampling=sampling,
              combos=combos, mean=mean, seed=4)
    ours = tds.DMVideoDataset(tget_spec("mug"), corpus, **kw)
    theirs = jds.DMVideoDataset(jget_spec("mug"), corpus, **kw)
    assert len(ours) == len(theirs) > 0
    for i in range(len(ours)):
        for epoch in (0, 1):
            a, b = ours.sample(i, epoch), theirs.sample(i, epoch)
            assert {k: a[k] for k in ("text", "name", "subject")} == {k: b[k] for k in ("text", "name", "subject")}
            assert a["video"].shape == (6, 48, 48, 3)
            np.testing.assert_allclose(a["video"], b["video"], atol=1e-6)
    if combos:
        assert ours.find("001", "anger") == theirs.find("001", "anger")


@pytest.mark.parametrize("frame_shape,id_sampling", [(64, False), (32, True)])
def test_lfae_pair_dataset_matches_jax(corpus, frame_shape, id_sampling):
    kw = dict(split="train", frame_shape=frame_shape, seed=5, id_sampling=id_sampling)
    ours = tds.LFAEPairDataset(tget_spec("mug"), corpus, augment=taug.ClipAugment(), **kw)
    theirs = jds.LFAEPairDataset(jget_spec("mug"), corpus, augment=jaug.ClipAugment(), **kw)
    assert len(ours) == len(theirs) > 0
    # exact without a resize; through a resize one uint8 LSB, which the
    # jitter's brightness, contrast and saturation factors (each <= 1.1) scale
    atol = 1e-6 if frame_shape == 64 else 1.1 ** 3 / 255 + 1e-6
    for i in range(len(ours)):
        a, b = ours.sample(i, 2), theirs.sample(i, 2)
        assert (a["name"], a["id"]) == (b["name"], b["id"])
        for k in ("source", "driving"):
            assert a[k].shape == (frame_shape, frame_shape, 3)
            np.testing.assert_allclose(a[k], b[k], atol=atol)
    rep_t, rep_j = tds.DatasetRepeater(ours, 3), jds.DatasetRepeater(theirs, 3)
    assert len(rep_t) == len(rep_j)
    np.testing.assert_allclose(rep_t[len(ours) + 1]["source"], rep_j[len(theirs) + 1]["source"], atol=atol)


def test_paired_dataset_matches_jax(corpus):
    kw = dict(split="test", num_frames=3, image_size=32, color_jitter=False, sampling="uniform")
    ours = tds.PairedDataset(tds.DMVideoDataset(tget_spec("mug"), corpus, **kw), 5, seed=1)
    theirs = jds.PairedDataset(jds.DMVideoDataset(jget_spec("mug"), corpus, **kw), 5, seed=1)
    assert ours.pairs == theirs.pairs
    a, b = ours[2], theirs[2]
    assert a["driving_name"] == b["driving_name"] and a["source_name"] == b["source_name"]
    np.testing.assert_allclose(a["source_video"], b["source_video"], atol=1e-6)
    np.testing.assert_array_equal(tds.visit_rng(1, 2, 3).random(4), jds.visit_rng(1, 2, 3).random(4))
