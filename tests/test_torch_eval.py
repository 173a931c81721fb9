"""The port's evaluation path against the JAX package, on the CPU: PSNR,
SSIM, the LPIPS-style distance, the Fréchet statistics, `extract_features`
with a ragged tail, `FVD` and its grouped cFVD / sFVD, the VGG video
extractor, I3D and LPIPS on the committed fixture weights (against the JAX
extractors and `tests/golden/metrics_golden.npz`), their converters, the
LFAE reconstruction `evaluate`, and the copied loader and viz modules.

Tolerances, stated at each assertion: 1e-6 for elementwise metrics and host
statistics (fp32 sums in another order); 1e-5 relative for the small VGG
distances; the JAX golden tests' own for I3D (features rtol 1e-3 / atol 0.5
on logits of O(1e4), FVD 1e-2) and LPIPS (1e-4 / 1e-6); 2e-4 for an LFAE
reconstruction (as `test_torch_lfae_train.py`) and 1e-4 relative for its
summed L1 losses.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_viz import assert_lattice_close
from cvpr23_lfdm_tpu.data import loader as jloader
from cvpr23_lfdm_tpu.eval import flowautoenc as jfae
from cvpr23_lfdm_tpu.eval import i3d as ji3d
from cvpr23_lfdm_tpu.eval import lpips as jlpips
from cvpr23_lfdm_tpu.eval import metrics as jm
from cvpr23_lfdm_tpu.train import vgg as jvgg
from cvpr23_lfdm_tpu.utils import viz as jviz
from cvpr23_lfdm_torch.data import loader as tloader
from cvpr23_lfdm_torch.eval import flowautoenc as tfae
from cvpr23_lfdm_torch.eval import i3d as ti3d
from cvpr23_lfdm_torch.eval import lpips as tlpips
from cvpr23_lfdm_torch.eval import metrics as tm
from cvpr23_lfdm_torch.models.flow_autoenc import FlowAE
from cvpr23_lfdm_torch.train.vgg import Vgg19Features, seed_vgg_weights
from cvpr23_lfdm_torch.utils import viz as tviz
from cvpr23_lfdm_torch.utils.bench_ckpt import to_jax_params
from metrics_fixtures import GOLDEN_PATH, golden_i3d_inputs, i3d_random_sd_np, lpips_random_sds_np
from test_torch_lfae_train import _lfae_pair, _tiny_jcfg
from test_torch_slice import _port_cfg

T = torch.from_numpy


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: as fast at these sizes, and test processes that
    share the CPU do not oversubscribe it (spinning OpenMP threads made the
    DM resume 70x slower under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ PSNR, SSIM, LPIPS-style


def test_psnr_and_ssim_match_jax():
    rng = np.random.RandomState(1)
    a = rng.uniform(size=(2, 3, 24, 20, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(float(tm.psnr(T(a), T(b))), float(jm.psnr(a, b)), rtol=1e-6)
    np.testing.assert_allclose(float(tm.psnr(T(a), T(b), max_val=2.0)), float(jm.psnr(a, b, 2.0)), rtol=1e-6)
    assert float(tm.psnr(T(a), T(a))) == pytest.approx(120.0)  # mse floored at 1e-12
    np.testing.assert_allclose(float(tm.ssim(T(a), T(b))), float(jm.ssim(a, b)), atol=1e-6)
    np.testing.assert_allclose(float(tm.ssim(T(a[0, 0]), T(b[0, 0]))), float(jm.ssim(a[0, 0], b[0, 0])),
                               atol=1e-6)
    assert float(tm.ssim(T(a), T(a))) == pytest.approx(1.0, abs=1e-6)


@pytest.fixture(scope="module")
def vgg_pair():
    vgg = Vgg19Features()
    seed_vgg_weights(vgg, 3)
    jvars = to_jax_params(vgg.state_dict())
    return vgg.eval(), (lambda x: jvgg.Vgg19Features().apply(jvars, x))


@pytest.mark.parametrize("lin", [False, True])
def test_lpips_distance_matches_jax(vgg_pair, lin):
    vgg, japply = vgg_pair
    rng = np.random.RandomState(2)
    a, b = (rng.uniform(size=(2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    lins = [rng.uniform(size=c).astype(np.float32) for c in (64, 128, 256, 512, 512)] if lin else None
    with torch.no_grad():
        got = float(tm.lpips_distance(vgg, T(a), T(b), None if lins is None else [T(w) for w in lins]))
    want = float(jm.lpips_distance(japply, jnp.asarray(a), jnp.asarray(b), lins))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    with torch.no_grad():
        assert float(tm.lpips_distance(vgg, T(a), T(a))) == 0.0


def test_vgg_video_extractor_matches_jax(vgg_pair):
    vgg, japply = vgg_pair
    v = np.random.RandomState(3).uniform(size=(2, 3, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        got = tm.vgg_video_extractor(vgg)(v).numpy()
    want = np.asarray(jm.vgg_video_extractor(japply)(jnp.asarray(v)))
    assert got.shape == want.shape == (2, 512)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ Fréchet statistics and FVD


def test_frechet_statistics_match_jax():
    rng = np.random.RandomState(4)
    x, y = rng.standard_normal((12, 6)), 1.5 + 2 * rng.standard_normal((9, 6))
    for feats in (x, x[:1]):
        for ours, theirs in zip(tm.feature_statistics(feats), jm.feature_statistics(feats)):
            np.testing.assert_array_equal(ours, theirs)
    assert not tm.feature_statistics(x[:1])[1].any()  # n=1: a point mass, no NaN
    stats = tm.feature_statistics(x) + tm.feature_statistics(y)
    assert tm.frechet_distance(*stats) == jm.frechet_distance(*stats) > 0
    mu, s = tm.feature_statistics(x)
    assert abs(tm.frechet_distance(mu, s, mu, s)) < 1e-9


def _projection_extractors(seed=5, d=6):
    """A fixed random projection of the mean frame, in both frameworks."""
    w = np.random.RandomState(seed).standard_normal((3, d)).astype(np.float32)
    return (lambda v: torch.as_tensor(v).mean(dim=(1, 2, 3)) @ T(w),
            lambda v: jnp.mean(v, axis=(1, 2, 3)) @ w)


def _videos(seed, n, shift=0.0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(size=(n, 2, 4, 4, 3)) + shift).astype(np.float32)


def test_extract_features_ragged_tail_matches_jax():
    ours, theirs = _projection_extractors()
    calls = []
    v = _videos(6, 11)
    got = tm.extract_features(lambda x: calls.append(len(x)) or ours(x), v, batch_size=4)
    want = jm.extract_features(theirs, v, batch_size=4)
    assert calls == [4, 4, 4]  # the tail padded to the batch, then cropped
    assert got.shape == want.shape == (11, 6)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, tm.extract_features(ours, T(v), batch_size=11), rtol=1e-6, atol=1e-6)


def test_fvd_and_grouped_match_jax():
    """Plain FVD, and the grouped cFVD / sFVD: a group in one set only is
    NaN and skipped, a singleton group is finite."""
    ours, theirs = _projection_extractors()
    real, fake = _videos(7, 10), _videos(8, 9, shift=0.3)
    got, want = tm.FVD(ours)(real, fake, 4), jm.FVD(theirs)(real, fake, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got > 0 and tm.FVD(ours)(real, real, 4) < 1e-6
    rg = ["a"] * 5 + ["b"] * 4 + ["only_real"]
    fg = ["a"] * 4 + ["b"] + ["only_fake"] * 4
    (gm, gper), (jmean, jper) = tm.FVD(ours).grouped(real, fake, rg, fg, 4), \
        jm.FVD(theirs).grouped(real, fake, rg, fg, 4)
    assert set(gper) == set(jper) == {"a", "b", "only_real", "only_fake"}
    assert np.isnan(gper["only_real"]) and np.isnan(gper["only_fake"]) and np.isfinite(gper["b"])
    np.testing.assert_allclose(gm, jmean, rtol=1e-5)
    for g in ("a", "b"):
        np.testing.assert_allclose(gper[g], jper[g], rtol=1e-5)
    with pytest.raises(ValueError):
        tm.FVD(ours).grouped(real, fake, rg[:-1], fg)


# ------------------------------------------------------------------ I3D and LPIPS


@pytest.fixture(scope="module")
def i3d_sd():
    return i3d_random_sd_np()


def test_convert_i3d_checkpoint(i3d_sd):
    sd = dict(i3d_sd)
    sd["Conv3d_1a_7x7.bn.num_batches_tracked"] = np.array(3)
    state = ti3d.convert_i3d_checkpoint(sd)
    assert set(state) == set(i3d_sd)
    net = ti3d.InceptionI3d()
    net.load_state_dict(state)  # strict: the pytorch_i3d names are the port's
    assert torch.equal(net.Mixed_4b.b1b.conv3d.weight, T(i3d_sd["Mixed_4b.b1b.conv3d.weight"]))
    assert set(ti3d.random_i3d_vars(0)) == set(net.state_dict())


def test_i3d_matches_jax_and_golden(i3d_sd):
    """The fixture weights and inputs (32², 9 frames, no resize): the port's
    features against the JAX extractor's, then features and FVD against
    the committed golden at the JAX golden test's tolerances."""
    golden = np.load(GOLDEN_PATH)
    real, fake = golden_i3d_inputs()
    extract = ti3d.i3d_extractor(ti3d.convert_i3d_checkpoint(i3d_sd), resize_to=None, device="cpu")
    feats = extract(real).numpy()
    want = np.asarray(ji3d.i3d_extractor(ji3d.convert_i3d_checkpoint(i3d_sd), resize_to=None)(real[:2]))
    np.testing.assert_allclose(feats[:2], want, rtol=1e-3, atol=0.5)
    np.testing.assert_allclose(feats, golden["i3d_feats_real"], rtol=1e-3, atol=0.5)
    np.testing.assert_allclose(tm.FVD(extract)(real, fake), float(golden["i3d_fvd"]), rtol=1e-2)


def test_i3d_extractor_resizes_as_jax():
    """The 224² resize and [-1, 1] rescale in front of the network, on
    seeded weights at a small input (resized to 64²)."""
    state = ti3d.random_i3d_vars(1, num_classes=7)
    jshapes = jax.eval_shape(lambda r: ji3d.InceptionI3d(7).init(r, jnp.zeros((1, 9, 64, 64, 3))),
                             jax.random.PRNGKey(0))
    # the port's seeded values through the JAX tree (5-D kernels DHWIO)
    params, stats = {}, {}
    for k, v in state.items():
        *unit, mod, leaf = k.split(".")
        a = v.numpy()
        if mod == "conv3d":
            node = params
            name = "kernel" if leaf == "weight" else "bias"
            a = a.transpose(2, 3, 4, 1, 0) if leaf == "weight" else a
        else:
            node = stats if leaf.startswith("running") else params
            name = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}[leaf]
        for u in unit + [mod]:
            node = node.setdefault(u, {})
        node[name] = a
    assert jax.tree.structure(jax.tree.map(np.shape, {"params": params, "batch_stats": stats})) == \
        jax.tree.structure(jax.tree.map(np.shape, jshapes))
    v = np.random.RandomState(9).uniform(size=(2, 9, 40, 48, 3)).astype(np.float32)
    got = ti3d.i3d_extractor(state, 7, resize_to=64, device="cpu")(v).numpy()
    want = np.asarray(ji3d.i3d_extractor({"params": params, "batch_stats": stats}, 7, resize_to=64)(v))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_lpips_converters_and_golden():
    feat_sd, lin_sd, a, b = lpips_random_sds_np(seed=2)
    state = tlpips.convert_vgg16_features(feat_sd)
    net = tlpips.Vgg16Features()
    net.load_state_dict(state)  # strict
    assert torch.equal(net.conv_28.weight, T(feat_sd["28.weight"]))
    lins = tlpips.convert_lpips_lin(lin_sd)
    jlins = jlpips.convert_lpips_lin(lin_sd)
    assert all(np.array_equal(x.numpy(), y) for x, y in zip(lins, jlins))
    renamed = {k.replace("lin", "lins.", 1): v for k, v in lin_sd.items()}
    assert all(torch.equal(x, y) for x, y in zip(tlpips.convert_lpips_lin(renamed), lins))
    with pytest.raises(KeyError):
        tlpips.convert_lpips_lin({})
    got = tlpips.make_lpips(state, lins, device="cpu")(a, b).numpy()
    want = np.asarray(jlpips.make_lpips(jlpips.convert_vgg16_features(feat_sd), jlins)(a, b))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got, np.load(GOLDEN_PATH)["lpips_vals"], rtol=1e-4, atol=1e-6)
    assert float(tlpips.make_lpips(state, lins, device="cpu")(a, a).abs().max()) < 1e-6
    rand = tlpips.random_lpips_for_testing(0, device="cpu")(a, b)
    assert rand.shape == (2,) and bool(torch.isfinite(rand).all())


def test_chip_smoke_fixture_builders_are_the_tests():
    """`chip_smoke.py` carries its own copies of the fixture builders (the
    card has no JAX, which `tests/metrics_fixtures.py` reaches for its
    channel table): the same arrays, draw for draw."""
    import chip_smoke

    ours, theirs = chip_smoke.i3d_fixture_sd(), i3d_random_sd_np()
    assert list(ours) == list(theirs) and all(np.array_equal(ours[k], theirs[k]) for k in ours)
    for x, y in zip(chip_smoke.lpips_fixture_sds(), lpips_random_sds_np(seed=2)):
        if isinstance(x, dict):
            assert list(x) == list(y) and all(np.array_equal(x[k], y[k]) for k in x)
        else:
            np.testing.assert_array_equal(x, y)
    for x, y in zip(chip_smoke.golden_i3d_inputs(), golden_i3d_inputs()):
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------------ LFAE reconstruction eval


class _Videos:
    """An in-memory dataset of smooth seeded videos (`[F, H, W, 3]`)."""

    def __init__(self, n, f, s, seed):
        rng = np.random.RandomState(seed)
        lin = np.linspace(0, 1, s, dtype=np.float32)
        base = rng.uniform(0.2, 0.8, size=(n, 1, 1, 1, 3)).astype(np.float32)
        ramp = (lin[:, None] + lin[None, :])[None, None, :, :, None] / 2
        drift = rng.uniform(-0.1, 0.1, size=(n, f, 1, 1, 3)).astype(np.float32)
        self.videos = np.clip(base + 0.3 * ramp + drift, 0, 1).astype(np.float32)

    def __len__(self):
        return len(self.videos)

    def __getitem__(self, i):
        return {"video": self.videos[i], "name": f"v{i}"}


def test_evaluate_matches_jax(tmp_path):
    """3 videos of 5 frames at batch 2 (a ragged last batch) and
    `frame_chunk` 3 (a ragged last chunk): the losses, and one video's
    reconstruction against the JAX `make_reconstruct_fn`."""
    rng = np.random.RandomState(10)
    jcfg = _tiny_jcfg()
    variables, net = _lfae_pair(jcfg, rng)
    cfg = _port_cfg(jcfg).lfae
    data = _Videos(3, 5, 32, seed=11)
    kw = dict(batch_size=2, image_size=32, frame_chunk=3)
    got = tfae.evaluate(net.state_dict(), cfg, data, device="cpu", **kw)
    want = jfae.evaluate(variables, jcfg.lfae, data, **kw)
    for k in ("out_loss", "warp_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert 0 < got["warp_loss"] and 0 < got["out_loss"]

    vid = data.videos[:1]
    fae = FlowAE(cfg)
    fae.load_state_dict(net.state_dict())
    run = tfae.make_reconstruct_fn(fae)
    ours = run(T(vid[:, 0]), T(vid))
    theirs = jax.device_get(jfae.make_reconstruct_fn(jcfg.lfae)(variables, vid[:, 0], vid))
    assert set(ours) == set(theirs)
    for k in theirs:
        assert ours[k].shape == theirs[k].shape, k
        np.testing.assert_allclose(ours[k].numpy(), theirs[k], atol=2e-4, err_msg=k)

    path = tmp_path / "gifs"
    again = tfae.evaluate(net.state_dict(), cfg, data, device="cpu", save_video_dir=str(path), **kw)
    assert again == got
    assert sorted(os.listdir(path)) == ["0000_v0.gif", "0001_v1.gif", "0002_v2.gif"]
    tfae.write_json(got, str(tmp_path / "eval.json"))
    with open(tmp_path / "eval.json") as f:
        assert f.read().startswith('{"out_loss"')


# ------------------------------------------------------------------ copied modules


class _Visits:
    """A dataset whose samples name their visit (index and epoch)."""

    def __len__(self):
        return 7

    def sample(self, i, epoch):
        return {"x": np.full((2,), 10 * epoch + i, np.int64), "tag": f"{epoch}:{i}"}


@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_stream_matches_jax(drop_last):
    """The shuffled stream across epochs, and a seek (`start_batch`) into the
    middle of the second epoch, batch for batch as the JAX loader's."""
    for start in (0, 4):
        kw = dict(batch_size=3, shuffle=True, num_workers=2, seed=3, drop_last=drop_last,
                  start_batch=start)
        ours, theirs = iter(tloader.PrefetchLoader(_Visits(), **kw)), \
            iter(jloader.PrefetchLoader(_Visits(), **kw))
        for _ in range(6):
            a, b = next(ours), next(theirs)
            np.testing.assert_array_equal(a["x"], b["x"])
            assert a["tag"] == b["tag"]
    assert tloader.collate([{"a": np.ones(2), "n": "x"}] * 3)["a"].shape == (3, 2)


def test_viz_matches_jax(tmp_path):
    rng = np.random.RandomState(12)
    flow = rng.standard_normal((16, 16, 2)).astype(np.float32)
    np.testing.assert_array_equal(tviz.flow_to_color(flow), jviz.flow_to_color(flow))
    np.testing.assert_array_equal(tviz.flow_to_color(flow, 0.5), jviz.flow_to_color(flow, 0.5))
    img = rng.uniform(-0.2, 1.2, size=(8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(tviz.to_uint8(img), jviz.to_uint8(img))
    rows = [[tviz.to_uint8(img)] * 2] * 3
    np.testing.assert_array_equal(tviz.tile_grid(rows), jviz.tile_grid(rows))
    conf = rng.uniform(size=(8, 8, 1)).astype(np.float32)
    np.testing.assert_array_equal(tviz.conf2fig(conf, 32), jviz.conf2fig(conf, 32))
    grid = rng.uniform(-1, 1, size=(8, 8, 2)).astype(np.float32)
    assert_lattice_close(tviz.grid2fig(grid, img_size=64), jviz.grid2fig(grid, img_size=64))
    # the port writes GIFs itself (one fixed palette) where the JAX package
    # calls imageio: the same frames and timing, each pixel the nearest
    # palette colour (within half a palette step of the frame, 255 / 5 / 2)
    import imageio.v2 as imageio
    from PIL import Image

    frames = rng.uniform(size=(3, 8, 8, 3)).astype(np.float32)
    tviz.save_gif(str(tmp_path / "a.gif"), frames)
    jviz.save_gif(str(tmp_path / "b.gif"), frames)
    ours, theirs = (np.asarray(imageio.mimread(str(tmp_path / n)))[..., :3] for n in ("a.gif", "b.gif"))
    assert ours.shape == theirs.shape == (3, 8, 8, 3)
    np.testing.assert_array_equal(ours, tviz.quantize(tviz.to_uint8(frames)))
    assert np.abs(ours.astype(int) - tviz.to_uint8(frames)).max() <= 255 / 5 / 2
    info = [Image.open(str(tmp_path / n)).info for n in ("a.gif", "b.gif")]
    assert info[0]["loop"] == info[1]["loop"] == 0 and info[0]["duration"] == info[1]["duration"]
