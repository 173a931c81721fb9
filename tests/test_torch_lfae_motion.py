"""The port's frozen LFAE motion modules against the JAX package, on the
CPU in fp32: `eig2x2`, `antialias`, `region2gaussian`, `RegionPredictor`,
`BGMotionPredictor`, `PixelwiseFlowPredictor` and the generator's
`forward_flow_video` / `forward_video`.

Inputs and weights come from a numpy seed: every leaf of the JAX variable
tree gets seeded values (`_random_variables`, shapes from `eval_shape` of
`init`) and reaches the port through `from_jax_params` with a strict
`load_state_dict`. Small configs: 32² or 64² frames, block expansion 8-16,
2-3 blocks, 4 regions.

Tolerances (max-abs, fp32): 1e-5 for closed-form ops; 1e-4 for a network
output (a few conv layers of fp32 sums in another order); 2e-4 where a
softmax with temperature 0.1 or a matrix inverse amplifies that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr23_lfdm_tpu.models.bg_predictor import BGMotionPredictor as JBG
from cvpr23_lfdm_tpu.models.generator import Generator as JGenerator
from cvpr23_lfdm_tpu.models.pixelwise_flow import PixelwiseFlowPredictor as JPixelwise
from cvpr23_lfdm_tpu.models.region_predictor import RegionPredictor as JRegion
from cvpr23_lfdm_tpu.ops import antialias as jantialias
from cvpr23_lfdm_tpu.ops import eig2x2 as jeig
from cvpr23_lfdm_tpu.ops import grid as jgrid
from cvpr23_lfdm_torch.models.bg_predictor import BGMotionPredictor
from cvpr23_lfdm_torch.models.generator import Generator
from cvpr23_lfdm_torch.models.pixelwise_flow import PixelwiseFlowPredictor
from cvpr23_lfdm_torch.models.region_predictor import RegionPredictor
from cvpr23_lfdm_torch.ops import antialias, eig2x2, grid
from cvpr23_lfdm_torch.utils.bench_ckpt import from_jax_params
from test_torch_unet import _random_variables

T = torch.from_numpy
K = 4  # regions


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _region_params(rng, n, spread=0.5):
    """Plausible region parameters for `n` images: means in [-spread,
    spread], SPD covariances and their `U sqrt(S)` factors."""
    shift = rng.uniform(-spread, spread, (n, K, 2)).astype(np.float32)
    a = rng.standard_normal((n, K, 2, 2)).astype(np.float32) * 0.2
    covar = a @ a.transpose(0, 1, 3, 2) + 0.02 * np.eye(2, dtype=np.float32)
    affine = np.array(jeig.sqrt_psd_2x2(jnp.asarray(covar)))
    return {"shift": shift, "covar": covar, "affine": affine}


# ------------------------------------------------------------------ ops


def test_eig2x2_matches_jax_incl_degenerate():
    rng = np.random.RandomState(0)
    a = rng.standard_normal((64, 2, 2)).astype(np.float32)
    covar = a @ a.transpose(0, 2, 1)
    special = np.array([
        [[2.0, 0.0], [0.0, 2.0]],      # isotropic: e1 fallback
        [[0.0, 0.0], [0.0, 0.0]],      # zero
        [[3.0, 1e-9], [1e-9, 1.0]],    # near-diagonal, a > c
        [[1.0, 1e-9], [1e-9, 3.0]],    # near-diagonal, c > a
        [[1.0, -0.5], [-0.5, 1.0]],    # negative off-diagonal (sign convention)
        [[1.0, 0.999], [0.999, 1.0]],  # near-singular
    ], np.float32)
    covar = np.concatenate([covar, special])
    ju, js = jeig.eigh_2x2(jnp.asarray(covar))
    u, s = eig2x2.eigh_2x2(T(covar))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), atol=1e-5)
    np.testing.assert_allclose(eig2x2.sqrt_psd_2x2(T(covar)).numpy(),
                               np.asarray(jeig.sqrt_psd_2x2(jnp.asarray(covar))), atol=1e-5)
    m2 = (a + 2 * np.eye(2, dtype=np.float32))
    np.testing.assert_allclose(eig2x2.inv_2x2(T(m2)).numpy(),
                               np.asarray(jeig.inv_2x2(jnp.asarray(m2))), rtol=1e-4, atol=1e-5)
    m3 = rng.standard_normal((16, 3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(eig2x2.inv_3x3(T(m3)).numpy(),
                               np.asarray(jeig.inv_3x3(jnp.asarray(m3))), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("angle", [0.0, 0.5 * np.pi, 0.25 * np.pi, 1.1])
def test_eig2x2_small_eigenvalue_of_thin_covariances(angle):
    """A thin region's smaller eigenvalue, 1e-4 to 1e-9 of the larger (the
    card recorded 6.1e-9 against 0.35), against float64 `eigvalsh` of the
    same fp32 matrix: within 1e-5 of itself, and never rounded to 0, where
    the fp32 `tr / 2 - rad` of the JAX package cancels. The eigenvectors and
    the larger eigenvalue stay within 1e-6 of the JAX package's."""
    rng = np.random.RandomState(5)
    n = 64
    s1 = rng.uniform(0.01, 0.5, n)
    s2 = s1 * 10.0 ** -rng.uniform(4, 9, n)
    v = np.array([np.cos(angle), np.sin(angle)])
    w = np.array([-v[1], v[0]])
    covar = (s1[:, None, None] * np.outer(v, v) + s2[:, None, None] * np.outer(w, w)).astype(np.float32)
    want = np.linalg.eigvalsh(covar.astype(np.float64))[:, ::-1]
    u, s = eig2x2.eigh_2x2(T(covar))
    s = s.numpy().astype(np.float64)
    np.testing.assert_allclose(s[:, 1], want[:, 1], rtol=1e-5, atol=0)
    assert (np.sign(s[:, 1]) == np.sign(want[:, 1])).all()
    ju, js = jeig.eigh_2x2(jnp.asarray(covar))
    np.testing.assert_allclose(s[:, 0], np.asarray(js)[:, 0], rtol=1e-6)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), atol=1e-6)


@pytest.mark.parametrize("scale", [0.25, 0.5, 1.0])
def test_antialias_matches_jax(scale):
    x = np.random.RandomState(1).uniform(size=(2, 32, 24, 3)).astype(np.float32)
    want = np.asarray(jantialias.AntiAliasDownsample(scale)(jnp.asarray(x)))
    got = antialias.AntiAliasDownsample(scale)(T(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    if scale == 0.25:
        assert antialias.gaussian_kernel_1d(scale).shape == (13,)


def test_region2gaussian_and_homogeneous_match_jax():
    rng = np.random.RandomState(2)
    p = _region_params(rng, 3)
    for covar in (p["covar"], 0.01):
        jc = jnp.asarray(covar) if isinstance(covar, np.ndarray) else covar
        tc = T(covar) if isinstance(covar, np.ndarray) else covar
        want = np.asarray(jgrid.region2gaussian(jnp.asarray(p["shift"]), jc, (8, 6)))
        got = grid.region2gaussian(T(p["shift"]), tc, (8, 6))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    c = rng.standard_normal((5, 2)).astype(np.float32)
    hom = grid.to_homogeneous(T(c))
    np.testing.assert_array_equal(hom.numpy(), np.asarray(jgrid.to_homogeneous(jnp.asarray(c))))
    h3 = np.concatenate([c, rng.uniform(0.5, 2, (5, 1)).astype(np.float32)], -1)
    np.testing.assert_allclose(grid.from_homogeneous(T(h3)).numpy(),
                               np.asarray(jgrid.from_homogeneous(jnp.asarray(h3))), rtol=1e-6)


# ------------------------------------------------------------------ modules


@pytest.mark.parametrize("pad,pca", [(3, True), (0, True), (3, False)])
def test_region_predictor_matches_jax(pad, pca):
    rng = np.random.RandomState(3)
    kw = dict(num_regions=K, block_expansion=8, max_features=32, num_blocks=2, pad=pad,
              pca_based=pca)
    img = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    jm = JRegion(**kw)
    variables = _random_variables(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(img)), rng)
    want = _np(jm.apply(variables, jnp.asarray(img)))
    net = RegionPredictor(**kw).eval()
    net.load_state_dict(from_jax_params(variables))
    with torch.no_grad():
        got = net(T(img))
    assert set(got) == set(want)
    hh = 16 if pad == 3 else 10
    assert got["heatmap"].shape == (2, hh, hh, K)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=2e-4, err_msg=key)


@pytest.mark.parametrize("bg_type", ["zero", "shift", "affine", "perspective"])
def test_bg_predictor_matches_jax(bg_type):
    rng = np.random.RandomState(4)
    kw = dict(block_expansion=8, max_features=32, num_blocks=2, bg_type=bg_type)
    src = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    dri = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    jm = JBG(**kw)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(src), jnp.asarray(dri))
    net = BGMotionPredictor(**kw).eval()
    if bg_type != "zero":
        # the identity-transform init, before any weights are loaded
        fresh = jm.init(jax.random.PRNGKey(0), jnp.asarray(src), jnp.asarray(dri))
        np.testing.assert_array_equal(net.fc.bias.detach().numpy(), np.asarray(fresh["params"]["fc"]["bias"]))
        assert float(net.fc.weight.detach().abs().max()) == 0.0
    variables = _random_variables(shapes, rng)
    want = np.asarray(jm.apply(variables, jnp.asarray(src), jnp.asarray(dri)))
    net.load_state_dict(from_jax_params(variables))
    with torch.no_grad():
        got = net(T(src), T(dri))
    assert got.shape == (2, 3, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("frames", [1, 3])
@pytest.mark.parametrize("covar_heatmap,bg", [(True, True), (False, False)])
def test_pixelwise_flow_matches_jax(frames, covar_heatmap, bg):
    rng = np.random.RandomState(5)
    kw = dict(num_regions=K, block_expansion=8, max_features=32, num_blocks=2,
              use_covar_heatmap=covar_heatmap)
    b = 2
    src = rng.uniform(size=(b, 64, 64, 3)).astype(np.float32)
    dparams = _region_params(rng, b * frames)
    sparams = {k: np.repeat(v, frames, axis=0) for k, v in _region_params(rng, b).items()}
    bgp = None
    if bg:
        bgp = np.tile(np.eye(3, dtype=np.float32), (b * frames, 1, 1))
        bgp[:, :2] += 0.05 * rng.standard_normal((b * frames, 2, 3)).astype(np.float32)
    jm = JPixelwise(**kw)
    j = lambda d: None if d is None else jax.tree.map(jnp.asarray, d)
    variables = _random_variables(jax.eval_shape(
        lambda r: jm.init(r, jnp.asarray(src), j(dparams), j(sparams), j(bgp), frames=frames),
        jax.random.PRNGKey(0)), rng)
    want = _np(jm.apply(variables, jnp.asarray(src), j(dparams), j(sparams), j(bgp), frames=frames))
    net = PixelwiseFlowPredictor(**kw).eval()
    net.load_state_dict(from_jax_params(variables))
    t = lambda d: None if d is None else ({k: T(v) for k, v in d.items()} if isinstance(d, dict) else T(d))
    with torch.no_grad():
        got = net(T(src), t(dparams), t(sparams), t(bgp), frames=frames)
    assert got["optical_flow"].shape == (b * frames, 16, 16, 2)
    for key in ("optical_flow", "occlusion_map"):
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=2e-4, err_msg=key)


def test_pixelwise_flow_gradient_path_is_differentiable():
    """With a gradient asked for, the deformed-source sample goes through
    the plain `grid_sample` and carries a graph."""
    rng = np.random.RandomState(6)
    net = PixelwiseFlowPredictor(num_regions=K, block_expansion=8, max_features=32, num_blocks=2).eval()
    src = T(rng.uniform(size=(1, 32, 32, 3)).astype(np.float32)).requires_grad_()
    p = {k: T(v) for k, v in _region_params(rng, 1).items()}
    out = net(src, p, {k: v.clone() for k, v in p.items()})
    out["optical_flow"].sum().backward()
    assert src.grad is not None and torch.isfinite(src.grad).all()


@pytest.mark.parametrize("method", ["forward_flow_video", "forward_video"])
def test_generator_video_forwards_match_jax(method):
    rng = np.random.RandomState(7)
    pf = dict(block_expansion=8, max_features=32, num_blocks=2)
    kw = dict(num_regions=K, block_expansion=8, max_features=32, num_bottleneck_blocks=2)
    b, frames = 2, 3
    src = rng.uniform(size=(b, 64, 64, 3)).astype(np.float32)
    dparams = _region_params(rng, b * frames, spread=0.2)
    sparams = {k: np.repeat(v, frames, axis=0) for k, v in _region_params(rng, b, spread=0.2).items()}
    bgp = np.tile(np.eye(3, dtype=np.float32), (b * frames, 1, 1))
    jm = JGenerator(**kw, pixelwise_flow_predictor_params=pf)
    j = lambda d: jax.tree.map(jnp.asarray, d)
    jargs = (jnp.asarray(src), j(dparams), j(sparams), jnp.asarray(bgp))
    variables = _random_variables(jax.eval_shape(
        lambda r: jm.init(r, *jargs, frames=frames, method=JGenerator.forward_video),
        jax.random.PRNGKey(0)), rng)
    want = _np(jm.apply(variables, *jargs, frames=frames, method=getattr(JGenerator, method)))
    net = Generator(**kw, pixelwise_flow_params=pf).eval()
    net.load_state_dict(from_jax_params(variables))
    t = lambda d: {k: T(v) for k, v in d.items()}
    with torch.no_grad():
        got = getattr(net, method)(T(src), t(dparams), t(sparams), T(bgp), frames=frames)
    assert set(got) == set(want)
    for key in want:
        # the decode runs 4 more conv blocks on warped features
        atol = 5e-4 if key in ("prediction", "deformed") else 2e-4
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=atol, err_msg=key)


def test_generator_single_frame_forwards():
    """`forward` is `forward_video` with one frame per source, and
    `forward_with_flow` decodes its flow to the same prediction."""
    rng = np.random.RandomState(8)
    pf = dict(block_expansion=8, max_features=32, num_blocks=2)
    net = Generator(num_regions=K, block_expansion=8, max_features=32,
                    num_bottleneck_blocks=1, pixelwise_flow_params=pf).eval()
    src = T(rng.uniform(size=(2, 32, 32, 3)).astype(np.float32))
    d = {k: T(v) for k, v in _region_params(rng, 2).items()}
    s = {k: T(v) for k, v in _region_params(rng, 2).items()}
    with torch.no_grad():
        full = net(src, d, s)
        again = net.forward_with_flow(src, full["optical_flow"], full["occlusion_map"])
    torch.testing.assert_close(again["prediction"], full["prediction"])
    torch.testing.assert_close(again["deformed"], full["deformed"])
    serving = Generator(num_regions=K, block_expansion=8, max_features=32, num_bottleneck_blocks=1)
    with pytest.raises(RuntimeError, match="pixelwise flow predictor"):
        serving.forward_flow_video(src, d, s)
