"""The port's LFAE (stage-1) training slice against the JAX package, on the
CPU in fp32: the differentiable `grid_sample` (every padding mode) and the
training warp, the JAX tie conventions (`ops/ties.py`), train-mode
BatchNorm against flax, `eig2x2` gradients at ties, `TPSTransform`,
`image_pyramid` and the VGG perceptual loss, `equivariance_losses`,
`AVDNetwork`, `FlowAE`, `LFAEReconstruction` (outputs and parameter
gradients), two `LFAETrainer` steps against the JAX trainer, the resume of
`fit`, `convert_torchvision_vgg19`, the weight bridge both ways, the CPU
entry point, and the JAX golden of the full-width step that `chip_smoke.py`
holds the card against.

Inputs and weights come from numpy seeds. Tiny configs: 32² frames (64²
for the VGG), block expansion 8, 2 blocks, 4 regions; the VGG19 at its full
width. Tolerances, stated at each assertion: 1e-5 for closed-form ops and
single layers; 1e-4 to 2e-4 for a network's outputs and 1e-3 of a leaf's
largest value for its parameter gradient (fp32 sums in another order,
amplified by the temperature-0.1 softmax and 2x2 inverses). The L1 losses
are not smooth: where a feature of the prediction and of the target agree
to rounding, the two frameworks may take the other side of the kink, so a
gradient through the perceptual loss is held elementwise for 99% of its
elements, and Adam's first update (+-lr on every parameter) flips with it.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr23_lfdm_tpu import config as jconfig
from cvpr23_lfdm_tpu.models import avd_network as javd
from cvpr23_lfdm_tpu.models.blocks import batch_norm as jbatch_norm
from cvpr23_lfdm_tpu.models.flow_autoenc import FlowAE as JFlowAE
from cvpr23_lfdm_tpu.ops import eig2x2 as jeig
from cvpr23_lfdm_tpu.ops import warp as jwarp
from cvpr23_lfdm_tpu.ops.grid import make_coordinate_grid as jgrid
from cvpr23_lfdm_tpu.parallel.mesh import make_mesh
from cvpr23_lfdm_tpu.train import lfae_trainer as jlt
from cvpr23_lfdm_tpu.train import losses as jlosses
from cvpr23_lfdm_tpu.train import vgg as jvgg
from cvpr23_lfdm_torch.models import avd_network as tavd
from cvpr23_lfdm_torch.models.blocks import BatchNorm
from cvpr23_lfdm_torch.models.flow_autoenc import FlowAE
from cvpr23_lfdm_torch.ops import eig2x2, ties
from cvpr23_lfdm_torch.ops import warp as twarp
from cvpr23_lfdm_torch.train import losses as tlosses
from cvpr23_lfdm_torch.train.dm_trainer import step_generator
from cvpr23_lfdm_torch.train.lfae_trainer import LFAEReconstruction, LFAETrainer, LFAETrainState
from cvpr23_lfdm_torch.train.vgg import (
    Vgg19Features, convert_torchvision_vgg19, seed_vgg_weights,
)
from cvpr23_lfdm_torch.utils.bench_ckpt import from_jax_params, to_jax_params
from test_torch_slice import _port_cfg
from test_torch_unet import _random_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_lfae_step.npz")
GOLDEN_SEED = 20231017
T = torch.from_numpy
K = 4  # regions of the tiny config
LR = 2e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tiny_jcfg(frame=32, scales=(1.0, 0.5), perceptual=10.0):
    """The JAX experiment config of the tiny LFAE (every module kept)."""
    narrow = dict(block_expansion=8, max_features=32)
    lfae = jconfig.LFAEConfig(
        frame_shape=frame, num_regions=K,
        region_predictor=jconfig.RegionPredictorConfig(num_regions=K, num_blocks=2, **narrow),
        bg_predictor=jconfig.BGPredictorConfig(num_blocks=2, **narrow),
        generator=jconfig.GeneratorConfig(
            num_bottleneck_blocks=1, **narrow,
            pixelwise_flow=jconfig.PixelwiseFlowConfig(num_blocks=2, **narrow)),
    )
    train = jconfig.LFAETrainConfig(scales=scales, perceptual_weights=(perceptual,) * 5)
    return jconfig.ExperimentConfig(lfae=lfae, lfae_train=train)


def _tps_params(rng, b, points=5, sigma_affine=0.05, sigma_tps=0.005):
    theta = (np.eye(2, 3)[None] + sigma_affine * rng.standard_normal((b, 2, 3))).astype(np.float32)
    cpar = (sigma_tps * rng.standard_normal((b, points ** 2))).astype(np.float32)
    return theta, cpar


def _both_tps(theta, cpar, points=5):
    jt = jlosses.TPSTransform(jnp.asarray(theta),
                              None if cpar is None else jgrid((points, points)).reshape(-1, 2),
                              None if cpar is None else jnp.asarray(cpar))
    tt = tlosses.TPSTransform.from_params(T(theta), None if cpar is None else T(cpar), points)
    return jt, tt


def _walk(a, b, fn, path=""):
    """fn(path, a_leaf, b_leaf) over two trees of the same keys."""
    assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
    for k in a:
        if isinstance(a[k], dict):
            _walk(a[k], b[k], fn, f"{path}/{k}")
        else:
            fn(f"{path}/{k}", a[k], b[k])


# ------------------------------------------------------------------ grid_sample


def _warp_case(rng, b=2, h=7, w=8, c=3, gh=6, gw=5):
    """An image and a grid that reaches outside [-1, 1], with exact ties:
    coordinates that unnormalize onto a pixel centre, onto 0 and size-1
    (the clip bounds of border / reflection padding) and onto the
    reflection bounds."""
    img = rng.standard_normal((b, h, w, c)).astype(np.float32)
    grid = rng.uniform(-1.6, 1.6, size=(b, gh, gw, 2)).astype(np.float32)
    # x: align_corners=False puts pixel i at (2i + 1)/w - 1; True at 2i/(w-1) - 1
    grid[0, 0, :5, 0] = [1 / w - 1, 1 - 1 / w, -1.0, 1.0, 0.0]
    grid[0, 1, :5, 1] = [1 / h - 1, 1 - 1 / h, -1.0, 1.0, 3 / h - 1]
    grid[1, 0, :2, 0] = [-1 - 1 / w, 1 + 1 / w]  # the reflection bounds, align_corners=False
    return img, grid


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
def test_grid_sample_and_vjp_match_jax(padding_mode, align_corners):
    """Forward and both gradients against `jax.vjp` of the JAX `grid_sample`
    (its hand-written `_grid_sample_bwd`), ties included. 1e-5 forward, 1e-4
    gradients (fp32, 4-corner sums in another order)."""
    rng = np.random.RandomState(0)
    img, grid = _warp_case(rng)
    cot = rng.standard_normal(grid.shape[:3] + (img.shape[-1],)).astype(np.float32)
    out, vjp = jax.vjp(lambda i, g: jwarp.grid_sample(
        i, g, padding_mode=padding_mode, align_corners=align_corners), jnp.asarray(img), jnp.asarray(grid))
    d_img, d_grid = vjp(jnp.asarray(cot))
    ti, tg = T(img).requires_grad_(), T(grid).requires_grad_()
    got = twarp.grid_sample(ti, tg, padding_mode=padding_mode, align_corners=align_corners)
    (got * T(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-5)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(d_img), atol=1e-4)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(d_grid), atol=1e-4)


def test_train_warp_matches_jax_vjp():
    """The training warp (`F.grid_sample`, zeros padding) against the same
    JAX VJP, at a decode-like shape (C = 19). 1e-5 forward, 1e-4 gradients."""
    rng = np.random.RandomState(1)
    img, grid = _warp_case(rng, h=9, w=8, c=19, gh=9, gw=8)
    cot = rng.standard_normal(grid.shape[:3] + (19,)).astype(np.float32)
    out, vjp = jax.vjp(jwarp.grid_sample, jnp.asarray(img), jnp.asarray(grid))
    d_img, d_grid = vjp(jnp.asarray(cot))
    ti, tg = T(img).requires_grad_(), T(grid).requires_grad_()
    got = twarp.train_warp(ti, tg)
    (got * T(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-5)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(d_img), atol=1e-4)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(d_grid), atol=1e-4)
    with pytest.raises(ValueError, match="padding_mode"):
        twarp.grid_sample(ti, tg, padding_mode="wrap")


@pytest.mark.parametrize("name", ["maximum", "clip", "abs_"])
def test_tie_gradients_match_jax(name):
    """At the kink, `ops.ties` has JAX's gradient (exact), where torch's
    `clamp` / `abs` have another."""
    x = np.array([-1.0, 0.0, 0.5, 2.0, 3.0], np.float32)
    jfn, tfn, torch_native = {
        "maximum": (lambda v: jnp.maximum(v, 0.0), lambda v: ties.maximum(v, 0.0),
                    lambda v: torch.clamp_min(v, 0.0)),
        "clip": (lambda v: jnp.clip(v, 0.0, 2.0), lambda v: ties.clip(v, 0.0, 2.0),
                 lambda v: torch.clamp(v, 0.0, 2.0)),
        "abs_": (jnp.abs, ties.abs_, torch.abs),
    }[name]
    want = np.asarray(jax.grad(lambda v: jfn(v).sum())(jnp.asarray(x)))
    grads = []
    for fn in (tfn, torch_native):
        t = T(x).requires_grad_()
        y = fn(t)
        np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jfn(jnp.asarray(x))))
        y.sum().backward()
        grads.append(t.grad.numpy())
    np.testing.assert_array_equal(grads[0], want)
    assert not np.array_equal(grads[1], want)  # the torch op this module replaces


# ------------------------------------------------------------------ BatchNorm


@pytest.mark.parametrize("n", [8, 512])
def test_batchnorm_train_mode_matches_flax(n):
    """Train mode: output, gradients and the running statistics of two
    updates against the JAX package's `batch_norm` (flax `nn.BatchNorm`,
    momentum 0.9, `use_fast_variance`), over N = n elements per channel;
    eval mode normalises with the running statistics and moves nothing.
    1e-5 (fp32 reductions in another order). `torch.nn.BatchNorm2d` keeps
    the unbiased variance, N/(N-1) of flax's."""
    rng = np.random.RandomState(2)
    c = 6
    shape = (2, 2, 2, c) if n == 8 else (2, 16, 16, c)
    xs = [(rng.standard_normal(shape) * 2 + 0.5).astype(np.float32) for _ in range(2)]
    cot = rng.standard_normal(shape).astype(np.float32)
    scale = (1 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    jbn = jbatch_norm()
    stats = {"mean": jnp.zeros(c), "var": jnp.ones(c)}
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}

    bn = BatchNorm(c)
    bn.load_state_dict(from_jax_params({"params": _np(params), "batch_stats": _np(stats)}))
    bn.train()
    for x in xs:
        def f(p, xx):
            y, upd = jbn.apply({"params": p, "batch_stats": stats}, xx, use_running_average=False,
                               mutable=["batch_stats"])
            return (y * cot).sum(), (y, upd)
        (dp, dx), (y, upd) = jax.grad(f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
        stats = upd["batch_stats"]
        for p in bn.parameters():
            p.grad = None
        tx = T(x).requires_grad_()
        ty = bn(tx)
        (ty * T(cot)).sum().backward()
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), atol=1e-5)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dx), atol=1e-5)
        np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(dp["scale"]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(dp["bias"]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), atol=1e-6)

    ref = torch.nn.BatchNorm2d(c, momentum=0.1)
    ref(T(xs[0]).permute(0, 3, 1, 2))
    biased = xs[0].reshape(-1, c).var(axis=0)
    np.testing.assert_allclose(ref.running_var.numpy(), 0.9 + 0.1 * biased * n / (n - 1), rtol=1e-5)

    bn.eval()
    before = (bn.running_mean.clone(), bn.running_var.clone())
    want = jbn.apply({"params": params, "batch_stats": stats}, jnp.asarray(xs[0]),
                     use_running_average=True)
    with torch.no_grad():
        got = bn(T(xs[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert torch.equal(bn.running_mean, before[0]) and torch.equal(bn.running_var, before[1])


# ------------------------------------------------------------------ eig2x2


def test_eig2x2_gradients_at_ties_match_jax():
    """Gradients of `eigh_2x2` and `sqrt_psd_2x2` against `jax.grad` at exact
    ties of their `maximum`s (isotropic, zero, rank-1 covariances) and near
    them: equal (1e-3 of 1 + |g|: near a tie the gradient carries 1 / (the
    eigenvalue gap), which amplifies fp32 rounding), or non-finite at the
    same elements in both."""
    rng = np.random.RandomState(3)
    a = rng.standard_normal((16, 2, 2)).astype(np.float32)
    special = np.array([
        [[2.0, 0.0], [0.0, 2.0]], [[0.0, 0.0], [0.0, 0.0]], [[1.0, 1.0], [1.0, 1.0]],
        [[4.0, 2.0], [2.0, 1.0]], [[1.0, 0.0], [0.0, 0.0]], [[1e-12, 0.0], [0.0, 1e-12]],
        [[3.0, 1e-9], [1e-9, 1.0]], [[1.0, 0.999], [0.999, 1.0]], [[1.0, 1e-4], [1e-4, 1.0]],
    ], np.float32)
    covar = np.concatenate([a @ a.transpose(0, 2, 1), special])
    cot = rng.standard_normal(covar.shape).astype(np.float32)
    for name in ("sqrt_psd_2x2", "eigh_2x2"):
        def jf(cv):
            out = getattr(jeig, name)(cv)
            return ((out if name == "sqrt_psd_2x2" else out[0]) * cot).sum()
        want = np.asarray(jax.grad(jf)(jnp.asarray(covar)))
        t = T(covar).requires_grad_()
        out = getattr(eig2x2, name)(t)
        ((out if name == "sqrt_psd_2x2" else out[0]) * T(cot)).sum().backward()
        got = t.grad.numpy()
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want), err_msg=name)
        fin = np.isfinite(want)
        assert (~fin).any(), "the ties reach sqrt at 0"
        np.testing.assert_allclose(got[fin], want[fin], atol=1e-3, rtol=1e-3, err_msg=name)


# ------------------------------------------------------------------ TPS


@pytest.mark.parametrize("tps", [True, False])
def test_tps_transform_matches_jax(tps):
    """`warp_coordinates`, `jacobian` (rows: the output coordinate; against
    `jax.jacfwd`, with coordinates on a control point's x or y, where
    d|x|/dx is +1 as in JAX) and its gradient in the coordinates, and
    `transform_frame` (reflection padding), with injected parameters and
    a theta that is not symmetric. 1e-5 (1e-4 for the gradient)."""
    rng = np.random.RandomState(4)
    theta, cpar = _tps_params(rng, 2, sigma_affine=0.3)
    jt, tt = _both_tps(theta, cpar if tps else None)
    coords = rng.uniform(-1, 1, (2, 9, 2)).astype(np.float32)
    coords[0, :4] = [[0.0, 0.3], [-0.5, 0.5], [1.0, -1.0], [0.25, 0.0]]  # on control-point lines
    np.testing.assert_allclose(tt.warp_coordinates(T(coords)).numpy(),
                               np.asarray(jax.jit(jt.warp_coordinates)(jnp.asarray(coords))), atol=1e-5)
    want = np.asarray(jax.jit(jt.jacobian)(jnp.asarray(coords)))
    tc = T(coords).requires_grad_()
    jac = tt.jacobian(tc)
    assert jac.shape == (2, 9, 2, 2)
    np.testing.assert_allclose(jac.detach().numpy(), want, atol=1e-5)
    if tps:  # the affine jacobian does not depend on the coordinates
        cot = rng.standard_normal(want.shape).astype(np.float32)
        (jac * T(cot)).sum().backward()
        dj = jax.jit(jax.grad(lambda c: (jt.jacobian(c) * cot).sum()))(jnp.asarray(coords))
        np.testing.assert_allclose(tc.grad.numpy(), np.asarray(dj), atol=1e-4)
    frame = rng.uniform(size=(2, 16, 12, 3)).astype(np.float32)
    np.testing.assert_allclose(tt.transform_frame(T(frame)).numpy(),
                               np.asarray(jax.jit(jt.transform_frame)(jnp.asarray(frame))), atol=1e-5)


def test_tps_sample_is_seeded_and_shaped():
    g = lambda: torch.Generator().manual_seed(11)
    a = tlosses.TPSTransform.sample(g(), 3, 0.05, 0.005, 5)
    b = tlosses.TPSTransform.sample(g(), 3, 0.05, 0.005, 5)
    assert a.theta.shape == (3, 2, 3) and a.control_params.shape == (3, 25)
    assert a.control_points.shape == (25, 2)
    assert torch.equal(a.theta, b.theta) and torch.equal(a.control_params, b.control_params)
    assert float((a.theta - torch.eye(2, 3)).abs().max()) < 0.05 * 6
    affine = tlosses.TPSTransform.sample(g(), 3, 0.05)
    assert affine.control_points is None and torch.equal(affine.theta, a.theta)


# ------------------------------------------------------------------ VGG and the perceptual loss


def _vgg_pair(seed=0):
    """The port's seeded VGG19 and its variables in the JAX layout."""
    vgg = Vgg19Features()
    seed_vgg_weights(vgg, seed)
    return vgg, jax.tree.map(jnp.asarray, to_jax_params(vgg.state_dict()))


def test_image_pyramid_and_vgg_match_jax():
    """`image_pyramid` (1e-6) and the VGG19's five outputs, from seeded port
    weights moved to JAX by `to_jax_params` and from JAX init variables moved
    to the port by `from_jax_params` (1e-5 of each output's largest value),
    and the gradient of a smooth function of them in the input (1e-5 of its
    largest value)."""
    rng = np.random.RandomState(5)
    x = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    want = jlosses.image_pyramid(jnp.asarray(x), (1.0, 0.5, 0.25))
    got = tlosses.image_pyramid(T(x), (1.0, 0.5, 0.25))
    for s in want:
        np.testing.assert_allclose(got[s].numpy(), np.asarray(want[s]), atol=1e-6)
    vgg, jvars = _vgg_pair()
    init_vars = jax.jit(jvgg.Vgg19Features().init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    other = Vgg19Features()
    other.load_state_dict(from_jax_params(_np(init_vars)))
    apply = jax.jit(jvgg.Vgg19Features().apply)
    for net, variables in ((vgg, jvars), (other, init_vars)):
        want = apply(variables, jnp.asarray(x))
        with torch.no_grad():
            got = net(T(x))
        assert [tuple(g.shape) for g in got] == [(2, 32, 32, 64), (2, 16, 16, 128), (2, 8, 8, 256),
                                                 (2, 4, 4, 512), (2, 2, 2, 512)]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5 * float(np.abs(w).max()))
    cots = [rng.standard_normal(w.shape).astype(np.float32) for w in want]
    jg = np.asarray(jax.jit(jax.grad(lambda v: sum((f * c).sum() for f, c in zip(
        jvgg.Vgg19Features().apply(jvars, v), cots))))(jnp.asarray(x)))
    tx = T(x).requires_grad_()
    sum((f * T(c)).sum() for f, c in zip(vgg(tx), cots)).backward()
    np.testing.assert_allclose(tx.grad.numpy(), jg, atol=1e-5 * float(np.abs(jg).max()))


def test_perceptual_pyramid_loss_matches_jax():
    """The loss at 64² with the recipe's scales cut to those VGG19 takes
    (1, 0.5, 0.25): value 1e-5 relative; the gradient in the prediction to
    2% of its norm (the L1's kink, see the module docstring: a feature on
    the other side spreads its change over the pixels its conv stack reads;
    the VGG's own gradient is held to 1e-5 above); none reaches the
    target."""
    rng = np.random.RandomState(6)
    pred = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    tgt = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    vgg, jvars = _vgg_pair()
    scales, weights = (1.0, 0.5, 0.25), (10.0,) * 5
    jfn = lambda p, t: jlosses.perceptual_pyramid_loss(
        lambda v: jvgg.Vgg19Features().apply(jvars, v), p, t, scales, weights)
    want, (jg, jt) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1)))(jnp.asarray(pred), jnp.asarray(tgt))
    assert float(jnp.abs(jt).max()) == 0.0
    tp, tt = T(pred).requires_grad_(), T(tgt).requires_grad_()
    got = tlosses.perceptual_pyramid_loss(vgg, tp, tt, scales, weights)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert tt.grad is None
    jg = np.asarray(jg)
    err = np.linalg.norm(tp.grad.numpy() - jg) / np.linalg.norm(jg)
    assert err <= 2e-2, err


@pytest.mark.parametrize("revert_axis_swap", [True, False])
def test_equivariance_losses_match_jax(revert_axis_swap):
    """Both losses and their gradients in the four region-parameter inputs,
    with a TPS transform of non-symmetric theta. 1e-5 (values), 1e-4
    (gradients)."""
    rng = np.random.RandomState(7)
    theta, cpar = _tps_params(rng, 2, sigma_affine=0.2)
    jt, tt = _both_tps(theta, cpar)

    def params():
        a = (rng.standard_normal((2, K, 2, 2)) * 0.3).astype(np.float32)
        a[:, :2] *= -1  # some regions with a negative leading entry (the axis swap)
        return {"shift": rng.uniform(-0.7, 0.7, (2, K, 2)).astype(np.float32), "affine": a}

    d, t = params(), params()

    def jf(d_, t_):
        return jlosses.equivariance_losses(d_, t_, jt, revert_axis_swap)

    jd, jt_ = jax.tree.map(jnp.asarray, d), jax.tree.map(jnp.asarray, t)
    js, ja = jax.jit(jf)(jd, jt_)
    jgd, jgt = jax.jit(jax.grad(lambda a, b: jf(a, b)[0] + 0.7 * jf(a, b)[1], argnums=(0, 1)))(jd, jt_)
    td = {k: T(v).requires_grad_() for k, v in d.items()}
    tt_ = {k: T(v).requires_grad_() for k, v in t.items()}
    s, a = tlosses.equivariance_losses(td, tt_, tt, revert_axis_swap)
    np.testing.assert_allclose([float(s), float(a)], [float(js), float(ja)], rtol=1e-5)
    (s + 0.7 * a).backward()
    for k in ("shift", "affine"):
        np.testing.assert_allclose(td[k].grad.numpy(), np.asarray(jgd[k]), atol=1e-4, err_msg=k)
        np.testing.assert_allclose(tt_[k].grad.numpy(), np.asarray(jgt[k]), atol=1e-4, err_msg=k)


# ------------------------------------------------------------------ AVD network


@pytest.mark.parametrize("train", [True, False])
def test_avd_network_matches_jax(train):
    """`AVDNetwork` from JAX init variables (Dense and BatchNorm leaves via
    `from_jax_params`): the reconstructed region parameters (2e-4: three
    1024-wide MLPs) and, in train mode, the running statistics (1e-5)."""
    rng = np.random.RandomState(8)
    b = 6
    def params():
        a = (rng.standard_normal((b, K, 2, 2)) * 0.3 + np.eye(2)).astype(np.float32)
        return {"shift": rng.uniform(-0.5, 0.5, (b, K, 2)).astype(np.float32), "affine": a}
    x_id, x_pose = params(), params()
    j = lambda d: jax.tree.map(jnp.asarray, d)
    jm = javd.AVDNetwork(num_regions=K, id_bottle_size=16, pose_bottle_size=16)
    variables = _random_variables(jax.eval_shape(jm.init, jax.random.PRNGKey(0), j(x_id), j(x_pose)), rng)
    want, upd = jm.apply(variables, j(x_id), j(x_pose), train, mutable=["batch_stats"])
    net = tavd.AVDNetwork(num_regions=K, id_bottle_size=16, pose_bottle_size=16)
    net.load_state_dict(from_jax_params(variables))
    net.train(train)
    with torch.no_grad():
        got = net({k: T(v) for k, v in x_id.items()}, {k: T(v) for k, v in x_pose.items()})
    assert set(got) == {"shift", "affine", "covar"}
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=2e-4, err_msg=k)
    stats = to_jax_params(net.state_dict())["batch_stats"]
    _walk(stats, _np(upd["batch_stats"]), lambda p, a, w: np.testing.assert_allclose(a, w, atol=1e-5, err_msg=p))
    emb = tavd.region_params_to_emb({k: T(v) for k, v in x_id.items()})
    np.testing.assert_array_equal(emb.numpy(), np.asarray(javd.region_params_to_emb(j(x_id))))
    back = tavd.emb_to_region_params(emb, K)
    for k in ("shift", "affine"):
        np.testing.assert_array_equal(back[k].numpy(), x_id[k])


# ------------------------------------------------------------------ FlowAE, LFAEReconstruction


def _lfae_pair(jcfg, rng):
    """JAX LFAE variables (seeded values on `init`'s tree) and the port's
    `LFAEReconstruction` loaded with them."""
    s = jcfg.lfae.frame_shape
    img = jnp.zeros((1, s, s, 3))
    shapes = jax.eval_shape(lambda r: JFlowAE(jcfg.lfae).init(r, img, img, train=False),
                            jax.random.PRNGKey(0))
    variables = _random_variables(shapes, rng)
    net = LFAEReconstruction(_port_cfg(jcfg).lfae)
    net.load_state_dict(from_jax_params(variables))
    return variables, net


def _assert_outputs(got, want, path=""):
    for k in want:
        if isinstance(want[k], dict):
            _assert_outputs(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), atol=2e-4,
                                       err_msg=f"{path}/{k}")


def test_flow_ae_eval_matches_jax():
    """`FlowAE` in eval mode against the JAX `FlowAE` (`train=False`): every
    output (2e-4: a few conv layers, the temperature-0.1 softmax)."""
    rng = np.random.RandomState(9)
    jcfg = _tiny_jcfg()
    variables, net = _lfae_pair(jcfg, rng)
    ref, dri = (rng.uniform(size=(2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    want = _np(jax.jit(lambda v, a, b: JFlowAE(jcfg.lfae).apply(v, a, b, False))(
        variables, jnp.asarray(ref), jnp.asarray(dri)))
    flow_ae = FlowAE(_port_cfg(jcfg).lfae)
    flow_ae.load_state_dict(net.state_dict())
    assert not flow_ae.training
    with torch.no_grad():
        got = flow_ae(T(ref), T(dri))
    assert set(got) == set(want)
    _assert_outputs({k: v if isinstance(v, dict) else v.numpy() for k, v in got.items()}, want)


@pytest.mark.parametrize("outputs", ["motion", "decode"])
def test_lfae_reconstruction_train_forward_and_gradients_match_jax(outputs):
    """`LFAEReconstruction` in train mode (batch statistics, the training
    warp) against the JAX module with `train=True`: every output (2e-4), the
    moved running statistics (1e-5), and the parameter gradients of a fixed
    random projection of some outputs, leaf by leaf to 1e-3 of the leaf's
    largest value (the zero-gradient leaves: below 1e-5 of the largest
    gradient in both).

    `motion`: the dense flow, the occlusion map and the driving and
    transformed region parameters; every leaf. `decode`: the prediction and
    the warped source; the generator's own leaves (not its flow
    predictor). A bilinear warp's derivative in its grid jumps where a
    sample point crosses a pixel centre, and the two frameworks' flows,
    equal to rounding, can straddle one, so the leaves upstream of the flow
    are not compared through the decode; instead the decode's gradient in
    the flow and the occlusion map is held (1e-5 of its largest value) on
    the same flow, JAX's, in `Generator.forward_with_flow` (train mode),
    and `motion` holds everything upstream of the flow."""
    rng = np.random.RandomState(10)
    jcfg = _tiny_jcfg()
    variables, net = _lfae_pair(jcfg, rng)
    src, dri = (rng.uniform(size=(2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    jt, tt = _both_tps(*_tps_params(rng, 2))
    jm = jlt.LFAEReconstruction(jcfg.lfae)
    cot = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    if outputs == "motion":
        cots = {"optical_flow": cot(2, 8, 8, 2), "occlusion_map": cot(2, 8, 8, 1),
                "driving": {"shift": cot(2, K, 2), "affine": cot(2, K, 2, 2)},
                "transformed": {"shift": cot(2, K, 2), "affine": cot(2, K, 2, 2)}}
    else:
        cots = {"prediction": cot(2, 32, 32, 3), "deformed": cot(2, 32, 32, 3)}

    def scalar(gen, dp, tp, to):
        outs = {**gen, "driving": dp, "transformed": tp}
        total = 0.0
        for k, c in cots.items():
            for name, v in (c.items() if isinstance(c, dict) else [(None, c)]):
                out = outs[k][name] if name else outs[k]
                total = total + (out * to(v)).sum()
        return total

    def jf(params):
        (gen, dp, tp), upd = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                      jnp.asarray(src), jnp.asarray(dri), jt, True,
                                      mutable=["batch_stats"])
        return scalar(gen, dp, tp, jnp.asarray), ((gen, dp, tp), upd)

    jgrad, ((jgen, jdp, jtp), upd) = jax.jit(jax.grad(jf, has_aux=True))(variables["params"])
    net.train()
    gen, dp, tp = net(T(src), T(dri), tt)
    scalar(gen, dp, tp, T).backward()
    _assert_outputs({k: v.detach().numpy() for k, v in gen.items()}, _np(jgen))
    for got, want in ((dp, jdp), (tp, jtp)):
        _assert_outputs({k: v.detach().numpy() for k, v in got.items()}, _np(want))
    stats = to_jax_params({k: v for k, v in net.state_dict().items() if "running" in k})
    _walk(stats["batch_stats"], _np(upd["batch_stats"]),
          lambda p, a, w: np.testing.assert_allclose(a, w, atol=1e-5, err_msg=p))
    grads = to_jax_params({k: p.grad if p.grad is not None else torch.zeros_like(p)
                           for k, p in net.named_parameters()})["params"]
    scale = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree.leaves(jgrad))

    def check(path, got, want):
        want = np.asarray(want)
        if _zero_grad_leaf(path):
            assert max(np.abs(got).max(), np.abs(want).max()) <= 1e-5 * scale, path
        elif outputs == "motion" or (path.startswith("/generator/") and "pixelwise" not in path):
            np.testing.assert_allclose(got, want, atol=1e-3 * float(np.abs(want).max()), err_msg=path)

    _walk(grads, _np(jgrad), check)
    if outputs == "decode":  # the decode's gradient in the flow, on JAX's flow
        def jdec(flow, occ):
            out, _ = jm.apply(variables, jnp.asarray(src), flow, occ, True, mutable=["batch_stats"],
                              method=lambda m, *a: m.generator.forward_with_flow(*a))
            return (out["prediction"] * cots["prediction"]).sum() + (out["deformed"] * cots["deformed"]).sum()

        jflow, jocc = jgen["optical_flow"], jgen["occlusion_map"]
        want = jax.jit(jax.grad(jdec, argnums=(0, 1)))(jflow, jocc)
        flow, occ = T(np.asarray(jflow)).requires_grad_(), T(np.asarray(jocc)).requires_grad_()
        out = net.generator.forward_with_flow(T(src), flow, occ)
        ((out["prediction"] * T(cots["prediction"])).sum()
         + (out["deformed"] * T(cots["deformed"])).sum()).backward()
        for got, w in ((flow.grad, want[0]), (occ.grad, want[1])):
            w = np.asarray(w)
            np.testing.assert_allclose(got.numpy(), w, atol=1e-5 * float(np.abs(w).max()))


# ------------------------------------------------------------------ the trainer


def _trainer_pair(jcfg, rng, b=2):
    """The port's trainer (CPU, seeded weights and VGG) and the JAX trainer
    on the same weights (through `to_jax_params`), on a one-device mesh."""
    trainer = LFAETrainer(_port_cfg(jcfg), steps_per_epoch=10, device="cpu")
    state = trainer.init_state(seed=5)
    jtrainer = jlt.LFAETrainer(jcfg, steps_per_epoch=10,
                               vgg_vars=to_jax_params(trainer.vgg.state_dict()), mesh=make_mesh(1))
    jstate = jtrainer.load_state(to_jax_params(trainer.model.state_dict()))
    s = jcfg.lfae.frame_shape
    batch = {k: rng.uniform(size=(b, s, s, 3)).astype(np.float32) for k in ("source", "driving")}
    return trainer, state, jtrainer, jstate, batch


def _zero_grad_leaf(path: str) -> bool:
    """Leaves whose gradient is 0 up to rounding in both frameworks (a conv
    bias ahead of a train-mode BatchNorm, the spatial softmax's `regions`
    bias): Adam moves them +-lr by the sign of rounding noise."""
    return path.endswith(("/conv/bias", "/conv1/bias", "/regions/bias"))


@pytest.mark.parametrize("losses", ["recipe", "equivariance"])
def test_two_trainer_steps_match_jax(losses, monkeypatch):
    """Two `train_step`s against two JAX `LFAETrainer` steps from the same
    weights, batch and injected TPS transform (the JAX `TPSTransform.sample`
    monkeypatched): losses, parameters and `batch_stats`.

    Adam with betas (0.5, 0.999) moves a parameter by at most 1.06·lr a step,
    so two runs whose gradient signs differ part by at most 2.12·lr·steps:
    every parameter is held to that. `equivariance` (perceptual weights 0:
    the smooth part of the loss): losses 1e-5 relative, parameters 1e-6
    (but the zero-gradient leaves), statistics 1e-5 then 2e-4 (those leaves
    shift the means). `recipe` (all three losses): step 1 as above but for
    the L1's kink, on under 1% of the parameters, where the first update
    flips; step 2's losses 1e-3 relative and statistics 1e-3."""
    rng = np.random.RandomState(11)
    jcfg = _tiny_jcfg(perceptual=10.0 if losses == "recipe" else 0.0)
    trainer, state, jtrainer, jstate, batch = _trainer_pair(jcfg, rng)
    theta, cpar = _tps_params(rng, 2)
    jt, tt = _both_tps(theta, cpar)
    monkeypatch.setattr(jlt.TPSTransform, "sample", staticmethod(lambda *a, **k: jt))
    for step in (1, 2):
        jstate, jm = jtrainer.train_step(jstate, jax.random.PRNGKey(step), batch)
        state, m = trainer.train_step(state, None, batch, transform=tt)
        jm = jax.device_get(jm)
        rel = 1e-5 if step == 1 or losses == "equivariance" else 1e-3
        for k in ("perceptual", "equivariance_shift", "equivariance_affine", "total"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rel, atol=1e-7, err_msg=k)
        assert state.step == step == int(jax.device_get(jstate.step))
        ours = to_jax_params(trainer.model.state_dict())
        theirs = _np({"params": jstate.params, "batch_stats": jstate.batch_stats})
        diffs = []

        def check(path, a, w):
            d = np.abs(a - w)
            assert d.max() <= 2.12 * LR * step, (path, d.max())
            if not _zero_grad_leaf(path):
                diffs.append(d.ravel())

        _walk(ours["params"], theirs["params"], check)
        d = np.concatenate(diffs)
        if losses == "equivariance":
            assert d.max() <= 1e-6, d.max()
        elif step == 1:
            assert (d > 1e-6).mean() < 0.01, (d > 1e-6).mean()
        atol = 1e-5 if step == 1 else (2e-4 if losses == "equivariance" else 1e-3)
        _walk(ours["batch_stats"], theirs["batch_stats"],
              lambda p, a, w: np.testing.assert_allclose(a, w, atol=atol, err_msg=p))


def test_fit_resume_replays_the_step_stream(monkeypatch):
    """`fit` from step 0 to 3 against `fit(start_step=1)` to 3 in a fresh
    trainer from the checkpoint written after step 1 (model and optimizer
    state): the same per-step TPS draws (`step_generator(seed, step)`) and
    the same parameters and statistics, bit for bit."""
    cfg = _port_cfg(_tiny_jcfg())
    rng = np.random.RandomState(12)
    batches = [{k: rng.uniform(size=(2, 32, 32, 3)).astype(np.float32) for k in ("source", "driving")}
               for _ in range(3)]
    sample = tlosses.TPSTransform.sample
    drawn = {"straight": [], "resumed": []}
    run = ["straight"]

    def recording(gen, *a, **k):
        t = sample(gen, *a, **k)
        drawn[run[0]].append(t.theta.clone())
        return t

    monkeypatch.setattr(tlosses.TPSTransform, "sample", staticmethod(recording))
    straight = LFAETrainer(cfg, steps_per_epoch=10, device="cpu")
    saved = {}

    def checkpoint(state):
        if state.step == 1:
            saved.update(model=copy.deepcopy(straight.model.state_dict()),
                         optim=copy.deepcopy(straight.optimizer.state_dict()))

    st = straight.fit(straight.init_state(seed=3), iter(batches), 3, seed=7, log_every=0,
                      checkpoint_fn=checkpoint, checkpoint_every=1)
    resumed = LFAETrainer(cfg, steps_per_epoch=10, device="cpu")
    resumed.init_state()
    resumed.model.load_state_dict(saved["model"])
    resumed.optimizer.load_state_dict(saved["optim"])
    run[0] = "resumed"
    rst = resumed.fit(LFAETrainState(step=1), iter(batches[1:]), 3, seed=7, log_every=0, start_step=1)
    assert st.step == rst.step == 3
    assert len(drawn["straight"]) == 3 and len(drawn["resumed"]) == 2
    for a, b in zip(drawn["straight"][1:], drawn["resumed"]):
        assert torch.equal(a, b)
    assert not torch.equal(drawn["straight"][1], drawn["straight"][2])
    assert torch.equal(drawn["straight"][2], sample(step_generator(7, 2, "cpu"), 2, 0.05, 0.005, 5).theta)
    for (k, a), b in zip(straight.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), k


# ------------------------------------------------------------------ weights and entry points


def test_convert_torchvision_vgg19():
    """A seeded synthetic torchvision `features` state_dict: the port's
    conversion loads strictly, keeps OIHW as it is, and equals the JAX
    conversion taken through `from_jax_params`."""
    rng = np.random.RandomState(13)
    vgg = Vgg19Features()
    sd = {}
    for name, p in vgg.state_dict().items():
        idx = name.split(".")[0].removeprefix("conv_")
        sd[f"{idx}.{name.split('.')[1]}"] = torch.from_numpy(
            rng.standard_normal(tuple(p.shape)).astype(np.float32))
    converted = convert_torchvision_vgg19(sd)
    vgg.load_state_dict(converted)
    assert torch.equal(vgg.conv_28.weight, sd["28.weight"])
    via_jax = from_jax_params(jvgg.convert_torchvision_vgg19({k: v.numpy() for k, v in sd.items()}))
    assert set(via_jax) == set(converted)
    for k in converted:
        assert torch.equal(converted[k], via_jax[k]), k
    numpy_sd = convert_torchvision_vgg19({k: v.numpy() for k, v in sd.items()})
    assert all(torch.equal(numpy_sd[k], converted[k]) for k in converted)


def test_weight_bridge_both_ways():
    """`to_jax_params` of the port's `FlowAE`, `AVDNetwork` and VGG19 has the
    JAX `init` tree's keys and shapes, and `from_jax_params` inverts it
    exactly."""
    jcfg = _tiny_jcfg()
    s = jcfg.lfae.frame_shape
    img = jnp.zeros((1, s, s, 3))
    p = {"shift": jnp.zeros((2, K, 2)), "affine": jnp.tile(jnp.eye(2), (2, K, 1, 1))}
    cases = [
        (FlowAE(_port_cfg(jcfg).lfae),
         jax.eval_shape(lambda r: JFlowAE(jcfg.lfae).init(r, img, img, train=False), jax.random.PRNGKey(0))),
        (tavd.AVDNetwork(num_regions=K),
         jax.eval_shape(lambda r: javd.AVDNetwork(num_regions=K).init(r, p, p), jax.random.PRNGKey(0))),
        (Vgg19Features(),
         jax.eval_shape(lambda r: jvgg.Vgg19Features().init(r, jnp.zeros((1, 16, 16, 3))), jax.random.PRNGKey(0))),
    ]
    for net, shapes in cases:
        sd = net.state_dict()
        tree = to_jax_params(sd)

        def same_shape(path, a, w):
            assert a.shape == tuple(w.shape), path

        _walk(tree, shapes, same_shape)
        back = from_jax_params(tree)
        assert set(back) == set(sd)
        for k in sd:
            assert torch.equal(back[k], sd[k]), k


def test_trainer_cpu_entry_point_builds_and_steps():
    """`LFAETrainer(..., device="cpu")` builds, draws its own TPS transform
    and steps; without a card the default device raises."""
    cfg = _port_cfg(_tiny_jcfg())
    trainer = LFAETrainer(cfg, steps_per_epoch=5, device="cpu")
    state = trainer.init_state(seed=0)
    rng = np.random.RandomState(14)
    batch = {k: rng.uniform(size=(2, 32, 32, 3)).astype(np.float32) for k in ("source", "driving")}
    state, m = trainer.train_step(state, step_generator(0, 0, "cpu"), batch)
    assert state.step == 1 and set(m) == {"perceptual", "equivariance_shift", "equivariance_affine", "total"}
    assert all(np.isfinite(float(v)) for v in m.values())
    out = trainer.reconstruct(state, batch["source"], batch["driving"])
    assert out["prediction"].shape == (2, 32, 32, 3) and not trainer.model.training
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LFAETrainer(cfg, steps_per_epoch=5)


def test_warps_selected_by_mode(monkeypatch):
    """In train mode no warp goes through the forward-only `warp_video`
    (the generator's decode and the pixelwise predictor's deformed source
    take `train_warp`); in eval mode all four do."""
    cfg = _port_cfg(_tiny_jcfg())
    net = FlowAE(cfg.lfae)
    calls = []
    real = twarp.warp_video
    monkeypatch.setattr(twarp, "warp_video", lambda *a: calls.append(1) or real(*a))
    rng = np.random.RandomState(15)
    x, y = (T(rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)) for _ in range(2))
    net.train()
    net(x, y)["prediction"].sum().backward()
    assert calls == []
    net.eval()
    with torch.no_grad():
        net(x, y)
    assert len(calls) == 4


# ------------------------------------------------------------------ the golden of the card's step


GOLDEN_KEYS = ("source", "driving", "theta", "control_params", "prediction", "optical_flow",
               "occlusion_map",
               *(f"{w}_{k}" for w in ("source", "driving", "transformed") for k in ("shift", "affine")),
               *(f"{s}_{k}" for s in ("step1", "step2")
                 for k in ("perceptual", "equivariance_shift", "equivariance_affine", "total")))


def test_lfae_golden_file_loads():
    g = np.load(GOLDEN)
    assert int(g["weight_seed"]) == GOLDEN_SEED and set(GOLDEN_KEYS) <= set(g.files)
    assert g["source"].shape == g["driving"].shape == g["prediction"].shape == (2, 128, 128, 3)
    assert g["theta"].shape == (2, 2, 3) and g["control_params"].shape == (2, 25)
    assert g["driving_affine"].shape == (2, 10, 2, 2) and g["optical_flow"].shape == (2, 32, 32, 2)
    for k in GOLDEN_KEYS:
        assert np.isfinite(g[k]).all(), k


def _golden_run(jcfg, seed):
    """The port's full-width trainer (CPU) on the golden's seeded weights,
    and the golden's inputs: smooth seeded frames (an 8x8 uniform field per
    channel, upsampled bicubically and clipped to [0, 1]), as video frames
    are smooth, and TPS parameters. (On white noise a warp's output moves by
    a pixel-to-pixel difference times any rounding-level change of the flow,
    which the two frameworks' flows have.)"""
    rng = np.random.RandomState(seed)
    trainer = LFAETrainer(_port_cfg(jcfg), steps_per_epoch=93, device="cpu", vgg_seed=seed)
    state = trainer.init_state(seed=seed)
    s = jcfg.lfae.frame_shape
    coarse = T(rng.uniform(size=(4, 3, 8, 8)).astype(np.float32))
    frames = torch.nn.functional.interpolate(coarse, size=(s, s), mode="bicubic", align_corners=False)
    frames = frames.clamp(0, 1).permute(0, 2, 3, 1).contiguous().numpy()
    data = {"source": frames[:2], "driving": frames[2:]}
    theta, cpar = _tps_params(rng, 2)
    return trainer, state, data, theta, cpar


def test_write_lfae_golden(monkeypatch):
    """Opt-in (RUN_TORCH_GOLDEN=1): the JAX package's fp32 LFAE step at the
    MUG widths (128², 10 regions, the recipe's losses and scales), B=2, on the
    port's seeded weights (`seed_lfae_weights`, `seed_vgg_weights`) moved by
    `to_jax_params`, with an injected TPS transform: the train-mode
    forward's prediction and region parameters, the losses of step 1 and
    of step 2 (after one Adam update). The golden holds no weights."""
    if os.environ.get("RUN_TORCH_GOLDEN") != "1":
        pytest.skip("writes the golden; set RUN_TORCH_GOLDEN=1")
    jcfg = jconfig.mug_config()
    trainer, _, data, theta, cpar = _golden_run(jcfg, GOLDEN_SEED)
    jt, _ = _both_tps(theta, cpar)
    monkeypatch.setattr(jlt.TPSTransform, "sample", staticmethod(lambda *a, **k: jt))
    jtrainer = jlt.LFAETrainer(jcfg, steps_per_epoch=93,
                               vgg_vars=to_jax_params(trainer.vgg.state_dict()), mesh=make_mesh(1))
    jstate = jtrainer.load_state(to_jax_params(trainer.model.state_dict()))
    _, (_, _, gen) = jax.jit(lambda p, bs: jtrainer._losses(p, bs, jax.random.PRNGKey(0),
                                                            data["source"], data["driving"]))(
        jstate.params, jstate.batch_stats)
    region = jax.jit(lambda p, bs, x: jlt.LFAEReconstruction(jcfg.lfae).apply(
        {"params": p, "batch_stats": bs}, x, method=lambda m, v: m.region_predictor(v, True),
        mutable=["batch_stats"])[0])
    out = {k: np.asarray(gen[k]) for k in ("prediction", "optical_flow", "occlusion_map")}
    for who, x in (("source", data["source"]), ("driving", data["driving"]),
                   ("transformed", np.asarray(jt.transform_frame(jnp.asarray(data["driving"]))))):
        params = jax.device_get(region(jstate.params, jstate.batch_stats, x))
        out.update({f"{who}_shift": params["shift"], f"{who}_affine": params["affine"]})
    for step in (1, 2):
        jstate, m = jtrainer.train_step(jstate, jax.random.PRNGKey(step), data)
        out.update({f"step{step}_{k}": np.float32(v) for k, v in jax.device_get(m).items()})
    np.savez_compressed(GOLDEN, **data, theta=theta, control_params=cpar, weight_seed=GOLDEN_SEED,
                        **{k: np.asarray(v, np.float32) for k, v in out.items()})


def test_lfae_step_matches_golden_on_cpu():
    """Opt-in (RUN_TORCH_LFAE_FULL=1; full width, B=2, ~1 min): the port's
    step on the CPU against the golden, at `chip_smoke.py`'s tolerances."""
    if os.environ.get("RUN_TORCH_LFAE_FULL") != "1":
        pytest.skip("full-width LFAE step on the CPU; set RUN_TORCH_LFAE_FULL=1")
    import chip_smoke

    g = np.load(GOLDEN)
    jcfg = jconfig.mug_config()
    trainer, state, data, theta, cpar = _golden_run(jcfg, int(g["weight_seed"]))
    for k, v in (("source", data["source"]), ("driving", data["driving"]), ("theta", theta),
                 ("control_params", cpar)):
        np.testing.assert_array_equal(v, g[k])
    tt = tlosses.TPSTransform.from_params(T(theta), T(cpar), 5)
    tol = chip_smoke.LFAE_GOLDEN_TOL
    trainer.model.train()
    with torch.no_grad():
        _, out = trainer.losses(None, T(data["source"]), T(data["driving"]), tt)
        out["source_region_params"] = trainer.model.region_predictor(T(data["source"]))
    for k in ("prediction", "optical_flow", "occlusion_map"):
        np.testing.assert_allclose(out[k].numpy(), g[k], atol=tol[k], err_msg=k)
    for who in ("source", "driving", "transformed"):
        for k in ("shift", "affine"):
            np.testing.assert_allclose(out[f"{who}_region_params"][k].numpy(), g[f"{who}_{k}"],
                                       atol=tol["region"], err_msg=f"{who}_{k}")
    for step in (1, 2):
        state, m = trainer.train_step(state, None, data, transform=tt)
        for k, v in m.items():
            rtol = tol["step1_rel"] if step == 1 else tol["step2_rel"][k]
            np.testing.assert_allclose(float(v), float(g[f"step{step}_{k}"]), rtol=rtol, err_msg=k)
