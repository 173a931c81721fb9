"""Port ops (cvpr23_lfdm_torch.ops) against the JAX package's ops, on the CPU.

Inputs come from seeded numpy. fp32 throughout; tolerances are a few fp32
ulps of the compared values unless stated.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr23_lfdm_tpu.ops import grid as jgrid
from cvpr23_lfdm_tpu.ops import quantile as jquantile
from cvpr23_lfdm_tpu.ops import resize as jresize
from cvpr23_lfdm_tpu.ops import warp as jwarp
from cvpr23_lfdm_tpu.ops.warp_pallas import warp_gather as jwarp_gather
from cvpr23_lfdm_tpu.ops.warp_pallas import warp_onehot as jwarp_onehot
from cvpr23_lfdm_tpu.ops.warp_pallas import warp_video_tiled
from cvpr23_lfdm_torch.ops import grid as tgrid
from cvpr23_lfdm_torch.ops import quantile as tquantile
from cvpr23_lfdm_torch.ops import resize as tresize
from cvpr23_lfdm_torch.ops import warp as twarp


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("src,dst", [((8, 8), (16, 16)), ((32, 32), (64, 64)),
                                     ((16, 12), (5, 7)), ((32, 32), (128, 128))])
def test_resize_bilinear_matches_jax(src, dst):
    # 1e-6: same separable lerp, identical op order
    x = np.random.RandomState(0).randn(2, *src, 3).astype(np.float32)
    ref = np.asarray(jresize.resize_bilinear(jnp.asarray(x), dst))
    out = tresize.resize_bilinear(_t(x), dst).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_resize_bilinear_matches_torch_interpolate():
    # the port's resize IS F.interpolate(bilinear, align_corners=False)
    x = np.random.RandomState(1).randn(2, 16, 16, 2).astype(np.float32)
    out = tresize.resize_bilinear(_t(x), (64, 64))
    ref = torch.nn.functional.interpolate(
        _t(x).permute(0, 3, 1, 2), size=(64, 64), mode="bilinear", align_corners=False
    ).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6)


def test_pool_and_nearest_match_jax():
    # exact: repeats and a 4-term mean
    x = np.random.RandomState(2).randn(2, 8, 6, 5).astype(np.float32)
    np.testing.assert_array_equal(
        tresize.upsample_nearest_2x(_t(x)).numpy(),
        np.asarray(jresize.upsample_nearest_2x(jnp.asarray(x))),
    )
    np.testing.assert_allclose(
        tresize.avg_pool_2x2(_t(x)).numpy(),
        np.asarray(jresize.avg_pool_2x2(jnp.asarray(x))), atol=1e-6,
    )


def test_grids_match_jax():
    # exact: same arange/divide arithmetic
    np.testing.assert_array_equal(
        tgrid.make_coordinate_grid((5, 7)).numpy(),
        np.asarray(jgrid.make_coordinate_grid((5, 7))),
    )
    np.testing.assert_array_equal(
        tgrid.identity_flow_volume(2, 3, 4, 6).numpy(),
        np.asarray(jgrid.identity_flow_volume(2, 3, 4, 6)),
    )


def test_grid_sample_matches_jax():
    # 1e-5: fp32 bilinear weights, 4-term sums in another order
    rng = np.random.RandomState(3)
    img = rng.randn(2, 9, 11, 3).astype(np.float32)
    grid = rng.uniform(-1.7, 1.7, size=(2, 6, 5, 2)).astype(np.float32)
    ref = np.asarray(jwarp.grid_sample(jnp.asarray(img), jnp.asarray(grid)))
    out = twarp.grid_sample(_t(img), _t(grid)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_warp_video_matches_jax_tiled_kernel_at_32():
    """The plain warp == the Pallas `warp_video_tiled` (interpret mode) at
    the 32² decode scale, where its window is the whole frame."""
    # 1e-5: the TPU kernel's one-hot matmul sums the same 4 weighted corners
    rng = np.random.RandomState(4)
    b, f, h, w, c = 1, 3, 32, 32, 8
    img = rng.randn(b, h, w, c).astype(np.float32)
    base = np.asarray(jgrid.identity_flow_volume(b, f, h, w))
    g5 = (base + rng.uniform(-0.3, 0.3, size=base.shape)).astype(np.float32)
    ref = np.asarray(warp_video_tiled(jnp.asarray(img), jnp.asarray(g5), interpret=True))
    out = twarp.warp_video(_t(img), _t(g5)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_warp_video_exact_for_wild_flow():
    """No fit check: flows far outside any TPU window still match the
    gather warp, including out-of-image corners (zeros padding)."""
    rng = np.random.RandomState(5)
    b, f, h, w, c = 2, 2, 16, 16, 4
    img = rng.randn(b, h, w, c).astype(np.float32)
    g5 = rng.uniform(-1.5, 1.5, size=(b, f, h, w, 2)).astype(np.float32)
    ref = np.asarray(jwarp.grid_sample(jnp.asarray(img), jnp.asarray(g5.reshape(b, f * h, w, 2))))
    out = twarp.warp_video(_t(img), _t(g5)).numpy()
    np.testing.assert_allclose(out, ref.reshape(out.shape), atol=1e-5)


@pytest.mark.parametrize("blend", ["none", "occlusion", "previous"])
@pytest.mark.parametrize("name", ["warp_onehot", "warp_gather"])
def test_warp_blend_matches_jax_kernels(name, blend):
    """`warp_onehot` / `warp_gather` (plain path) == the Pallas kernels of
    the same names in interpret mode, for the three blends, with sample
    points up to half a frame outside the image (zero-weight corners) and
    bf16 inputs for one of them (everything is cast to fp32, fp32 out)."""
    # 1e-5: fp32 bilinear weights, the 4 corners summed in the same order
    rng = np.random.RandomState(7)
    b, h, w, c = 2, 8, 12, 5
    img = rng.randn(b, h, w, c).astype(np.float32)
    grid = rng.uniform(-1.5, 1.5, size=(b, h, w, 2)).astype(np.float32)
    grid[0, 0, 0] = (-1.0, 1.0)  # lands exactly on a pixel-edge
    occ = rng.uniform(size=(b, h, w, 1)).astype(np.float32) if blend != "none" else None
    prev = rng.randn(b, h, w, c).astype(np.float32) if blend == "previous" else None
    jfn, tfn = {"warp_onehot": (jwarp_onehot, twarp.warp_onehot),
                "warp_gather": (jwarp_gather, twarp.warp_gather)}[name]
    low = name == "warp_gather"  # bf16 image and partner, cast inside both wrappers
    jimg = jnp.asarray(img).astype(jnp.bfloat16) if low else jnp.asarray(img)
    timg = _t(img).to(torch.bfloat16) if low else _t(img)
    j = lambda a: None if a is None else jnp.asarray(a)
    t = lambda a: None if a is None else _t(a)
    ref = np.asarray(jfn(jimg, j(grid), j(occ), j(prev), interpret=True))
    out = tfn(timg, t(grid), t(occ), t(prev))
    assert out.dtype == torch.float32 and out.shape == (b, h, w, c)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    # the explicit blend argument overrides the inferred one, as in JAX
    if blend == "previous":
        ref = np.asarray(jfn(jimg, j(grid), j(occ), j(prev), blend="occlusion", interpret=True))
        np.testing.assert_allclose(tfn(timg, t(grid), t(occ), t(prev), blend="occlusion").numpy(),
                                   ref, atol=1e-5)


def test_warp_onehot_has_no_size_cap_and_checks_blend():
    # 40 x 40 > the TPU kernel's 1024-pixel cap
    rng = np.random.RandomState(8)
    img = rng.randn(1, 40, 40, 3).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, size=(1, 40, 40, 2)).astype(np.float32)
    ref = np.asarray(jwarp.grid_sample(jnp.asarray(img), jnp.asarray(grid)))
    np.testing.assert_allclose(twarp.warp_onehot(_t(img), _t(grid)).numpy(), ref, atol=1e-5)
    with pytest.raises(ValueError, match="blend"):
        twarp.warp_onehot(_t(img), _t(grid), blend="occlusion")
    with pytest.raises(RuntimeError, match="unsupported device"):
        twarp.warp_gather(torch.empty((1, 4, 4, 2), device="meta"), torch.empty((1, 4, 4, 2), device="meta"))
    assert twarp.warp_onehot.launches == 0 and twarp.warp_gather.launches == 0


def test_warp_video_refuses_other_devices():
    # a wrapper runs its plain version only for CPU tensors
    src = torch.empty((1, 4, 4, 2), device="meta")
    grid = torch.empty((1, 1, 4, 4, 2), device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        twarp.warp_video(src, grid)


@pytest.mark.parametrize("n", [7, 1000, 12288])
def test_quantile_matches_jax(n):
    # exact order statistics; the lerp uses the same fp32 fraction
    x = np.abs(np.random.RandomState(n).randn(3, n)).astype(np.float32)
    x[1, : n // 2] = x[1, 0]  # duplicates
    ref = np.asarray(jquantile.quantile_nonneg(jnp.asarray(x), 0.9))
    out = tquantile.quantile_nonneg(_t(x), 0.9).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_allclose(out, np.quantile(x, 0.9, axis=-1), rtol=1e-6)


def test_quantile_propagates_nan():
    x = np.ones((2, 10), np.float32)
    x[0, 3] = np.nan
    out = tquantile.quantile_nonneg(_t(x), 0.9).numpy()
    assert np.isnan(out[0]) and out[1] == 1.0


def test_dynamic_threshold_matches_jax():
    from cvpr23_lfdm_tpu.diffusion.gaussian_diffusion import dynamic_threshold as jdt
    from cvpr23_lfdm_torch.diffusion.gaussian_diffusion import dynamic_threshold as tdt

    # exact up to one fp32 division
    x = (np.random.RandomState(6).randn(2, 4, 8, 8, 3) * 2).astype(np.float32)
    np.testing.assert_allclose(tdt(_t(x)).numpy(), np.asarray(jdt(jnp.asarray(x))), atol=1e-7)


def test_kernel_counters_table_and_no_count_on_cpu():
    """One table names every kernel wrapper's launch counter; a CPU call
    takes the plain version and counts nothing."""
    from cvpr23_lfdm_torch import ops as tops

    table = tops.kernel_counters()
    assert len(table) == 13 and all(hasattr(fn, attr) for fn, attr in table.values())
    tops.reset_counters()
    rng = np.random.RandomState(8)
    img = _t(rng.randn(1, 4, 4, 3).astype(np.float32))
    grid = _t(rng.uniform(-1, 1, (1, 4, 4, 2)).astype(np.float32))
    twarp.warp_onehot(img, grid)
    twarp.warp_video(img, grid[:, None])
    assert set(tops.read_counters().values()) == {0}
    twarp.warp_gather.launches = 3
    assert tops.read_counters()["warp_gather"] == 3
    tops.reset_counters()
    assert tops.read_counters()["warp_gather"] == 0
