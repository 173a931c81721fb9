"""The port's Generator serving entry points against the JAX Generator, on
the CPU at fp32: `compute_fea` and `decode_video_with_flow` (warp plan with
skips, per-scale flow/occlusion resize, blends, final sigmoid).

Weights come from the JAX `init`, with random BatchNorm statistics, and go
across with `from_jax_params`. Tolerances: 1e-4 max-abs on features that
pass through ~13 conv layers of fp32 sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr23_lfdm_tpu.config import GeneratorConfig, LFAEConfig
from cvpr23_lfdm_tpu.models.flow_autoenc import build_lfae_modules
from cvpr23_lfdm_tpu.models.generator import Generator as JGenerator
from cvpr23_lfdm_torch.models.generator import Generator
from cvpr23_lfdm_torch.utils.bench_ckpt import from_jax_params


def _setup(warp_impl):
    cfg = LFAEConfig(frame_shape=64, warp_impl=warp_impl,
                     generator=GeneratorConfig(num_bottleneck_blocks=2))
    jgen = build_lfae_modules(cfg)[2]
    rng = np.random.RandomState(0)
    b, f = 1, 3
    img = rng.uniform(size=(b, 64, 64, 3)).astype(np.float32)
    base = np.stack(np.meshgrid(np.linspace(-1, 1, 16), np.linspace(-1, 1, 16)), -1)
    flow = (base[None, None] + rng.uniform(-0.2, 0.2, (b, f, 16, 16, 2))).astype(np.float32)
    occ = rng.uniform(size=(b, f, 16, 16, 1)).astype(np.float32)
    variables = jax.device_get(jax.jit(lambda r: jgen.init(
        r, jnp.asarray(img), jnp.asarray(flow), jnp.asarray(occ),
        method=JGenerator.decode_video_with_flow,
    ))(jax.random.PRNGKey(0)))
    variables = jax.tree.map(np.array, variables)
    for name, bn in variables["batch_stats"].items():
        for sub in bn.values():
            sub["mean"] = (0.1 * rng.standard_normal(sub["mean"].shape)).astype(np.float32)
            sub["var"] = rng.uniform(0.5, 1.5, sub["var"].shape).astype(np.float32)
    gen = Generator(num_bottleneck_blocks=2)
    gen.load_state_dict(from_jax_params(variables))
    return jgen, variables, gen, img, flow, occ


def test_compute_fea_matches_jax():
    jgen, variables, gen, img, _, _ = _setup("xla")
    ref = jgen.apply(variables, jnp.asarray(img), method=JGenerator.compute_fea)
    out = gen.compute_fea(torch.from_numpy(img))
    assert out.shape == (1, 16, 16, 256)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("warp_impl", ["xla", "tiled"])
def test_decode_video_with_flow_matches_jax(warp_impl):
    """Against the JAX gather warp and the tiled Pallas warp (interpret)."""
    jgen, variables, gen, img, flow, occ = _setup(warp_impl)
    ref = jax.jit(lambda v, i, f, o: jgen.apply(
        v, i, f, o, method=JGenerator.decode_video_with_flow))(
        variables, jnp.asarray(img), jnp.asarray(flow), jnp.asarray(occ))
    with torch.no_grad():
        out = gen.decode_video_with_flow(
            torch.from_numpy(img), torch.from_numpy(flow), torch.from_numpy(occ))
    for key in ("prediction", "deformed", "bottle_neck_feat"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-4, err_msg=key)
    assert out["prediction"].shape == (1, 3, 64, 64, 3)


@pytest.mark.parametrize("warp_impl", ["xla", "tiled"])
def test_no_skip_decode_matches_jax(warp_impl):
    """`skips=False`, the JAX package's no-skip decode: the bottleneck warp
    alone, no skip blends, `deformed` the source warped at full resolution;
    the JAX no-skip generator's parameters through `from_jax_params`; band
    mode refused."""
    from cvpr23_lfdm_torch.models.generator import shard_generator

    cfg = LFAEConfig(frame_shape=64, warp_impl=warp_impl,
                     generator=GeneratorConfig(num_bottleneck_blocks=2, skips=False))
    jgen = build_lfae_modules(cfg)[2]
    _, variables, _, img, flow, occ = _setup(warp_impl)
    jvars = jax.device_get(jax.jit(lambda r: jgen.init(
        r, jnp.asarray(img), jnp.asarray(flow), jnp.asarray(occ),
        method=JGenerator.decode_video_with_flow))(jax.random.PRNGKey(1)))
    assert jax.tree.map(np.shape, jvars) == jax.tree.map(np.shape, variables)
    ref = jax.jit(lambda v, i, f, o: jgen.apply(
        v, i, f, o, method=JGenerator.decode_video_with_flow))(
        variables, jnp.asarray(img), jnp.asarray(flow), jnp.asarray(occ))
    gen = Generator(num_bottleneck_blocks=2, skips=False)
    gen.load_state_dict(from_jax_params(variables))
    with torch.no_grad():
        out = gen.decode_video_with_flow(
            torch.from_numpy(img), torch.from_numpy(flow), torch.from_numpy(occ))
    for key in ("prediction", "deformed", "bottle_neck_feat"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-4, err_msg=key)
    assert out["prediction"].shape == out["deformed"].shape == (1, 3, 64, 64, 3)
    with_skips = Generator(num_bottleneck_blocks=2)
    with_skips.load_state_dict(gen.state_dict())
    with torch.no_grad():
        assert not torch.allclose(with_skips.decode_video_with_flow(
            torch.from_numpy(img), torch.from_numpy(flow), torch.from_numpy(occ))["prediction"],
            out["prediction"], atol=1e-3)
    with pytest.raises(ValueError, match="skips=False"):
        shard_generator(gen, type("Mesh", (), {"space_size": 2})())
