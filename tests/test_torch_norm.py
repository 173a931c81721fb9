"""The port's fused GroupNorm+FiLM+SiLU (cvpr23_lfdm_torch.ops.norm, plain
path) against the JAX package's Pallas kernel in interpret mode and against
the unfused flax `Block`, on the CPU.

Inputs and affine parameters come from seeded numpy. fp32 tolerance 3e-5,
the one the JAX package holds its own kernel to against the flax Block
(same math, fp32 sums in another order); bf16 inputs: the output is rounded
to bf16 once on both sides, so one bf16 ulp (2^-8 relative, 1e-2 absolute
near zero) against the kernel, and the JAX package's own 0.03 against the
fp32 flax Block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr23_lfdm_tpu.models.unet3d import Block as JBlock
from cvpr23_lfdm_tpu.ops.norm_pallas import groupnorm_film_silu as jgn
from cvpr23_lfdm_torch.models.unet3d import Block
from cvpr23_lfdm_torch.ops import norm as tnorm
from cvpr23_lfdm_torch.utils.bench_ckpt import from_jax_params


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, b, f, h, w, c):
    rng = np.random.default_rng(seed)
    x = (1.5 * rng.standard_normal((b, f, h, w, c)) + 0.3).astype(np.float32)
    gamma = (1 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.2 * rng.standard_normal(c)).astype(np.float32)
    scale = rng.standard_normal((b, c)).astype(np.float32)
    shift = rng.standard_normal((b, c)).astype(np.float32)
    return x, gamma, beta, scale, shift


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("shape,groups", [((2, 3, 4, 4, 16), 8), ((1, 2, 3, 5, 24), 4)])
def test_groupnorm_film_silu_matches_pallas(shape, groups, film, dtype):
    x, gamma, beta, scale, shift = _inputs(11, *shape)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = _t(x).to(getattr(torch, dtype))
    jfilm = (jnp.asarray(scale), jnp.asarray(shift)) if film else (None, None)
    tfilm = (_t(scale), _t(shift)) if film else (None, None)
    ref = jgn(jx, jnp.asarray(gamma), jnp.asarray(beta), *jfilm, groups=groups, interpret=True)
    out = tnorm.groupnorm_film_silu(tx, _t(gamma), _t(beta), *tfilm, groups=groups)
    assert out.shape == shape and out.dtype == tx.dtype
    ref = np.asarray(ref.astype(jnp.float32))
    atol, rtol = (3e-5, 0) if dtype == "float32" else (1e-2, 2 ** -7)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("film", [False, True])
def test_fused_block_matches_unfused_jax_block(film, dtype):
    """The port's `Block(fused_norm=True)` == the JAX `Block(fused_norm=
    False)` with random conv, scale and bias, weights bridged by
    `from_jax_params`; the FiLM pair arrives as `[B, 1, 1, 1, C]`. The bf16
    case holds the port's bf16-compute block (bf16 conv and output) to the
    fp32 JAX block at 0.03 absolute, as the JAX package's own test does,
    plus two bf16 ulps (2^-6 relative) for the FiLM-scaled values above 1.
    The conv has a bias of the output's scale: in fp32 it stays inside the
    convolution, in bf16 the fused chain adds it (`pre_bias`)."""
    rng = np.random.default_rng(12)
    b, f, h, w, cin, c = 2, 3, 6, 6, 5, 16
    x = rng.standard_normal((b, f, h, w, cin)).astype(np.float32)
    ss = tuple(rng.standard_normal((b, 1, 1, 1, c)).astype(np.float32) for _ in range(2))
    jm = JBlock(c, groups=8)
    shapes = jax.eval_shape(lambda r: jm.init(r, jnp.asarray(x)), jax.random.PRNGKey(0))
    variables = jax.tree.map(
        lambda v: (rng.standard_normal(v.shape) / np.sqrt(max(1, np.prod(v.shape[:-1])))).astype(np.float32),
        shapes)
    variables["params"]["norm"]["scale"] = (1 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    variables["params"]["proj"]["conv"]["bias"] = (0.8 * rng.standard_normal(c)).astype(np.float32)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), tuple(map(jnp.asarray, ss)) if film else None))
    tdt = getattr(torch, dtype)
    blk = Block(cin, c, groups=8, dtype=tdt, fused_norm=True)
    blk.load_state_dict(from_jax_params(variables))
    assert (blk.proj.product(_t(x))[1] is None) == (dtype == "float32")
    with torch.no_grad():
        out = blk(_t(x), tuple(map(_t, ss)) if film else None)
    assert out.dtype == tdt
    atol, rtol = (3e-5, 0) if dtype == "float32" else (0.03, 2 ** -6)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=atol, rtol=rtol)


@pytest.mark.parametrize("film", [False, True])
def test_pre_bias_matches_the_unfused_bf16_chain(film):
    """`groupnorm_film_silu_plain(conv, ..., pre_bias=bias)` on a bf16
    `Block`'s rounded product equals that Block's unfused chain
    (`Conv2d` + `split_bias` -> `GroupNorm` -> FiLM -> SiLU, each in bf16)
    up to the chain's own roundings: the unfused chain rounds the
    normalised value, the FiLM product and sum and the SiLU to bf16, the
    fused one only its result. Those four roundings of values up to ~4 are
    held at 2^-5 absolute and 2^-6 relative; the bias add itself is
    bit-equal to the chain's."""
    torch.manual_seed(3)
    b, f, hw, cin, c = 2, 3, 6, 8, 32
    blk = Block(cin, c, groups=8, dtype=torch.bfloat16)
    with torch.no_grad():
        blk.proj.conv.bias.copy_(torch.randn(c))
        blk.norm.weight.copy_(1 + 0.3 * torch.randn(c))
        blk.norm.bias.copy_(0.2 * torch.randn(c))
    x = torch.randn(b, f, hw, hw, cin)
    ss = tuple(torch.randn(b, 1, 1, 1, c).bfloat16() for _ in range(2)) if film else None
    with torch.no_grad():
        want = blk(x, ss)
        conv, after = blk.proj.product(x)
        assert conv.dtype == after.dtype == torch.bfloat16
        args = (blk.norm.weight, blk.norm.bias, *(ss or (None, None)))
        got = tnorm.groupnorm_film_silu_plain(conv, *args, pre_bias=after)
        # the bias add is the chain's own: x + pre_bias rounded once to bf16
        assert torch.equal(got, tnorm.groupnorm_film_silu_plain(conv + after, *args))
        unbiased = tnorm.groupnorm_film_silu_plain(conv, *args)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=2 ** -5, rtol=2 ** -6)
    assert (unbiased.float() - want.float()).abs().max() > 0.1  # the bias matters


def test_variance_that_cancels_below_zero_is_clamped():
    """A constant group whose fp32 `E[x²] − mean²` cancels below −eps: the
    variance is clamped at 0 (as flax's GroupNorm and the unfused `Block`),
    so the output is finite where the unclamped rsqrt would be NaN."""
    groups, eps = 8, 1e-5
    x = torch.full((1, 2, 4, 4, 16), 370.1754455566406)
    xf = x.reshape(1, -1, 16)
    cnt = float(xf.shape[1] * 16 // groups)
    s_g = xf.sum(dim=1).reshape(1, groups, -1).sum(dim=-1)
    ss_g = (xf * xf).sum(dim=1).reshape(1, groups, -1).sum(dim=-1)
    assert (ss_g / cnt - (s_g / cnt) ** 2).max() < -eps  # the case is real
    gamma, beta = torch.ones(16), 0.5 * torch.ones(16)
    scale, shift = torch.zeros(1, 16), torch.zeros(1, 16)
    for dtype in (torch.float32, torch.bfloat16):
        out = tnorm.groupnorm_film_silu_plain(x.to(dtype), gamma, beta, scale, shift, groups, eps,
                                              pre_bias=torch.zeros(16))
        assert torch.isfinite(out).all(), dtype


def test_groupnorm_film_silu_checks_arguments_on_other_devices():
    x = torch.empty((1, 2, 4, 4, 16), device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        tnorm.groupnorm_film_silu(x, x, x)
    # the plain version is differentiable (the kernel is forward-only)
    xs = torch.randn(1, 2, 3, 3, 8, requires_grad=True)
    tnorm.groupnorm_film_silu(xs, torch.ones(8), torch.zeros(8), groups=4).sum().backward()
    assert xs.grad is not None and torch.isfinite(xs.grad).all()
    assert tnorm.groupnorm_film_silu.launches == 0
