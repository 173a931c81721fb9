"""The port's head-packed temporal attention (plain forward and backward,
the CPU path of `ops.attention.headpacked_temporal_attention`) against the
JAX package: the Pallas kernel pair in interpret mode
(`headpacked_temporal_attention(..., interpret=True)` and its custom-VJP
backward) and the XLA einsum attention of `TemporalAttention(impl="xla")`.

Inputs come from a numpy seed and go through both. Sizes: B=2, F=5 or 7,
HW=6, 2 heads x 32 (the port's kernels need d=32; the plain version takes
any d and the XLA comparison also runs d=8); against the interpret kernel
also the training step's F=40 and F=33, at HW=2.

Tolerances. fp32 forward 2e-5 and gradients 2e-4 max-abs, the bounds of the
JAX package's own tests of its kernel against XLA
(`tests/test_attention_pallas.py`): the same sums in another order. bf16:
both sides round to bf16 at the same points, so a value moves by at most a
few bf16 ulps (2^-8 relative) when an input lands on the other side of a
rounding boundary: 4 ulps of the largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr23_lfdm_tpu.models.unet3d import TemporalAttention as JTemporalAttention
from cvpr23_lfdm_tpu.ops import attention_pallas as JA
from cvpr23_lfdm_torch.ops import _build
from cvpr23_lfdm_torch.ops import attention as A

HEADS, DH = 2, 32
BF16_ULP = 2.0 ** -8


def _inputs(seed, b=2, f=5, hw=6, heads=HEADS, dh=DH, bias_gap=0.0):
    rng = np.random.RandomState(seed)
    qkv = rng.standard_normal((b, f, hw, 3 * heads * dh)).astype(np.float32)
    pos_bias = rng.standard_normal((heads, f, f)).astype(np.float32)
    pos_bias[0] += bias_gap
    do = rng.standard_normal((b, f, hw, heads * dh)).astype(np.float32)
    return qkv, pos_bias, do


def _jax_tables(f, heads, dh, dtype):
    return JA.rotary_tables(f, heads, dh, dh ** -0.5, dtype)


def _jax_kernel(qkv, bias_flat, heads, dh):
    cos_t, sin_t = _jax_tables(qkv.shape[1], heads, dh, qkv.dtype)
    return JA.headpacked_temporal_attention(qkv, bias_flat, cos_t, sin_t, heads, dh,
                                            interpret=True)


def _jax_xla(qkv, pos_bias, mask, heads, dh):
    """The XLA attention core of `TemporalAttention(impl="xla")` on a raw
    qkv: identity `to_qkv`/`to_out` are not expressible, so the einsum form
    is repeated here from `models/unet3d.py:220-252`."""
    from cvpr23_lfdm_tpu.models.unet3d import _rotary_freqs, _rotate_half_interleaved

    b, f, hw, _ = qkv.shape
    x = qkv.reshape(b, f, hw, 3, heads, dh)
    q, k, v = x[..., 0, :, :], x[..., 1, :, :], x[..., 2, :, :]
    q = q * dh ** -0.5
    cos, sin = _rotary_freqs(min(32, dh), f)
    cos, sin = cos[None, :, None, None, :], sin[None, :, None, None, :]
    q = q * cos + _rotate_half_interleaved(q) * sin
    k = k * cos + _rotate_half_interleaved(k) * sin
    sim = jnp.einsum("bixhd,bjxhd->bxhij", q, k) + pos_bias[None, None]
    if mask is not None:
        keep = jnp.where(mask[:, None, None, None, None], jnp.eye(f, dtype=bool)[None, None, None], True)
        sim = jnp.where(keep, sim, jnp.finfo(jnp.float32).min)
    attn = jax.nn.softmax(sim, axis=-1)
    return jnp.einsum("bxhij,bjxhd->bixhd", attn, v).reshape(b, f, hw, heads * dh)


def _torch_run(qkv, pos_bias, mask, do, heads, dh, dtype=torch.float32):
    """Port forward and gradients w.r.t. qkv and pos_bias (through
    `build_bias_flat`)."""
    b, f = qkv.shape[:2]
    q = torch.from_numpy(qkv).to(dtype).requires_grad_()
    pb = torch.from_numpy(pos_bias).requires_grad_()
    m = None if mask is None else torch.from_numpy(mask)
    bias = A.build_bias_flat(pb, b, f, m)
    cos_t, sin_t = A.rotary_tables(f, heads, dh, dh ** -0.5, dtype)
    out = A.headpacked_temporal_attention(q, bias, cos_t, sin_t, heads, dh)
    out.backward(torch.from_numpy(do).to(dtype))
    return out.detach().float().numpy(), q.grad.float().numpy(), pb.grad.numpy()


@pytest.mark.parametrize("f,focus", [(5, False), (7, False), (5, True), (40, False), (33, False)])
def test_forward_and_grads_match_jax_interpret_kernel(f, focus):
    """F = 40 is the training step's frame count (33: odd, one past a
    multiple of 16, as the card kernels pad); those run at HW = 2."""
    qkv, pos_bias, do = _inputs(0, f=f, hw=2 if f > 32 else 6)
    mask = np.array([True, False]) if focus else None

    def jloss(q, pb):
        bias = JA.build_bias_flat(pb, q.shape[0], f, None if mask is None else jnp.asarray(mask))
        out = _jax_kernel(q, bias, HEADS, DH)
        return jnp.sum(out * do), out

    (_, jout), (jdq, jdpb) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(qkv), jnp.asarray(pos_bias))
    out, dq, dpb = _torch_run(qkv, pos_bias, mask, do, HEADS, DH)
    np.testing.assert_allclose(out, np.asarray(jout), atol=2e-5)
    np.testing.assert_allclose(dq, np.asarray(jdq), atol=2e-4)
    np.testing.assert_allclose(dpb, np.asarray(jdpb), atol=2e-4)


@pytest.mark.parametrize("dh,focus", [(32, False), (8, False), (32, True)])
def test_forward_and_grads_match_jax_xla(dh, focus):
    qkv, pos_bias, do = _inputs(1, dh=dh)
    mask = np.array([False, True]) if focus else None
    jmask = None if mask is None else jnp.asarray(mask)

    def jloss(q, pb):
        out = _jax_xla(q, pb, jmask, HEADS, dh)
        return jnp.sum(out * do), out

    (_, jout), (jdq, jdpb) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(qkv), jnp.asarray(pos_bias))
    out, dq, dpb = _torch_run(qkv, pos_bias, mask, do, HEADS, dh)
    np.testing.assert_allclose(out, np.asarray(jout), atol=2e-5)
    np.testing.assert_allclose(dq, np.asarray(jdq), atol=2e-4)
    np.testing.assert_allclose(dpb, np.asarray(jdpb), atol=2e-4)


def test_extreme_head_bias_gap():
    """A head whose bias level sits ~300 above another's still gives a
    valid softmax in every head (the case of the JAX package's
    `test_headpacked_attention_extreme_head_bias_gap`), forward and
    gradients, against the XLA form (3e-5 as there; gradients 2e-4)."""
    qkv, pos_bias, do = _inputs(7, bias_gap=300.0)

    def jloss(q, pb):
        out = _jax_xla(q, pb, None, HEADS, DH)
        return jnp.sum(out * do), out

    (_, jout), (jdq, jdpb) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(qkv), jnp.asarray(pos_bias))
    out, dq, dpb = _torch_run(qkv, pos_bias, None, do, HEADS, DH)
    assert np.abs(out).max() > 0.1
    np.testing.assert_allclose(out, np.asarray(jout), atol=3e-5)
    np.testing.assert_allclose(dq, np.asarray(jdq), atol=2e-4)
    np.testing.assert_allclose(dpb, np.asarray(jdpb), atol=2e-4)


@pytest.mark.parametrize("f", [5, 40, 33])
def test_bf16_forward_and_grads_within_ulps_of_jax_kernel(f):
    qkv, pos_bias, do = _inputs(3, f=f, hw=2 if f > 32 else 6)
    b, f = qkv.shape[:2]
    to_bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)

    def jloss(q, pb):
        out = _jax_kernel(q, JA.build_bias_flat(pb, b, f), HEADS, DH)
        return jnp.sum(out.astype(jnp.float32) * to_bf(do).astype(jnp.float32)), out

    (_, jout), (jdq, jdpb) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        to_bf(qkv), jnp.asarray(pos_bias))
    out, dq, dpb = _torch_run(qkv, pos_bias, None, do, HEADS, DH, torch.bfloat16)
    for got, want in ((out, jout), (dq, jdq)):
        want = np.asarray(want.astype(jnp.float32))
        assert np.abs(got - want).max() <= 4 * BF16_ULP * np.abs(want).max()
    # dbias is an fp32 sum over pixels of terms that carry bf16 rounding
    want = np.asarray(jdpb)
    assert np.abs(dpb - want).max() <= 4 * BF16_ULP * np.abs(want).max()


def test_plain_version_gradcheck_fp64():
    """The hand-derived backward against finite differences of the forward
    (fp64: the rounding points are exact)."""
    rng = np.random.RandomState(4)
    b, f, hw, heads, dh = 1, 3, 2, 2, 4
    qkv = torch.from_numpy(rng.standard_normal((b, f, hw, 3 * heads * dh))).requires_grad_()
    bias = torch.from_numpy(rng.standard_normal((b, f, heads * f))).requires_grad_()
    cos_t, sin_t = A.rotary_tables(f, heads, dh, dh ** -0.5, torch.float64)
    fn = lambda q, bb: A.headpacked_temporal_attention_plain(q, bb, cos_t, sin_t, heads, dh)
    assert torch.autograd.gradcheck(fn, (qkv, bias), atol=1e-6)


def test_focus_rows_give_zero_not_nan():
    qkv, pos_bias, do = _inputs(5)
    out, dq, dpb = _torch_run(qkv, pos_bias, np.array([True, True]), do, HEADS, DH)
    assert np.isfinite(out).all() and np.isfinite(dq).all() and np.isfinite(dpb).all()
    # focused rows attend to their own frame only: out == rotated v, and the
    # off-diagonal bias gets no gradient
    f = qkv.shape[1]
    off = ~np.eye(f, dtype=bool)
    assert np.abs(dpb[:, off]).max() == 0.0
    v = qkv[..., 2 * HEADS * DH:]
    np.testing.assert_allclose(out, v, atol=1e-6)


def test_bias_needs_no_grad_when_frozen():
    qkv, pos_bias, do = _inputs(6)
    b, f = qkv.shape[:2]
    q = torch.from_numpy(qkv).requires_grad_()
    bias = A.build_bias_flat(torch.from_numpy(pos_bias), b, f)
    cos_t, sin_t = A.rotary_tables(f, HEADS, DH, DH ** -0.5, torch.float32)
    out = A.headpacked_temporal_attention(q, bias, cos_t, sin_t, HEADS, DH)
    out.backward(torch.from_numpy(do))
    assert q.grad is not None and bias.grad is None


def test_build_bias_flat_detaches_row_max_as_jax():
    """Gradient to `pos_bias` through `build_bias_flat` + the attention ==
    `jax.grad` through the JAX `build_bias_flat` + the XLA attention (2e-4,
    as the fp32 gradients above); and the shift alone carries no gradient:
    with a gradient through the row max, the max entry of each row would
    also collect minus the row's sum."""
    qkv, pos_bias, do = _inputs(8)
    b, f = qkv.shape[:2]

    def jloss(pb):
        bias = JA.build_bias_flat(pb, b, f)
        s = bias.reshape(b, f, HEADS, f).transpose(0, 2, 1, 3)[:, None]  # [B,1,h,i,j]
        x = jnp.asarray(qkv).reshape(b, f, -1, 3, HEADS, DH)
        sim = jnp.einsum("bixhd,bjxhd->bxhij", x[..., 0, :, :], x[..., 1, :, :]) + s
        out = jnp.einsum("bxhij,bjxhd->bixhd", jax.nn.softmax(sim, -1), x[..., 2, :, :])
        return jnp.sum(out.reshape(do.shape) * do)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(pos_bias)))

    pb = torch.from_numpy(pos_bias).requires_grad_()
    bias = A.build_bias_flat(pb, b, f)
    s = bias.reshape(b, f, HEADS, f).permute(0, 2, 1, 3)[:, None]
    x = torch.from_numpy(qkv).reshape(b, f, -1, 3, HEADS, DH)
    sim = torch.einsum("bixhd,bjxhd->bxhij", x[..., 0, :, :], x[..., 1, :, :]) + s
    out = torch.einsum("bxhij,bjxhd->bixhd", torch.softmax(sim, -1), x[..., 2, :, :])
    (out.reshape(do.shape) * torch.from_numpy(do)).sum().backward()
    np.testing.assert_allclose(pb.grad.numpy(), want, atol=2e-4)

    # the shift alone: d/d pos_bias of sum(w * build_bias_flat(pos_bias)) is w,
    # with no -sum(w) term at the row's argmax
    w = torch.from_numpy(np.random.RandomState(9).standard_normal((b, f, HEADS * f)).astype(np.float32))
    pb2 = torch.from_numpy(pos_bias).requires_grad_()
    (A.build_bias_flat(pb2, b, f) * w).sum().backward()
    want_w = w.sum(0).reshape(f, HEADS, f).permute(1, 0, 2)
    torch.testing.assert_close(pb2.grad, want_w, atol=1e-6, rtol=0)


def test_forward_only_kernels_refuse_a_gradient():
    """The guard the fused serving wrappers and `warp_video` run on a CUDA
    tensor: it raises when grad mode is on and a floating input requires a
    gradient, and passes under `no_grad` or for frozen inputs."""
    x = torch.zeros(2, requires_grad=True)
    idx = torch.zeros(2, dtype=torch.long)
    with pytest.raises(RuntimeError, match="forward-only"):
        _build.require_no_grad("fused_temporal_layer", x.detach(), x, None)
    with torch.no_grad():
        _build.require_no_grad("fused_temporal_layer", x)
    _build.require_no_grad("warp_video", x.detach(), idx, None)
