"""The fused attention layers' and the packed attention's plain versions
(cvpr23_lfdm_torch.ops.attention) against the JAX package's Pallas kernels
in interpret mode and against the unfused flax layers, on the CPU at fp32
(the packed attention and the `xla` / `pallas` layer forms also at bf16).

Shapes follow tests/test_attention_pallas.py (heads 2, dim_head 8, dim 16).
Tolerance 3e-5 max-abs, the one the JAX package holds its own fused kernels
to against the unfused layers: same math, fp32 sums in another order.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr23_lfdm_tpu.models import unet3d as junet
from cvpr23_lfdm_tpu.ops import attention_pallas as jattn
from cvpr23_lfdm_torch.models import unet3d as tunet
from cvpr23_lfdm_torch.ops import attention as tattn
from cvpr23_lfdm_torch.utils.bench_ckpt import from_jax_params

HEADS, DH, DIM = 2, 8, 16
ATOL = 3e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _layer_inputs(rng, b, f, hw, dim, heads, dh):
    hd = heads * dh
    x = rng.standard_normal((b, f, hw, dim)).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(dim)).astype(np.float32)
    wqkv = (rng.standard_normal((dim, 3 * hd)) / np.sqrt(dim)).astype(np.float32)
    wout = (rng.standard_normal((hd, dim)) / np.sqrt(hd)).astype(np.float32)
    return x, gamma, wqkv, wout


# bf16: both round to bf16 at the same points (LN(x), rotated q|k|v, exp,
# o, the projection, the residual), with fp32 sums in another order; a value
# that lands on the other side of a rounding boundary moves by one bf16 ulp
BF16_TOL = {"atol": 3e-2, "rtol": 2e-2}


# (b, hw, f, focus, heads, dim_head, dim, dtype): the fp32 cases at the small
# config, then bf16 at that config and at F = 40 with 8 heads of 32 channels
@pytest.mark.parametrize("b,hw,f,focus,heads,dh,dim,dtype", [
    (2, 16, 5, False, HEADS, DH, DIM, "float32"), (2, 64, 7, False, HEADS, DH, DIM, "float32"),
    (2, 32, 5, True, HEADS, DH, DIM, "float32"),
    (2, 16, 5, False, HEADS, DH, DIM, "bfloat16"), (2, 32, 5, True, HEADS, DH, DIM, "bfloat16"),
    (2, 16, 40, False, 8, 32, 64, "bfloat16"), (2, 64, 7, True, 8, 32, 32, "bfloat16"),
    (1, 32, 40, False, 8, 32, 128, "bfloat16"),
])
def test_fused_temporal_layer_matches_pallas(b, hw, f, focus, heads, dh, dim, dtype):
    """The port's layer (its plain version on the CPU) against the JAX
    package's Pallas kernel in interpret mode, on the same inputs: fp32 to
    3e-5, bf16 to 3e-2 + 2e-2 |y| (the gate the bf16 kernel is held to on the
    card against this plain version)."""
    rng = np.random.default_rng(3)
    x, gamma, wqkv, wout = _layer_inputs(rng, b, f, hw, dim, heads, dh)
    pos_bias = rng.standard_normal((heads, f, f)).astype(np.float32)
    mask = np.array([True, False]) if focus else None
    scale = dh ** -0.5
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jbias = jattn.build_bias_flat(jnp.asarray(pos_bias), b, f, None if mask is None else jnp.asarray(mask))
    jcos, jsin = jattn.rotary_tables(f, heads, dh, scale, jdt)
    ref = jattn.fused_temporal_layer(
        jnp.asarray(x).astype(jdt), jnp.asarray(gamma), jnp.asarray(wqkv).astype(jdt),
        jnp.asarray(wout).astype(jdt), jbias, jcos, jsin, heads, dh, interpret=True,
    )
    tbias = tattn.build_bias_flat(_t(pos_bias), b, f, None if mask is None else _t(mask))
    tcos, tsin = tattn.rotary_tables(f, heads, dh, scale, tdt)
    # the port's tables and bias are the JAX ones exactly
    np.testing.assert_array_equal(tbias.numpy(), np.asarray(jbias))
    np.testing.assert_array_equal(tcos.float().numpy(), np.asarray(jcos.astype(jnp.float32)))
    np.testing.assert_array_equal(tsin.float().numpy(), np.asarray(jsin.astype(jnp.float32)))
    out = tattn.fused_temporal_layer(
        _t(x).to(tdt), _t(gamma), _t(wqkv).to(tdt), _t(wout).to(tdt), tbias, tcos, tsin, heads, dh
    )
    assert out.dtype == tdt
    got, want = out.float().numpy(), np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL)
    else:
        assert np.all(np.abs(got - want) <= BF16_TOL["atol"] + BF16_TOL["rtol"] * np.abs(want))


@pytest.mark.parametrize("hw", [32, 48])
def test_fused_spatial_linear_layer_matches_pallas(hw):
    """The port's layer (its plain version on the CPU) against the JAX
    interpret kernel; hw = 48 is no multiple of the 32-pixel tile that the
    kernel on the card once required."""
    rng = np.random.default_rng(4)
    b, f = 2, 8
    x, gamma, wqkv, wout = _layer_inputs(rng, b, f, hw, DIM, HEADS, DH)
    bout = (0.1 * rng.standard_normal(DIM)).astype(np.float32)
    ref = jattn.fused_spatial_linear_layer(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(wqkv), jnp.asarray(wout),
        jnp.asarray(bout), HEADS, DH, interpret=True,
    )
    out = tattn.fused_spatial_linear_layer(_t(x), _t(gamma), _t(wqkv), _t(wout), _t(bout), HEADS, DH)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def _flax_prenorm(attn_cls, dim):
    class Wrap(nn.Module):
        @nn.compact
        def __call__(self, x, pos_bias=None, focus_mask=None):
            kw = {}
            if pos_bias is not None:
                kw = dict(pos_bias=pos_bias, focus_present_mask=focus_mask)
            return junet.PreNormResidual(dim, attn_cls, HEADS, DH, name="layer")(x, **kw)

    return Wrap()


def _perturb_gamma(variables, rng):
    """Random LN gamma (init is all ones, which would hide a gamma slip)."""
    params = jax.tree.map(np.asarray, jax.device_get(variables))
    g = params["params"]["layer"]["norm"]["gamma"]
    params["params"]["layer"]["norm"]["gamma"] = (g + 0.2 * rng.standard_normal(g.shape)).astype(np.float32)
    return params


@pytest.mark.parametrize("focus", [False, True])
def test_temporal_prenorm_matches_xla_layer(focus):
    """The port's PreNormResidual(TemporalAttention) (fused) == the JAX
    unfused `impl="xla"` PreNormResidual, weights bridged by from_jax_params."""
    rng = np.random.default_rng(5)
    b, f, h, w = 2, 6, 4, 4
    x = rng.standard_normal((b, f, h, w, DIM)).astype(np.float32)
    pos_bias = rng.standard_normal((HEADS, f, f)).astype(np.float32)
    mask = np.array([True, False]) if focus else None
    jm = _flax_prenorm(functools.partial(junet.TemporalAttention, impl="xla"), DIM)
    variables = _perturb_gamma(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(pos_bias)), rng)
    ref = jm.apply(variables, jnp.asarray(x), jnp.asarray(pos_bias),
                   None if mask is None else jnp.asarray(mask))
    layer = tunet.PreNormResidual(DIM, tunet.TemporalAttention, HEADS, DH)
    sd = {k.removeprefix("layer."): v for k, v in from_jax_params(variables).items()}
    layer.load_state_dict(sd)
    out = layer(_t(x), pos_bias=_t(pos_bias), focus_present_mask=None if mask is None else _t(mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL)


def test_linear_prenorm_matches_xla_layer():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, 4, 8, DIM)).astype(np.float32)
    jm = _flax_prenorm(junet.SpatialLinearAttention, DIM)
    variables = _perturb_gamma(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)), rng)
    variables["params"]["layer"]["attn"]["to_out"]["bias"] = (
        0.1 * rng.standard_normal(DIM)).astype(np.float32)
    ref = jm.apply(variables, jnp.asarray(x))
    layer = tunet.PreNormResidual(DIM, tunet.SpatialLinearAttention, HEADS, DH)
    layer.load_state_dict({k.removeprefix("layer."): v for k, v in from_jax_params(variables).items()})
    np.testing.assert_allclose(layer(_t(x)).detach().numpy(), np.asarray(ref), atol=ATOL)


def test_mid_spatial_attention_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 3, 4, 4, DIM)).astype(np.float32)
    jm = _flax_prenorm(junet.SpatialAttention, DIM)
    variables = _perturb_gamma(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)), rng)
    ref = jm.apply(variables, jnp.asarray(x))
    layer = tunet.PreNormResidual(DIM, tunet.SpatialAttention, HEADS, DH)
    layer.load_state_dict({k.removeprefix("layer."): v for k, v in from_jax_params(variables).items()})
    np.testing.assert_allclose(layer(_t(x)).detach().numpy(), np.asarray(ref), atol=ATOL)


def test_layers_refuse_other_devices():
    x = torch.empty((1, 2, 4, 16), device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        tattn.fused_spatial_linear_layer(x, x, x, x, x, 2, 8)


# ------------------------------------------------ packed attention (`pallas`)


def test_pick_pack_build_bias_rotate_pairs_match_jax_exactly():
    for hw, f in ((1024, 40), (256, 40), (64, 40), (16, 40), (16, 5), (12, 7), (1, 300)):
        assert tattn.pick_pack(hw, f) == jattn.pick_pack(hw, f)
    assert tattn.pick_pack(1024, 40) == 4
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 5, 12)).astype(np.float32)
    np.testing.assert_array_equal(tattn.rotate_pairs(_t(x)).numpy(),
                                  np.asarray(jattn.rotate_pairs(jnp.asarray(x))))
    pos_bias = rng.standard_normal((HEADS, 5, 5)).astype(np.float32)
    for mask in (None, np.array([True, False, True])):
        ref = jattn.build_bias(jnp.asarray(pos_bias), 3, 4, 5, None if mask is None else jnp.asarray(mask))
        out = tattn.build_bias(_t(pos_bias), 3, 4, 5, None if mask is None else _t(mask))
        assert out.dtype == torch.float32 and out.is_contiguous()
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert tattn.NEG_INF == jattn.NEG_INF


def _packed_inputs(rng, b, hw, f, focus, dtype):
    hd = HEADS * DH
    qkv = rng.standard_normal((b, hw, f, 3 * hd)).astype(np.float32)
    pos_bias = rng.standard_normal((HEADS, f, f)).astype(np.float32)
    mask = np.array([True, False][:b]) if focus else None
    pack = jattn.pick_pack(hw, f, target_rows=4 * f)
    jbias = jattn.build_bias(jnp.asarray(pos_bias), b, pack, f, None if mask is None else jnp.asarray(mask))
    tbias = tattn.build_bias(_t(pos_bias), b, pack, f, None if mask is None else _t(mask))
    jq = jnp.asarray(qkv).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tq = _t(qkv).to(getattr(torch, dtype))
    return jq, tq, jbias, tbias, pack


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw,f,focus", [(16, 5, False), (8, 7, True), (6, 5, False)])
def test_packed_temporal_attention_matches_pallas(hw, f, focus, dtype):
    """The plain packed attention == the Pallas kernel in interpret mode.
    fp32: 3e-5 (sums in another order). bf16: both round the probabilities
    and the output to bf16 at the same points; one bf16 ulp (2^-8 relative)
    where a value lands across a rounding boundary."""
    rng = np.random.default_rng(9)
    jq, tq, jbias, tbias, pack = _packed_inputs(rng, 2, hw, f, focus, dtype)
    ref = jattn.packed_temporal_attention(jq, jbias, HEADS, DH, pack, interpret=True)
    out = tattn.packed_temporal_attention(tq, tbias, HEADS, DH, pack)
    assert out.shape == (2, hw, f, HEADS * DH) and str(out.dtype) == f"torch.{dtype}"
    ref = np.asarray(ref.astype(jnp.float32))
    atol, rtol = (ATOL, 0) if dtype == "float32" else (1e-2, 2 ** -7)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("focus", [False, True])
def test_temporal_prenorm_forms_match_xla_layer(focus, impl, dtype):
    """The port's PreNormResidual(TemporalAttention) in the `xla` and
    `pallas` forms == the JAX `impl="xla"` layer of the same compute dtype.
    fp32: 3e-5. bf16: the port's `xla` form rounds where the JAX one does
    (the scores to bf16) and is held to 2 bf16 ulps of the output scale; the
    `pallas` form rotates in bf16 and keeps fp32 scores, so it is held to
    the JAX layer only at 5e-2 of the output scale."""
    rng = np.random.default_rng(10)
    b, f, h, w = 2, 6, 4, 4
    x = rng.standard_normal((b, f, h, w, DIM)).astype(np.float32)
    pos_bias = rng.standard_normal((HEADS, f, f)).astype(np.float32)
    mask = np.array([True, False]) if focus else None
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)

    class Wrap(nn.Module):
        @nn.compact
        def __call__(self, x, pos_bias, focus_mask=None):
            cls = functools.partial(junet.TemporalAttention, impl="xla")
            return junet.PreNormResidual(DIM, cls, HEADS, DH, dtype=jdt, name="layer")(
                x, pos_bias=pos_bias, focus_present_mask=focus_mask)

    jm = Wrap()
    jx = jnp.asarray(x).astype(jdt)
    variables = _perturb_gamma(jm.init(jax.random.PRNGKey(0), jx, jnp.asarray(pos_bias)), rng)
    ref = jm.apply(variables, jx, jnp.asarray(pos_bias), None if mask is None else jnp.asarray(mask))
    ref = np.asarray(ref.astype(jnp.float32))
    layer = tunet.PreNormResidual(DIM, tunet.TemporalAttention, HEADS, DH, dtype=tdt, impl=impl)
    layer.load_state_dict({k.removeprefix("layer."): v for k, v in from_jax_params(variables).items()})
    with torch.no_grad():
        out = layer(_t(x).to(tdt), pos_bias=_t(pos_bias),
                    focus_present_mask=None if mask is None else _t(mask))
    assert out.dtype == tdt
    err = np.abs(out.float().numpy() - ref).max()
    scale = np.abs(ref).max()
    tol = ATOL if dtype == "float32" else (2 ** -7 if impl == "xla" else 5e-2) * scale
    assert err <= tol, (err, tol)


def test_packed_attention_refuses_other_devices_and_bad_pack():
    qkv = torch.empty((1, 6, 4, 48), device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        tattn.packed_temporal_attention(qkv, qkv, 2, 8, 2)
    with pytest.raises(ValueError, match="does not divide"):
        tattn.packed_temporal_attention(torch.zeros(1, 6, 4, 48), torch.zeros(1, 2, 16, 16), 2, 8, 4)
    with pytest.raises(ValueError, match="not in"):
        tattn.ablation_defines("kvbuild")
    assert tattn.ablation_defines("full") == () and tattn.ablation_defines("pv") == ("LFDM_ABLATE_PV",)


def test_build_library_name_covers_the_defines():
    """An ablation build is a library of its own: the name hashes the
    preprocessor defines beside the source, the headers and the flags."""
    from cvpr23_lfdm_torch.ops import _build

    plain = _build._target("fused_temporal_layer")
    assert plain == _build._target("fused_temporal_layer", ())
    names = {_build._target("fused_temporal_layer", tattn.ablation_defines(v)) for v in tattn.ABLATIONS}
    assert len(names) == len(tattn.ABLATIONS) and plain not in names
    assert _build._target("fused_temporal_layer", ("LFDM_ABLATE_PV",)) in names
