"""The port's Unet3D against the JAX Unet3D on the CPU at fp32, at a small
config (dim 32, mults (1, 2), 4 heads x 32, F=4, 16² latent): the serving
form against the `pallas3` fused layers in interpret mode, and the training
form (`temporal_attn_impl="pallas2"`) against the `pallas2` head-packed
kernel pair in interpret mode, output and the gradient of a scalar loss
with respect to every parameter.

Weights: seeded random values for every leaf of the JAX variable tree
(shapes from `init`), bridged by `from_jax_params`. Tolerance 1e-4 max-abs
on the fp32 output: ~20 layers of fp32 sums in another order. The bf16
serving policy (bf16 convs and matmuls, fp32 norm statistics, softmax and
heads) is held to the JAX bf16 model more loosely: both round to bf16 at
nearly the same points, but one value on the other side of a rounding
boundary moves by a bf16 ulp (2^-8 relative) and ~20 layers carry it on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr23_lfdm_tpu.models.unet3d import Unet3D as JUnet3D
from cvpr23_lfdm_torch.models.unet3d import Unet3D
from cvpr23_lfdm_torch.utils.bench_ckpt import from_jax_params

KW = dict(dim=32, dim_mults=(1, 2), attn_heads=4, attn_dim_head=32)


def _random_variables(shapes, rng):
    """Seeded numpy values for a JAX variable tree of shapes (from
    `jax.eval_shape` of `init`, which traces without compiling): kernels
    ~N(0, 1/fan_in), norm scales ~1, biases and BN means small, BN vars ~1."""
    out = {}
    for k, v in shapes.items():
        if isinstance(v, dict):
            out[k] = _random_variables(v, rng)
            continue
        shape = tuple(v.shape)
        if k in ("gamma", "scale"):
            a = 1 + 0.2 * rng.standard_normal(shape)
        elif k in ("bias", "mean"):
            a = 0.1 * rng.standard_normal(shape)
        elif k == "var":
            a = rng.uniform(0.5, 1.5, shape)
        else:  # kernels, embeddings, the learned null embedding
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]) if len(shape) > 1 else 1)
        out[k] = a.astype(np.float32)
    return out


@pytest.mark.parametrize("focus,use_deconv", [(False, True), (True, False)])
def test_unet_matches_jax_pallas3(focus, use_deconv):
    rng = np.random.RandomState(0)
    b, f, s = 2, 4, 16
    x = rng.standard_normal((b, f, s, s, 3)).astype(np.float32)
    fea = rng.standard_normal((b, 1, s, s, 256)).astype(np.float32)
    t = np.array([999, 317])
    cond = rng.standard_normal((b, 768)).astype(np.float32)
    null = np.array([False, True])
    mask = np.array([True, False]) if focus else None
    jm = JUnet3D(**KW, use_deconv=use_deconv, temporal_attn_impl="pallas3_interpret")
    args = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond), jnp.asarray(null),
            None if mask is None else jnp.asarray(mask))
    variables = _random_variables(jax.eval_shape(
        lambda r: jm.init(r, *args[:4], fea=jnp.asarray(fea)), jax.random.PRNGKey(0)), rng)
    ref = jax.jit(lambda v, *a: jm.apply(v, *a[:5], fea=a[5]))(variables, *args, jnp.asarray(fea))

    net = Unet3D(**KW, use_deconv=use_deconv)
    net.load_state_dict(from_jax_params(variables))
    to = lambda a: None if a is None else torch.from_numpy(a)
    with torch.no_grad():
        out = net(to(x), to(t), to(cond), to(null), focus_present_mask=to(mask), fea=to(fea))
    assert out.shape == (b, f, s, s, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_unet_bf16_policy_matches_jax():
    rng = np.random.RandomState(1)
    b, f, s = 1, 4, 16
    x = rng.standard_normal((b, f, s, s, 3)).astype(np.float32)
    fea = rng.standard_normal((b, 1, s, s, 256)).astype(np.float32)
    t = np.array([500])
    cond = rng.standard_normal((b, 768)).astype(np.float32)
    jm = JUnet3D(**KW, temporal_attn_impl="pallas3_interpret", dtype=jnp.bfloat16)
    args = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    variables = _random_variables(jax.eval_shape(
        lambda r: jm.init(r, *args, fea=jnp.asarray(fea)), jax.random.PRNGKey(0)), rng)
    ref = np.asarray(jax.jit(lambda v, *a: jm.apply(v, *a[:3], fea=a[3]))(
        variables, *args, jnp.asarray(fea)))
    net = Unet3D(**KW, dtype=torch.bfloat16)
    net.load_state_dict(from_jax_params(variables))
    with torch.no_grad():
        out = net(*(torch.from_numpy(a) for a in (x, t, cond)), fea=torch.from_numpy(fea)).numpy()
    assert out.dtype == np.float32
    err, scale = np.abs(out - ref), np.abs(ref).max()
    assert err.max() <= 3e-2 * scale and err.mean() <= 5e-3 * scale, (err.max(), err.mean(), scale)


@pytest.mark.parametrize("focus,learn_null", [(False, False), (True, True)])
def test_unet_training_form_output_and_grads_match_jax_pallas2(focus, learn_null):
    """Tolerances: output 1e-4 as above; each parameter's gradient within
    2e-4 of the largest gradient entry of that parameter plus 2e-5 absolute
    (the backward doubles the chain of fp32 sums, and gradients of
    different layers differ by orders of magnitude)."""
    rng = np.random.RandomState(2)
    b, f, s = 2, 4, 16
    x = rng.standard_normal((b, f, s, s, 3)).astype(np.float32)
    fea = rng.standard_normal((b, 1, s, s, 256)).astype(np.float32)
    t = np.array([999, 317])
    cond = rng.standard_normal((b, 768)).astype(np.float32)
    null = np.array([False, True])
    mask = np.array([True, False]) if focus else None
    w = rng.standard_normal((b, f, s, s, 3)).astype(np.float32)
    jm = JUnet3D(**KW, learn_null_cond=learn_null, temporal_attn_impl="pallas2_interpret")
    jmask = None if mask is None else jnp.asarray(mask)
    call = lambda v: jm.apply(v, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond),
                              jnp.asarray(null), jmask, fea=jnp.asarray(fea))
    variables = _random_variables(jax.eval_shape(
        lambda r: jm.init(r, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond), jnp.asarray(null),
                          fea=jnp.asarray(fea)), jax.random.PRNGKey(0)), rng)

    def jloss(params):
        out = call({"params": params})
        return jnp.sum(out * w), out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(variables["params"])
    want = from_jax_params({"params": jax.tree.map(np.asarray, jgrads)})

    net = Unet3D(**KW, learn_null_cond=learn_null, temporal_attn_impl="pallas2")
    net.load_state_dict(from_jax_params(variables))
    to = lambda a: None if a is None else torch.from_numpy(a)
    out = net(to(x), to(t), to(cond), to(null), focus_present_mask=to(mask), fea=to(fea))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-4)
    (out * to(w)).sum().backward()
    params = dict(net.named_parameters())
    assert set(params) == set(want)
    for name, p in params.items():
        assert p.grad is not None, name
        g, wg = p.grad.numpy(), want[name].numpy()
        assert np.abs(g - wg).max() <= 2e-4 * np.abs(wg).max() + 2e-5, (name, np.abs(g - wg).max())
    if learn_null:
        assert float(params["null_cond_emb"].grad.abs().max()) > 0


def test_unet_serving_and_training_forms_agree():
    """One state dict, both forms: the fused layers' plain versions and the
    unfused layers compute the same function (1e-4: fp32 sums regrouped)."""
    rng = np.random.RandomState(3)
    b, f, s = 1, 4, 16
    serving = Unet3D(**KW)
    training = Unet3D(**KW, temporal_attn_impl="pallas2")
    training.load_state_dict(serving.state_dict())
    args = (torch.from_numpy(rng.standard_normal((b, f, s, s, 3)).astype(np.float32)),
            torch.tensor([400]), torch.from_numpy(rng.standard_normal((b, 768)).astype(np.float32)))
    fea = torch.from_numpy(rng.standard_normal((b, 1, s, s, 256)).astype(np.float32))
    with torch.no_grad():
        a, c = serving(*args, fea=fea), training(*args, fea=fea)
    torch.testing.assert_close(a, c, atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="temporal_attn_impl"):
        Unet3D(**KW, temporal_attn_impl="xla")


def test_resolve_attn_impl():
    from cvpr23_lfdm_torch.models.unet3d import resolve_attn_impl

    assert resolve_attn_impl("xla", training=False) == "pallas3"
    assert resolve_attn_impl("xla", training=True) == "pallas2"
    assert resolve_attn_impl("pallas2_interpret", training=False) == "pallas2"
    assert resolve_attn_impl("pallas3", training=True) == "pallas3"
