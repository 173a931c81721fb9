"""The port's bf16 UNet against the JAX bf16 UNet at the MUG widths (dim 64,
mults (1, 2, 4, 8), 8 heads of 32, the bench checkpoint's weights), on the
CPU: one eval run four ways, JAX fp32 / bf16 and port fp32 / bf16, with the
four distances between them, each over the JAX fp32 output's scale.

What the reading found. flax's `nn.Conv` / `nn.Dense` (and the JAX
`Upsample`'s deconvolution) round the product to bf16 and then add the
bias in bf16; the port added the bias inside the product and rounded once.
That put the port's bf16 `init_conv` as far from JAX's bf16 as bf16 is from
fp32 (3.7e-3 of its scale, ~30% of its values). The port now rounds where JAX rounds
(`models/blocks.py::split_bias`); `test_bf16_biased_layers_round_as_flax`
fails on the code before that repair (~29% of the elements of each layer
one bf16 ulp apart), and the UNet case gates `init_conv`.

What stays apart, and why it is not a port fault: after the first layer the
two bf16 evals differ by as much as each differs from fp32. A bf16 value
one ulp across a rounding boundary (the convolutions' fp32 sums taken in
another order) is carried on by ~20 layers; the port's bf16 eval against
itself with its convolutions summed in another order (oneDNN off) is as far
apart (full reading, F=40, 32²: max 1.55e-2, mean 2.2e-3 of scale), and
XLA's CPU bf16 `logistic` (flax's SiLU) is up to 2 ulp from the rounded
sigmoid, which the port's correctly rounded `F.silu` does not copy. So the
gates below hold the port's bf16 to JAX's bf16 no further apart than JAX's
own bf16 distance from fp32 at the mean, and 1.5x it at the maximum; and
the port's bf16 no further from its fp32 than 1.5x JAX's.

What the whole-eval gates can tell apart. With the bias put back inside
the product (the fault above), d(port bf16, JAX bf16) over d(JAX bf16, JAX
fp32) reads 1.11 (`xla`) / 1.11 (`pallas3`) at the mean at F=8, 16² and
1.07 / 1.09 at F=40, 32², against 0.91 / 0.93 and 0.86 / 0.88 with the
repair: the mean gate at 1.0 sits between them. The maximum cannot: one
element's carried ulps set it, and it reads 0.96 / 0.92 (F=8) and 1.26 /
1.27 (F=40) with the fault against 1.04 / 1.04 and 1.25 / 1.25 without, so
its gate only bounds the reading, and `init_conv`'s share of unequal
values is what names the layer.

The full reading (B=1, F=40, 32², the layer table) runs with
`RUN_TORCH_BF16_MUG=1` (~1 min, ~4 GB)."""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.serialization import msgpack_restore
from flax.traverse_util import flatten_dict

from cvpr23_lfdm_tpu.models import unet3d as junet
from cvpr23_lfdm_tpu.utils.bench_ckpt import load_bench_ckpt as jload_bench_ckpt
from cvpr23_lfdm_torch.models import unet3d as punet
from cvpr23_lfdm_torch.models.blocks import Dense
from cvpr23_lfdm_torch.utils.bench_ckpt import from_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_CKPT = os.path.join(ROOT, "assets", "bench_ckpt")
MUG = dict(dim=64, dim_mults=(1, 2, 4, 8), attn_heads=8, attn_dim_head=32, cond_dim=768,
           learn_null_cond=False, use_deconv=True, use_final_activation=False)
T_FIRST = 909  # the first step of DDIM-10 over 1000 steps
# the gates: JAX's own bf16 distance from fp32 times these
BF16_OF_JAX_MAX, BF16_OF_JAX_MEAN = 1.5, 1.0
FP32_TOL = 1e-4  # of scale: ~20 layers of fp32 sums in another order
# the first layer rounds where JAX rounds: at most this share of its bf16
# outputs one ulp apart (the fp32 sums' order), ~30% with the bias inside
INIT_CONV_SHARE = 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test processes that share the CPU do not
    oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(frames, size):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, frames, size, size, 3)).astype(np.float32)
    fea = rng.standard_normal((1, 1, size, size, 256)).astype(np.float32)
    cond = np.load(os.path.join(BENCH_CKPT, "cond.npy")).astype(np.float32)[None]
    return x, np.array([T_FIRST]), cond, fea


def _jax_variables(jm, args):
    """The bench checkpoint's UNet through the JAX package's own loader (the
    generator's saved tree is its own template; it is not used here)."""
    x, t, cond, fea = (jnp.asarray(a) for a in args)
    template = jax.eval_shape(lambda r: jm.init(r, x, t, cond, fea=fea), jax.random.PRNGKey(0))
    with open(os.path.join(BENCH_CKPT, "generator.msgpack"), "rb") as f:
        gen = msgpack_restore(f.read())
    return jload_bench_ckpt(BENCH_CKPT, template, gen).unet_vars


def _jax_eval(dtype, args, variables):
    """Output and every module's output (flax `capture_intermediates`), by
    module path."""
    jm = junet.Unet3D(**MUG, temporal_attn_impl="xla", dtype=jnp.dtype(dtype))
    out, state = jax.jit(lambda v, x, t, c, f: jm.apply(
        v, x, t, c, fea=f, capture_intermediates=True, mutable=["intermediates"]))(
        variables, *(jnp.asarray(a) for a in args))
    inter = flatten_dict(state["intermediates"], sep=".")
    layers = {k.removesuffix(".__call__"): np.asarray(v[0], np.float32)
              for k, v in inter.items() if k != "__call__" and hasattr(v[0], "shape")}
    return np.asarray(out, np.float32), layers


def _port_eval(dtype, impl, args, state):
    """Output and the outputs of the modules of the same names (forward
    hooks; the port names its modules after the JAX tree paths)."""
    net = punet.Unet3D(**MUG, temporal_attn_impl=impl, dtype=getattr(torch, dtype)).eval()
    net.load_state_dict(state)
    layers = {}
    for name, module in net.named_modules():
        if name:
            module.register_forward_hook(
                lambda m, i, o, name=name: layers.__setitem__(name, o.float().numpy())
                if torch.is_tensor(o) else None)
    with torch.no_grad():
        x, t, cond, fea = (torch.from_numpy(a) for a in args)
        out = net(x, t, cond, fea=fea).numpy()
    return out, layers


def _distances(out, scale):
    """The four distances (max-abs, mean-abs) over `scale`."""
    d = lambda a, b: (float(np.abs(out[a] - out[b]).max() / scale),
                      float(np.abs(out[a] - out[b]).mean() / scale))
    return {"jax_bf16-jax_fp32": d("jax_bf16", "jax_fp32"),
            "port_bf16-port_fp32": d("port_bf16", "port_fp32"),
            "port_bf16-jax_bf16": d("port_bf16", "jax_bf16"),
            "port_fp32-jax_fp32": d("port_fp32", "jax_fp32")}


def _reading(frames, size, impls):
    """Every output and layer table of the four ways (the port once per form
    in `impls`)."""
    args = _inputs(frames, size)
    variables = _jax_variables(junet.Unet3D(**MUG, temporal_attn_impl="xla"), args)
    state = from_jax_params(jax.tree.map(np.asarray, variables))
    out, layers = {}, {}
    for dt in ("float32", "bfloat16"):
        key = "fp32" if dt == "float32" else "bf16"
        out[f"jax_{key}"], layers[f"jax_{key}"] = _jax_eval(dt, args, variables)
        for impl in impls:
            out[f"{impl}_{key}"], layers[f"{impl}_{key}"] = _port_eval(dt, impl, args, state)
    return out, layers


def _check(out, layers, impl):
    out = {k.replace(f"{impl}_", "port_"): v for k, v in out.items()}
    layers = {k.replace(f"{impl}_", "port_"): v for k, v in layers.items()}
    scale = float(np.abs(out["jax_fp32"]).max())
    d = _distances(out, scale)
    print(impl, {k: [f"{x:.3e}" for x in v] for k, v in d.items()})
    jmax, jmean = d["jax_bf16-jax_fp32"]
    assert d["port_fp32-jax_fp32"][0] <= FP32_TOL, d
    assert d["port_bf16-port_fp32"][0] <= BF16_OF_JAX_MAX * jmax, d
    assert d["port_bf16-port_fp32"][1] <= BF16_OF_JAX_MAX * jmean, d
    assert d["port_bf16-jax_bf16"][0] <= BF16_OF_JAX_MAX * jmax, d
    assert d["port_bf16-jax_bf16"][1] <= BF16_OF_JAX_MEAN * jmean, d
    share = float((layers["port_bf16"]["init_conv"] != layers["jax_bf16"]["init_conv"]).mean())
    assert share <= INIT_CONV_SHARE, share
    return d


def _layer_table(layers):
    """Per module of the xla form: distance of each bf16 eval from the other
    package's bf16 and from its own fp32, over the JAX fp32 output's scale."""
    rows = []
    for name, ref in layers["jax_fp32"].items():
        if name not in layers["xla_fp32"] or layers["xla_fp32"][name].shape != ref.shape:
            continue
        sc = np.abs(ref).max() or 1.0
        dist = lambda a, b: float(np.abs(layers[a][name] - layers[b][name]).max() / sc)
        rows.append((name, dist("jax_bf16", "jax_fp32"), dist("xla_bf16", "xla_fp32"),
                     dist("xla_bf16", "jax_bf16")))
    return rows


def test_bf16_unet_matches_jax_at_mug_width():
    """F=8, 16² (the tier-1 cut of the serving eval's F=40, 32²): the `xla`
    form and the serving form's plain version (`pallas3` on the CPU)."""
    out, layers = _reading(8, 16, ("xla", "pallas3"))
    for impl in ("xla", "pallas3"):
        _check({k: v for k, v in out.items() if k.startswith(("jax", impl))},
               {k: v for k, v in layers.items() if k.startswith(("jax", impl))}, impl)


def test_bf16_unet_matches_jax_full_reading():
    """Opt-in (RUN_TORCH_BF16_MUG=1): the serving eval's shape, B=1, F=40,
    32², with the layer table printed (`pytest -s`)."""
    if os.environ.get("RUN_TORCH_BF16_MUG") != "1":
        pytest.skip("the full-width reading; set RUN_TORCH_BF16_MUG=1")
    out, layers = _reading(40, 32, ("xla", "pallas3"))
    for name, jd, pd, xd in _layer_table(layers):
        print(f"{name:48s} jax_bf16-fp32 {jd:.2e}  port_bf16-fp32 {pd:.2e}  port-jax bf16 {xd:.2e}")
    for impl in ("xla", "pallas3"):
        _check({k: v for k, v in out.items() if k.startswith(("jax", impl))},
               {k: v for k, v in layers.items() if k.startswith(("jax", impl))}, impl)


class _Up(fnn.Module):
    """The JAX `Upsample` under the name the weight bridge reads a deconv
    kernel by."""

    @fnn.compact
    def __call__(self, x):
        return junet.Upsample(64, dtype=jnp.bfloat16, name="ups_0_upsample")(x)


class _PortUp(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.ups_0_upsample = punet.Upsample(64, dtype=torch.bfloat16)

    def forward(self, x):
        return self.ups_0_upsample(x)


@pytest.mark.parametrize("layer", ["conv", "dense", "deconv"])
def test_bf16_biased_layers_round_as_flax(layer):
    """A bf16 layer with a bias (conv, Dense, the UNet's deconvolution)
    against its flax counterpart on the same bf16 input and N(0, 1) biases:
    the product rounded to bf16, then the bias added in bf16. At most 1e-3
    of the elements one ulp apart (the fp32 sums' order); with the bias
    inside the product ~29% are."""
    bf = jnp.bfloat16
    jmod, pmod = {
        "conv": (lambda: junet.conv_2plus1d(64, 3, name="proj", dtype=bf),
                 lambda: punet.Conv2plus1d(64, 64, 3, dtype=torch.bfloat16)),
        "dense": (lambda: fnn.Dense(128, dtype=bf), lambda: Dense(64, 128, dtype=torch.bfloat16)),
        "deconv": (_Up, _PortUp),
    }[layer]
    jmod, pmod = jmod(), pmod()
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((2, 4, 16, 16, 64)), bf)
    variables = jmod.init(jax.random.PRNGKey(0), x)
    variables = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32) if a.ndim == 1 else a,
        variables)
    ref = np.asarray(jax.jit(jmod.apply)(variables, x), np.float32)
    pmod.load_state_dict(from_jax_params(jax.tree.map(np.asarray, variables)))
    with torch.no_grad():
        out = pmod(torch.from_numpy(np.asarray(x.astype(jnp.float32))).bfloat16()).float().numpy()
    assert out.shape == ref.shape
    assert (out != ref).mean() <= 1e-3, (out != ref).mean()
