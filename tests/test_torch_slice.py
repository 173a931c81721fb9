"""The port's serving slice end to end: `FlowDiffusion.sample_video` on the
CPU against the JAX `FlowDiffusion.sample_video` (`pallas3` fused layers in
interpret mode, tiled Pallas decode warp), under the same injected noise;
and the same under the `xla` and `pallas` forms of the UNet, each against
the JAX package under that form.

Config: the small config of `__graft_entry__.py` (64² frames, 16² latent,
UNet dim 32 mults (1, 2), 4 heads, F=4), rebuilt here, with 3 DDIM steps,
for the `eps` and `x0` objectives. Tolerance 1e-3 max-abs on `out_vid`
and 1e-4 on the latent outputs: fp32 sums in another order through three
UNet evals, dynamic thresholding and the decode.

Also: the DDPM sampler with a stub denoiser, the device default, the
import guard (no JAX in the port), and the JAX golden of the full-width
MUG serving path that `chip_smoke.py` holds the card run against.
"""

import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr23_lfdm_tpu import config as jconfig
from cvpr23_lfdm_tpu.diffusion.flow_diffusion import FlowDiffusion as JFlowDiffusion
from cvpr23_lfdm_tpu.models.generator import Generator as JGenerator
from cvpr23_lfdm_torch import config as tconfig
from cvpr23_lfdm_torch.diffusion.flow_diffusion import FlowDiffusion

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_mug_ddim10.npz")
# the golden's run: the bench checkpoint at the MUG serving widths with
# the frame count cut to 8 (the UNet and decode are frame-count agnostic)
GOLDEN_FRAMES = 8
GOLDEN_SEED = 20231016
GOLDEN_KEEP = (0, GOLDEN_FRAMES // 2 - 1, GOLDEN_FRAMES - 1)


def _port_cfg(jcfg):
    """The same config as the port's own dataclasses."""
    def conv(dc):
        cls = getattr(tconfig, type(dc).__name__)
        kw = {}
        for f in dataclasses.fields(dc):
            v = getattr(dc, f.name)
            kw[f.name] = conv(v) if dataclasses.is_dataclass(v) else v
        return cls(**kw)

    return conv(jcfg)


def _small_cfg(objective, impl="pallas3_interpret"):
    lfae = jconfig.LFAEConfig(
        frame_shape=64, warp_impl="tiled",
        generator=jconfig.GeneratorConfig(num_bottleneck_blocks=2),
    )
    diffusion = jconfig.DiffusionConfig(
        img_size=16, num_frames=4, timesteps=50, sampling_timesteps=3,
        dim=32, dim_mults=(1, 2), attn_heads=4, compute_dtype="float32",
        objective=objective, temporal_attn_impl=impl,
    )
    return jconfig.ExperimentConfig(dataset="mug", lfae=lfae, diffusion=diffusion)


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


@pytest.mark.parametrize("objective", ["eps", "x0"])
def test_sample_video_matches_jax(objective):
    _check_sample_video(_small_cfg(objective), "pallas3")


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_sample_video_forms_match_jax(impl):
    """The slice under the `xla` and `pallas` forms against the JAX package
    under the same form (the config names it; nothing reroutes it)."""
    _check_sample_video(_small_cfg("eps", impl), impl.removesuffix("_interpret"))


def _check_sample_video(cfg, form):
    jm = JFlowDiffusion(cfg.lfae, cfg.diffusion)
    rng = np.random.RandomState(0)
    b, f, s = 1, cfg.diffusion.num_frames, cfg.diffusion.img_size
    ref = rng.uniform(size=(b, 64, 64, 3)).astype(np.float32)
    cond = rng.standard_normal((b, 768)).astype(np.float32)
    init = rng.standard_normal((b, f, s, s, 3)).astype(np.float32)
    noise = rng.standard_normal((3, b, f, s, s, 3)).astype(np.float32)

    flow0 = jnp.zeros((b, f, s, s, 2))
    key = jax.random.PRNGKey(0)
    gen_vars = _random_variables(jax.eval_shape(lambda r: jm.generator.init(
        r, jnp.asarray(ref), flow0, flow0[..., :1], method=JGenerator.decode_video_with_flow,
    ), key), rng)
    lfae_vars = {col: {"generator": gen_vars[col]} for col in gen_vars}
    unet_vars = _random_variables(jax.eval_shape(jm.unet.init, key, jnp.asarray(init), jnp.zeros((b,)),
                                                 jnp.asarray(cond), fea=jnp.zeros((b, 1, s, s, 256))), rng)

    want = jax.device_get(jax.jit(lambda u, l, r, c, i, n: jm.sample_video(
        u, l, jax.random.PRNGKey(0), r, c, 1.0, init_img=i, noise_seq=n,
    ))(unet_vars, lfae_vars, ref, cond, init, noise))

    tcfg = _port_cfg(cfg)
    model = FlowDiffusion(tcfg.lfae, tcfg.diffusion, device="cpu")
    assert model.unet.temporal_attn_impl == form
    model.load_jax_variables(unet_vars, lfae_vars)
    got = model.sample_video(
        torch.from_numpy(ref), torch.from_numpy(cond), 1.0,
        init_img=torch.from_numpy(init), noise_seq=torch.from_numpy(noise),
    )
    assert got["out_vid"].shape == (b, f, 64, 64, 3)
    for key, atol in (("vid_grid", 1e-4), ("vid_conf", 1e-4), ("out_vid", 1e-3), ("warped_vid", 1e-3)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=atol, err_msg=key)


def test_ddpm_sampler_matches_jax():
    """`p_sample_loop` with a stub denoiser and injected noise."""
    from cvpr23_lfdm_tpu.diffusion.gaussian_diffusion import GaussianDiffusion as JGD
    from cvpr23_lfdm_torch.diffusion.gaussian_diffusion import GaussianDiffusion as TGD

    dcfg = jconfig.DiffusionConfig(timesteps=20, sampling_timesteps=20, objective="v")
    rng = np.random.RandomState(1)
    shape = (2, 3, 4, 4, 3)
    fea = rng.standard_normal((2, 4, 4, 5)).astype(np.float32)
    init = rng.standard_normal(shape).astype(np.float32)
    noise = rng.standard_normal((20,) + shape).astype(np.float32)
    cond = rng.standard_normal((2, 6)).astype(np.float32)

    def jstub(x, t, c, null, f):
        return jnp.tanh(x) * (0.5 + 0.001 * t.reshape(-1, 1, 1, 1, 1)) + f.mean(-1, keepdims=True)

    def tstub(x, t, c, null, f):
        return torch.tanh(x) * (0.5 + 0.001 * t.reshape(-1, 1, 1, 1, 1)) + f.mean(-1, keepdim=True)

    want = JGD.create(dcfg).p_sample_loop(
        jstub, jax.random.PRNGKey(0), shape, jnp.asarray(fea), jnp.asarray(cond), 2.0,
        init_img=jnp.asarray(init), noise_seq=jnp.asarray(noise),
    )
    got = TGD.create(_port_cfg(dcfg)).p_sample_loop(
        tstub, shape, torch.from_numpy(fea), torch.from_numpy(cond), 2.0,
        init_img=torch.from_numpy(init), noise_seq=torch.from_numpy(noise),
    )
    # 2e-5: 20 steps of fp32 elementwise algebra, exact order statistics
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_entry_points_default_to_the_card():
    from cvpr23_lfdm_torch.utils.device import resolve_device

    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_port_imports_no_jax():
    """Nothing under cvpr23_lfdm_torch/, nor chip_smoke.py, imports jax,
    flax or the JAX package."""
    banned = ("jax", "jaxlib", "flax", "optax", "cvpr23_lfdm_tpu")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "cvpr23_lfdm_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    walked = {os.path.relpath(p, ROOT) for p in files}
    for new in ("ops/norm.py", "utils/profiling.py", "scripts/_common.py", "scripts/bench_unet.py",
                "scripts/bench_warp.py", "scripts/bench_attn_ablate.py",
                "scripts/check_kernel_parity.py", "scripts/bench_temporal_layer.py",
                "scripts/bench_train_warp.py", "ops/ties.py", "models/avd_network.py",
                "models/flow_autoenc.py", "train/vgg.py", "train/losses.py",
                "train/lfae_trainer.py", "utils/bench_ckpt.py", "utils/checkpoint.py",
                "utils/torch_convert.py", "data/loader.py", "utils/viz.py", "eval/metrics.py",
                "eval/lpips.py", "eval/i3d.py", "eval/flowautoenc.py", "scripts/probe_lfae_nan.py",
                "models/bert.py", "models/text.py", "utils/safetensors.py", "utils/logging.py",
                "data/__init__.py", "data/specs.py", "data/sampling.py", "data/io.py",
                "data/augment.py", "data/native.py", "data/datasets.py", "data/synthetic.py",
                "parallel/serving.py", "scripts/demo.py", "scripts/test_dm.py",
                "scripts/eval_flowautoenc.py", "data/preprocess.py", "data/grain_loader.py",
                "utils/msgpack.py", "scripts/train_dm.py", "scripts/train_lfae.py",
                "scripts/make_bench_ckpt.py", "scripts/preprocess.py", "parallel/distributed.py",
                "parallel/mesh.py", "scripts/bench_attention.py", "scripts/bench_attn_fused.py",
                "scripts/bench_batch_sweep.py", "scripts/bench_train.py", "scripts/profile_sampler.py",
                "utils/tracing.py"):
        assert os.path.join("cvpr23_lfdm_torch", new) in walked, new
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                assert m.split(".")[0] not in banned, f"{path} imports {m}"


def test_golden_file_loads():
    g = np.load(GOLDEN)
    f = int(g["num_frames"])
    assert f == GOLDEN_FRAMES and int(g["seed"]) == GOLDEN_SEED
    assert g["vid_grid"].shape == (1, f, 32, 32, 2)
    assert g["vid_conf"].shape == (1, f, 32, 32, 1)
    assert g["out_vid_frames"].shape == (1, len(GOLDEN_KEEP), 128, 128, 3)
    assert tuple(g["frames"]) == GOLDEN_KEEP
    for key in ("vid_grid", "vid_conf", "out_vid_frames"):
        assert np.isfinite(g[key]).all()


def golden_noise(f: int, steps: int = 10, seed: int = GOLDEN_SEED):
    """The golden's injected gaussians: init `[1, F, 32, 32, 3]` and
    `[steps, 1, F, 32, 32, 3]` (a legacy RandomState stream, stable across
    numpy versions)."""
    rng = np.random.RandomState(seed)
    init = rng.standard_normal((1, f, 32, 32, 3)).astype(np.float32)
    noise = rng.standard_normal((steps, 1, f, 32, 32, 3)).astype(np.float32)
    return init, noise


def test_write_golden():
    """Opt-in (RUN_TORCH_GOLDEN=1): the JAX package's fp32 `sample_video` on
    the bench checkpoint at the MUG serving widths (128², 32² latent, dim 64
    mults (1,2,4,8), 8x32 heads, DDIM-10, B=1, cond_scale 1), `xla` impls,
    F=8."""
    if os.environ.get("RUN_TORCH_GOLDEN") != "1":
        pytest.skip("writes the golden; set RUN_TORCH_GOLDEN=1")
    from cvpr23_lfdm_torch.utils.bench_ckpt import load_bench_ckpt

    ck = load_bench_ckpt(os.path.join(ROOT, "assets", "bench_ckpt"))
    cfg = jconfig.mug_config()
    cfg = cfg.replace(diffusion=dataclasses.replace(
        cfg.diffusion, sampling_timesteps=10, num_frames=GOLDEN_FRAMES,
        compute_dtype="float32", objective=ck.meta["objective"],
    ))
    jm = JFlowDiffusion(cfg.lfae, cfg.diffusion)
    lfae_vars = {col: {"generator": ck.generator_vars[col]} for col in ("params", "batch_stats")}
    init, noise = golden_noise(GOLDEN_FRAMES)
    out = jax.device_get(jax.jit(lambda u, l, r, c, i, n: jm.sample_video(
        u, l, jax.random.PRNGKey(0), r, c, 1.0, init_img=i, noise_seq=n,
    ))(ck.unet_vars, lfae_vars, ck.ref[None], ck.cond[None], init, noise))
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(
        GOLDEN, vid_grid=np.asarray(out["vid_grid"]), vid_conf=np.asarray(out["vid_conf"]),
        out_vid_frames=np.asarray(out["out_vid"])[:, list(GOLDEN_KEEP)],
        frames=np.asarray(GOLDEN_KEEP), num_frames=GOLDEN_FRAMES, seed=GOLDEN_SEED,
    )
