"""The port's DM training path against the JAX package, on the CPU in fp32:
`GaussianDiffusion.p_losses`, `FlowDiffusion.loss` and `DMTrainer` steps.

Config: 64² frames -> 16² latent, UNet dim 32 mults (1, 2), 4 heads x 32,
F=4, B=2, small LFAE (3-block hourglasses, 2 bottleneck blocks); the JAX
UNet runs its `pallas2` head-packed kernel pair in interpret mode, the port
its plain forward and backward. Weights: seeded values for every leaf of
the JAX variable trees, bridged by `from_jax_params`. The random draws of a
step (t, noise, null-condition dropout) are derived in the test from the
JAX key exactly as `p_losses` splits it, and injected into the port.

Tolerances (fp32 sums in another order through the frozen LFAE, the UNet
and its backward): losses 1e-5 relative + 1e-6; pseudo-ground-truth and
decoded videos 2e-4 / 1e-3 max-abs; gradient norm 1e-3 relative. Updated
parameters: Adam divides each gradient entry by its own magnitude, so an
entry whose gradient is rounding noise (a conv bias ahead of a GroupNorm
has an exactly zero gradient in exact arithmetic) moves by up to the
learning rate in either direction; every entry is held within twice the
sum of the learning rates of the steps taken (opposite signs), and 99% of
each parameter's entries within 5% of that sum.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr23_lfdm_tpu import config as jconfig
from cvpr23_lfdm_tpu.diffusion.gaussian_diffusion import GaussianDiffusion as JGD
from cvpr23_lfdm_tpu.models.flow_autoenc import init_lfae_vars
from cvpr23_lfdm_tpu.train.dm_trainer import DMTrainState, DMTrainer as JDMTrainer
from cvpr23_lfdm_torch.diffusion.gaussian_diffusion import GaussianDiffusion as TGD
from cvpr23_lfdm_torch.train.dm_trainer import DMTrainer, DMTrainState as TState, step_generator
from cvpr23_lfdm_torch.train.optim import multistep_lr
from cvpr23_lfdm_torch.utils.bench_ckpt import from_jax_params
from test_torch_slice import _port_cfg
from test_torch_unet import _random_variables

T = torch.from_numpy
LR = 2e-4


def _cfg(objective="eps", learn_null_cond=False):
    lfae = jconfig.LFAEConfig(
        frame_shape=64,
        region_predictor=jconfig.RegionPredictorConfig(num_blocks=3, block_expansion=8, max_features=64),
        bg_predictor=jconfig.BGPredictorConfig(num_blocks=3, block_expansion=8, max_features=64),
        generator=jconfig.GeneratorConfig(
            num_bottleneck_blocks=2, block_expansion=16, max_features=64,
            pixelwise_flow=jconfig.PixelwiseFlowConfig(num_blocks=3, block_expansion=8, max_features=64),
        ),
    )
    diffusion = jconfig.DiffusionConfig(
        img_size=16, num_frames=4, timesteps=50, sampling_timesteps=10,
        dim=32, dim_mults=(1, 2), attn_heads=4, compute_dtype="float32",
        objective=objective, learn_null_cond=learn_null_cond,
        temporal_attn_impl="pallas2_interpret", null_cond_prob=0.5,
    )
    # steps_per_epoch 2, milestone epoch 1: the rate drops on the third step
    dm_train = jconfig.DMTrainConfig(batch_size=2, epoch_milestones=(1,), lr=LR)
    return jconfig.ExperimentConfig(dataset="mug", lfae=lfae, diffusion=diffusion, dm_train=dm_train)


def _draws(key, dcfg, x_shape):
    """t, noise and the null-condition dropout as `p_losses` draws them."""
    key_t, key_noise, key_null = jax.random.split(key, 3)
    b = x_shape[0]
    t = jax.random.randint(key_t, (b,), 0, dcfg.timesteps)
    noise = jax.random.normal(key_noise, x_shape, jnp.float32)
    null = jax.random.uniform(key_null, (b,)) < dcfg.null_cond_prob
    return np.array(t), np.array(noise), np.array(null)


def _batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    b, f, s = cfg.dm_train.batch_size, cfg.diffusion.num_frames, cfg.lfae.frame_shape
    vid = rng.uniform(size=(b, f, s, s, 3)).astype(np.float32)
    return {"ref_img": vid[:, 0].copy(), "real_vid": vid,
            "cond": rng.standard_normal((b, cfg.diffusion.cond_dim)).astype(np.float32),
            "none_cond_mask": np.array([False, True])}


def _setup(cfg, seed=0):
    """The JAX trainer with seeded variables and the port's trainer on the
    same weights."""
    rng = np.random.RandomState(seed)
    lfae_vars = _random_variables(jax.eval_shape(
        lambda r: init_lfae_vars(r, cfg.lfae), jax.random.PRNGKey(0)), rng)
    jt = JDMTrainer(cfg, steps_per_epoch=2, lfae_vars=lfae_vars)
    unet_vars = _random_variables(jax.eval_shape(jt.model.init_unet_vars, jax.random.PRNGKey(1)), rng)
    tt = DMTrainer(_port_cfg(cfg), steps_per_epoch=2, device="cpu")
    tt.model.load_jax_variables(unet_vars, lfae_vars)
    return jt, unet_vars, lfae_vars, tt


@pytest.mark.parametrize("objective,loss_type", [("eps", "l2"), ("x0", "l1"), ("v", "l2")])
def test_p_losses_match_jax(objective, loss_type):
    """With a stub denoiser (the UNet has its own tests): q_sample, the
    three targets, both norms, the null mask and the thresholded x0."""
    dcfg = jconfig.DiffusionConfig(timesteps=30, objective=objective, loss_type=loss_type,
                                   null_cond_prob=0.5)
    rng = np.random.RandomState(1)
    shape = (4, 3, 4, 4, 3)
    x0 = rng.uniform(-1, 1, shape).astype(np.float32)
    fea = rng.standard_normal((4, 4, 4, 5)).astype(np.float32)
    cond = rng.standard_normal((4, 6)).astype(np.float32)
    none_mask = np.array([False, False, True, False])
    key = jax.random.PRNGKey(3)
    t, noise, null = _draws(key, dcfg, shape)

    def jstub(x, tt, c, nm, f):
        return jnp.tanh(x) * (0.5 + 0.01 * tt.reshape(-1, 1, 1, 1, 1)) + f.mean(-1, keepdims=True) \
            + jnp.where(nm, 0.0, c.mean(-1)).reshape(-1, 1, 1, 1, 1)

    def tstub(x, tt, c, nm, f):
        return torch.tanh(x) * (0.5 + 0.01 * tt.reshape(-1, 1, 1, 1, 1)) + f.mean(-1, keepdim=True) \
            + torch.where(nm, 0.0, c.mean(-1)).reshape(-1, 1, 1, 1, 1)

    jl, jaux = JGD.create(dcfg).p_losses(jstub, key, jnp.asarray(x0), jnp.asarray(fea),
                                         jnp.asarray(cond), jnp.asarray(none_mask))
    np.testing.assert_array_equal(np.asarray(jaux["t"]), t)
    gd = TGD.create(_port_cfg(dcfg), device="cpu")
    tl, taux = gd.p_losses(tstub, T(x0), T(fea), T(cond), T(none_mask),
                           t=T(t), noise=T(noise), null_mask=T(null))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(taux["pred_x0"].numpy(), np.asarray(jaux["pred_x0"]), atol=2e-5)
    # without injection the draws come from the generator, reproducibly
    g = lambda: torch.Generator().manual_seed(5)
    a = gd.p_losses(tstub, T(x0), T(fea), T(cond), generator=g())
    b = gd.p_losses(tstub, T(x0), T(fea), T(cond), generator=g())
    assert float(a[0]) == float(b[0]) and 0 <= int(a[1]["t"].min()) and int(a[1]["t"].max()) < 30


@pytest.mark.parametrize("with_monitoring,only_use_flow", [(True, True), (False, True), (True, False)])
def test_flow_diffusion_loss_matches_jax(with_monitoring, only_use_flow):
    cfg = _cfg(objective="x0")
    jt, unet_vars, lfae_vars, tt = _setup(cfg)
    batch = _batch(cfg)
    key = jax.random.PRNGKey(11)
    b, f, s = 2, cfg.diffusion.num_frames, cfg.diffusion.img_size
    t, noise, null = _draws(key, cfg.diffusion, (b, f, s, s, 3))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jtotal, jaux = jax.jit(lambda u, l: jt.model.loss(
        u, l, key, jb["ref_img"], jb["real_vid"], jb["cond"], jb["none_cond_mask"],
        with_monitoring=with_monitoring, only_use_flow=only_use_flow))(unet_vars, lfae_vars)
    tb = {k: T(v) for k, v in batch.items()}
    total, aux = tt.model.loss(
        tb["ref_img"], tb["real_vid"], tb["cond"], tb["none_cond_mask"],
        with_monitoring=with_monitoring, only_use_flow=only_use_flow,
        t=T(t), noise=T(noise), null_mask=T(null))
    assert set(aux) == set(jaux)
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux["loss"].detach()), float(jaux["loss"]), rtol=1e-5, atol=1e-6)
    for key_, atol in (("vid_grid", 2e-4), ("vid_conf", 2e-4), ("ref_fea", 2e-4)):
        np.testing.assert_allclose(aux[key_].numpy(), np.asarray(jaux[key_]), atol=atol, err_msg=key_)
        assert not aux[key_].requires_grad
    if with_monitoring:
        for key_ in ("out_vid", "warped_vid", "fake_out_vid", "fake_warped_vid"):
            np.testing.assert_allclose(aux[key_].numpy(), np.asarray(jaux[key_]), atol=1e-3, err_msg=key_)
        for key_ in ("rec_loss", "rec_warp_loss"):
            np.testing.assert_allclose(float(aux[key_]), float(jaux[key_]), rtol=1e-4)
        assert not aux["fake_out_vid"].requires_grad  # the detached pred_x0 quirk
    assert total.requires_grad


@pytest.fixture(scope="module")
def three_steps():
    """Three train steps of both trainers from the same weights and draws;
    the state after each step."""
    cfg = _cfg(objective="eps", learn_null_cond=True)
    jt, unet_vars, lfae_vars, tt = _setup(cfg, seed=1)
    state = DMTrainState(step=jnp.zeros((), jnp.int32), unet_vars=unet_vars,
                         opt_state=jt.tx.init(unet_vars["params"]))
    jstep = jax.jit(jt._train_step_impl, static_argnames=("with_monitoring",))
    tstate = tt.init_state()
    b, f, s = 2, cfg.diffusion.num_frames, cfg.diffusion.img_size
    out = []
    for i in range(3):
        batch = _batch(cfg, seed=10 + i)
        key = jax.random.fold_in(jax.random.PRNGKey(5), i)
        t, noise, null = _draws(key, cfg.diffusion, (b, f, s, s, 3))
        state, jm = jstep(state, lfae_vars, key, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tt.train_step(tstate, None, batch, t=T(t), noise=T(noise), null_mask=T(null))
        out.append({
            "jax": {k: float(v) for k, v in jm.items()},
            "port": {k: float(v) for k, v in tm.items()},
            "jax_params": from_jax_params({"params": jax.tree.map(np.asarray, state.unet_vars["params"])}),
            "port_params": {k: v.detach().clone() for k, v in tt.model.unet.named_parameters()},
            "step": tstate.step,
        })
    return out


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jax(three_steps, n_steps):
    lr_sum = 0.0
    for i in range(n_steps):
        rec = three_steps[i]
        np.testing.assert_allclose(rec["port"]["loss"], rec["jax"]["loss"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(rec["port"]["grad_norm"], rec["jax"]["grad_norm"], rtol=1e-3)
        lr_sum += rec["port"]["lr"]
    rec = three_steps[n_steps - 1]
    assert rec["step"] == n_steps
    assert set(rec["port_params"]) == set(rec["jax_params"])
    moved = 0
    for name, p in rec["port_params"].items():
        diff = (p - rec["jax_params"][name]).abs()
        assert float(diff.max()) <= 2 * lr_sum * 1.01, (name, float(diff.max()))
        close = float((diff <= 0.05 * lr_sum).float().mean())
        assert close >= 0.99, (name, close)
        moved += 1
    assert moved > 100


def test_learning_rate_drops_on_the_milestone_step_as_optax(three_steps):
    """`steps_per_epoch` 2, milestone epoch 1: optax's piecewise-constant
    schedule, read at the count before the update, lowers the rate on the
    step with index 2. The third step's update is 10x smaller in both."""
    assert [r["port"]["lr"] for r in three_steps] == pytest.approx([LR, LR, LR * 0.1])
    assert [multistep_lr(LR, (1, 2), 2, s) for s in range(6)] == pytest.approx(
        [LR, LR, LR * 0.1, LR * 0.1, LR * 0.01, LR * 0.01])
    for side in ("jax_params", "port_params"):
        name = "final_conv.weight"
        d2 = (three_steps[1][side][name] - three_steps[0][side][name]).abs().max()
        d3 = (three_steps[2][side][name] - three_steps[1][side][name]).abs().max()
        assert float(d3) < 0.2 * float(d2), (side, float(d2), float(d3))


def test_trainer_entry_points_on_cpu():
    """`init_state(seed)`, a monitored step from the generator's own draws,
    `monitor`, `sample_video` and `fit` with `start_step` (resume draws
    the straight-through run's stream)."""
    cfg = _cfg()
    cfg = cfg.replace(diffusion=dataclasses.replace(cfg.diffusion, sampling_timesteps=2))
    tcfg = _port_cfg(cfg)
    tr = DMTrainer(tcfg, steps_per_epoch=2, device="cpu")
    state = tr.init_state(seed=3)
    w0 = tr.model.unet.final_conv.weight.detach().clone()
    assert tr.init_state(seed=3).step == 0
    torch.testing.assert_close(tr.model.unet.final_conv.weight.detach(), w0, atol=0, rtol=0)
    batch = _batch(cfg)
    state, m = tr.train_step(state, step_generator(0, 0, "cpu"), batch, with_monitoring=True)
    assert state.step == 1 and np.isfinite(float(m["loss"])) and np.isfinite(float(m["rec_loss"]))
    assert not torch.equal(tr.model.unet.final_conv.weight.detach(), w0)
    assert all(not p.requires_grad for n, p in tr.model.named_parameters() if not n.startswith("unet."))
    aux = tr.monitor(state, step_generator(0, 1, "cpu"), {k: v[:1] for k, v in batch.items()})
    assert aux["fake_out_vid"].shape == (1, 4, 64, 64, 3)
    out = tr.sample_video(state, torch.Generator().manual_seed(0), batch["ref_img"][:1], batch["cond"][:1],
                          cond_scale=2.0)
    assert out["out_vid"].shape == (1, 4, 64, 64, 3) and torch.isfinite(out["out_vid"]).all()

    def run(start, seed_state):
        tr.model.unet.load_state_dict(seed_state["unet"])
        tr.optimizer.load_state_dict(copy.deepcopy(seed_state["opt"]))  # load aliases tensors
        calls = []
        st = tr.fit(TState(step=start), iter([batch] * 4), num_steps=3, seed=9, log_every=0,
                    sample_fn=lambda s, b, i: calls.append(i), sample_every=3, start_step=start)
        return st, calls, tr.model.unet.final_conv.weight.detach().clone()

    snap = lambda: {"unet": copy.deepcopy(tr.model.unet.state_dict()),
                    "opt": copy.deepcopy(tr.optimizer.state_dict())}
    s0 = snap()
    st, calls, w_straight = run(0, s0)
    assert st.step == 3 and calls == [3]
    # resume: replay steps 0-1, snapshot, then run only step 2 from start_step
    tr.model.unet.load_state_dict(s0["unet"])
    tr.optimizer.load_state_dict(copy.deepcopy(s0["opt"]))
    st2 = tr.fit(TState(step=0), iter([batch] * 4), num_steps=2, seed=9, log_every=0)
    st3, _, w_resumed = run(st2.step, snap())
    assert st3.step == 3
    torch.testing.assert_close(w_resumed, w_straight, atol=0, rtol=0)
