"""Checkpoints of the port: `CheckpointManager` (round trip, rolling latest,
garbage collection, the JSON sidecar), the resume of both trainers (a
straight run against crash + restore + the rest, bit for bit on the CPU, on
injected batches), the frozen LFAE of a training `FlowDiffusion` kept in
eval mode, and the import of the reference's `.pth` checkpoints held to the
JAX package's converters.

The reference-import check needs no reference checkpoint: a seeded port
module is written out in the reference's layout by the port's inverse key
map (`lfae_to_reference`, `unet_to_reference`), the JAX package's
`convert_lfae_checkpoint` / `convert_unet3d` read it (every key must be
read), and `from_jax_params` of their result must equal the port's direct
conversion, tensor for tensor (exact: both only move and reshape values).
Tiny configs as in `test_torch_train.py` and `test_torch_lfae_train.py`.
"""

import os

import jax
import numpy as np
import pytest
import torch

from cvpr23_lfdm_tpu import config as jconfig
from cvpr23_lfdm_tpu.utils import torch_convert as jtc
from cvpr23_lfdm_torch.diffusion.flow_diffusion import FlowDiffusion, build_unet
from cvpr23_lfdm_torch.models.flow_autoenc import FlowAE, seed_lfae_weights
from cvpr23_lfdm_torch.train.dm_trainer import DMTrainer
from cvpr23_lfdm_torch.train.lfae_trainer import LFAETrainer
from cvpr23_lfdm_torch.utils.bench_ckpt import from_jax_params
from cvpr23_lfdm_torch.utils.checkpoint import (
    CheckpointManager, load_lfae_from_torch, load_torch_state_dicts, load_unet_from_torch,
)
from cvpr23_lfdm_torch.utils.torch_convert import (
    convert_lfae_checkpoint, convert_unet3d, lfae_to_reference, unet_to_reference,
)
from test_torch_lfae_train import _tiny_jcfg
from test_torch_slice import _port_cfg


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: as fast at these sizes, and test processes that
    share the CPU do not oversubscribe it (spinning OpenMP threads made the
    DM resume 70x slower under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dm_jcfg(use_deconv=True):
    """The tiny DM config of `test_torch_train.py` (plain attention)."""
    narrow = dict(num_blocks=3, block_expansion=8, max_features=64)
    lfae = jconfig.LFAEConfig(
        frame_shape=64,
        region_predictor=jconfig.RegionPredictorConfig(**narrow),
        bg_predictor=jconfig.BGPredictorConfig(**narrow),
        generator=jconfig.GeneratorConfig(
            num_bottleneck_blocks=2, block_expansion=16, max_features=64,
            pixelwise_flow=jconfig.PixelwiseFlowConfig(**narrow)),
    )
    diffusion = jconfig.DiffusionConfig(
        img_size=16, num_frames=4, timesteps=50, dim=32, dim_mults=(1, 2), attn_heads=4,
        compute_dtype="float32", learn_null_cond=True, use_deconv=use_deconv,
        temporal_attn_impl="xla", null_cond_prob=0.5)
    dm_train = jconfig.DMTrainConfig(batch_size=2, epoch_milestones=(1,))
    return jconfig.ExperimentConfig(dataset="mug", lfae=lfae, diffusion=diffusion, dm_train=dm_train)


def _randomize(module, rng):
    """Seeded values for every entry of a module's state dict (BatchNorm
    variances positive), so that no leaf is at its initial value."""
    with torch.no_grad():
        for name, t in module.state_dict().items():
            a = rng.standard_normal(tuple(t.shape)).astype(np.float32)
            if name.endswith("running_var"):
                a = np.abs(a) + 0.5
            t.copy_(torch.from_numpy(a))


# ------------------------------------------------------------------ CheckpointManager


def test_checkpoint_roundtrip_rolling_and_gc(tmp_path):
    state = {"step": 7, "w": torch.arange(12.0).reshape(3, 4), "nested": {"m": torch.ones(2)}}
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    path = mgr.save(state, step=7)
    assert mgr.has_latest() and path.endswith("latest.pt")
    for name in ("latest", "step_00000007"):
        restored = mgr.restore(name)
        assert restored["step"] == 7
        assert torch.equal(restored["w"], state["w"]) and torch.equal(restored["nested"]["m"], state["nested"]["m"])
    for s in (8, 9, 10):
        mgr.save({**state, "step": s}, step=s, extra={"s": s})
    assert mgr.latest_step() == 10 and mgr.restore()["step"] == 10
    files = sorted(os.listdir(tmp_path / "ckpt"))
    assert files == ["latest.extra.json", "latest.pt", "step_00000009.extra.json", "step_00000009.pt",
                     "step_00000010.extra.json", "step_00000010.pt"]  # gc took 7, 8; no temp file
    mgr.save({**state, "step": 11}, step=11, rolling=False)
    assert mgr.restore()["step"] == 10 and mgr.latest_step() == 11
    with pytest.raises(ValueError):
        mgr.save(state, step=None, rolling=False)
    empty = CheckpointManager(str(tmp_path / "empty"))
    assert empty.latest_step() is None and not empty.has_latest() and empty.load_extra() is None


def test_checkpoint_extra_bytes_roundtrip(tmp_path):
    """The JSON sidecar of the JAX package's format (bytes base64-encoded)."""
    from cvpr23_lfdm_tpu.utils.checkpoint import CheckpointManager as JManager

    ckpt = CheckpointManager(str(tmp_path / "ck"))
    ckpt.save({"w": torch.ones(2)}, step=1, extra={"grain_state": b"\x00\x01binary", "n": 3})
    out = ckpt.load_extra()
    assert out["grain_state"] == b"\x00\x01binary" and out["n"] == 3
    assert ckpt.load_extra("step_00000001") == out
    with open(tmp_path / "ck" / "latest.extra.json") as f:
        ours = f.read()
    JManager(str(tmp_path / "jax"))._write_extra("latest", {"grain_state": b"\x00\x01binary", "n": 3})
    with open(tmp_path / "jax" / "latest.extra.json") as f:
        assert f.read() == ours


# ------------------------------------------------------------------ resume


def _dm_trainer(cfg):
    """A CPU trainer with the same seeded frozen LFAE every time (its own
    source, as a resumed run loads it) and a UNet from `init_state(seed=1)`."""
    tr = DMTrainer(cfg, steps_per_epoch=2, device="cpu")
    seed_lfae_weights([tr.model.region_predictor, tr.model.bg_predictor, tr.model.generator], 4)
    return tr


def _dm_batches(cfg, n):
    rng = np.random.RandomState(21)
    d, s = cfg.diffusion, cfg.lfae.frame_shape
    out = []
    for _ in range(n):
        vid = rng.uniform(size=(2, d.num_frames, s, s, 3)).astype(np.float32)
        out.append({"ref_img": vid[:, 0].copy(), "real_vid": vid,
                    "cond": rng.standard_normal((2, d.cond_dim)).astype(np.float32),
                    "none_cond_mask": np.array([False, True])})
    return out


def _assert_same_run(a, b, state_a, state_b, module):
    """Same step, the same parameters and buffers of `module`, the same Adam
    moments and step counters, bit for bit."""
    assert state_a.step == state_b.step
    for (k, x), y in zip(getattr(a, module).state_dict().items(), getattr(b, module).state_dict().values()):
        assert torch.equal(x, y), k
    oa, ob = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert set(oa) == set(ob) and len(oa) > 10
    for i in oa:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(oa[i][k], ob[i][k]), (i, k)
            assert oa[i][k].device == ob[i][k].device, (i, k)


def test_dm_trainer_resume_bit_identical(tmp_path):
    """Straight 4 steps == 2 steps + checkpoint + "crash" + a new trainer
    restored from it + 2 more steps (the milestone lowers the rate on the
    third step): the same step, UNet and Adam state, bit for bit."""
    cfg = _port_cfg(_dm_jcfg())
    batches = _dm_batches(cfg, 4)
    straight = _dm_trainer(cfg)
    st = straight.fit(straight.init_state(seed=1), iter(batches), 4, seed=42, log_every=0)

    ckpt = CheckpointManager(str(tmp_path / "ck"))
    crashed = _dm_trainer(cfg)
    crashed.fit(crashed.init_state(seed=1), iter(batches), 2, seed=42, log_every=0,
                checkpoint_fn=lambda s: ckpt.save(crashed.state_dict(s), step=s.step, extra={"seed": 42}),
                checkpoint_every=2)
    del crashed
    resumed = _dm_trainer(cfg)
    rs = resumed.load_state_dict(ckpt.restore(map_location=resumed.device))
    assert rs.step == 2 and ckpt.latest_step() == 2 and ckpt.load_extra() == {"seed": 42}
    assert len(resumed.optimizer.state_dict()["state"]) > 10  # the moments, not a fresh Adam
    rs = resumed.fit(rs, iter(batches[2:]), 4, seed=42, log_every=0, start_step=2)
    _assert_same_run(straight, resumed, st, rs, "model")


def test_lfae_trainer_resume_bit_identical(tmp_path):
    """Straight 3 steps == 1 step + checkpoint + a new trainer restored from
    it + 2 more steps: the step, the three nets' parameters and BatchNorm
    statistics, and the Adam state, bit for bit."""
    cfg = _port_cfg(_tiny_jcfg())
    rng = np.random.RandomState(22)
    batches = [{k: rng.uniform(size=(2, 32, 32, 3)).astype(np.float32) for k in ("source", "driving")}
               for _ in range(3)]
    straight = LFAETrainer(cfg, steps_per_epoch=10, device="cpu")
    st = straight.fit(straight.init_state(seed=3), iter(batches), 3, seed=7, log_every=0)

    ckpt = CheckpointManager(str(tmp_path / "ck"))
    crashed = LFAETrainer(cfg, steps_per_epoch=10, device="cpu")
    crashed.fit(crashed.init_state(seed=3), iter(batches), 1, seed=7, log_every=0,
                checkpoint_fn=lambda s: ckpt.save(crashed.state_dict(s), step=s.step),
                checkpoint_every=1)
    del crashed
    resumed = LFAETrainer(cfg, steps_per_epoch=10, device="cpu")
    rs = resumed.load_state_dict(ckpt.restore("step_00000001", map_location=resumed.device))
    assert rs.step == 1
    rs = resumed.fit(rs, iter(batches[1:]), 3, seed=7, log_every=0, start_step=1)
    assert any(k.endswith("running_var") for k in resumed.model.state_dict())
    _assert_same_run(straight, resumed, st, rs, "model")


def test_training_flow_diffusion_keeps_the_lfae_in_eval_mode():
    """`model.train()` on a training `FlowDiffusion` puts the UNet in train
    mode and leaves the frozen LFAE in eval mode: the pseudo-ground truth is
    the same as before, and no BatchNorm statistic moves."""
    cfg = _port_cfg(_dm_jcfg())
    model = FlowDiffusion(cfg.lfae, cfg.diffusion, device="cpu", training=True)
    lfae = [model.region_predictor, model.bg_predictor, model.generator]
    seed_lfae_weights(lfae, 6)
    rng = np.random.RandomState(23)
    vid = torch.from_numpy(rng.uniform(size=(1, 4, 64, 64, 3)).astype(np.float32))
    before = model.pseudo_ground_truth(vid[:, 0], vid)
    stats = {k: v.clone() for m in lfae for k, v in m.state_dict().items() if "running" in k}
    assert model.train() is model
    assert model.training and model.unet.training
    assert not any(m.training for part in lfae for m in part.modules())
    after = model.pseudo_ground_truth(vid[:, 0], vid)
    for k in before:
        assert torch.equal(before[k], after[k]), k
    now = {k: v for m in lfae for k, v in m.state_dict().items() if "running" in k}
    assert all(torch.equal(stats[k], now[k]) for k in stats) and stats
    model.eval()
    assert not model.unet.training


# ------------------------------------------------------------------ reference import


class _Recording(dict):
    """A state dict that records which keys were read."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _assert_state_equal(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k in want:
        assert got[k].shape == want[k].shape and torch.equal(got[k], want[k]), k


def test_lfae_reference_import_matches_jax_convert():
    jcfg = _tiny_jcfg()
    cfg = _port_cfg(jcfg)
    net = FlowAE(cfg.lfae)
    _randomize(net, np.random.RandomState(31))
    state = net.state_dict()
    ref = lfae_to_reference(state)
    assert ref["generator"]["bottleneck.r0.conv1.weight"].shape == state["generator.bottleneck_r0.conv1.weight"].shape
    recorded = {part: _Recording(_numpy(sd)) for part, sd in ref.items()}
    jvars = jtc.convert_lfae_checkpoint(recorded, jcfg.lfae)
    for part, sd in recorded.items():
        assert sd.read == set(sd), (part, sorted(set(sd) - sd.read))
    ours = convert_lfae_checkpoint(ref, cfg.lfae)
    _assert_state_equal(ours, state)
    _assert_state_equal(from_jax_params(jvars), ours)
    FlowAE(cfg.lfae).load_state_dict(from_jax_params(jvars))  # strict


@pytest.mark.parametrize("use_deconv", [True, False])
def test_unet_reference_import_matches_jax_convert(use_deconv):
    jcfg = _dm_jcfg(use_deconv)
    cfg = _port_cfg(jcfg)
    unet = build_unet(cfg.lfae, cfg.diffusion, training=True)
    _randomize(unet, np.random.RandomState(32))
    state = unet.state_dict()
    ref = unet_to_reference(state)
    assert ref["init_conv.weight"].shape[1:3] == (3 + 64, 1)  # one conv over latent + features
    recorded = _Recording(_numpy(ref))
    jvars = jtc.convert_unet3d(recorded, num_levels=len(cfg.diffusion.dim_mults), use_deconv=use_deconv)
    assert recorded.read == set(recorded), sorted(set(recorded) - recorded.read)
    with torch.device("meta"):
        target = build_unet(cfg.lfae, cfg.diffusion, training=True)
    ours = convert_unet3d(ref, target)
    _assert_state_equal(ours, state)
    _assert_state_equal(from_jax_params(jax.tree.map(np.asarray, jvars)), ours)
    build_unet(cfg.lfae, cfg.diffusion, training=True).load_state_dict(ours)  # strict


def test_load_from_torch_pth_files(tmp_path):
    """`.pth` files in the reference's layouts (with an optimizer state,
    numbers, BatchNorm `num_batches_tracked` and non-UNet diffusion buffers
    the port does not read) load with `weights_only=True`."""
    jcfg = _dm_jcfg()
    cfg = _port_cfg(jcfg)
    rng = np.random.RandomState(33)
    lfae = FlowAE(cfg.lfae)
    _randomize(lfae, rng)
    ref = lfae_to_reference(lfae.state_dict())
    ref["region_predictor"]["predictor.encoder.down_blocks.0.norm.num_batches_tracked"] = torch.tensor(5)
    w = torch.nn.Parameter(torch.ones(3))
    opt = torch.optim.Adam([w])
    w.sum().backward()
    opt.step()
    torch.save({**ref, "optimizer": opt.state_dict(), "epoch": 3, "example": 1200}, tmp_path / "RegionMM.pth")
    assert load_torch_state_dicts(str(tmp_path / "RegionMM.pth"))["epoch"] == 3
    _assert_state_equal(load_lfae_from_torch(str(tmp_path / "RegionMM.pth"), cfg.lfae), lfae.state_dict())

    unet = build_unet(cfg.lfae, cfg.diffusion, training=True)
    _randomize(unet, rng)
    diffusion = {f"denoise_fn.{k}": v for k, v in unet_to_reference(unet.state_dict()).items()}
    diffusion["betas"] = torch.linspace(0, 1, 50)
    torch.save({"diffusion": diffusion, "optimizer_diff": opt.state_dict(), "example": 7},
               tmp_path / "flowdiff.pth")
    got = load_unet_from_torch(str(tmp_path / "flowdiff.pth"), unet)
    _assert_state_equal(got, unet.state_dict())
    with pytest.raises(KeyError):
        convert_unet3d({k: v for k, v in unet_to_reference(unet.state_dict()).items()
                        if not k.startswith("mid_block1.")}, unet)
