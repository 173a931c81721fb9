"""The port's training CLIs (`python -m cvpr23_lfdm_torch.scripts.{train_dm,
train_lfae,make_bench_ckpt,preprocess}`) on the CPU at a tiny config.

* `train_dm.run`, 4 steps with every hook firing (still grid every 2, GIF
  at 3, sample GIF at 4): its state (UNet, Adam moments, step) equal
  (torch.equal) to `DMTrainer.fit` called directly on the same batches and
  seed; the PNGs and GIFs written; the checkpoint directory read back by
  `CheckpointManager`. `--resume`: 2 steps, then on to 4, equal to 4
  straight steps, with the thread loader and with `--loader grain`.
* `train_lfae.run`, the same against `LFAETrainer.fit`, with the
  `Visualizer` board written; `--resume`; `--warm-start` of a reference
  `.pth` (written by `utils/torch_convert.py::lfae_to_reference`) starts
  from those weights; `train_dm --lfae-ckpt <that run's lfae_ckpt>` trains
  on them.
* `train_lfae --vgg-weights` of a torchvision `vgg19` state dict.
* `make_bench_ckpt.run`, 2 + 2 steps (`--save-every 1`) and one probe video:
  the directory is read by both packages' loaders, `fit_report.json` has
  finite `disp_p99_px` at 32, 64 and 128 and no `fit_rate`.
* `preprocess --dataset mug`: the split of the JAX CLI.
* The parsers: each JAX flag the port keeps has the JAX default. Changed on
  purpose: `make_bench_ckpt --out` (default `<log-dir>/bench_ckpt`: the
  committed `assets/bench_ckpt` belongs to the JAX package), and
  `train_dm --lfae-ckpt` reads a port checkpoint directory where the JAX
  CLI reads an Orbax one (the flag and its default are the same).
* The four CLIs in a fresh interpreter with `cv2`, `imageio`, `PIL`,
  `matplotlib`, `grain`, `transformers`, `jax` and `flax` blocked.

Config: `tests/test_torch_cli.py::tiny_cfg` (64² frames, 4 of them, 16²
latent, UNet dim 32) in the training form `pallas2` (plain version here),
LFAE loss scales (1, 0.5); batches of 2 videos or 4 pairs.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cvpr23_lfdm_torch.scripts import make_bench_ckpt, preprocess, train_dm, train_lfae
from cvpr23_lfdm_torch.utils.checkpoint import CheckpointManager
from test_torch_cli import ROOT, UNPORTED, _jax_parser, tiny_cfg

BLOCKED = ("cv2", "imageio", "imageio.v2", "PIL", "matplotlib", "matplotlib.pyplot", "grain",
           "grain.python", "transformers", "jax", "flax")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def train_cfg():
    cfg = tiny_cfg("pallas2")
    return cfg.replace(lfae_train=dataclasses.replace(cfg.lfae_train, scales=(1.0, 0.5)))


def dm_args(log_dir, corpus, steps, *extra):
    return train_dm.parser().parse_args([
        "--device", "cpu", "--synthetic", "--data-root", str(corpus), "--log-dir", str(log_dir),
        "--batch-size", "2", "--num-steps", str(steps), *extra])


def lfae_args(log_dir, corpus, steps, *extra):
    return train_lfae.parser().parse_args([
        "--device", "cpu", "--synthetic", "--data-root", str(corpus), "--log-dir", str(log_dir),
        "--batch-size", "4", "--num-steps", str(steps), *extra])


def run_dm(log_dir, corpus, steps=4, *extra) -> dict:
    return train_dm.run(train_cfg(), dm_args(log_dir, corpus, steps, *extra))


def run_lfae(log_dir, corpus, steps=3, *extra) -> dict:
    return train_lfae.run(train_cfg(), lfae_args(log_dir, corpus, steps, *extra))


def run_bench_ckpt(log_dir, corpus) -> dict:
    args = make_bench_ckpt.parser().parse_args([
        "--device", "cpu", "--log-dir", str(log_dir), "--data-root", str(corpus), "--lfae-steps", "2",
        "--dm-steps", "2", "--lfae-batch", "4", "--dm-batch", "2", "--probe-videos", "1", "--save-every", "1"])
    return make_bench_ckpt.run(train_cfg(), args)


def assert_states_equal(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_states_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_states_equal(x, y, f"{where}[{i}]")
    elif torch.is_tensor(a):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def saved(log_dir, name):
    return CheckpointManager(os.path.join(str(log_dir), name)).restore("latest")


def test_train_dm_equals_fit_and_writes_its_hooks(tmp_path):
    from cvpr23_lfdm_torch.data import DMVideoDataset, PrefetchLoader, get_spec
    from cvpr23_lfdm_torch.scripts._common import load_text_embedder
    from cvpr23_lfdm_torch.train.dm_trainer import DMTrainer

    corpus = tmp_path / "corpus"
    res = run_dm(tmp_path / "log", corpus, 4, "--save-img-freq", "2", "--save-vid-freq", "3",
                 "--sample-vid-freq", "4")
    assert res["steps"] == 4 and res["state"].step == 4
    log = tmp_path / "log"
    assert sorted(os.listdir(log / "dm_imgs")) == ["step_0000002.png", "step_0000004.png"]
    assert os.listdir(log / "dm_vidshots") == ["B0002_S000003.gif"]
    assert os.listdir(log / "dm_samples") == ["B0002_S000004.gif"]
    for gif in (log / "dm_vidshots" / "B0002_S000003.gif", log / "dm_samples" / "B0002_S000004.gif"):
        with open(gif, "rb") as f:
            assert f.read(6) == b"GIF89a"
    ckpt = CheckpointManager(str(log / "dm_ckpt"))
    assert ckpt.latest_step() == 4 and ckpt.load_extra() == {"seed": 1234}
    got = ckpt.restore("latest")

    # DMTrainer.fit itself, on the same model, batches and seed
    cfg = train_cfg()
    args = dm_args(log, corpus, 4)
    dataset = DMVideoDataset(get_spec("mug"), str(corpus), "train", num_frames=4, image_size=64,
                             sampling=cfg.dm_train.frame_sampling, seed=1234)
    trainer = DMTrainer(cfg, max(1, len(dataset) // 2), model=train_dm.build_model(cfg, args, "cpu"))
    state = trainer.init_state(1234)
    loader = PrefetchLoader(dataset, 2, num_workers=16, seed=1234)
    state = trainer.fit(state, train_dm.dm_batches(loader, load_text_embedder(args)), 4, 1234)
    assert_states_equal(got, trainer.state_dict(state))


@pytest.mark.parametrize("loader", ["threads", "grain"])
def test_train_dm_resume_equals_a_straight_run(tmp_path, loader):
    corpus = tmp_path / "corpus"
    run_dm(tmp_path / "straight", corpus, 4, "--loader", loader)
    first = run_dm(tmp_path / "resumed", corpus, 2, "--loader", loader)
    assert first["state"].step == 2
    res = run_dm(tmp_path / "resumed", corpus, 4, "--loader", loader, "--resume")
    assert res["start_step"] == 2 and res["steps"] == 2
    extra = CheckpointManager(str(tmp_path / "resumed" / "dm_ckpt")).load_extra()
    assert ("grain_state" in extra) == (loader == "grain")
    assert_states_equal(saved(tmp_path / "resumed", "dm_ckpt"), saved(tmp_path / "straight", "dm_ckpt"))


def test_train_lfae_equals_fit_resumes_and_feeds_train_dm(tmp_path):
    from cvpr23_lfdm_torch.data import ClipAugment, DatasetRepeater, LFAEPairDataset, PrefetchLoader, get_spec
    from cvpr23_lfdm_torch.train.lfae_trainer import LFAETrainer

    corpus = tmp_path / "corpus"
    res = run_lfae(tmp_path / "log", corpus, 3, "--save-img-freq", "2")
    assert res["state"].step == 3 and res["avd_params"] > 0
    assert os.listdir(tmp_path / "log" / "lfae_imgs") == ["step_0000002.png"]
    from cvpr23_lfdm_torch.data.io import read_image

    board = read_image(str(tmp_path / "log" / "lfae_imgs" / "step_0000002.png"))
    assert board.shape == (64, 5 * 64, 3)  # driving, source, deformed, prediction, occlusion
    got = saved(tmp_path / "log", "lfae_ckpt")

    cfg = train_cfg()
    dataset = DatasetRepeater(LFAEPairDataset(get_spec("mug"), str(corpus), "train", frame_shape=64,
                                              augment=ClipAugment(), seed=1234), cfg.lfae_train.num_repeats)
    trainer = LFAETrainer(cfg, max(1, len(dataset) // 4), device="cpu")
    state = trainer.init_state(1234)
    state = trainer.fit(state, iter(PrefetchLoader(dataset, 4, num_workers=6, seed=1234)), 3, 1234)
    assert_states_equal(got, trainer.state_dict(state))

    # resume: 2 steps, then on to 3
    run_lfae(tmp_path / "resumed", corpus, 2)
    res = run_lfae(tmp_path / "resumed", corpus, 3, "--resume")
    assert res["start_step"] == 2
    assert_states_equal(saved(tmp_path / "resumed", "lfae_ckpt"), got)

    # train_dm on this run's stage-1 weights
    res = run_dm(tmp_path / "dm", corpus, 1, "--lfae-ckpt", str(tmp_path / "log" / "lfae_ckpt"))
    model = res["trainer"].model
    for name in ("region_predictor", "bg_predictor", "generator"):
        for k, v in getattr(model, name).state_dict().items():
            assert torch.equal(v, got["model"][f"{name}.{k}"]), (name, k)


def test_train_lfae_warm_starts_from_a_reference_pth(tmp_path, monkeypatch):
    from cvpr23_lfdm_torch.models.flow_autoenc import FlowAE, seed_lfae_weights
    from cvpr23_lfdm_torch.train.lfae_trainer import LFAETrainer
    from cvpr23_lfdm_torch.utils.torch_convert import lfae_to_reference

    net = FlowAE(train_cfg().lfae)
    seed_lfae_weights([net], 7)
    pth = str(tmp_path / "RegionMM.pth")
    torch.save(lfae_to_reference(net.state_dict()), pth)
    seen, fit = {}, LFAETrainer.fit

    def record(self, state, *a, **k):  # the weights the first step starts from
        seen.update({key: v.clone() for key, v in self.model.state_dict().items()})
        return fit(self, state, *a, **k)

    monkeypatch.setattr(LFAETrainer, "fit", record)
    res = run_lfae(tmp_path / "log", tmp_path / "corpus", 1, "--warm-start", pth)
    assert res["start_step"] == 0
    assert_states_equal(seen, net.state_dict())


def test_train_lfae_loads_torchvision_vgg_weights(tmp_path):
    """`--vgg-weights`: a torchvision `vgg19` state dict (`features.{idx}.*`,
    classifier keys ignored) becomes the perceptual loss's VGG19."""
    from cvpr23_lfdm_torch.train.vgg import Vgg19Features, seed_vgg_weights

    vgg = Vgg19Features()
    seed_vgg_weights(vgg, 5)
    sd = {"features." + k.removeprefix("conv_"): v for k, v in vgg.state_dict().items()}
    sd["classifier.0.weight"] = torch.zeros(3, 2)
    path = str(tmp_path / "vgg19.pth")
    torch.save(sd, path)
    res = run_lfae(tmp_path / "log", tmp_path / "corpus", 1, "--vgg-weights", path)
    assert_states_equal(res["trainer"].vgg.state_dict(), vgg.state_dict())


def test_make_bench_ckpt_is_read_by_both_packages(tmp_path, capsys):
    import jax

    from cvpr23_lfdm_torch.utils.bench_ckpt import apply_bench_ckpt, to_jax_params
    from cvpr23_lfdm_tpu.utils import bench_ckpt as jck

    res = run_bench_ckpt(tmp_path / "log", tmp_path / "corpus")
    assert capsys.readouterr().out.count("snapshot saved at step") == 2  # --save-every 1
    out = res["out"]
    assert out == os.path.join(str(tmp_path / "log"), "bench_ckpt")
    assert sorted(os.listdir(out)) == [".lock", "cond.npy", "fit_report.json", "generator.msgpack",
                                       "meta.json", "ref.npy", "unet.msgpack"]
    with open(os.path.join(out, "fit_report.json")) as f:
        report = json.load(f)
    assert "fit_rate" not in report and report["probe_videos"] == 1
    assert sorted(report["disp_p99_px"][0]) == ["128", "32", "64"]
    assert all(np.isfinite(v) for v in report["disp_p99_px"][0].values())
    assert report["lfae_steps"] == report["dm_steps"] == 2 and report["objective"] == "x0"

    cfg, model, cond, ref, meta = apply_bench_ckpt(out, train_cfg(), device="cpu")
    assert meta == {"objective": "x0"} and cfg.diffusion.objective == "x0"
    assert cond.shape == (1, 768) and ref.shape == (1, 64, 64, 3)
    video = model.sample_video(ref, cond, 1.0, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(video["out_vid"]).all()
    # the JAX package's reader, on templates of the same trees
    unet_t = to_jax_params(model.unet.state_dict())
    lfae_t = {c: {"generator": t} for c, t in to_jax_params(model.generator.state_dict()).items()}
    loaded = jck.load_bench_ckpt(out, unet_t, lfae_t)
    got = jax.device_get(loaded.unet_vars)
    flat = jax.tree_util.tree_leaves_with_path(unet_t)
    for path, leaf in flat:
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(np.asarray(node), leaf)
    assert loaded.meta["objective"] == "x0"
    np.testing.assert_array_equal(loaded.cond[None], cond.numpy())


def test_preprocess_mug_splits_as_the_jax_cli(tmp_path, capsys):
    from cvpr23_lfdm_tpu.data.preprocess import mug_split

    for s in ("001", "002", "017", "033", "040"):
        os.makedirs(tmp_path / s)
    res = preprocess.main(["--dataset", "mug", "--data-root", str(tmp_path), "--seed", "3"])
    assert (res["train"], res["test"]) == mug_split(str(tmp_path), 3)
    assert "train:" in capsys.readouterr().out


@pytest.mark.parametrize("name,module", [("train_dm", train_dm), ("train_lfae", train_lfae),
                                         ("make_bench_ckpt", make_bench_ckpt), ("preprocess", preprocess)])
def test_parser_keeps_the_jax_flags(name, module):
    changed = {"out"} if name == "make_bench_ckpt" else set()
    theirs = {a.dest: a for a in _jax_parser(name)._actions if a.dest != "help"}
    ours = {a.dest: a for a in module.parser()._actions if a.dest != "help"}
    for dest, action in theirs.items():
        if dest in ("platform", "matmul_precision"):
            assert dest not in ours and "device" in ours
        elif dest == "warp_impl":
            assert dest not in ours
        else:
            assert dest in ours, dest
            assert ours[dest].option_strings == action.option_strings, dest
            if dest in changed:
                assert ours[dest].default == "" and action.default.endswith(os.path.join("assets", "bench_ckpt"))
                continue
            default = ours[dest].default
            assert (tuple(default) if isinstance(default, list) else default) == (
                tuple(action.default) if isinstance(action.default, list) else action.default), dest
    assert ours["device"].default is None
    for flags in UNPORTED:
        with pytest.raises(SystemExit, match="not ported"):
            module.main(["--device", "cpu", *flags])


CARD_INSTALL = """
import sys
import torch
torch.set_num_threads(1)
for m in {blocked!r}:
    sys.modules[m] = None
sys.path.insert(0, {tests!r})
import test_torch_train_cli as t
d = {tmp!r}
res = t.run_dm(d + "/dm", d + "/corpus", 2, "--save-img-freq", "1", "--save-vid-freq", "2", "--sample-vid-freq", "2",
               "--loader", "grain")
assert res["state"].step == 2
res = t.run_lfae(d + "/lfae", d + "/corpus", 2, "--save-img-freq", "2")
assert res["state"].step == 2
res = t.run_bench_ckpt(d + "/mbc", d + "/corpus")
assert "fit_rate" not in res["report"]
res = t.preprocess.main(["--dataset", "mug", "--data-root", d + "/corpus"])
assert res["train"]
print("OK", sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r} and sys.modules[m] is not None))
"""


def test_training_clis_run_without_the_host_libraries_the_card_lacks(tmp_path):
    code = CARD_INSTALL.format(blocked=BLOCKED, tests=os.path.join(ROOT, "tests"), tmp=str(tmp_path))
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "OK []"
    for sub in ("dm/dm_imgs", "dm/dm_vidshots", "dm/dm_samples", "lfae/lfae_imgs", "mbc/bench_ckpt"):
        assert os.listdir(tmp_path / sub), sub
