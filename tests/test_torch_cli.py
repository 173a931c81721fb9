"""The port's CLIs (`python -m cvpr23_lfdm_torch.scripts.{demo,test_dm,
eval_flowautoenc}`) on the CPU at a tiny config.

* `demo.run`: one GIF per class (ref | out | warped | flow | confidence),
  and `out_vid` equal (torch.equal) to `FlowDiffusion.sample_video` called
  directly with the same weights, reference image, class table and
  generator; `sample_video` is held against the JAX package elsewhere
  (`tests/test_torch_slice.py`).
* `test_dm.run` on a synthetic corpus with `--random-metric-weights`:
  every metric finite, every GIF written.
* `eval_flowautoenc.run` on a synthetic corpus, with seeded weights and
  with the same weights from a `CheckpointManager` directory: the JSON is
  written and both runs agree with `evaluate` called directly.
* The parsers: each JAX flag the port keeps has the JAX default; the
  replaced (`--platform`, `--matmul-precision` -> `--device`) and absent
  (`--warp-impl`) flags are not offered; each unported flag raises.
* The three CLIs (`eval_flowautoenc` with `--save-video`: the warp
  lattices) in a fresh interpreter with `cv2`, `imageio`, `PIL`,
  `matplotlib`, `transformers` (and JAX) blocked in `sys.modules`: the
  card's installation (`test_dm` there without the metric extractors, which
  the in-process test runs).

Config: 64² frames, 16² latent, UNet dim 32 mults (1, 2), 4 heads, F=4,
3 DDIM steps, a small LFAE, fp32, the `pallas3` form (plain layers here).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cvpr23_lfdm_torch import config as C
from cvpr23_lfdm_torch.scripts import demo, eval_flowautoenc, test_dm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("cv2", "imageio", "imageio.v2", "PIL", "matplotlib", "matplotlib.pyplot",
           "transformers", "jax", "flax")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: as fast at these sizes, and the test processes
    that share the CPU do not oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(attn="pallas3") -> C.ExperimentConfig:
    small = dict(num_blocks=3, block_expansion=8, max_features=64)
    lfae = C.LFAEConfig(
        frame_shape=64, region_predictor=C.RegionPredictorConfig(**small),
        bg_predictor=C.BGPredictorConfig(**small),
        generator=C.GeneratorConfig(num_bottleneck_blocks=2, block_expansion=16, max_features=64,
                                    pixelwise_flow=C.PixelwiseFlowConfig(**small)))
    d = C.DiffusionConfig(img_size=16, num_frames=4, timesteps=50, sampling_timesteps=3, dim=32,
                          dim_mults=(1, 2), attn_heads=4, compute_dtype="float32",
                          temporal_attn_impl=attn)
    return C.ExperimentConfig(dataset="mug", lfae=lfae, diffusion=d)


def run_demo(log_dir, classes=("anger", "fear")) -> dict:
    args = demo.parser().parse_args(["--device", "cpu", "--log-dir", str(log_dir), "--classes", *classes])
    saved, demo.BENCH_CKPT = demo.BENCH_CKPT, os.path.join(log_dir, "none")  # seeded weights
    try:
        return demo.run(tiny_cfg(), args)
    finally:
        demo.BENCH_CKPT = saved


def run_test_dm(log_dir, data_root, metrics: bool = True) -> dict:
    args = test_dm.parser().parse_args([
        "--device", "cpu", "--log-dir", str(log_dir), "--synthetic", "--data-root", str(data_root),
        "--num-videos", "2", "--save-video"] + (["--random-metric-weights"] if metrics else []))
    return test_dm.run(tiny_cfg(), args)


def run_eval(log_dir, data_root, extra=()) -> dict:
    args = eval_flowautoenc.parser().parse_args([
        "--device", "cpu", "--log-dir", str(log_dir), "--synthetic", "--data-root", str(data_root),
        "--num-frames", "4", "--batch-size", "3", *extra])
    return eval_flowautoenc.run(tiny_cfg(), args)


def test_demo_matches_sample_video(tmp_path):
    import imageio.v2 as imageio

    from cvpr23_lfdm_torch.diffusion.flow_diffusion import FlowDiffusion
    from cvpr23_lfdm_torch.models.text import MUG_CLASSES, TextEmbedder
    from cvpr23_lfdm_torch.scripts._common import load_model_weights

    res = run_demo(tmp_path)
    assert [os.path.basename(p) for p in res["gifs"]] == ["anger.gif", "fear.gif"]
    for p in res["gifs"]:
        frames = np.asarray(imageio.mimread(p))
        assert frames.shape[:4] == (4, 64, 5 * 64, 3)
    # the same model, image, table and generator, called directly
    cfg = tiny_cfg()
    torch.manual_seed(1234)
    model = FlowDiffusion(cfg.lfae, cfg.diffusion, device="cpu")
    load_model_weights(model, "", "")
    args = demo.parser().parse_args([])
    ref = torch.from_numpy(demo.reference_image(args, 64))[None]
    table = TextEmbedder.random_for_testing(MUG_CLASSES)
    gen = torch.Generator().manual_seed(1234)
    for text in ("anger", "fear"):
        out = model.sample_video(ref, torch.from_numpy(table([text])[0]), 1.0, generator=gen)
        got = res["outputs"][text]
        for k in ("out_vid", "warped_vid", "vid_grid", "vid_conf"):
            assert torch.equal(torch.from_numpy(got[k]), out[k]), (text, k)


def test_test_dm_metrics_are_finite(tmp_path):
    res = run_test_dm(tmp_path / "log", tmp_path / "corpus")
    assert res["videos"] == 2
    for k in ("rec_loss", "warp_loss", "psnr", "ssim", "lpips", "fvd", "cfvd", "sfvd"):
        assert np.isfinite(res[k]), k
    assert sorted(os.listdir(tmp_path / "log" / "dm_test")) == [
        "001_anger_take000.gif", "001_disgust_take000.gif"]


def test_eval_flowautoenc_writes_json_and_reads_checkpoints(tmp_path):
    from cvpr23_lfdm_torch.data import DMVideoDataset, get_spec
    from cvpr23_lfdm_torch.eval.flowautoenc import evaluate
    from cvpr23_lfdm_torch.models.flow_autoenc import FlowAE, seed_lfae_weights
    from cvpr23_lfdm_torch.utils.checkpoint import CheckpointManager

    res = run_eval(tmp_path / "log", tmp_path / "corpus")
    with open(tmp_path / "log" / "flowautoenc_eval.json") as f:
        assert json.load(f) == res
    assert np.isfinite(res["out_loss"]) and np.isfinite(res["warp_loss"])
    cfg = tiny_cfg()
    torch.manual_seed(7)
    lfae = FlowAE(cfg.lfae)
    seed_lfae_weights([lfae], 3)
    CheckpointManager(str(tmp_path / "ckpt")).save({"step": 0, "model": lfae.state_dict()}, step=0)
    res = run_eval(tmp_path / "log2", tmp_path / "corpus", ["--lfae-ckpt", str(tmp_path / "ckpt")])
    ds = DMVideoDataset(get_spec("mug"), str(tmp_path / "corpus"), "test", num_frames=4, image_size=64,
                        color_jitter=False, sampling="uniform", seed=1234)
    want = evaluate(lfae.state_dict(), cfg.lfae, ds, batch_size=3, image_size=64, device="cpu")
    assert res == want


def _jax_parser(script: str):
    """The parser a JAX CLI builds in its `main()`, caught at `parse_args`."""
    import argparse
    import importlib

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        mod = importlib.import_module(script)
    finally:
        sys.path.remove(os.path.join(ROOT, "scripts"))

    class Caught(Exception):
        pass

    def grab(self, *a, **k):
        raise Caught(self)

    saved = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        mod.main()
    except Caught as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = saved
    raise AssertionError(f"{script}.main() built no parser")


REPLACED = {"platform": "device", "matmul_precision": "device"}
ABSENT = {"warp_impl"}
UNPORTED = (["--mesh", "dp=2"], ["--coordinator", "localhost:1234"], ["--num-processes", "2"],
            ["--process-id", "0"])
# the CLIs that take the multi-device flags (demo, test_dm, train_dm,
# train_lfae): the flags that still raise, and what they say (`tp=2` or
# `sp=2` in one process: the serving CLIs take tp and sp and want 2
# processes, the training CLIs take neither)
MULTI_DEVICE_ERRORS = ((["--mesh", "tp=2"], "not ported"), (["--mesh", "dp=1,sp=2"], "serving only"),
                       (["--mesh", "dp=2"], "number of processes"),
                       (["--mesh", "zz=2"], "unknown mesh axis"), (["--mesh", "sp=0"], "at least 1"),
                       (["--coordinator", "localhost:1234"], "together"),
                       (["--num-processes", "2"], "together"), (["--process-id", "0"], "together"))
SERVING_ERRORS = {("--mesh", "tp=2"): "number of processes", ("--mesh", "dp=1,tp=3"): "must divide",
                  ("--mesh", "dp=1,sp=2"): "needs 2 processes", ("--mesh", "sp=3"): "must divide the height",
                  ("--mesh", "tp=2,sp=2"): "tp=2 x sp=2 needs 4 processes"}


def assert_multi_device_flags(module, multi_device: bool, serving: bool = False):
    """Each flag that cannot run here raises before any work: every
    multi-device flag where the CLI does not take them, else the table
    (with `serving`, a CLI that takes the tp and sp axes)."""
    cases = MULTI_DEVICE_ERRORS if multi_device else [(f, "not ported") for f in UNPORTED]
    if serving:
        cases = [(f, SERVING_ERRORS.get(tuple(f), m)) for f, m in cases] + [
            (list(f), m) for f, m in SERVING_ERRORS.items() if list(f) not in [c[0] for c in cases]]
    for flags, message in cases:
        with pytest.raises(SystemExit, match=message):
            module.main(["--device", "cpu", *flags])


@pytest.mark.parametrize("name,module", [("demo", demo), ("test_dm", test_dm),
                                         ("eval_flowautoenc", eval_flowautoenc)])
def test_parser_keeps_the_jax_flags(name, module):
    theirs = {a.dest: a for a in _jax_parser(name)._actions if a.dest != "help"}
    ours = {a.dest: a for a in module.parser()._actions if a.dest != "help"}
    for dest, action in theirs.items():
        if dest in REPLACED:
            assert dest not in ours and REPLACED[dest] in ours
        elif dest in ABSENT:
            assert dest not in ours
        else:
            assert dest in ours, dest
            default = ours[dest].default
            assert (tuple(default) if isinstance(default, list) else default) == (
                tuple(action.default) if isinstance(action.default, list) else action.default), dest
            assert ours[dest].option_strings == action.option_strings, dest
    assert ours["device"].default is None  # the card unless the caller says otherwise
    assert_multi_device_flags(module, name != "eval_flowautoenc", serving=name != "eval_flowautoenc")


CARD_INSTALL = """
import sys
import torch
torch.set_num_threads(1)
for m in {blocked!r}:
    sys.modules[m] = None
sys.path.insert(0, {tests!r})
import test_torch_cli as t
d = {tmp!r}
res = t.run_demo(d + "/demo")
assert len(res["gifs"]) == 2
res = t.run_test_dm(d + "/dm", d + "/corpus", metrics=False)  # I3D / LPIPS run in-process above
assert all(v == v for v in res.values())
res = t.run_eval(d + "/eval", d + "/corpus", ["--save-video"])
import os
gifs = os.listdir(d + "/eval/eval_videos")  # warp lattices drawn without matplotlib
assert gifs and all(open(d + "/eval/eval_videos/" + g, "rb").read(6) == b"GIF89a" for g in gifs)
print("OK", sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r} and sys.modules[m] is not None))
"""


def test_clis_run_without_the_host_libraries_the_card_lacks(tmp_path):
    code = CARD_INSTALL.format(blocked=BLOCKED, tests=os.path.join(ROOT, "tests"), tmp=str(tmp_path))
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "OK []"
