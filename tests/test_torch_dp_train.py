"""Data-parallel training on the CPU: `DMTrainer` and `LFAETrainer` on a
two-rank `data` mesh, and the CLIs' multi-process flags.

Two rank processes (`tests/torch_dp_worker.py`: the port only, gloo on
127.0.0.1) run every rank-side case of this file in one module-scoped
spawn; each rank is given its contiguous half of every global batch. This
process builds the weights and batches from numpy seeds and computes the
references: the port in one process on the global batch, and the JAX
trainers on a 2-device `data` mesh (`make_mesh(2)` of the conftest's 8
virtual devices; Pallas in interpret mode).

* DM: the config of `tests/test_torch_train.py` cut to 32² frames (an 8²
  latent, UNet dim 16, 2 heads) at global B=4, two steps,
  the `xla` UNet form (the step's data parallelism does not depend on the
  form; `pallas2` is held in `tests/test_torch_train.py` and on the card in
  `chip_smoke.py`'s `dp` phase), the draws (t, noise, null-condition
  dropout) of the JAX key for the
  global batch, which each rank's trainer cuts to its rows. Against one
  process: the loss 1e-5 relative, each all-reduced gradient within 1e-5
  of its norm. Against the JAX trainer: loss 1e-5 relative, gradient norm
  1e-3, and the parameters within the Adam band of
  `test_train_steps_match_jax` (2·Σlr at most, 99% within 0.05·Σlr: Adam's
  first steps are close to lr·sign(g), and a gradient near 0 may flip
  sign with the order of the sums). Without injected draws, the ranks'
  draws from `step_generator` equal one process's.
* LFAE: the tiny config of `tests/test_torch_lfae_train.py`, global B=4,
  the synchronised BatchNorm; two steps with injected global TPS
  transforms, against one process and against the JAX `LFAETrainer` at
  the tolerances of `test_two_trainer_steps_match_jax`.
* CLIs: `train_dm` as two processes (`--coordinator`, `--num-processes 2`,
  `--process-id`) at the tiny config of `tests/test_torch_train_cli.py`,
  two steps: the state against a one-process run (Adam band), rank 0 the
  only writer of checkpoints, `--resume` continuing at step 2; then `demo
  --mesh dp=2` writes one GIF per class on rank 0 only, its videos those
  of one process's `sample_video` of the padded class batch (1e-4).
* `GrainLoader`: a state saved by shard 0 resumes shard 1 on the batches
  a straight shard-1 stream takes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr23_lfdm_tpu.models.flow_autoenc import init_lfae_vars
from cvpr23_lfdm_tpu.parallel.mesh import make_mesh as jmake_mesh, replicate as jreplicate
from cvpr23_lfdm_tpu.train import lfae_trainer as jlt
from cvpr23_lfdm_tpu.train.dm_trainer import DMTrainer as JDMTrainer, DMTrainState as JDMTrainState
from cvpr23_lfdm_torch.data.grain_loader import GrainLoader
from cvpr23_lfdm_torch.scripts import demo
from cvpr23_lfdm_torch.scripts._common import load_text_embedder
from cvpr23_lfdm_torch.train.dm_trainer import DMTrainer, step_generator
from cvpr23_lfdm_torch.train.lfae_trainer import LFAETrainer
from cvpr23_lfdm_torch.utils.bench_ckpt import from_jax_params, to_jax_params
from test_torch_cli import tiny_cfg
from test_torch_grain_loader import Visits, assert_same, take
from test_torch_lfae_train import _both_tps, _tiny_jcfg, _tps_params, _walk, _zero_grad_leaf
from test_torch_parallel import spawn_ranks
from test_torch_slice import _port_cfg
from test_torch_train import _cfg, _draws
from test_torch_train_cli import run_dm, train_cfg
from test_torch_unet import _random_variables

T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():  # module scope: it runs before the module's spawn fixture
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
LR = 2e-4
B = 4  # the global batch of the trainer cases


def _clone(sd: dict) -> dict:
    return {k: v.detach().clone() for k, v in sd.items()}


def _grads(module) -> dict:
    return {k: p.grad.clone() for k, p in module.named_parameters() if p.grad is not None}


def assert_grads_close(got: dict, want: dict, rel: float, what: str):
    """Each gradient within `rel` of its norm."""
    assert set(got) == set(want), what
    for k, w in want.items():
        err, scale = float((got[k] - w).norm()), float(w.norm())
        assert err <= rel * max(scale, 1e-30), (what, k, err, scale)


def assert_adam_band(got: dict, want: dict, lr_sum: float, what: str):
    """Every entry within 2·Σlr and 99% of each tensor's entries within
    0.05·Σlr (`test_train_steps_match_jax`)."""
    assert set(got) == set(want), what
    for k, w in want.items():
        diff = (got[k] - w).abs()
        assert float(diff.max()) <= 2 * lr_sum * 1.01, (what, k, float(diff.max()))
        assert float((diff <= 0.05 * lr_sum).float().mean()) >= 0.99, (what, k)


# ------------------------------------------------------------------ inputs


def _dm_inputs():
    """The DM case: JAX and port weights, two global batches and the JAX
    key's draws for them."""
    cfg = _cfg(objective="eps", learn_null_cond=True)  # cut to 32² frames, an 8² latent, UNet dim 16
    cfg = cfg.replace(lfae=dataclasses.replace(cfg.lfae, frame_shape=32),
                      diffusion=dataclasses.replace(cfg.diffusion, img_size=8, dim=16, attn_heads=2,
                                                    temporal_attn_impl="xla"),
                      dm_train=dataclasses.replace(cfg.dm_train, batch_size=B))
    rng = np.random.RandomState(1)
    lfae_vars = _random_variables(jax.eval_shape(
        lambda r: init_lfae_vars(r, cfg.lfae), jax.random.PRNGKey(0)), rng)
    jt = JDMTrainer(cfg, steps_per_epoch=2, lfae_vars=lfae_vars, mesh=jmake_mesh(2))
    unet_vars = _random_variables(jax.eval_shape(jt.model.init_unet_vars, jax.random.PRNGKey(1)), rng)
    tcfg = _port_cfg(cfg)
    tt = DMTrainer(tcfg, steps_per_epoch=2, device="cpu")
    tt.model.load_jax_variables(unet_vars, lfae_vars)
    f, s, fs = cfg.diffusion.num_frames, cfg.diffusion.img_size, cfg.lfae.frame_shape
    batches, keys, draws = [], [], []
    for i in range(2):
        vid = rng.uniform(size=(B, f, fs, fs, 3)).astype(np.float32)
        batches.append({"ref_img": vid[:, 0].copy(), "real_vid": vid,
                        "cond": rng.standard_normal((B, cfg.diffusion.cond_dim)).astype(np.float32),
                        "none_cond_mask": np.array([False, True, False, False])})
        keys.append(jax.random.fold_in(jax.random.PRNGKey(5), i))
        draws.append(tuple(T(np.asarray(a)) for a in _draws(keys[-1], cfg.diffusion, (B, f, s, s, 3))))
    return {"jt": jt, "unet_vars": unet_vars, "tt": tt, "batches": batches, "keys": keys,
            "draws": draws, "model": _clone(tt.model.state_dict()), "cfg": tcfg}


def _lfae_inputs(losses: str):
    jcfg = _tiny_jcfg(perceptual=10.0 if losses == "recipe" else 0.0)
    trainer = LFAETrainer(_port_cfg(jcfg), steps_per_epoch=10, device="cpu")
    trainer.init_state(seed=5)
    rng = np.random.RandomState(11)
    s = jcfg.lfae.frame_shape
    batches = [{k: rng.uniform(size=(B, s, s, 3)).astype(np.float32) for k in ("source", "driving")}
               for _ in range(2)]
    tps = [_tps_params(rng, B)] * 2  # one transform: the JAX step traces its draw once
    return {"jcfg": jcfg, "trainer": trainer, "batches": batches, "tps": tps,
            "model": _clone(trainer.model.state_dict()), "vgg": _clone(trainer.vgg.state_dict())}


def _cli_inputs(tmp):
    """The one-process `train_dm` run (it also writes the synthetic corpus
    the ranks read) and the ranks' argv."""
    corpus = tmp / "corpus"
    one = run_dm(tmp / "one", corpus, 2)
    argv = ["--device", "cpu", "--synthetic", "--data-root", str(corpus), "--log-dir", str(tmp / "two"),
            "--batch-size", "2"]
    classes = ["anger", "fear", "happiness"]
    return {"one": one, "case": {"cfg": train_cfg(), "train": [*argv, "--num-steps", "2"],
                                 "resume": [*argv, "--num-steps", "3", "--resume"],
                                 "demo_cfg": tiny_cfg(), "demo_dir": str(tmp / "demo"),
                                 "demo": ["--device", "cpu", "--mesh", "dp=2", "--classes", *classes]},
            "classes": classes}


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Every rank-side case of this file, run once on two processes, and the
    one-process and JAX references."""
    tmp = tmp_path_factory.mktemp("dp_train")
    dm = _dm_inputs()
    lfae = {k: _lfae_inputs(k) for k in ("recipe", "equivariance")}
    cli = _cli_inputs(tmp)
    cases = {
        "dm_injected": {"case": "dm_steps", "cfg": dm["cfg"], "model": dm["model"], "steps_per_epoch": 2,
                        "batches": dm["batches"], "draws": dm["draws"]},
        "dm_generator": {"case": "dm_steps", "cfg": dm["cfg"], "model": dm["model"], "steps_per_epoch": 2,
                         "batches": dm["batches"][:1], "seed": 9},
        **{f"lfae_{k}": {"case": "lfae_steps", "cfg": v["trainer"].cfg, "model": v["model"], "vgg": v["vgg"],
                         "batches": v["batches"], "transforms": [(T(a), T(c)) for a, c in v["tps"]]}
           for k, v in lfae.items()},
        "lfae_generator": {"case": "lfae_steps", "cfg": lfae["recipe"]["trainer"].cfg,
                           "model": lfae["recipe"]["model"], "vgg": lfae["recipe"]["vgg"],
                           "batches": lfae["recipe"]["batches"][:1], "seed": 9},
        "cli": cli["case"],
    }
    results = spawn_ranks(cases, str(tmp), ports=4)
    return {"dm": dm, "lfae": lfae, "cli": cli, "results": results}


# ------------------------------------------------------------------ DM


@pytest.fixture(scope="module")
def dm_one_process(dp):
    """The port's trainer on the global batch, one process, the same draws."""
    tt, out = dp["dm"]["tt"], []
    state = tt.init_state()
    for batch, (t, noise, null) in zip(dp["dm"]["batches"], dp["dm"]["draws"]):
        state, m = tt.train_step(state, None, batch, t=t, noise=noise, null_mask=null)
        out.append({"metrics": {k: float(v) for k, v in m.items()}, "grads": _grads(tt.model.unet),
                    "unet": _clone(tt.model.unet.state_dict())})
    return out


@pytest.fixture(scope="module")
def dm_jax(dp):
    """The JAX trainer on a 2-device `data` mesh: its draws come from the
    step keys (the same as the port's injected ones)."""
    jt, unet_vars = dp["dm"]["jt"], dp["dm"]["unet_vars"]
    jt.place_lfae()
    state = jreplicate(JDMTrainState(step=jnp.zeros((), jnp.int32), unet_vars=unet_vars,
                                     opt_state=jt.tx.init(unet_vars["params"])), jt.mesh)
    out = []
    for batch, key in zip(dp["dm"]["batches"], dp["dm"]["keys"]):
        state, m = jt.train_step(state, key, batch)
        out.append({"metrics": {k: float(v) for k, v in jax.device_get(m).items()},
                    "unet": from_jax_params({"params": jax.tree.map(np.asarray, state.unet_vars["params"])})})
    return out


@pytest.mark.parametrize("step", [0, 1])
def test_dm_step_on_two_ranks_matches_one_process(dp, dm_one_process, step):
    want = dm_one_process[step]
    for res in dp["results"]:
        got = res["dm_injected"][step]
        np.testing.assert_allclose(got["metrics"]["loss"], want["metrics"]["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["metrics"]["grad_norm"], want["metrics"]["grad_norm"], rtol=1e-5)
        assert got["metrics"]["lr"] == want["metrics"]["lr"] == LR
        assert_grads_close(got["grads"], want["grads"], 1e-5, f"dm step {step}")
        params = {k: v for k, v in got["unet"].items() if k in want["grads"]}
        assert_adam_band(params, {k: want["unet"][k] for k in params}, LR * (step + 1), "dm")
        assert got["agree"]
    a, b = (res["dm_injected"][step] for res in dp["results"])
    assert a["metrics"] == b["metrics"]
    assert all(torch.equal(a["unet"][k], b["unet"][k]) for k in a["unet"])


@pytest.mark.parametrize("step", [0, 1])
def test_dm_step_on_two_ranks_matches_jax_data_mesh(dp, dm_jax, step):
    want = dm_jax[step]
    got = dp["results"][0]["dm_injected"][step]
    np.testing.assert_allclose(got["metrics"]["loss"], want["metrics"]["loss"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["metrics"]["grad_norm"], want["metrics"]["grad_norm"], rtol=1e-3)
    params = {k: v for k, v in got["unet"].items() if k in want["unet"]}
    assert len(params) > 100
    assert_adam_band(params, {k: want["unet"][k] for k in params}, LR * (step + 1), "dm vs jax")


def test_dm_ranks_draw_what_one_process_draws(dp):
    """No injected draws: each rank draws the global batch's t, noise and
    dropout from `step_generator(seed, 0)` and keeps its rows; one process
    draws the same inside `p_losses`."""
    tt = DMTrainer(dp["dm"]["cfg"], steps_per_epoch=2, device="cpu")
    tt.model.load_state_dict(dp["dm"]["model"])
    _, m = tt.train_step(tt.init_state(), step_generator(9, 0, "cpu"), dp["dm"]["batches"][0])
    for res in dp["results"]:
        got = res["dm_generator"][0]
        np.testing.assert_allclose(got["metrics"]["loss"], float(m["loss"]), rtol=1e-5)
        assert_grads_close(got["grads"], _grads(tt.model.unet), 1e-5, "dm generator")


# ------------------------------------------------------------------ LFAE


def _lfae_one_process(inp):
    trainer = inp["trainer"]
    trainer.model.load_state_dict(inp["model"])
    state = trainer.init_state()
    out = []
    for batch, (theta, cpar) in zip(inp["batches"], inp["tps"]):
        _, tt = _both_tps(theta, cpar)
        state, m = trainer.train_step(state, None, batch, transform=tt)
        out.append({"metrics": {k: float(v) for k, v in m.items()}, "grads": _grads(trainer.model),
                    "model": _clone(trainer.model.state_dict())})
    return out


def _port_zero_grad_leaf(name: str) -> bool:
    """`_zero_grad_leaf` under the port's parameter names."""
    return name.endswith(("conv.bias", "conv1.bias", "regions.bias"))


def hold_lfae_step(step: int, losses: str, got: dict, want_metrics: dict, want: dict):
    """One LFAE step of the two ranks (`got`: metrics and state dict)
    against a reference (`want`: JAX variable tree), at the tolerances of
    `test_two_trainer_steps_match_jax`: losses 1e-5 relative, every
    parameter within 2.12·lr·step, the parameters off the zero-gradient
    leaves within 1e-6 (`equivariance`) or, at step 1 of `recipe`, under
    1% of them further, BatchNorm statistics 1e-5 (then 2e-4 / 1e-3: the
    zero-gradient leaves shift the means). Step 2 of `recipe` starts from
    parameters that Adam's sign step parted on those 1%: its losses are
    held to 1e-2 relative (that test's B=2 case reads under 1e-3; at B=4
    one process of the port against the JAX trainer reads 1.5e-3 on the
    perceptual loss and 3.6e-3 on the shift loss, with no rank split)."""
    rel = 1e-5 if step == 1 or losses == "equivariance" else 1e-2
    for k in ("perceptual", "equivariance_shift", "equivariance_affine", "total"):
        np.testing.assert_allclose(got["metrics"][k], float(want_metrics[k]), rtol=rel, atol=1e-7,
                                   err_msg=f"{k} step {step}")
    ours = to_jax_params(got["model"])
    diffs = []

    def check(path, a, w):
        d = np.abs(a - w)
        assert d.max() <= 2.12 * LR * step, (path, d.max())
        if not _zero_grad_leaf(path):
            diffs.append(d.ravel())

    _walk(ours["params"], want["params"], check)
    d = np.concatenate(diffs)
    if losses == "equivariance":
        assert d.max() <= 1e-6, d.max()
    elif step == 1:
        assert (d > 1e-6).mean() < 0.01, (d > 1e-6).mean()
    atol = 1e-5 if step == 1 else (2e-4 if losses == "equivariance" else 1e-3)
    _walk(ours["batch_stats"], want["batch_stats"],
          lambda p, a, w: np.testing.assert_allclose(a, w, atol=atol, err_msg=p))


@pytest.mark.parametrize("losses", ["recipe", "equivariance"])
def test_lfae_steps_with_synchronised_batchnorm_match_one_process(dp, losses):
    """Two ranks of 2 rows, BatchNorm statistics over both, against one
    process on the 4 (`hold_lfae_step`), the same state on both ranks; and
    step 1's gradients of `equivariance` (the smooth part of the loss) each
    within 5e-5 of its norm (fp32 sums in another order through the 2x2
    eigen-decompositions and the temperature-0.1 softmax; the zero-gradient
    leaves, a conv bias ahead of a BatchNorm, are rounding noise in both).
    `recipe`'s gradients are held through Adam's first update only: they
    are not smooth in the rounding of the forward (one process, the same
    batch in another row order: ~2% of the largest gradient apart at this
    config), so two ranks and one process part by as much."""
    want = _lfae_one_process(dp["lfae"][losses])
    for res in dp["results"]:
        for step, w in enumerate(want, start=1):
            got = res[f"lfae_{losses}"][step - 1]
            hold_lfae_step(step, losses, got, w["metrics"], to_jax_params(w["model"]))
            if step == 1 and losses == "equivariance":
                smooth = [k for k in w["grads"] if not _port_zero_grad_leaf(k)]
                assert_grads_close({k: got["grads"][k] for k in smooth},
                                   {k: w["grads"][k] for k in smooth}, 5e-5, "lfae equivariance")
            assert got["agree"]
    a, b = (res[f"lfae_{losses}"][-1]["model"] for res in dp["results"])
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("losses", ["recipe", "equivariance"])
def test_lfae_steps_on_two_ranks_match_jax_data_mesh(dp, losses, monkeypatch):
    """Against the JAX `LFAETrainer` on a 2-device `data` mesh (its batch
    statistics global over the sharded batch), the same global TPS
    transform (the JAX `TPSTransform.sample` monkeypatched), held by
    `hold_lfae_step`."""
    inp = dp["lfae"][losses]
    jtrainer = jlt.LFAETrainer(inp["jcfg"], steps_per_epoch=10, vgg_vars=to_jax_params(inp["vgg"]),
                               mesh=jmake_mesh(2))
    jstate = jtrainer.load_state(to_jax_params(inp["model"]))
    jt, _ = _both_tps(*inp["tps"][0])
    monkeypatch.setattr(jlt.TPSTransform, "sample", staticmethod(lambda *a, **k: jt))
    for step, batch in enumerate(inp["batches"], start=1):
        jstate, jm = jtrainer.train_step(jstate, jax.random.PRNGKey(step), batch)
        theirs = jax.tree.map(np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats})
        hold_lfae_step(step, losses, dp["results"][0][f"lfae_{losses}"][step - 1],
                       jax.device_get(jm), theirs)


def test_lfae_ranks_draw_the_tps_transform_of_one_process(dp):
    inp = dp["lfae"]["recipe"]
    trainer = LFAETrainer(inp["trainer"].cfg, steps_per_epoch=10, device="cpu")
    trainer.model.load_state_dict(inp["model"])
    trainer.vgg.load_state_dict(inp["vgg"])
    _, m = trainer.train_step(trainer.init_state(), step_generator(9, 0, "cpu"), inp["batches"][0])
    for res in dp["results"]:
        got = res["lfae_generator"][0]
        for k, v in m.items():
            np.testing.assert_allclose(got["metrics"][k], float(v), rtol=1e-5, atol=1e-7, err_msg=k)


# ------------------------------------------------------------------ CLIs


def test_train_dm_on_two_processes(dp):
    """`train_dm` as two processes: the global batch 2 split 1 + 1, the
    state of one process's run within the Adam band, identical on the two
    ranks; rank 0 wrote the checkpoint files, rank 1 none; `--resume`
    continued from step 2 to 3."""
    one = dp["cli"]["one"]
    lr = train_cfg().dm_train.lr
    got = [res["cli"] for res in dp["results"]]
    for r, res in enumerate(got):
        assert (res["train"]["start"], res["train"]["step"]) == (0, 2)
        assert (res["resume"]["start"], res["resume"]["step"]) == (2, 3)
        want_written = {0: ["step_00000002", "latest"], 1: []}[r]
        assert res["train"]["written"] == want_written
        assert res["resume"]["written"] == ([n.replace("2", "3") for n in want_written])
    unet = one["trainer"].model.unet
    trainable = {k for k, p in unet.named_parameters() if p.requires_grad}
    want = {k: v for k, v in unet.state_dict().items() if k in trainable}
    assert_adam_band({k: got[0]["train"]["unet"][k] for k in want}, want, 2 * lr, "train_dm")
    for k, v in got[0]["train"]["unet"].items():
        assert torch.equal(v, got[1]["train"]["unet"][k]), k
        assert torch.equal(got[0]["resume"]["unet"][k], got[1]["resume"]["unet"][k]), k


def test_demo_mesh_dp2_on_two_processes(dp, tmp_path):
    """`demo --mesh dp=2`: the three classes in one request batch (padded to
    4), one GIF per class written by rank 0 only; the videos of both ranks
    equal, and those of one process's `sample_video` of the padded batch
    from the same generator within 1e-4."""
    r0, r1 = (res["cli"]["demo"] for res in dp["results"])
    classes = dp["cli"]["classes"]
    assert len(r0["gifs"]) == 3 and r1["gifs"] == []
    assert all(open(p, "rb").read(6) == b"GIF89a" for p in r0["gifs"])
    args = demo.parser().parse_args(["--device", "cpu", "--log-dir", str(tmp_path)])
    saved, demo.BENCH_CKPT = demo.BENCH_CKPT, str(tmp_path / "none")
    try:
        cfg, model = demo.build_model(tiny_cfg(), args)
    finally:
        demo.BENCH_CKPT = saved
    img = torch.from_numpy(demo.reference_image(args, cfg.lfae.frame_shape))
    conds = torch.from_numpy(load_text_embedder(args)(classes + classes[-1:])[0])
    want = model.sample_video(img[None].expand(4, -1, -1, -1), conds, 1.0,
                              generator=torch.Generator().manual_seed(args.seed))
    for bi, text in enumerate(classes):
        for key, v in r0["outputs"][text].items():
            np.testing.assert_array_equal(v, r1["outputs"][text][key])
            np.testing.assert_allclose(v, want[key][bi:bi + 1].numpy(), atol=1e-4, err_msg=key)


# ------------------------------------------------------------------ loader


@pytest.mark.parametrize("workers", [0, 2])
def test_grain_state_of_shard_0_resumes_shard_1(workers):
    """A multi-process run saves the primary's `GrainLoader` state; every
    shard of the same shard count seeks to it and takes the batches of its
    straight stream. `get_state(k)` names the position after k batches;
    another shard count is refused."""
    make = lambda k: GrainLoader(Visits(12), batch_size=4, num_workers=workers, seed=2,  # noqa: E731
                                 shard_index=k, shard_count=2)
    straight = take(make(1), 5)
    shard0 = make(0)
    take(shard0, 3)
    resumed = make(1)
    resumed.set_state(shard0.get_state())
    assert_same(take(resumed, 2), straight[3:])
    early = make(1)
    early.set_state(shard0.get_state(1))
    assert_same(take(early, 2), straight[1:3])
    with pytest.raises(ValueError, match="another stream"):
        GrainLoader(Visits(12), batch_size=4, num_workers=0, seed=2).set_state(shard0.get_state())
    for loader in (shard0, resumed, early):
        loader.close()

