"""Where an LFAE run's NaN comes from (ROADMAP §3, To settle 4): the JAX
package's numbers against the port's, on the numbers the card produced.

`python -m cvpr23_lfdm_torch.scripts.probe_lfae_nan` (MUG widths, seeded
weights, seed 2, data seed 3, B=16) gets a NaN in 42 region-predictor
gradients at its second step on the card, first made in the backward of
`ops/eig2x2.py::sqrt_psd_2x2`. Two recordings of that run on the card (an
NVIDIA H100) are committed: the TPS transforms its two steps draw from the
card's generator (`tests/golden/lfae_nan_tps.npz`), and, for the region
predictor call whose backward went non-finite, the covariances that entered
`sqrt_psd_2x2`, the gradient that reached its output and the gradient it
gave back (`tests/golden/lfae_nan_sqrt_psd.npz`).

* Tier-1: the JAX `sqrt_psd_2x2` backward on those recorded numbers is
  non-finite at the same (sample, region) as the card's was. That region is
  thin, not collapsed: its variances are 6.1e-9 and 0.35, and its smaller
  eigenvalue, 6.1e-9, rounds to 0 in the closed form's fp32 `tr / 2 - rad`,
  where `sqrt` is then differentiated. The port takes that eigenvalue as
  `det / s1` for such a thin matrix (`ops/eig2x2.py`), so its backward is
  finite there and equals the JAX expression's in float64 (1e-5); where the
  JAX package's fp32 gradient is finite, the two agree as before.
* Opt-in (RUN_TORCH_LFAE_NAN=1; full MUG widths, B=16, ~1.5 min and a few GB
  on the CPU): the JAX `LFAETrainer` and the port's trainer on the CPU from
  the probe's weights (through `to_jax_params`) and batch, with the card's
  TPS draws injected, for two steps. Both stay finite on the CPU: the
  collapse needs the card's step-1 numbers (at full width one Adam step
  takes the two frameworks apart), which a CPU run of either package does
  not reproduce.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr23_lfdm_tpu.ops import eig2x2 as jeig
from cvpr23_lfdm_torch.ops import eig2x2 as teig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPS = os.path.join(ROOT, "tests", "golden", "lfae_nan_tps.npz")
SQRT = os.path.join(ROOT, "tests", "golden", "lfae_nan_sqrt_psd.npz")
SEED, DATA_SEED, BATCH = 2, 3, 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: as fast at these sizes, and the test processes
    that share the CPU do not oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sqrt_psd_backward_on_the_cards_numbers_is_non_finite_in_both_packages():
    rec = np.load(SQRT)
    covar, cot = rec["covar"], rec["out_grad"]
    _, vjp = jax.vjp(jeig.sqrt_psd_2x2, jnp.asarray(covar))
    (jgrad,) = vjp(jnp.asarray(cot))
    jgrad = np.asarray(jgrad)
    tc = torch.from_numpy(covar).requires_grad_(True)
    teig.sqrt_psd_2x2(tc).backward(torch.from_numpy(cot))
    tgrad = tc.grad.numpy()
    bad = lambda g: np.argwhere(~np.isfinite(g).all(axis=(-2, -1))).tolist()  # noqa: E731
    assert bad(rec["card_covar_grad"]) == bad(jgrad) == [[3, 1]]
    # the thin region: almost no variance along x, its smaller eigenvalue 6.1e-9, not 0
    assert covar[3, 1, 0, 0] < 1e-8 < covar[3, 1, 1, 1]
    assert bad(tgrad) == []
    with jax.enable_x64(True):
        _, vjp64 = jax.vjp(jeig.sqrt_psd_2x2, jnp.asarray(covar.astype(np.float64)))
        (exact,) = vjp64(jnp.asarray(cot.astype(np.float64)))
    np.testing.assert_allclose(tgrad[3, 1], np.asarray(exact)[3, 1], rtol=1e-5)
    fine = np.isfinite(jgrad)
    np.testing.assert_allclose(tgrad[fine], jgrad[fine], rtol=1e-3, atol=1e-3 * np.abs(jgrad[fine]).max())


def _non_finite(tree, path=""):
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _non_finite(v, f"{path}/{k}")
        elif not np.isfinite(np.asarray(v)).all():
            out.append(f"{path}/{k}")
    return out


def test_two_full_width_steps_of_both_trainers_on_the_cpu(monkeypatch):
    if os.environ.get("RUN_TORCH_LFAE_NAN") != "1":
        pytest.skip("full-width LFAE steps of both packages on the CPU; set RUN_TORCH_LFAE_NAN=1")
    from cvpr23_lfdm_tpu import config as jconfig
    from cvpr23_lfdm_tpu.parallel.mesh import make_mesh
    from cvpr23_lfdm_tpu.train import lfae_trainer as jlt
    from cvpr23_lfdm_torch.config import mug_config
    from cvpr23_lfdm_torch.scripts.probe_lfae_nan import non_finite_grads
    from cvpr23_lfdm_torch.train.lfae_trainer import LFAETrainer
    from cvpr23_lfdm_torch.utils.bench_ckpt import to_jax_params
    from test_torch_lfae_train import _both_tps

    tps = np.load(TPS)
    trainer = LFAETrainer(mug_config(), steps_per_epoch=93, device="cpu", vgg_seed=SEED)
    state = trainer.init_state(seed=SEED)
    rng = np.random.RandomState(DATA_SEED)
    s = trainer.cfg.lfae.frame_shape
    batch = {k: rng.uniform(size=(BATCH, s, s, 3)).astype(np.float32) for k in ("source", "driving")}
    jtrainer = jlt.LFAETrainer(jconfig.mug_config(), steps_per_epoch=93,
                               vgg_vars=to_jax_params(trainer.vgg.state_dict()), mesh=make_mesh(1))
    jstate = jtrainer.load_state(to_jax_params(trainer.model.state_dict()))
    report = []
    for step in range(2):
        jt, tt = _both_tps(tps[f"theta_{step}"], tps[f"control_params_{step}"])
        monkeypatch.setattr(jlt.TPSTransform, "sample", staticmethod(lambda *a, jt=jt, **k: jt))
        jstate, jm = jtrainer.train_step(jstate, jax.random.PRNGKey(step), batch)
        jm = jax.device_get(jm)
        state, m = trainer.train_step(state, None, batch, transform=tt)
        report.append({"step": step, "jax_losses": {k: float(v) for k, v in jm.items()},
                       "jax_non_finite_params": _non_finite(jax.device_get({"params": jstate.params})),
                       "port_losses": {k: float(v) for k, v in m.items()},
                       "port_non_finite_grads": non_finite_grads(trainer.model)})
        print(json.dumps(report[-1]))
    for r in report:
        assert not r["jax_non_finite_params"] and not r["port_non_finite_grads"], r["step"]
    for k, v in report[0]["jax_losses"].items():  # step 1 from the same weights: 1e-4
        np.testing.assert_allclose(report[0]["port_losses"][k], v, rtol=1e-4, err_msg=k)
