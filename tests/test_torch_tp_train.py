"""The tensor-parallel `DMTrainer` step on the CPU: two rank processes
(`tests/torch_dp_worker.py`, gloo on 127.0.0.1) on a `data` x `model`
mesh of 1 x 2, the tiny config of `__graft_entry__._tiny_config` (4
heads, dim 32, 2 frames), fp32, the `pallas2` form (the head-packed
attention on 2 heads per rank, its plain version here), B=2, the JAX key's
draws injected:

* against one process: loss and gradient norm 1e-5 relative, each
  gathered gradient within 1e-5 of the largest, `states_agree` over both
  axes, the checkpoint back into a tp trainer bit for bit;
* against the JAX one-device `DMTrainer` step from the same key: loss
  1e-5, the parameters after Adam 2e-4 (`tests/test_parallel.py:230-235`);
* the checkpoint (the one-process format) restored into a one-process
  trainer;
* the same step with a bf16 UNet (the compute dtype of the recipe's
  training): finite, and its loss and gathered gradients no further from
  the one-process fp32 step than twice the one-process bf16 step is.

The inputs are built as in `tests/test_torch_tp.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr23_lfdm_tpu.parallel.mesh import make_mesh as jmake_mesh
from cvpr23_lfdm_tpu.train.dm_trainer import DMTrainer as JDMTrainer, DMTrainState as JDMTrainState
from cvpr23_lfdm_torch.diffusion.flow_diffusion import FlowDiffusion
from cvpr23_lfdm_torch.train.dm_trainer import DMTrainer
from cvpr23_lfdm_torch.utils.bench_ckpt import from_jax_params
from cvpr23_lfdm_torch.utils.checkpoint import CheckpointManager
from test_torch_parallel import spawn_ranks
from test_torch_tp import assert_step_matches_one_process, dm_inputs, one_process_step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():  # module scope: it runs before the module's spawn fixture
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_train_ranks")
    dm = dm_inputs(np.random.RandomState(13), (1, 2), 2, str(tmp / "ckpt"))
    cfg = dm["tcfg"].replace(diffusion=dataclasses.replace(dm["tcfg"].diffusion, compute_dtype="bfloat16"))
    bf16 = {**dm, "tcfg": cfg, "case": {**dm["case"], "cfg": cfg, "ckpt_dir": str(tmp / "ckpt_bf16")}}
    return {"dm": dm, "bf16": bf16,
            "results": spawn_ranks({"dm": dm["case"], "bf16": bf16["case"]}, str(tmp))}


def test_tp_dm_step_matches_one_process(tp):
    _, _, m, grads = one_process_step(tp["dm"])
    for res in tp["results"]:
        assert_step_matches_one_process(res["dm"], m, grads)
    a, b = (res["dm"] for res in tp["results"])
    assert a["metrics"] == b["metrics"]


def test_tp_dm_step_matches_jax_one_device(tp):
    """Against the JAX trainer on one device from the same key (its draws
    are the injected ones): loss 1e-5, parameters after Adam 2e-4."""
    dm = tp["dm"]
    jt = JDMTrainer(dm["jcfg"], steps_per_epoch=4, lfae_vars=dm["lfae_vars"], mesh=jmake_mesh(1))
    jt.place_lfae()
    state = JDMTrainState(step=jnp.zeros((), jnp.int32), unet_vars=dm["unet_vars"],
                          opt_state=jt.tx.init(dm["unet_vars"]["params"]))
    state, m = jt.train_step(state, dm["key"], dm["batch"])
    want = from_jax_params({"params": jax.tree.map(np.asarray, state.unet_vars["params"])})
    got = tp["results"][0]["dm"]
    np.testing.assert_allclose(got["metrics"]["loss"], float(m["loss"]), atol=1e-5)
    assert set(want) == set(got["unet"])
    for k, w in want.items():
        np.testing.assert_allclose(got["unet"][k].numpy(), w.numpy(), atol=2e-4, rtol=0, err_msg=k)


def test_tp_checkpoint_restores_into_one_process(tp):
    """The tp run's checkpoint is the one-process format: a one-process
    trainer restores it (UNet and Adam moments equal to the gathered ones),
    and its own checkpoint holds the same tensors."""
    dm, got = tp["dm"], tp["results"][0]["dm"]
    model = FlowDiffusion(dm["tcfg"].lfae, dm["tcfg"].diffusion, device="cpu", training=True)
    model.load_state_dict(dm["case"]["model"])
    tt = DMTrainer(dm["tcfg"], steps_per_epoch=4, model=model)
    state = tt.load_state_dict(CheckpointManager(dm["case"]["ckpt_dir"]).restore("latest", map_location="cpu"))
    assert state.step == 1
    mine = tt.state_dict(state)
    assert all(torch.equal(mine["unet"][k], v) for k, v in got["unet"].items())
    assert all(torch.equal(mine["optimizer"]["state"][i]["exp_avg"], v) for i, v in got["moments"].items())
    assert len(got["moments"]) == len(list(tt.model.unet.parameters()))


def test_tp_dm_step_in_bf16_is_as_close_to_fp32_as_one_process(tp):
    """A bf16 UNet on the model axis (the activation gradients summed over
    the model group in fp32, the row-parallel products in fp32): the
    loss, gradient norm and gathered gradients are finite, and their
    distance from the one-process fp32 step is at most twice that of the
    one-process bf16 step (bf16 rounding, not the split, sets it)."""
    _, _, m32, g32 = one_process_step(tp["dm"])
    _, _, m16, g16 = one_process_step(tp["bf16"])
    got = tp["results"][0]["bf16"]
    assert all(np.isfinite(got["metrics"][k]) for k in ("loss", "grad_norm"))
    assert set(got["grads"]) == set(g32) and all(bool(torch.isfinite(g).all()) for g in got["grads"].values())
    gap = lambda grads: max(float((grads[k].float() - w).abs().max()) for k, w in g32.items())  # noqa: E731
    witness = gap(g16)
    assert 0 < gap(got["grads"]) <= 2 * witness, (gap(got["grads"]), witness)
    for k in ("loss", "grad_norm"):
        assert abs(got["metrics"][k] - m32[k]) <= 2 * abs(m16[k] - m32[k]), (k, got["metrics"][k], m16[k], m32[k])
    assert got["agree_data"] and got["agree_model"] and got["restored"]
    assert tp["results"][0]["bf16"]["metrics"] == tp["results"][1]["bf16"]["metrics"]
