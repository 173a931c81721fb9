"""Tensor parallelism on a `data` x `model` mesh of four rank processes
(`tests/torch_dp_worker.py`, gloo on 127.0.0.1), dp=2 x tp=2, on the CPU:

* `make_mesh((2, 2), ...)` in both axis orders: the ranks fill the mesh
  row-major, as the JAX `make_mesh` reshapes its devices, and the groups
  sum over the right ranks;
* `sample_video_sharded` of B=3 requests (padded to 4, two rows per data
  index, each row's UNet split over two model ranks) against one process's
  video of the padded batch (2e-4);
* one `DMTrainer` step at global B=4 (`pallas2`, the JAX key's draws
  injected) against one process: loss and gradient norm 1e-5 relative,
  each gathered gradient within 1e-5 of the largest, `states_agree` over
  both axes, the checkpoint back into a tp trainer bit for bit;
* `test_dm --mesh dp=2,tp=2` on a synthetic corpus: the metrics on rank 0,
  finite, and `{}` on the others.

The config and inputs are those of `tests/test_torch_tp.py`.
"""

import numpy as np
import pytest
import torch

from test_torch_cli import tiny_cfg
from test_torch_parallel import spawn_ranks
from test_torch_tp import (
    KEYS, assert_step_matches_one_process, dm_inputs, one_process_step, serving_inputs,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():  # module scope: it runs before the module's spawn fixture
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_mesh_ranks")
    rng = np.random.RandomState(12)
    serving = serving_inputs(rng, (2, 2), 3)
    dm = dm_inputs(rng, (2, 2), 4, str(tmp / "ckpt"))
    cases = {"tp_meshes": {}, "serving": serving["case"], "dm": dm["case"],
             "tp_cli": {"cfg": tiny_cfg(), "dir": str(tmp / "cli"),
                        "test_dm": ["--device", "cpu", "--mesh", "dp=2,tp=2", "--synthetic", "--data-root",
                                    str(tmp / "corpus"), "--num-videos", "3", "--random-metric-weights"]}}
    results = spawn_ranks(cases, str(tmp), ports=3, world=4)
    return {"serving": serving, "dm": dm, "results": results}


def test_mesh_orders_on_four_ranks(mesh4):
    """("data", "model"): rank = 2 d + m; ("model", "data"): rank = 2 m + d.
    The model group of a rank sums the two ranks of its data index, the
    data group the two of its model index."""
    for r, res in enumerate(mesh4["results"]):
        d, m = divmod(r, 2)
        got = res["tp_meshes"]
        assert got[("data", "model")] == (d, m, {"data": 2, "model": 2}, 4 * d + 1, 2 * m + 2)
        m, d = divmod(r, 2)
        assert got[("model", "data")] == (d, m, {"model": 2, "data": 2}, 2 * d + 2, 4 * m + 1)


def _pad(x, rows=4):
    return torch.cat([x, x[-1:].expand(rows - x.shape[0], *x.shape[1:])])


def test_dp2_tp2_video_matches_one_process(mesh4):
    inp = mesh4["serving"]["case"]
    one = mesh4["serving"]["model"].sample_video(_pad(inp["ref"]), _pad(inp["cond"]), 1.0,
                                                 init_img=inp["init"], noise_seq=inp["noise"])
    outs = [res["serving"]["out"] for res in mesh4["results"]]
    for r, res in enumerate(mesh4["results"]):
        assert res["serving"]["mesh"] == (2, r // 2, 2, r % 2, {"data": 2, "model": 2})
        assert res["serving"]["gather_exact"]
    for key in KEYS:
        assert all(torch.equal(o[key], outs[0][key]) for o in outs), key
        assert outs[0][key].shape[0] == 3
        np.testing.assert_allclose(outs[0][key].numpy(), one[key][:3].numpy(), atol=2e-4, rtol=0, err_msg=key)


def test_dp2_tp2_dm_step_matches_one_process(mesh4):
    _, _, m, grads = one_process_step(mesh4["dm"])
    for res in mesh4["results"]:
        assert_step_matches_one_process(res["dm"], m, grads)
    sizes = {res["dm"]["param_bytes"] for res in mesh4["results"]}
    assert len(sizes) == 1


def test_test_dm_on_a_dp2_tp2_mesh(mesh4):
    got = [res["tp_cli"]["test_dm"] for res in mesh4["results"]]
    assert got[0]["videos"] == 3 and got[1:] == [{}, {}, {}]
    for k in ("rec_loss", "warp_loss", "psnr", "ssim", "lpips", "fvd"):
        assert np.isfinite(got[0][k]), k
