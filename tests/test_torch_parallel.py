"""The port's data-parallel layer (`cvpr23_lfdm_torch/parallel/`) on the CPU:
process-group set-up, the `data` mesh and its collectives, the synchronised
BatchNorm and sharded serving.

Two rank processes (`tests/torch_dp_worker.py`, which imports the port
and no JAX) join a gloo group on 127.0.0.1 through `init_distributed`'s
coordinator arguments, as the CLIs' `--coordinator` / `--num-processes` /
`--process-id` do; one module-scoped spawn runs every rank-side case, and
each check below reads its results. This process builds the inputs from
numpy seeds and computes the references: the port in one process on the
global batch, and the JAX package on a 2-device `data` mesh of the
conftest's 8 virtual devices (Pallas in interpret mode).

Tolerances: the synchronised BatchNorm 1e-5 of each tensor's largest
value (fp32 sums in another order); the sharded video 1e-4 max-abs against
the one-process video (each rank's batch of 2 reduces in another order
than the batch of 4, which the JAX package measured at 3.6e-5) and 2e-4
against JAX (the bound of `tests/test_serving_mesh.py`); the averaged
least-squares gradient 1e-6 relative.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from cvpr23_lfdm_tpu.diffusion.flow_diffusion import FlowDiffusion as JFlowDiffusion
from cvpr23_lfdm_tpu.models.blocks import batch_norm as jbatch_norm
from cvpr23_lfdm_tpu.models.generator import Generator as JGenerator
from cvpr23_lfdm_tpu.parallel.mesh import make_mesh as jmake_mesh
from cvpr23_lfdm_tpu.parallel.serving import parse_mesh_spec as jparse_mesh_spec
from cvpr23_lfdm_torch.diffusion.flow_diffusion import FlowDiffusion
from cvpr23_lfdm_torch.models.blocks import BatchNorm
from cvpr23_lfdm_torch.parallel import distributed as D
from cvpr23_lfdm_torch.parallel import mesh as M
from cvpr23_lfdm_torch.parallel.serving import parse_mesh_spec, serving_mesh
from test_torch_slice import _port_cfg, _random_variables, _small_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dp_worker.py")
SPAWN_TIMEOUT_S = 600  # each rank process; the process group's own timeout is 120 s
T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():  # module scope: it runs before the module's spawn fixture
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def free_ports(n: int) -> list:
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def spawn_ranks(cases: dict, directory: str, ports: int = 1, world: int = 2) -> list:
    """Run `cases` on `world` rank processes; their results, rank 0 first."""
    path = os.path.join(directory, "cases.pt")
    torch.save({"ports": free_ports(ports), "cases": cases, "world": world}, path)
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, WORKER, path, str(r)], cwd=directory, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{err[-6000:]}"
    return [torch.load(os.path.join(directory, f"rank{r}.pt"), weights_only=False) for r in range(world)]


def assert_close(got, want, rel, what=""):
    """max |got - want| <= rel * max |want| (a tensor's largest value sets
    the scale of its fp32 rounding)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), max(np.abs(want).max(), 1e-30)
    assert err <= rel * scale, (what, err, scale)


# ------------------------------------------------------------------ one process


@pytest.mark.parametrize("spec", ["", "dp=8", "dp=4,tp=2", "dp=2,sp=2", " dp = 3 ", "tp=1", "zz=2",
                                  "dp=2,xx=1"])
def test_parse_mesh_spec_matches_jax(spec):
    try:
        want = jparse_mesh_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError, match="unknown mesh axis"):
            parse_mesh_spec(spec)
        assert "unknown mesh axis" in str(e)
        return
    got = parse_mesh_spec(spec)
    assert got == want and list(got) == list(want)


def test_serving_mesh_errors_and_one_process():
    assert serving_mesh("") is None
    with pytest.raises(ValueError, match="dp=2 needs 2 processes"):
        serving_mesh("dp=2", device="cpu")
    for spec, n in (("sp=2", 2), ("dp=1,tp=2", 2), ("dp=2,tp=2", 4), ("dp=2,sp=2", 4),
                    ("dp=1,tp=2,sp=2", 4)):  # tp and sp are ported: the processes are missing
        with pytest.raises(ValueError, match=f"needs {n} processes"):
            serving_mesh(spec, device="cpu")
    mesh = serving_mesh("dp=1", device="cpu")
    assert (mesh.size, mesh.rank, mesh.group, mesh.device) == (1, 0, None, torch.device("cpu"))
    assert mesh.shape == {"data": 1} and mesh.axis_names == ("data",)
    mesh = M.make_mesh((1, 1), ("data", "space"), device="cpu")
    assert (mesh.size, mesh.space_size, mesh.space_rank, mesh.space_group) == (1, 1, 0, None)
    assert mesh.shape == {"data": 1, "space": 1} and mesh.axis_names == ("data", "space")
    with pytest.raises(ValueError, match="sp=2 needs 2 processes"):
        serving_mesh("sp=2", device="cpu", frame_shape=128)
    with pytest.raises(ValueError, match="must divide the height 128"):
        serving_mesh("sp=3", device="cpu", frame_shape=128)
    with pytest.raises(ValueError, match="needs 2 processes"):
        M.make_mesh(2, device="cpu")


def test_one_process_is_a_no_op():
    """No process group: rank 0 of 1, primary, the whole batch; a one-rank
    mesh passes tensors through and its collectives do nothing."""
    assert D.init_distributed() == {"process_index": 0, "process_count": 1, "device_count": 1}
    assert D.is_primary() and D.local_device() is None and D.host_shard(6) == (0, 1, 6)
    D.barrier()
    mesh = M.make_mesh(device="cpu")
    x = torch.arange(12.0).reshape(4, 3)
    assert M.local_rows(x, mesh) is x and M.all_gather_rows(x, mesh) is x
    assert M.shard_batch({"x": x, "n": ["a"]}, mesh, 4)["x"] is x
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.full((3,), 2.0)
    M.mean_gradients([p], mesh)
    assert torch.equal(p.grad, torch.full((3,), 2.0))
    assert M.states_agree(torch.nn.Linear(2, 2), mesh)
    with pytest.raises(ValueError, match="multi-process run: needs"):
        D.init_distributed(num_processes=2)


def test_device_prefetch_keeps_the_batches_and_their_order():
    """On the CPU it hands the batches through unchanged and in order (on
    the card it issues each batch's copy one batch ahead; `chip_smoke.py`'s
    training phases run `fit`, which goes through it, there)."""
    rng = np.random.RandomState(0)
    batches = [{"x": rng.standard_normal((2, 3)).astype(np.float32), "name": f"b{i}"} for i in range(4)]
    mesh = M.make_mesh(device="cpu")
    got = list(M.device_prefetch(iter(batches), mesh, keys=("x",)))
    assert [b["name"] for b in got] == ["b0", "b1", "b2", "b3"]
    assert all(g["x"] is b["x"] for g, b in zip(got, batches))
    assert list(M.device_prefetch(iter([]), mesh)) == []


def test_rank_worker_imports_only_the_port():
    """The rank processes stand for the card's installation: no JAX."""
    import ast

    tree = ast.parse(open(WORKER).read())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    mods += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert "cvpr23_lfdm_torch.parallel" in mods
    assert not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "cvpr23_lfdm_tpu")
                or m.startswith("test_")]


# ------------------------------------------------------------------ two ranks


def _serving_inputs():
    """The small serving config (64² frames, F=2, 2 DDIM steps), weights
    seeded for the JAX trees, B=3 requests padded to 4, injected gaussians
    for the padded batch."""
    cfg = _small_cfg("eps", "pallas3_interpret")
    cfg = cfg.replace(diffusion=dataclasses.replace(cfg.diffusion, num_frames=2, sampling_timesteps=2))
    jm = JFlowDiffusion(cfg.lfae, cfg.diffusion)
    rng = np.random.RandomState(3)
    b, f, s = 3, cfg.diffusion.num_frames, cfg.diffusion.img_size
    ref = rng.uniform(size=(b, 64, 64, 3)).astype(np.float32)
    cond = rng.standard_normal((b, cfg.diffusion.cond_dim)).astype(np.float32)
    init = rng.standard_normal((4, f, s, s, 3)).astype(np.float32)
    noise = rng.standard_normal((2, 4, f, s, s, 3)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    flow0 = jnp.zeros((1, f, s, s, 2))
    gen_vars = _random_variables(jax.eval_shape(lambda r: jm.generator.init(
        r, jnp.asarray(ref[:1]), flow0, flow0[..., :1], method=JGenerator.decode_video_with_flow), key), rng)
    lfae_vars = {col: {"generator": gen_vars[col]} for col in gen_vars}
    unet_vars = _random_variables(jax.eval_shape(
        jm.unet.init, key, jnp.asarray(init[:1]), jnp.zeros((1,)), jnp.asarray(cond[:1]),
        fea=jnp.zeros((1, 1, s, s, 256))), rng)
    tcfg = _port_cfg(cfg)
    model = FlowDiffusion(tcfg.lfae, tcfg.diffusion, device="cpu")
    model.load_jax_variables(unet_vars, lfae_vars)
    return {"jcfg": cfg, "jm": jm, "unet_vars": unet_vars, "lfae_vars": lfae_vars, "model": model,
            "case": {"cfg": tcfg, "model": model.state_dict(), "ref": T(ref), "cond": T(cond),
                     "init": T(init), "noise": T(noise), "seed": 17}}


def _syncbn_inputs():
    rng = np.random.RandomState(2)
    c = 6
    return {"xs": [T((rng.standard_normal((8, 3, 3, c)) * 2 + 0.5).astype(np.float32)) for _ in range(2)],
            "cot": T(rng.standard_normal((8, 3, 3, c)).astype(np.float32)),
            "scale": T((1 + 0.2 * rng.standard_normal(c)).astype(np.float32)),
            "bias": T((0.1 * rng.standard_normal(c)).astype(np.float32))}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank-side case of this file, run once on two processes."""
    rng = np.random.RandomState(1)
    serving = _serving_inputs()
    cases = {
        "basics": {"x": T(rng.standard_normal((4, 6)).astype(np.float32))},
        "mean_grad": {"w": T(rng.standard_normal(5).astype(np.float32)),
                      "x": T(rng.standard_normal((8, 5)).astype(np.float32)),
                      "y": T(rng.standard_normal(8).astype(np.float32)), "lr": 0.1},
        "replicate": {},
        "syncbn": _syncbn_inputs(),
        "serving": serving["case"],
    }
    results = spawn_ranks(cases, str(tmp_path_factory.mktemp("parallel_ranks")))
    return {"cases": cases, "results": results, "serving": serving}


def test_init_distributed_ranks_and_host_shard(ranks):
    """The counterpart of `tests/test_multihost.py`: two processes joined
    through coordinator arguments; rank 0 is the primary, rank 1 is not;
    each loads its contiguous half of a global batch."""
    for r, res in enumerate(ranks["results"]):
        got = res["basics"]
        assert (got["primary"], got["index"], got["count"]) == (r == 0, r, 2)
        assert got["host_shard"] == (r, 2, 4)
        assert "not divisible by 2 processes" in got["host_shard_7"]
        assert got["mesh"] == (2, r, {"data": 2}) and got["device"] == "cpu"
        assert got["one_rank_mesh"] == 1


def test_shard_batch_local_rows_and_gather(ranks):
    x = ranks["cases"]["basics"]["x"]
    for r, res in enumerate(ranks["results"]):
        got = res["basics"]
        sb = got["shard_batch"]
        assert torch.equal(sb["x"], x[2 * r:2 * r + 2])
        assert torch.equal(sb["local"], x[:2]) and sb["names"] == ["a", "b"]
        assert torch.equal(got["local_rows_dim1"], x.reshape(2, 4, -1)[:, 2 * r:2 * r + 2])
        assert torch.equal(got["gathered"], x)


def test_mean_gradient_step_matches_one_host(ranks):
    """A least-squares SGD step, each rank on its 4 rows with its gradient
    averaged over the two, against one process on all 8."""
    inp = ranks["cases"]["mean_grad"]
    w = inp["w"].clone().requires_grad_()
    loss = ((inp["x"] @ w - inp["y"]) ** 2).mean()
    loss.backward()
    for res in ranks["results"]:
        got = res["mean_grad"]
        assert_close(got["grad"], w.grad, 1e-6, "grad")
        assert_close(got["w"], (w - inp["lr"] * w.grad).detach(), 1e-6, "w")
        assert_close(got["loss"], loss.detach(), 1e-6, "loss")
    assert torch.equal(ranks["results"][0]["mean_grad"]["w"], ranks["results"][1]["mean_grad"]["w"])


def test_replicate_broadcasts_rank_0(ranks):
    """Weights seeded differently per rank disagree (`states_agree` False);
    after `replicate` of the module and the optimizer every rank holds rank
    0's parameters, BatchNorm buffers and Adam moments."""
    r0, r1 = (res["replicate"] for res in ranks["results"])
    assert r0["before"] == r1["before"] == (False, False)
    assert r0["after"] == r1["after"] == (True, True)
    for k in r0["state"]:
        assert torch.equal(r0["state"][k], r1["state"][k]), k
    for a, b in zip(r0["moments"], r1["moments"]):
        assert torch.equal(a, b)


def _syncbn_one_process(inp):
    """The port's BatchNorm on all 8 rows in one process."""
    bn = BatchNorm(6)
    bn.load_state_dict({"weight": inp["scale"], "bias": inp["bias"],
                        "running_mean": torch.zeros(6), "running_var": torch.ones(6)})
    bn.train()
    out = []
    for x in inp["xs"]:
        bn.zero_grad()
        tx = x.clone().requires_grad_()
        y = bn(tx)
        (y * inp["cot"]).sum().backward()
        out.append({"y": y.detach(), "dx": tx.grad, "dweight": bn.weight.grad.clone(),
                    "dbias": bn.bias.grad.clone(), "running_mean": bn.running_mean.clone(),
                    "running_var": bn.running_var.clone()})
    return out


def _syncbn_flax(inp):
    """flax `nn.BatchNorm` (the JAX package's `batch_norm`) on all 8 rows."""
    jbn = jbatch_norm()
    params = {"scale": jnp.asarray(inp["scale"].numpy()), "bias": jnp.asarray(inp["bias"].numpy())}
    stats = {"mean": jnp.zeros(6), "var": jnp.ones(6)}
    cot = jnp.asarray(inp["cot"].numpy())
    out = []
    for x in inp["xs"]:
        def f(p, xx, stats=stats):
            y, upd = jbn.apply({"params": p, "batch_stats": stats}, xx, use_running_average=False,
                               mutable=["batch_stats"])
            return (y * cot).sum(), (y, upd)
        (dp, dx), (y, upd) = jax.grad(f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x.numpy()))
        stats = upd["batch_stats"]
        out.append({"y": y, "dx": dx, "dweight": dp["scale"], "dbias": dp["bias"],
                    "running_mean": stats["mean"], "running_var": stats["var"]})
    return jax.device_get(out)


@pytest.mark.parametrize("reference", ["one_process", "flax"])
def test_synchronised_batchnorm(ranks, reference):
    """Two ranks of 4 rows against BatchNorm on all 8 (the port in one
    process, and flax): outputs, input / weight / bias gradients and the
    running statistics of two updates, 1e-5 of each tensor's largest
    value. The biased variance: `torch.nn.SyncBatchNorm` would keep the
    unbiased one, 8·9/(8·9 - 1) of it, in `running_var`."""
    inp = ranks["cases"]["syncbn"]
    want = _syncbn_one_process(inp) if reference == "one_process" else _syncbn_flax(inp)
    for step, w in enumerate(want):
        got = [res["syncbn"][step] for res in ranks["results"]]
        for key in ("y", "dx"):
            assert_close(torch.cat([g[key] for g in got]), w[key], 1e-5, f"{key} {step}")
        for key in ("dweight", "dbias", "running_mean", "running_var"):
            for g in got:
                assert_close(g[key], w[key], 1e-5, f"{key} {step}")
        assert torch.equal(got[0]["running_var"], got[1]["running_var"])


def _pad(x, rows=4):
    return torch.cat([x, x[-1:].expand(rows - x.shape[0], *x.shape[1:])])


KEYS = ("vid_grid", "vid_conf", "out_vid", "warped_vid")


def test_sample_video_sharded_matches_one_process(ranks):
    """B=3 on two ranks (padded to 4, 2 rows each) against one process's
    `sample_video` of the padded batch under the same injected gaussians,
    its first 3 rows; the same outputs on both ranks."""
    inp, model = ranks["cases"]["serving"], ranks["serving"]["model"]
    want = model.sample_video(_pad(inp["ref"]), _pad(inp["cond"]), 1.0, init_img=inp["init"],
                              noise_seq=inp["noise"])
    for res in ranks["results"]:
        for key in KEYS:
            got = res["serving"]["injected"][key]
            assert got.shape[0] == 3
            np.testing.assert_allclose(got.numpy(), want[key][:3].numpy(), atol=1e-4, err_msg=key)
    for key in KEYS:
        assert torch.equal(ranks["results"][0]["serving"]["injected"][key],
                           ranks["results"][1]["serving"]["injected"][key])


def test_sample_video_sharded_draws_what_one_process_draws(ranks):
    """Without injected gaussians: every rank draws the padded global
    batch's from the same generator and keeps its rows, so the video is the
    one-process video of the padded batch under that generator."""
    inp, model = ranks["cases"]["serving"], ranks["serving"]["model"]
    want = model.sample_video(_pad(inp["ref"]), _pad(inp["cond"]), 1.0,
                              generator=torch.Generator().manual_seed(inp["seed"]))
    for res in ranks["results"]:
        for key in KEYS:
            np.testing.assert_allclose(res["serving"]["drawn"][key].numpy(), want[key][:3].numpy(),
                                       atol=1e-4, err_msg=key)


def test_sample_video_sharded_matches_jax_on_a_data_mesh(ranks):
    """Against the JAX `sample_video` jitted on the padded batch sharded
    over a 2-device `data` mesh, the same injected gaussians: 2e-4."""
    s = ranks["serving"]
    inp = ranks["cases"]["serving"]
    mesh = jmake_mesh(2)
    rows = NamedSharding(mesh, P("data"))
    put = lambda a, sh=rows: jax.device_put(jnp.asarray(a.numpy()), sh)  # noqa: E731
    want = jax.device_get(jax.jit(lambda u, l, r, c, i, n: s["jm"].sample_video(
        u, l, jax.random.PRNGKey(0), r, c, 1.0, init_img=i, noise_seq=n))(
        s["unet_vars"], s["lfae_vars"], put(_pad(inp["ref"])), put(_pad(inp["cond"])),
        put(inp["init"]), put(inp["noise"], NamedSharding(mesh, P(None, "data")))))
    for res in ranks["results"]:
        for key in KEYS:
            np.testing.assert_allclose(res["serving"]["injected"][key].numpy(), np.asarray(want[key])[:3],
                                       atol=2e-4, err_msg=key)
