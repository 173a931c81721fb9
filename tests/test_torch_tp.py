"""Tensor parallelism of the port on the CPU: the `model` axis of
`parallel/mesh.py` (`UNET_TP_RULES`, `tp_spec`, `shard_variables`,
`gather_variables`), the head-shard mode of the two fused attention layers
(rows 1 and 2), the UNet's tensor-parallel form (`models/unet3d.py::
shard_unet`), tp serving and the tp `DMTrainer` step.

One process: `tp_spec` against the JAX `tp_spec` on every leaf of the MUG
UNet tree (`jax.eval_shape`, no weights), the port's path and shape of
every UNet entry against that tree, `shard_variables` at every model rank
put back together exactly, and the head-shard plain versions of rows 1 and
2 summed over the ranks' heads against the whole layer (fp32 1e-5; bf16
one ulp of the output, since the sum of the fp32 partials is rounded once
as the whole layer rounds its sum).

Two rank processes (`tests/torch_dp_worker.py`, gloo on 127.0.0.1) run the
tiny config of `__graft_entry__._tiny_config` (4 heads, dim 32, 2 frames,
2 DDIM steps), fp32, on a `model` axis of 2:

* the video of `sample_video_sharded` from injected gaussians (the
  `pallas3` form: rows 1 and 2 in their head-shard mode, plain here)
  against one process (2e-4) and the JAX one-device `sample_video` (5e-4,
  the bound of `tests/test_parallel.py:171`);
* a tiny UNet's forward in every form (`xla`, `pallas`, `pallas2`,
  `pallas3`, `pallas3` with the fused norm) against one process (1e-5 of
  the largest value), and the `xla` form's gathered gradients (1e-5 of the
  largest);
* `demo --mesh tp=2` (one GIF per class on rank 0; the videos those of one
  process's `sample_video` within 2e-4).

`tests/test_torch_tp_train.py` holds the tp `DMTrainer` step and its
checkpoint, `tests/test_torch_tp_mesh.py` the four-rank `dp=2` x `tp=2`
cases.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from cvpr23_lfdm_tpu.config import mug_config
from cvpr23_lfdm_tpu.diffusion.flow_diffusion import FlowDiffusion as JFlowDiffusion
from cvpr23_lfdm_tpu.models.flow_autoenc import init_lfae_vars
from cvpr23_lfdm_tpu.parallel.mesh import tp_spec as jtp_spec
from cvpr23_lfdm_torch.diffusion.flow_diffusion import FlowDiffusion
from cvpr23_lfdm_torch.models.unet3d import Unet3D
from cvpr23_lfdm_torch.ops import attention as A
from cvpr23_lfdm_torch.parallel import mesh as M
from cvpr23_lfdm_torch.scripts import demo
from cvpr23_lfdm_torch.scripts._common import load_text_embedder
from cvpr23_lfdm_torch.train.dm_trainer import DMTrainer
from cvpr23_lfdm_torch.utils.bench_ckpt import from_jax_params, jax_layout, to_jax_params
from test_torch_cli import tiny_cfg
from test_torch_parallel import spawn_ranks
from test_torch_slice import _port_cfg, _random_variables
from test_torch_train import _draws

T = torch.from_numpy
KEYS = ("vid_grid", "vid_conf", "out_vid", "warped_vid")
LR = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():  # module scope: it runs before the module's spawn fixture
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _walk(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield "/".join(path + (k,)), tuple(v.shape)


def _mug_unet_tree():
    cfg = mug_config()
    d = cfg.diffusion
    jm = JFlowDiffusion(cfg.lfae, d)
    x = jnp.zeros((1, d.num_frames, d.img_size, d.img_size, 3))
    return jax.eval_shape(jm.unet.init, jax.random.PRNGKey(0), x, jnp.zeros((1,)),
                          jnp.zeros((1, d.cond_dim)), fea=jnp.zeros((1, 1, d.img_size, d.img_size, 256)))


@pytest.fixture(scope="module")
def mug_tree():
    return dict(_walk(_mug_unet_tree()["params"]))


# ------------------------------------------------------------------ one process


@pytest.mark.parametrize("size", [2, 4, 8])
def test_tp_spec_matches_jax_on_the_mug_unet(mug_tree, size):
    """Every leaf of the MUG UNet (303 of them): the same spec as the JAX
    package's rule table; the port's own UNet entries map onto exactly
    these paths and shapes, and the sharded ones onto a port axis."""
    assert len(mug_tree) == 303
    for path, shape in mug_tree.items():
        assert M.tp_spec(path, shape, size) == tuple(jtp_spec(path, shape, size)), path
    d = mug_config().diffusion
    with torch.device("meta"):
        net = Unet3D(dim=d.dim, cond_dim=d.cond_dim, dim_mults=d.dim_mults, attn_heads=d.attn_heads,
                     attn_dim_head=d.attn_dim_head, learn_null_cond=d.learn_null_cond)
    seen, sharded = set(), 0
    for key, value in net.state_dict().items():
        _, path, shape, axes = jax_layout(key, tuple(value.shape))
        assert mug_tree[path] == shape, key
        seen.add(path)
        plan = M.shard_plan(key, tuple(value.shape), size)
        spec = M.tp_spec(path, shape, size)
        assert (plan is None) == ("model" not in spec), key
        if plan is not None:
            sharded += 1
            assert plan[0] == axes[spec.index("model")]
    assert seen == set(mug_tree)
    assert sharded == 189  # 115 kernels (57 convs, 19 + 19 attention, 18 FiLM, 2 time MLP), 74 biases


def _tiny_unet(seed=0, heads=4):
    torch.manual_seed(seed)
    return Unet3D(dim=32, cond_dim=16, dim_mults=(1, 2), attn_heads=heads, fea_channels=8,
                  learn_null_cond=True)


def test_jax_layout_round_trips_a_learn_null_cond_unet():
    """`jax_layout` places every entry of a UNet with a learned null
    condition (`null_cond_emb` too) at the JAX shape it names, and
    `to_jax_params` then `from_jax_params` gives the state back bit for
    bit."""
    state = _tiny_unet().state_dict()
    assert "null_cond_emb" in state
    tree = to_jax_params(state)
    back = from_jax_params(tree)
    assert set(back) == set(state) and all(torch.equal(back[k], v) for k, v in state.items())
    for key, value in state.items():
        col, path, shape, _ = jax_layout(key, tuple(value.shape))
        node = tree[col]
        for part in path.split("/"):
            node = node[part]
        assert node.shape == shape, key


@pytest.mark.parametrize("size", [2, 4])
def test_shard_variables_slices_and_inverse(size):
    """Each model rank's shard: q, k and v of its heads in `to_qkv`, scale
    and shift of its channels in a FiLM `mlp`, contiguous output channels
    elsewhere (the deconv's axis 1), replicated leaves whole; the ranks'
    shards put back in place give the state bit for bit."""
    state = _tiny_unet().state_dict()
    shards = [M.shard_variables(state, M.Mesh(1, 0, None, torch.device("cpu"), ("data", "model"),
                                              size, r, None)) for r in range(size)]
    for key, full in state.items():
        plan = M.shard_plan(key, tuple(full.shape), size)
        if plan is None:
            assert all(s[key] is full for s in shards), key
            continue
        axis, parts = plan
        back = torch.empty_like(full)
        for r, s in enumerate(shards):
            back.index_copy_(axis, M.shard_index(full.shape[axis], parts, size, r), s[key])
        assert torch.equal(back, full), key
    hd, c = 4 * 32, 32  # heads x dim_head; init_temporal_attn runs at dim 32
    qkv = state["init_temporal_attn.attn.to_qkv.weight"]  # [3 hd, C]
    for r, s in enumerate(shards):
        w = hd // size
        want = torch.cat([qkv[t * hd + r * w:t * hd + (r + 1) * w] for t in range(3)])
        assert torch.equal(s["init_temporal_attn.attn.to_qkv.weight"], want)
        mlp = state["downs_0_block1.mlp.weight"]  # [2 C, emb]: scale rows, then shift rows
        n = c // size
        assert torch.equal(s["downs_0_block1.mlp.weight"],
                           torch.cat([mlp[r * n:(r + 1) * n], mlp[c + r * n:c + (r + 1) * n]]))
        up = state["ups_0_upsample.weight"]  # [in, out, 4, 4]
        n = up.shape[1] // size
        assert torch.equal(s["ups_0_upsample.weight"], up[:, r * n:(r + 1) * n])
        assert s["downs_0_block1.block1.norm.weight"] is state["downs_0_block1.block1.norm.weight"]


def _layer_inputs(row, dtype, c=64, heads=8, branch=False, seed=0):
    g = torch.Generator().manual_seed(seed)
    b, f, hw, d = 2, 6, 12, 32
    hd = heads * d
    x = torch.randn(b, f, hw, c, generator=g) / (16 if branch else 1)
    gamma = 1 + 0.2 * torch.randn(c, generator=g)
    wqkv = torch.randn(c, 3 * hd, generator=g) / c ** 0.5
    wout = torch.randn(hd, c, generator=g) / hd ** 0.5 * (3 if branch else 1)
    if row == 1:
        pos = torch.randn(heads, f, f, generator=g)
        mask = torch.tensor([False, True])
        extra = {"pos": pos, "mask": mask}
    else:
        extra = {"bout": 0.1 * torch.randn(c, generator=g)}
    cast = lambda t: t.to(dtype)  # noqa: E731
    return cast(x), gamma, cast(wqkv), cast(wout), extra


def _row(row, x, gamma, wqkv, wout, extra, heads, partial, rank=0, size=1):
    """Row 1 or 2's plain version on model rank `rank` of `size` (its heads)."""
    f = x.shape[1]
    hl, hd = heads // size, heads * 32
    cols = M.shard_index(3 * hd, 3, size, rank)
    wq, wo = wqkv[:, cols].contiguous(), wout[rank * hl * 32:(rank + 1) * hl * 32].contiguous()
    if row == 2:
        return A.fused_spatial_linear_layer(x, gamma, wq, wo, extra["bout"], hl, 32, partial=partial)
    pos = extra["pos"][rank * hl:(rank + 1) * hl]
    bias = A.build_bias_flat(pos, x.shape[0], f, extra["mask"])
    cos_t, sin_t = A.rotary_tables(f, hl, 32, 32 ** -0.5, x.dtype)
    return A.fused_temporal_layer(x, gamma, wq, wo, bias, cos_t, sin_t, hl, 32, partial=partial)


@pytest.mark.parametrize("branch", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("row", [1, 2])
@pytest.mark.parametrize("size", [2, 4])
def test_head_shard_plain_rows_sum_to_the_layer(row, dtype, size, branch):
    """The ranks' fp32 partials (`partial=True`, each on its heads) summed,
    `+ bout` for row 2, rounded once to the compute dtype and added to x,
    against the whole layer. The partial of all heads on one rank, so
    rounded and added, is the whole layer bit for bit; the ranks' sum
    differs from it in the order of the fp32 sums only: 1e-5 in fp32, and
    in bf16 the rounded attention term within one bf16 ulp of the whole
    layer's (an output that nearly cancels x moves by more than one ulp of
    itself when its term moves by one). `branch`: inputs under which the
    attention term is O(1)."""
    x, gamma, wqkv, wout, extra = _layer_inputs(row, dtype, branch=branch)
    bout = extra["bout"] if row == 2 else 0.0
    whole = _row(row, x, gamma, wqkv, wout, extra, 8, False)
    one = _row(row, x, gamma, wqkv, wout, extra, 8, True)
    assert one.dtype == torch.float32 and torch.equal(x + (one + bout).to(dtype), whole)
    parts = [_row(row, x, gamma, wqkv, wout, extra, 8, True, r, size) for r in range(size)]
    assert all(p.dtype == torch.float32 for p in parts)
    term = (sum(parts) + bout).to(dtype)
    if dtype == torch.float32:
        np.testing.assert_allclose((x + term).numpy(), whole.numpy(), atol=1e-5, rtol=0)
    else:
        want = (one + bout).to(dtype).float()
        ulp = torch.finfo(dtype).eps * want.abs().clamp_min(2.0 ** -126)
        assert bool(((term.float() - want).abs() <= ulp).all())


def test_check_tp_and_the_one_rank_mesh():
    """tp must divide the 8 GroupNorm groups and the heads; `shard_unet` on
    a mesh of one model rank changes nothing."""
    from cvpr23_lfdm_torch.models.unet3d import check_tp, shard_unet

    for size in (1, 2, 4, 8):
        check_tp(size, 8)
    for size, heads in ((3, None), (16, None), (4, 2)):
        with pytest.raises(ValueError, match="must divide"):
            check_tp(size, heads)
    net = _tiny_unet()
    before = {k: v.clone() for k, v in net.state_dict().items()}
    mesh = M.make_mesh((1, 1), ("data", "model"), device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.model_group is None
    assert shard_unet(net, mesh) is net and net.tp is None
    assert all(torch.equal(v, before[k]) for k, v in net.state_dict().items())


# ------------------------------------------------------------------ two ranks


def _jcfg(impl: str):
    cfg = _tiny_config(num_frames=2, sampling_timesteps=2)
    return cfg.replace(diffusion=dataclasses.replace(cfg.diffusion, temporal_attn_impl=impl),
                       dm_train=dataclasses.replace(cfg.dm_train, lr=LR, batch_size=2))


def _weights(jcfg, rng):
    lfae_vars = _random_variables(jax.eval_shape(
        lambda r: init_lfae_vars(r, jcfg.lfae), jax.random.PRNGKey(0)), rng)
    jm = JFlowDiffusion(jcfg.lfae, jcfg.diffusion)
    d = jcfg.diffusion
    x = jnp.zeros((1, d.num_frames, d.img_size, d.img_size, 3))
    unet_vars = _random_variables(jax.eval_shape(
        jm.unet.init, jax.random.PRNGKey(1), x, jnp.zeros((1,)), jnp.zeros((1, d.cond_dim)),
        fea=jnp.zeros((1, 1, d.img_size, d.img_size, 256))), rng)
    return jm, lfae_vars, unet_vars


def serving_inputs(rng, mesh, b):
    """The `pallas3` serving case on `mesh` (dp, tp): B requests, injected
    gaussians of the padded batch."""
    jcfg = _jcfg("pallas3_interpret")
    jm, lfae_vars, unet_vars = _weights(jcfg, rng)
    tcfg = _port_cfg(jcfg)
    model = FlowDiffusion(tcfg.lfae, tcfg.diffusion, device="cpu")
    model.load_jax_variables(unet_vars, lfae_vars)
    d, s = jcfg.diffusion, jcfg.lfae.frame_shape
    rows = b + (-b) % mesh[0]
    ref = rng.uniform(size=(b, s, s, 3)).astype(np.float32)
    cond = rng.standard_normal((b, d.cond_dim)).astype(np.float32)
    init = rng.standard_normal((rows, d.num_frames, d.img_size, d.img_size, 3)).astype(np.float32)
    noise = rng.standard_normal((d.sampling_timesteps,) + init.shape).astype(np.float32)
    case = {"case": "tp_serving", "cfg": tcfg, "model": model.state_dict(), "mesh": mesh, "ref": T(ref),
            "cond": T(cond), "init": T(init), "noise": T(noise),
            "inspect": ["init_temporal_attn.attn.to_qkv.weight", "downs_0_block1.mlp.weight"]}
    return {"jm": jm, "lfae_vars": lfae_vars, "unet_vars": unet_vars, "model": model, "case": case}


def dm_inputs(rng, mesh, b, ckpt_dir):
    """The `pallas2` DM step on `mesh`: a global batch of B and the JAX
    key's draws for it."""
    jcfg = _jcfg("pallas2_interpret")
    jcfg = jcfg.replace(dm_train=dataclasses.replace(jcfg.dm_train, batch_size=b))
    _, lfae_vars, unet_vars = _weights(jcfg, rng)
    tcfg = _port_cfg(jcfg)
    model = FlowDiffusion(tcfg.lfae, tcfg.diffusion, device="cpu", training=True)
    model.load_jax_variables(unet_vars, lfae_vars)
    d, s = jcfg.diffusion, jcfg.lfae.frame_shape
    vid = rng.uniform(size=(b, d.num_frames, s, s, 3)).astype(np.float32)
    batch = {"ref_img": vid[:, 0].copy(), "real_vid": vid,
             "cond": rng.standard_normal((b, d.cond_dim)).astype(np.float32),
             "none_cond_mask": np.arange(b) % 3 == 1}
    key = jax.random.PRNGKey(5)
    draws = tuple(T(np.asarray(a)) for a in _draws(key, d, (b, d.num_frames, d.img_size, d.img_size, 3)))
    case = {"case": "tp_dm_step", "cfg": tcfg, "model": model.state_dict(), "mesh": mesh, "batch": batch,
            "draws": draws, "steps_per_epoch": 4, "ckpt_dir": ckpt_dir}
    return {"jcfg": jcfg, "tcfg": tcfg, "lfae_vars": lfae_vars, "unet_vars": unet_vars, "batch": batch,
            "key": key, "draws": draws, "case": case}


def one_process_step(dm):
    """The port's trainer in one process on the global batch, same draws."""
    model = FlowDiffusion(dm["tcfg"].lfae, dm["tcfg"].diffusion, device="cpu", training=True)
    model.load_state_dict(dm["case"]["model"])
    tt = DMTrainer(dm["tcfg"], steps_per_epoch=4, model=model)
    state = tt.init_state()
    t, noise, null = dm["draws"]
    state, m = tt.train_step(state, None, dm["batch"], t=t, noise=noise, null_mask=null)
    grads = {k: p.grad.clone() for k, p in tt.model.unet.named_parameters() if p.grad is not None}
    return tt, state, {k: float(v) for k, v in m.items()}, grads


def assert_step_matches_one_process(got: dict, want_metrics: dict, want_grads: dict):
    np.testing.assert_allclose(got["metrics"]["loss"], want_metrics["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["metrics"]["grad_norm"], want_metrics["grad_norm"], rtol=1e-5)
    assert set(got["grads"]) == set(want_grads)
    top = max(float(g.abs().max()) for g in want_grads.values())
    for k, w in want_grads.items():
        assert float((got["grads"][k] - w).abs().max()) <= 1e-5 * top, k
    assert got["agree_data"] and got["agree_model"] and got["restored"]


FORMS = (("xla", False), ("pallas", False), ("pallas2", False), ("pallas3", False), ("pallas3", True))
UNET_KW = dict(dim=32, cond_dim=16, dim_mults=(1, 2), attn_heads=4, fea_channels=8, learn_null_cond=True)


def forms_inputs(rng):
    """A tiny UNet's weights and one input (B=2, 4 frames, a focus row) for
    every form."""
    torch.manual_seed(3)
    state = Unet3D(**UNET_KW).state_dict()
    x = T(rng.standard_normal((2, 4, 8, 8, 3)).astype(np.float32))
    args = (x, torch.tensor([3.0, 41.0]), T(rng.standard_normal((2, 16)).astype(np.float32)),
            torch.tensor([False, True]), torch.tensor([True, False]))
    return {"case": "tp_forms", "mesh": (1, 2), "forms": FORMS, "kwargs": UNET_KW, "state": state,
            "args": args, "fea": T(rng.standard_normal((2, 1, 8, 8, 8)).astype(np.float32)),
            "cot": T(rng.standard_normal((2, 4, 8, 8, 3)).astype(np.float32))}


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_ranks")
    rng = np.random.RandomState(11)
    serving = serving_inputs(rng, (1, 2), 1)
    classes = ["anger", "fear", "happiness"]
    cases = {"forms": forms_inputs(rng), "serving": serving["case"],
             "tp_cli": {"cfg": tiny_cfg(), "dir": str(tmp / "demo"),
                        "demo": ["--device", "cpu", "--mesh", "tp=2", "--classes", *classes]}}
    results = spawn_ranks(cases, str(tmp), ports=3)
    return {"forms": cases["forms"], "serving": serving, "results": results, "classes": classes}


def test_meshes_and_shards_on_two_ranks(tp):
    """`make_mesh((1, 2), ("data", "model"))`: both ranks at data index 0,
    model indices 0 and 1; each holds 2 of the 4 heads and its q, k, v and
    FiLM columns, and `gather_variables` gives the one-process UNet back."""
    full = tp["serving"]["model"].unet.state_dict()
    qkv, mlp = full["init_temporal_attn.attn.to_qkv.weight"], full["downs_0_block1.mlp.weight"]
    for r, res in enumerate(tp["results"]):
        got = res["serving"]
        assert got["mesh"] == (1, 0, 2, r, {"data": 1, "model": 2})
        assert got["gather_exact"] and set(got["heads"]) == {2}
        assert torch.equal(got["shards"]["init_temporal_attn.attn.to_qkv.weight"],
                           torch.cat([qkv[t * 128 + 64 * r:t * 128 + 64 * (r + 1)] for t in range(3)]))
        assert torch.equal(got["shards"]["downs_0_block1.mlp.weight"],
                           torch.cat([mlp[16 * r:16 * (r + 1)], mlp[32 + 16 * r:32 + 16 * (r + 1)]]))


@pytest.mark.parametrize("impl,fused_norm", FORMS)
def test_every_unet_form_on_two_ranks_matches_one_process(tp, impl, fused_norm):
    """Each form's UNet output on a `model` axis of 2 (both ranks equal)
    within 1e-5 of its largest value of one process's; for `xla`, the
    training form without a kernel, every gathered gradient within 1e-5 of
    the largest."""
    inp = tp["forms"]
    net = Unet3D(**inp["kwargs"], temporal_attn_impl=impl, fused_norm=fused_norm)
    net.load_state_dict(inp["state"])
    with torch.set_grad_enabled(impl == "xla"):
        want = net(*inp["args"], fea=inp["fea"])
    key = f"{impl}{'+norm' if fused_norm else ''}"
    got = [res["forms"][key] for res in tp["results"]]
    assert torch.equal(got[0]["out"], got[1]["out"])
    scale = float(want.detach().abs().max())
    assert float((got[0]["out"] - want.detach()).abs().max()) <= 1e-5 * scale
    if impl == "xla":
        (want * inp["cot"]).sum().backward()
        grads = {k: p.grad for k, p in net.named_parameters()}
        top = max(float(g.abs().max()) for g in grads.values())
        assert set(got[0]["grads"]) == set(grads)
        for k, g in grads.items():
            assert float((got[0]["grads"][k] - g).abs().max()) <= 1e-5 * top, k


def test_tp_video_matches_one_process_and_jax(tp):
    """The tp=2 video from injected gaussians: both ranks the same, within
    2e-4 of one process and 5e-4 of the JAX one-device `sample_video`."""
    s, inp = tp["serving"], tp["serving"]["case"]
    one = s["model"].sample_video(inp["ref"], inp["cond"], 1.0, init_img=inp["init"], noise_seq=inp["noise"])
    want = jax.device_get(jax.jit(lambda u, lv, r, c, i, n: s["jm"].sample_video(
        u, lv, jax.random.PRNGKey(0), r, c, 1.0, init_img=i, noise_seq=n))(
        s["unet_vars"], s["lfae_vars"], *(jnp.asarray(inp[k].numpy()) for k in ("ref", "cond", "init", "noise"))))
    r0, r1 = (res["serving"]["out"] for res in tp["results"])
    for key in KEYS:
        assert torch.equal(r0[key], r1[key]), key
        np.testing.assert_allclose(r0[key].numpy(), one[key].numpy(), atol=2e-4, rtol=0, err_msg=key)
        np.testing.assert_allclose(r0[key].numpy(), np.asarray(want[key]), atol=5e-4, rtol=0, err_msg=key)


def test_demo_mesh_tp2_on_two_processes(tp, tmp_path):
    """`demo --mesh tp=2`: one GIF per class written by rank 0 only; both
    ranks' videos equal, and within 2e-4 of one process's `sample_video` of
    the class batch from the same generator."""
    assert_demo_matches_one_process([res["tp_cli"]["demo"] for res in tp["results"]], tp["classes"], tmp_path)


def assert_demo_matches_one_process(ranks: list, classes: list, tmp_path):
    """`demo` on a mesh whose ranks all sample every class (`ranks`: each
    rank's GIFs and outputs): rank 0 alone wrote one GIF per class, every
    rank's videos are equal, and within 2e-4 of one process's
    `sample_video` of the class batch from the same generator."""
    assert len(ranks[0]["gifs"]) == len(classes) and all(r["gifs"] == [] for r in ranks[1:])
    args = demo.parser().parse_args(["--device", "cpu", "--log-dir", str(tmp_path)])
    saved, demo.BENCH_CKPT = demo.BENCH_CKPT, str(tmp_path / "none")
    try:
        cfg, model = demo.build_model(tiny_cfg(), args)
    finally:
        demo.BENCH_CKPT = saved
    img = torch.from_numpy(demo.reference_image(args, cfg.lfae.frame_shape))
    conds = torch.from_numpy(load_text_embedder(args)(classes)[0])
    want = model.sample_video(img[None].expand(len(classes), -1, -1, -1), conds, 1.0,
                              generator=torch.Generator().manual_seed(args.seed))
    for bi, text in enumerate(classes):
        for key, v in ranks[0]["outputs"][text].items():
            for other in ranks[1:]:
                np.testing.assert_array_equal(v, other["outputs"][text][key])
            np.testing.assert_allclose(v, want[key][bi:bi + 1].numpy(), atol=2e-4, err_msg=key)
