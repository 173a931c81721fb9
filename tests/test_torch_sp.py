"""Spatial partitioning of the port on the CPU: the `space` axis of
`parallel/mesh.py` (`local_band`, `gather_band`, `halo_rows`,
`broadcast_space`), the band mode of `models/blocks.py::Conv2d` and of the
generator (`models/generator.py::check_sp` / `shard_generator`), row 3's
output band (`ops/warp.py::warp_video` at `Ho < Hs`) and sp serving.

One process: the helpers on a one-rank space axis are identities (a halo
of zeros); `check_sp`'s refusals; a band conv (7x7 and 3x3, fed the rows a
neighbour would send, cut from the whole tensor) within 1e-6 of its largest
value of the whole conv's rows; `warp_video_plain` on a band of grid rows
`torch.equal` to those rows of the whole call.

Two rank processes (`tests/torch_dp_worker.py`, gloo on 127.0.0.1), sp=2
on the tiny config of `__graft_entry__._tiny_config` (64² frames, 2
frames, 2 DDIM steps, `pallas3`), fp32:

* the meshes' indices, the halo rows (exact, zeros past the edges, in
  fp32 and bf16), the gathered bands in space-rank order, the broadcast;
* the band-mode generator's gathered `compute_fea` and
  `decode_video_with_flow` within 1e-5 of their largest value of one
  process's (convolutions of another height sum in another order);
* `sample_video_sharded` from injected gaussians: both ranks equal, within
  2e-4 of one process and 5e-4 of the JAX one-device `sample_video` (the
  bounds of `tests/test_torch_tp.py`); train mode refused;
* `demo --mesh sp=2`: one GIF per class on rank 0; its videos those of one
  process within 2e-4.

Four rank processes: the mesh orders of `data` x `space`, `model` x
`space` and the three axes, the video on `dp=2,sp=2` (a ragged batch of
3) and on `tp=2,sp=2`, each within 2e-4 of one process, every rank of a
data index equal, and `test_dm --mesh dp=2,sp=2` (finite metrics on rank
0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cvpr23_lfdm_torch.diffusion.flow_diffusion import FlowDiffusion
from cvpr23_lfdm_torch.models import blocks
from cvpr23_lfdm_torch.models.generator import check_sp, shard_generator
from cvpr23_lfdm_torch.ops import warp as W
from cvpr23_lfdm_torch.parallel import mesh as M
from test_torch_cli import tiny_cfg
from test_torch_parallel import spawn_ranks
from test_torch_slice import _port_cfg
from test_torch_tp import KEYS, _jcfg, _weights, assert_demo_matches_one_process

T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():  # module scope: it runs before the module's spawn fixtures
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_rel(got, want, rel, what=""):
    """max |got - want| <= rel * max |want|."""
    got, want = got.detach().double(), want.detach().double()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert float((got - want).abs().max()) <= rel * float(want.abs().max()), what


# ------------------------------------------------------------------ one process


def test_space_helpers_on_one_rank_are_identities():
    x = torch.randn(2, 6, 5, 3)
    for mesh in (None, M.make_mesh((1, 1), ("data", "space"), device="cpu")):
        assert M.local_band(x, mesh) is x and M.gather_band(x, mesh) is x
        assert M.broadcast_space(x, mesh) is x
        assert M.halo_rows(x, 0, mesh) is x
        assert torch.equal(M.halo_rows(x, 3, mesh), F.pad(x, (0, 0, 0, 0, 3, 3)))
    g = FlowDiffusion(tiny_cfg().lfae, tiny_cfg().diffusion, device="cpu").generator
    assert shard_generator(g, M.make_mesh((1, 1), ("data", "space"), device="cpu")) is g and g.sp is None
    assert len(g.band_convs()) == 10 and all(c.space is None for c in g.band_convs())


@pytest.mark.parametrize("size,frame,down,ok", [
    (1, 128, 2, True), (2, 128, 2, True), (4, 128, 2, True), (8, 128, 2, True), (2, 64, 2, True),
    (4, 16, 2, True), (16, 128, 2, True), (3, 128, 2, False), (64, 128, 2, False), (2, 12, 2, False),
    (8, 16, 1, False), (2, 4, 1, False),
    (0, 128, 2, False)])
def test_check_sp(size, frame, down, ok):
    """sp x 2^down must divide the height (whole bands, even where they are
    pooled), and a band must hold the 3-row halo of the 7x7 convs."""
    if ok:
        check_sp(size, frame, down)
    else:
        with pytest.raises(ValueError, match="the JAX package pads an uneven split"):
            check_sp(size, frame, down)


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("k", [7, 3])
def test_band_conv_matches_the_whole_conv(monkeypatch, k, size):
    """Each band of a band-mode `Conv2d`, given the rows its neighbours
    would send (cut from the whole tensor, zeros past the edges), is the
    whole conv's rows within 1e-6 of their largest value."""
    torch.manual_seed(k + size)
    conv = blocks.Conv2d(5, 4, k)
    torch.nn.init.normal_(conv.bias)
    x = torch.randn(2, 16, 9, 5)
    whole = conv(x)
    pad = F.pad(x, (0, 0, 0, 0, k // 2, k // 2))
    n = 16 // size
    for r in range(size):
        def halo(band, rows, mesh, dim=1, r=r):
            assert rows == k // 2 and mesh is conv.space and torch.equal(band, x[:, r * n:(r + 1) * n])
            return pad[:, r * n:(r + 1) * n + 2 * rows]

        monkeypatch.setattr(M, "halo_rows", halo)
        conv.space = object()
        got = conv(x[:, r * n:(r + 1) * n])
        conv.space = None
        assert_rel(got, whole[:, r * n:(r + 1) * n], 1e-6, (k, size, r))


@pytest.mark.parametrize("h,c", [(16, 8), (32, 4), (12, 3)])
def test_warp_video_plain_on_a_band_of_rows(h, c):
    """Row 3's plain version on a band of grid rows (`Ho < Hs`) is those
    rows of the whole-height call, bit for bit."""
    g = torch.Generator().manual_seed(h + c)
    src = torch.randn(2, h, h, c, generator=g)
    lin = torch.linspace(-1, 1, h)
    grid = torch.stack(torch.meshgrid(lin, lin, indexing="xy"), -1)[None, None] \
        + 0.3 * torch.randn(2, 3, h, h, 2, generator=g)
    whole = W.warp_video(src, grid)
    for lo, hi in ((0, h // 2), (h // 2, h), (h // 4, h // 4 + 2)):
        band = W.warp_video(src, grid[:, :, lo:hi].contiguous())
        assert band.shape == (2, 3, hi - lo, h, c)
        assert torch.equal(band, whole[:, :, lo:hi])


# ------------------------------------------------------------------ ranks


def sp_inputs(rng, shape, axes, b, decode=False):
    """The `pallas3` serving case on a mesh of `shape` over `axes`: B
    requests and injected gaussians of the padded batch; with `decode`, a
    source image, flow and occlusion for the generator alone."""
    jcfg = _jcfg("pallas3_interpret")
    jm, lfae_vars, unet_vars = _weights(jcfg, rng)
    tcfg = _port_cfg(jcfg)
    model = FlowDiffusion(tcfg.lfae, tcfg.diffusion, device="cpu")
    model.load_jax_variables(unet_vars, lfae_vars)
    d, s = jcfg.diffusion, jcfg.lfae.frame_shape
    dp = dict(zip(axes, shape)).get("data", 1)
    rows = b + (-b) % dp
    ref = rng.uniform(size=(b, s, s, 3)).astype(np.float32)
    cond = rng.standard_normal((b, d.cond_dim)).astype(np.float32)
    init = rng.standard_normal((rows, d.num_frames, d.img_size, d.img_size, 3)).astype(np.float32)
    noise = rng.standard_normal((d.sampling_timesteps,) + init.shape).astype(np.float32)
    case = {"case": "sp_serving", "cfg": tcfg, "model": model.state_dict(), "mesh": shape, "axes": axes,
            "ref": T(ref), "cond": T(cond), "init": T(init), "noise": T(noise)}
    if decode:
        h, f = d.img_size, d.num_frames
        lin = np.linspace(-1, 1, h, dtype=np.float32)
        ident = np.stack(np.meshgrid(lin, lin, indexing="xy"), -1)
        flow = ident[None, None] + 0.2 * rng.standard_normal((1, f, h, h, 2)).astype(np.float32)
        case["decode"] = (T(rng.uniform(size=(1, s, s, 3)).astype(np.float32)), T(flow),
                          T(rng.uniform(size=(1, f, h, h, 1)).astype(np.float32)))
    return {"jm": jm, "lfae_vars": lfae_vars, "unet_vars": unet_vars, "model": model, "case": case}


def _pad(x, rows):
    return torch.cat([x, x[-1:].expand(rows - x.shape[0], *x.shape[1:])])


def one_process(s, rows=None):
    inp = s["case"]
    rows = rows or inp["ref"].shape[0]
    return s["model"].sample_video(_pad(inp["ref"], rows), _pad(inp["cond"], rows), 1.0,
                                   init_img=inp["init"], noise_seq=inp["noise"])


@pytest.fixture(scope="module")
def sp2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp_ranks")
    rng = np.random.RandomState(16)
    serving = sp_inputs(rng, (1, 2), ("data", "space"), 1, decode=True)
    classes = ["anger", "fear"]
    x = T(rng.standard_normal((2, 8, 3, 4)).astype(np.float32))
    cases = {"sp_meshes": {"meshes": [((1, 2), ("data", "space")), ((2, 1), ("space", "data"))],
                           "x": x, "rows": 3},
             "serving": serving["case"],
             "tp_cli": {"cfg": tiny_cfg(), "dir": str(tmp / "demo"),
                        "demo": ["--device", "cpu", "--mesh", "sp=2", "--classes", *classes]}}
    results = spawn_ranks(cases, str(tmp), ports=3)
    return {"serving": serving, "results": results, "classes": classes, "x": x}


def test_space_meshes_and_collectives_on_two_ranks(sp2):
    """Both orders of a 1 x 2 `data` x `space` mesh put rank r at space
    index r; `halo_rows` gives each band the neighbour's 3 rows and zeros
    past the edges (exact in fp32 and in bf16, which gloo carries as
    fp32); `gather_band` concatenates in space order; `broadcast_space`
    gives rank 0's tensor."""
    x = sp2["x"]
    pad = F.pad(x, (0, 0, 0, 0, 3, 3))
    for r, res in enumerate(sp2["results"]):
        got = res["sp_meshes"]
        for m in got["meshes"]:
            assert m["index"] == (0, 0, r) and m["sizes"] == (1, 1, 2)
            assert torch.equal(m["gathered"].flatten(), torch.tensor([0.0, 0.0, 1.0, 1.0]))
        assert got["meshes"][0]["shape"] == {"data": 1, "space": 2}
        assert got["meshes"][1]["shape"] == {"space": 2, "data": 1}
        assert torch.equal(got["band"], x[:, 4 * r:4 * (r + 1)])
        for dt, halo in got["halo"].items():
            assert halo.dtype == getattr(torch, dt.removeprefix("torch."))
            assert torch.equal(halo, pad[:, 4 * r:4 * (r + 1) + 6].to(halo.dtype)), (r, dt)
        assert got["broadcast"].dtype == torch.bfloat16 and torch.equal(got["broadcast"], torch.zeros(3).bfloat16())


def test_band_generator_matches_one_process(sp2):
    """The band-mode generator's gathered feature and decode on two ranks,
    within 1e-5 of their largest value of one process's."""
    s = sp2["serving"]
    src, flow, occ = s["case"]["decode"]
    gen = s["model"].generator
    fea, dec = gen.compute_fea(src), gen.decode_video_with_flow(src, flow, occ)
    for res in sp2["results"]:
        got = res["serving"]
        assert_rel(got["fea"], fea, 1e-5, "fea")
        for key in ("prediction", "deformed", "bottle_neck_feat"):
            assert_rel(got["decode"][key], dec[key], 1e-5, key)
    r0, r1 = (res["serving"]["decode"] for res in sp2["results"])
    assert all(torch.equal(r0[k], r1[k]) for k in r0)


def test_sp_video_matches_one_process_and_jax(sp2):
    """The sp=2 video from injected gaussians: both ranks the same, within
    2e-4 of one process and 5e-4 of the JAX one-device `sample_video`;
    train mode refused on the band-mode generator."""
    s, inp = sp2["serving"], sp2["serving"]["case"]
    one = one_process(s)
    want = jax.device_get(jax.jit(lambda u, lv, r, c, i, n: s["jm"].sample_video(
        u, lv, jax.random.PRNGKey(0), r, c, 1.0, init_img=i, noise_seq=n))(
        s["unet_vars"], s["lfae_vars"], *(jnp.asarray(inp[k].numpy()) for k in ("ref", "cond", "init", "noise"))))
    r0, r1 = (res["serving"]["out"] for res in sp2["results"])
    for key in KEYS:
        assert torch.equal(r0[key], r1[key]), key
        np.testing.assert_allclose(r0[key].numpy(), one[key].numpy(), atol=2e-4, rtol=0, err_msg=key)
        np.testing.assert_allclose(r0[key].numpy(), np.asarray(want[key]), atol=5e-4, rtol=0, err_msg=key)
    for r, res in enumerate(sp2["results"]):
        assert res["serving"]["mesh"] == (0, 0, r, {"data": 1, "space": 2})
        assert "serving only" in res["serving"]["train_refused"]


def test_demo_mesh_sp2_on_two_processes(sp2, tmp_path):
    assert_demo_matches_one_process([res["tp_cli"]["demo"] for res in sp2["results"]], sp2["classes"],
                                    tmp_path)


@pytest.fixture(scope="module")
def sp4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp_mesh_ranks")
    rng = np.random.RandomState(17)
    dpsp = sp_inputs(rng, (2, 2), ("data", "space"), 3)
    tpsp = sp_inputs(rng, (2, 2), ("model", "space"), 1)
    meshes = [((2, 2), ("data", "space")), ((2, 2), ("space", "data")), ((2, 2), ("model", "space")),
              ((1, 2, 2), ("data", "model", "space")), ((2, 1, 2), ("space", "data", "model"))]
    cases = {"sp_meshes": {"meshes": meshes}, "dpsp": dpsp["case"], "tpsp": tpsp["case"],
             "tp_cli": {"cfg": tiny_cfg(), "dir": str(tmp / "cli"),
                        "test_dm": ["--device", "cpu", "--mesh", "dp=2,sp=2", "--synthetic", "--data-root",
                                    str(tmp / "corpus"), "--num-videos", "3", "--random-metric-weights"]}}
    results = spawn_ranks(cases, str(tmp), ports=3, world=4)
    return {"dpsp": dpsp, "tpsp": tpsp, "results": results}


def test_space_mesh_orders_on_four_ranks(sp4):
    """The ranks fill each mesh row-major, the last axis fastest; the
    gathered bands come in space order."""
    for r, res in enumerate(sp4["results"]):
        got = [m["index"] for m in res["sp_meshes"]["meshes"]]
        hi, lo = divmod(r, 2)
        assert got == [(hi, 0, lo), (lo, 0, hi), (0, hi, lo), (0, hi, lo), (0, lo, hi)], r
        for m in res["sp_meshes"]["meshes"]:
            assert torch.equal(m["gathered"].flatten(), torch.tensor([0.0, 0.0, 1.0, 1.0]))


@pytest.mark.parametrize("which", ["dpsp", "tpsp"])
def test_space_with_data_or_model_on_four_ranks(sp4, which):
    """`dp=2,sp=2` on a ragged batch of 3 (padded to 4) and `tp=2,sp=2` at
    B=1: every rank of a data index equal, within 2e-4 of one process's
    video of the padded batch."""
    s = sp4[which]
    b = s["case"]["ref"].shape[0]
    one = one_process(s, rows=4 if which == "dpsp" else 1)
    outs = [res[which]["out"] for res in sp4["results"]]
    for key in KEYS:
        assert all(torch.equal(o[key], outs[0][key]) for o in outs), key
        assert outs[0][key].shape[0] == b
        np.testing.assert_allclose(outs[0][key].numpy(), one[key][:b].numpy(), atol=2e-4, rtol=0, err_msg=key)


def test_test_dm_on_a_dp2_sp2_mesh(sp4):
    """`test_dm --mesh dp=2,sp=2` on a synthetic corpus: the ranks of data
    index 0 run the monitoring forwards with the band-mode generator
    together; the metrics on rank 0, finite, and `{}` on the others."""
    got = [res["tp_cli"]["test_dm"] for res in sp4["results"]]
    assert got[0]["videos"] == 3 and got[1:] == [{}, {}, {}]
    for k in ("rec_loss", "warp_loss", "psnr", "ssim", "lpips", "fvd"):
        assert np.isfinite(got[0][k]), k

