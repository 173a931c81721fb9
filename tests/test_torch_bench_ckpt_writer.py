"""The port's bench-checkpoint writer against the JAX package's.

* `utils/msgpack.py::msgpack_serialize` against
  `flax.serialization.msgpack_serialize`: equal bytes on trees of float16,
  float32, int32 and bool arrays, numpy and Python scalars, strings and
  nested dicts; the port's reader reads them back; other types raise.
* The committed `assets/bench_ckpt/{generator,unet}.msgpack` (15.7 MB and
  85 MB, read only): the port's reader's output written again is the file
  byte for byte, and so is the same tree carried through the port's state
  dict (`from_jax_params`, then `to_jax_params`).
* `to_jax_params` inverts `from_jax_params` on the tree a JAX `init` gives
  (UNet and LFAE of a small config): the same keys, shapes and values.
* `save_bench_ckpt` of the port (state dicts) and of the JAX package (the
  port's `to_jax_params` trees, so that both hold one tree) write the same
  bytes in every file; the JAX `load_bench_ckpt` and the port's
  `apply_bench_ckpt` read the port's directory back equal to the weights
  rounded to float16.
* A second writer holding the directory's lock raises.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.serialization import msgpack_serialize as flax_serialize

from cvpr23_lfdm_torch.utils import bench_ckpt as tck
from cvpr23_lfdm_torch.utils.msgpack import msgpack_restore, msgpack_serialize
from cvpr23_lfdm_tpu import config as jconfig
from cvpr23_lfdm_tpu.diffusion.flow_diffusion import FlowDiffusion as JFlowDiffusion
from cvpr23_lfdm_tpu.models.flow_autoenc import FlowAE as JFlowAE
from cvpr23_lfdm_tpu.utils import bench_ckpt as jck
from test_torch_slice import _port_cfg, _random_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(ROOT, "assets", "bench_ckpt")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trees():
    rng = np.random.default_rng(0)
    yield {"a": rng.random((3, 4)).astype(np.float16), "b": np.arange(7, dtype=np.int32)}
    yield {"params": {"z": {"kernel": rng.random((2, 3, 4, 5)).astype(np.float32),
                            "bias": rng.random(5).astype(np.float32)},
                      "a": {"scale": np.ones(300, np.float16)}},
           "batch_stats": {"m": {"mean": np.zeros(0, np.float32), "mask": np.array([True, False])}}}
    yield {"ints": {"small": 3, "neg": -5, "byte": 200, "short": -300, "word": 70000, "long": 2 ** 40,
                    "very_neg": -2 ** 40},
           "f": 0.1, "flag": True, "off": False, "name": "x" * 40, "long_name": "é" * 200,
           "np": {"f32": np.float32(1.5), "f64": np.float64(-2.25), "i32": np.int32(7), "b": np.bool_(True)},
           "scalar_array": np.array(3.0, np.float32),
           "wide": {f"k{i:02d}": np.full((i % 3,), i, np.float32) for i in range(20)}}


@pytest.mark.parametrize("case", range(3))
def test_msgpack_serialize_matches_flax(case):
    tree = list(_trees())[case]
    ours = msgpack_serialize(tree)
    assert ours == flax_serialize(tree)
    back = msgpack_restore(ours)
    flat = jax.tree_util.tree_leaves_with_path(tree)
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(np.asarray(node), np.asarray(leaf))
        assert np.asarray(node).dtype == np.asarray(leaf).dtype


@pytest.mark.parametrize("bad", [{"a": [1, 2]}, {"a": (1, 2)}, {"a": None}, {1: np.ones(2)},
                                 {"a": np.array(["s"], object)}, {"a": 1 + 2j}])
def test_msgpack_serialize_refuses_other_types(bad):
    with pytest.raises(TypeError):
        msgpack_serialize(bad)


@pytest.mark.parametrize("name", ["generator.msgpack", "unet.msgpack"])
def test_committed_checkpoint_is_written_back_byte_for_byte(name):
    with open(os.path.join(ASSET, name), "rb") as f:
        raw = f.read()
    tree = msgpack_restore(raw)
    assert msgpack_serialize(tree) == raw
    through_port = tck._fp16(tck.to_jax_params(tck.from_jax_params(tree)))
    assert msgpack_serialize(through_port) == raw


def _jax_small():
    """A small JAX config and its UNet and full LFAE variable trees (seeded
    values on `init`'s shapes)."""
    lfae = jconfig.LFAEConfig(
        frame_shape=32, num_regions=4,
        region_predictor=jconfig.RegionPredictorConfig(num_regions=4, num_blocks=2, block_expansion=8,
                                                       max_features=32),
        bg_predictor=jconfig.BGPredictorConfig(num_blocks=2, block_expansion=8, max_features=32),
        generator=jconfig.GeneratorConfig(num_bottleneck_blocks=1, block_expansion=8, max_features=32,
                                          pixelwise_flow=jconfig.PixelwiseFlowConfig(
                                              num_blocks=2, block_expansion=8, max_features=32)))
    diffusion = jconfig.DiffusionConfig(img_size=8, num_frames=4, timesteps=50, sampling_timesteps=3,
                                        dim=16, dim_mults=(1, 2), attn_heads=2, attn_dim_head=8,
                                        compute_dtype="float32", temporal_attn_impl="xla")
    cfg = jconfig.ExperimentConfig(dataset="mug", lfae=lfae, diffusion=diffusion)
    jm = JFlowDiffusion(cfg.lfae, cfg.diffusion)
    rng = np.random.default_rng(5)
    key = jax.random.PRNGKey(0)
    s, f, g = diffusion.img_size, diffusion.num_frames, lfae.generator
    fea = min(g.max_features, g.block_expansion * 2 ** g.num_down_blocks)  # compute_fea's channels
    unet = _random_variables(jax.eval_shape(
        jm.unet.init, key, jnp.zeros((1, f, s, s, 3)), jnp.zeros((1,)), jnp.zeros((1, 768)),
        fea=jnp.zeros((1, 1, s, s, fea))), rng)
    img = jnp.zeros((1, 32, 32, 3))
    lfae_vars = _random_variables(jax.eval_shape(
        lambda r: JFlowAE(cfg.lfae).init(r, img, img, train=False), key), rng)
    return cfg, unet, lfae_vars


def _assert_trees_equal(a: dict, b: dict, cast=None):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k], cast)
        else:
            want = np.asarray(b[k]) if cast is None else np.asarray(b[k]).astype(cast).astype(np.float32)
            assert np.shape(a[k]) == want.shape, k
            np.testing.assert_array_equal(np.asarray(a[k], np.float32), want, err_msg=k)


def test_to_jax_params_inverts_from_jax_params_on_jax_init_trees():
    _, unet, lfae_vars = _jax_small()
    for tree in (unet, lfae_vars):
        _assert_trees_equal(tck.to_jax_params(tck.from_jax_params(tree)), tree)


def test_save_bench_ckpt_writes_the_jax_packages_bytes(tmp_path):
    cfg, unet, lfae_vars = _jax_small()
    unet_sd, lfae_sd = tck.from_jax_params(unet), tck.from_jax_params(lfae_vars)
    rng = np.random.default_rng(6)
    cond = rng.standard_normal(768).astype(np.float32)
    ref = rng.random((32, 32, 3)).astype(np.float32)
    meta = {"objective": "x0"}
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    tck.save_bench_ckpt(ours, unet_sd, lfae_sd, torch.from_numpy(cond), ref=ref, meta=meta)
    jck.save_bench_ckpt(theirs, tck.to_jax_params(unet_sd), tck.to_jax_params(lfae_sd), cond, ref=ref, meta=meta)
    names = ("unet.msgpack", "generator.msgpack", "cond.npy", "ref.npy", "meta.json")
    for name in names:
        with open(os.path.join(ours, name), "rb") as a, open(os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read(), name
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs)) == sorted(names + (".lock",))

    # the JAX package reads the port's directory
    loaded = jck.load_bench_ckpt(ours, unet, lfae_vars)
    _assert_trees_equal(jax.device_get(loaded.unet_vars), unet, cast=np.float16)
    gen = {c: lfae_vars[c]["generator"] for c in lfae_vars}
    got = {c: jax.device_get(loaded.lfae_vars)[c]["generator"] for c in lfae_vars}
    for c in got:
        got[c].pop("pixelwise_flow_predictor")  # not stored: the template's values come back
        gen = {**gen, c: {k: v for k, v in gen[c].items() if k != "pixelwise_flow_predictor"}}
        _assert_trees_equal(got[c], gen[c], cast=np.float16)
    np.testing.assert_array_equal(loaded.cond, cond)
    np.testing.assert_array_equal(loaded.ref, ref)
    assert loaded.meta == meta

    # and so does the port's
    _, model, tcond, tref, tmeta = tck.apply_bench_ckpt(ours, _port_cfg(cfg), device="cpu")
    f16 = lambda t: t.to(torch.float16).to(torch.float32)  # noqa: E731
    for k, v in model.unet.state_dict().items():
        assert torch.equal(v, f16(unet_sd[k])), k
    for k, v in model.generator.state_dict().items():
        assert torch.equal(v, f16(lfae_sd["generator." + k])), k
    assert torch.equal(tcond[0], torch.from_numpy(cond)) and torch.equal(tref[0], torch.from_numpy(ref))
    assert tmeta["objective"] == "x0"


def test_a_second_writer_raises(tmp_path):
    d = str(tmp_path / "ck")
    unet = {"final_conv.weight": torch.ones(2, 3)}
    lfae = {"generator.norm.weight": torch.ones(2), "generator.norm.running_var": torch.ones(2)}
    with tck._writer_lock(d):
        with pytest.raises(RuntimeError, match="lock held"):
            tck.save_bench_ckpt(d, unet, lfae, np.zeros(4))
    assert not os.path.exists(os.path.join(d, "cond.npy"))
    tck.save_bench_ckpt(d, unet, lfae, np.zeros(4))  # the lock is released
    assert os.path.exists(os.path.join(d, "cond.npy"))
