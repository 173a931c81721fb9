"""The port's text path and `interpolate` against the JAX package, on the CPU.

* BERT (`cvpr23_lfdm_torch/models/bert.py`) vs `cvpr23_lfdm_tpu/models/bert.py`
  at a tiny spec (vocab 120, hidden 64, 3 layers, 4 heads, as
  `tests/test_bert.py`), seeded HF-named weights: hidden states with padded
  rows and `bert_embed` within 1e-5; `convert_hf_bert` against the JAX
  converter carried through `from_jax_params`, tensor for tensor.
* `WordPieceTokenizer` vs the JAX one on a vocab file the test writes: every
  class text of MUG, MHAD and NATOPS, punctuation, accents, CJK and unknown
  words, cased and lower-cased; the ids are equal.
* `TextEmbedder.build` from a seeded local checkpoint directory
  (`config.json`, `vocab.txt`, and `pytorch_model.bin` or
  `model.safetensors`) against the JAX `bert_embed` of the JAX tokenizer's
  ids within 1e-5, with both packages' `_CACHE_DIR` in `tmp_path`; the
  cache file read back by the JAX `TextEmbedder.build`.
* The random table and the NULL text.
* `GaussianDiffusion.interpolate` vs the JAX `interpolate` with the UNet of
  the slice test's small config (`pallas3`: the JAX fused layers in
  interpret mode), injected noise, with and without guidance, within the
  sampler parity tests' 1e-4.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr23_lfdm_tpu.models import bert as jbert
from cvpr23_lfdm_tpu.models import text as jtext
from cvpr23_lfdm_torch.models import bert as tbert
from cvpr23_lfdm_torch.models import text as ttext
from cvpr23_lfdm_torch.utils.bench_ckpt import from_jax_params

SPEC = dict(vocab_size=120, hidden_size=64, num_layers=3, num_heads=4, intermediate_size=128,
            max_position_embeddings=48, type_vocab_size=2)
TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: as fast at these sizes, and the test processes
    that share the CPU do not oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hf_state_dict(spec: dict, seed: int = 0) -> dict:
    """Seeded numpy weights under the HF `BertModel` names."""
    rng = np.random.RandomState(seed)
    h, i = spec["hidden_size"], spec["intermediate_size"]
    f = lambda *s: (rng.standard_normal(s) / np.sqrt(s[-1])).astype(np.float32)  # noqa: E731
    ln = lambda p: {p + ".weight": (1 + 0.1 * rng.standard_normal(h)).astype(np.float32),  # noqa: E731
                    p + ".bias": (0.1 * rng.standard_normal(h)).astype(np.float32)}
    sd = {"embeddings.word_embeddings.weight": f(spec["vocab_size"], h),
          "embeddings.position_embeddings.weight": f(spec["max_position_embeddings"], h),
          "embeddings.token_type_embeddings.weight": f(spec["type_vocab_size"], h),
          **ln("embeddings.LayerNorm")}
    for n in range(spec["num_layers"]):
        p = f"encoder.layer.{n}."
        for name, (o, k) in {"attention.self.query": (h, h), "attention.self.key": (h, h),
                             "attention.self.value": (h, h), "attention.output.dense": (h, h),
                             "intermediate.dense": (i, h), "output.dense": (h, i)}.items():
            sd[p + name + ".weight"] = f(o, k)
            sd[p + name + ".bias"] = (0.1 * rng.standard_normal(o)).astype(np.float32)
        sd.update(ln(p + "attention.output.LayerNorm"))
        sd.update(ln(p + "output.LayerNorm"))
    sd["pooler.dense.weight"] = f(h, h)  # unused by both
    return sd


def port_encoder(spec: dict, sd: dict) -> tbert.BertEncoder:
    enc = tbert.BertEncoder(tbert.BertSpec(**spec))
    enc.load_state_dict(tbert.convert_hf_bert(sd, enc.spec))
    return enc.eval()


def test_bert_matches_jax():
    sd = hf_state_dict(SPEC)
    jspec = jbert.BertSpec(**SPEC)
    params = jbert.convert_hf_bert(sd, jspec)
    enc = port_encoder(SPEC, sd)
    rng = np.random.RandomState(0)
    ids = rng.randint(1, SPEC["vocab_size"], (3, 11)).astype(np.int32)
    ids[0, 6:] = 0  # padded rows
    ids[2, 3:] = 0
    want = np.asarray(jbert.BertEncoder(jspec).apply({"params": params}, jnp.asarray(ids)))
    with torch.no_grad():
        got = enc(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)
    want = np.asarray(jbert.bert_embed(params, ids, jspec))
    got = tbert.bert_embed(enc, ids).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


def test_convert_hf_bert_matches_the_jax_converter():
    """The port's converter equals the JAX converter carried across by
    `from_jax_params`, also for a `bert.`-prefixed state dict with the
    older `gamma`/`beta` LayerNorm names."""
    sd = hf_state_dict(SPEC, seed=1)
    spec = tbert.BertSpec(**SPEC)
    bridged = from_jax_params({"params": jbert.convert_hf_bert(sd, jbert.BertSpec(**SPEC))})
    old = {"bert." + k.replace("LayerNorm.weight", "LayerNorm.gamma").replace("LayerNorm.bias", "LayerNorm.beta"): v
           for k, v in sd.items()}
    for source in (sd, old):
        ours = tbert.convert_hf_bert(source, spec)
        assert set(ours) == set(bridged) == set(tbert.BertEncoder(spec).state_dict())
        for k in ours:
            assert torch.equal(ours[k], bridged[k]), k


VOCAB_EXTRA = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "!", ",", ".", "?", "(", ")", "-",
               "'", "cafe", "café", "naïve", "##s", "##ing", "##gear", "Nose", "jog", "##ging",
               "s", "##quat", "你", "好", "Zürich", "zurich", "##ed", "un", "##known"]


def write_vocab(path) -> list[str]:
    """A vocab with the special tokens, every word of the three datasets'
    class texts and a few pieces, accents and CJK characters."""
    words = []
    for classes in ttext.DATASET_CLASSES.values():
        for text in classes:
            for w in text.replace("(", " ").replace(")", " ").split():
                words += [w, w.lower()]
    vocab = list(dict.fromkeys(VOCAB_EXTRA + words))
    path.write_text("\n".join(vocab) + "\n", encoding="utf-8")
    return vocab


TEXTS = [t for c in ttext.DATASET_CLASSES.values() for t in c] + [
    "Hello, world!", "  tabs\tand\nnewlines  ", "café naïve Zürich", "你好", "unknownword",
    "jogging walked?", "Nosegear-Steering", "None", "", "x" * 120]


@pytest.mark.parametrize("lower", [False, True])
def test_wordpiece_tokenizer_matches_jax(tmp_path, lower):
    write_vocab(tmp_path / "vocab.txt")
    ours = ttext.WordPieceTokenizer(str(tmp_path / "vocab.txt"), do_lower_case=lower)
    theirs = jtext.WordPieceTokenizer(str(tmp_path / "vocab.txt"), do_lower_case=lower)
    for t in TEXTS:
        assert ours.tokenize(t) == theirs.tokenize(t), t
    np.testing.assert_array_equal(ours.encode_batch(TEXTS), theirs.encode_batch(TEXTS))


def write_checkpoint(path, weights: str, seed: int = 0) -> tuple[dict, dict]:
    """An HF checkpoint directory of seeded weights; returns (spec, state dict)."""
    os.makedirs(path, exist_ok=True)
    vocab = write_vocab(path / "vocab.txt")
    spec = {**SPEC, "vocab_size": len(vocab)}
    sd = hf_state_dict(spec, seed)
    cfg = {"vocab_size": spec["vocab_size"], "hidden_size": spec["hidden_size"],
           "num_hidden_layers": spec["num_layers"], "num_attention_heads": spec["num_heads"],
           "intermediate_size": spec["intermediate_size"],
           "max_position_embeddings": spec["max_position_embeddings"],
           "type_vocab_size": spec["type_vocab_size"], "layer_norm_eps": 1e-12}
    (path / "config.json").write_text(json.dumps(cfg))
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    if weights == "bin":
        torch.save(tensors, path / "pytorch_model.bin")
    else:  # the reference writer where it is installed, else the port's
        try:
            from safetensors.torch import save_file
        except ImportError:
            from cvpr23_lfdm_torch.utils.safetensors import save_file
        save_file(tensors, str(path / "model.safetensors"))
    return spec, sd


@pytest.mark.parametrize("weights", ["bin", "safetensors"])
def test_text_embedder_build_matches_jax(tmp_path, monkeypatch, weights):
    ckpt = tmp_path / "bert"
    spec, sd = write_checkpoint(ckpt, weights)
    cache = tmp_path / "cache"
    monkeypatch.setattr(ttext, "_CACHE_DIR", str(cache))
    monkeypatch.setattr(jtext, "_CACHE_DIR", str(cache))
    params = jbert.convert_hf_bert(sd, jbert.BertSpec(**spec))
    tok = jtext.WordPieceTokenizer(str(ckpt / "vocab.txt"))
    for dataset, classes in ttext.DATASET_CLASSES.items():
        emb = ttext.TextEmbedder.build(dataset, model_name_or_path=str(ckpt), device="cpu")
        want = np.asarray(jbert.bert_embed(params, tok.encode_batch(list(classes)), jbert.BertSpec(**spec)))
        assert emb.classes == classes and emb.table.shape == (len(classes), spec["hidden_size"])
        np.testing.assert_allclose(emb.table, want, atol=TOL)
        assert os.path.exists(cache / f"bert_{dataset}.npz")
        # the cache, in the JAX package's format, serves both packages
        again = jtext.TextEmbedder.build(dataset, model_name_or_path="/nonexistent")
        np.testing.assert_array_equal(again.table, emb.table)
        cached = ttext.TextEmbedder.build(dataset, model_name_or_path="/nonexistent", device="cpu")
        np.testing.assert_array_equal(cached.table, emb.table)
    with pytest.raises(FileNotFoundError, match="not a local directory"):
        ttext.TextEmbedder.build("mug", recompute=True, model_name_or_path="bert-base-cased", device="cpu")


def test_safetensors_roundtrip_with_the_reference_package(tmp_path):
    from cvpr23_lfdm_torch.utils import safetensors as ours

    st = pytest.importorskip("safetensors.torch")
    g = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn(3, 5, generator=g), "b": torch.randn(7, generator=g).bfloat16(),
               "c": torch.arange(6, dtype=torch.int64).reshape(2, 3), "d": torch.tensor([True, False]),
               "e": torch.randn(2, 2, generator=g).half()}
    ours.save_file(tensors, str(tmp_path / "x.safetensors"))
    back = st.load_file(str(tmp_path / "x.safetensors"))
    st.save_file(tensors, str(tmp_path / "y.safetensors"))
    mine = ours.load_file(str(tmp_path / "y.safetensors"))
    for k, v in tensors.items():
        assert torch.equal(back[k], v) and torch.equal(mine[k], v), k


def test_torch_bert_text_encoder_matches_jax(tmp_path):
    ckpt = tmp_path / "bert"
    spec, sd = write_checkpoint(ckpt, "bin", seed=3)
    enc = ttext.TorchBertTextEncoder(str(ckpt), device="cpu")
    texts = ["a person smiles, then frowns", "None", "Turn Left", "你好 café"]
    emb, none = enc(texts)
    params = jbert.convert_hf_bert(sd, jbert.BertSpec(**spec))
    ids = jtext.WordPieceTokenizer(str(ckpt / "vocab.txt")).encode_batch(texts)
    want = np.array(jbert.bert_embed(params, ids, jbert.BertSpec(**spec)))
    want[1] = 0.0
    np.testing.assert_array_equal(none, [False, True, False, False])
    np.testing.assert_allclose(emb, want, atol=TOL)


def test_random_table_and_null_text():
    ours = ttext.TextEmbedder.random_for_testing(ttext.MUG_CLASSES, seed=5)
    theirs = jtext.TextEmbedder.random_for_testing(jtext.MUG_CLASSES, seed=5)
    np.testing.assert_array_equal(ours.table, theirs.table)
    texts = ["fear", ttext.NULL_TEXT, "anger"]
    (e1, m1), (e2, m2) = ours(texts), theirs(texts)
    np.testing.assert_array_equal(e1, e2)
    np.testing.assert_array_equal(m1, [False, True, False])
    np.testing.assert_array_equal(m1, m2)
    assert not e1[1].any() and e1[0].any()
    np.testing.assert_array_equal(ours.ids(["fear", "anger"]), theirs.ids(["fear", "anger"]))
    assert ttext.TextEmbedder.cache_path("mug").endswith(os.path.join("assets", "bert_mug.npz"))


@pytest.mark.parametrize("cond_scale", [1.0, 2.0])
def test_interpolate_matches_jax(cond_scale):
    """Both volumes noised to t = 3 of 50 with injected noise, lerped at 0.3,
    three ancestral steps through the small config's UNet."""
    from cvpr23_lfdm_tpu.diffusion.flow_diffusion import FlowDiffusion as JFlowDiffusion
    from cvpr23_lfdm_tpu.diffusion.gaussian_diffusion import GaussianDiffusion as JGD
    from cvpr23_lfdm_torch.diffusion.flow_diffusion import build_unet
    from cvpr23_lfdm_torch.diffusion.gaussian_diffusion import GaussianDiffusion as TGD
    from test_torch_slice import _port_cfg, _random_variables, _small_cfg

    cfg = _small_cfg("eps")
    jm = JFlowDiffusion(cfg.lfae, cfg.diffusion)
    rng = np.random.RandomState(11)
    b, f, s, t = 1, cfg.diffusion.num_frames, cfg.diffusion.img_size, 3
    shape = (b, f, s, s, 3)
    x1, x2, n1, n2 = (rng.uniform(-1, 1, shape).astype(np.float32) for _ in range(4))
    noise = rng.standard_normal((t,) + shape).astype(np.float32)
    fea = rng.standard_normal((b, s, s, 256)).astype(np.float32)
    cond = rng.standard_normal((b, 768)).astype(np.float32)
    unet_vars = _random_variables(jax.eval_shape(
        jm.unet.init, jax.random.PRNGKey(0), jnp.asarray(x1), jnp.zeros((b,)), jnp.asarray(cond),
        fea=jnp.zeros((b, 1, s, s, 256))), rng)
    want = JGD.create(cfg.diffusion).interpolate(
        jm.denoise_fn(unet_vars), jax.random.PRNGKey(0), jnp.asarray(x1), jnp.asarray(x2),
        jnp.asarray(fea), jnp.asarray(cond), cond_scale, t=t, lam=0.3,
        noise1=jnp.asarray(n1), noise2=jnp.asarray(n2), noise_seq=jnp.asarray(noise))

    tcfg = _port_cfg(cfg)
    unet = build_unet(tcfg.lfae, tcfg.diffusion, training=False).eval()
    unet.load_state_dict(from_jax_params(unet_vars))
    T = torch.from_numpy
    with torch.no_grad():
        got = TGD.create(tcfg.diffusion).interpolate(
            lambda x, tt, c, m, fe: unet(x, tt, c, m, fea=fe), T(x1), T(x2), T(fea), T(cond),
            cond_scale, t=t, lam=0.3, noise1=T(n1), noise2=T(n2), noise_seq=T(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_interpolate_draws_from_the_generator():
    """Without injected noise the draws come from the generator, in order:
    noise1, noise2, then one per step."""
    from cvpr23_lfdm_torch.config import DiffusionConfig
    from cvpr23_lfdm_torch.diffusion.gaussian_diffusion import GaussianDiffusion as TGD

    gd = TGD.create(DiffusionConfig(timesteps=20, sampling_timesteps=20))
    shape = (2, 3, 4, 4, 3)
    x1, x2 = torch.rand(shape), torch.rand(shape)
    fea = torch.zeros(2, 4, 4, 5)
    stub = lambda x, t, c, m, f: torch.tanh(x)  # noqa: E731
    a = gd.interpolate(stub, x1, x2, fea, t=5, generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(3)
    draws = [torch.randn(shape, generator=g) for _ in range(7)]
    b = gd.interpolate(stub, x1, x2, fea, t=5, noise1=draws[0], noise2=draws[1],
                       noise_seq=torch.stack(draws[2:]))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="differ"):
        gd.interpolate(stub, x1, x2[:1], fea, t=5)
