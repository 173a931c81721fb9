"""Text conditioning: BERT class-text embeddings (counterpart of
`cvpr23_lfdm_tpu/models/text.py`).

Reference: DM/modules/text.py — a frozen `bert-base-cased` whose masked
token mean (excluding [CLS]) is a 768-d embedding; the reference only
feeds it the fixed class names of each dataset. Serving and training look
the class embeddings up in a precomputed table `[num_classes, 768]`
(:class:`TextEmbedder`), cached as `assets/bert_{dataset}.npz` in the JAX
package's format. Building the table runs the port's own BERT
(`models/bert.py`) and :class:`WordPieceTokenizer` on a local checkpoint
directory (`config.json`, `vocab.txt`, and `pytorch_model.bin` or
`model.safetensors`), with no `transformers` and no hub.
:class:`TorchBertTextEncoder` embeds free text on the card.
"""

from __future__ import annotations

import json
import os
import unicodedata

import numpy as np

BERT_MODEL_DIM = 768
NULL_TEXT = "None"  # forced-null conditioning token

MUG_CLASSES = (
    "anger", "disgust", "fear", "happiness", "neutral", "sadness", "surprise",
)

MHAD_CLASSES = (
    "right arm swipe to the left",
    "right arm swipe to the right",
    "right hand wave",
    "two hand front clap",
    "right arm throw",
    "cross arms in the chest",
    "basketball shooting",
    "draw x",
    "draw circle clockwise",
    "draw circle counter clockwise",
    "draw triangle",
    "right hand bowling",
    "front boxing",
    "baseball swing from right",
    "tennis forehand swing",
    "two arms curl",
    "tennis serve",
    "two hand push",
    "knock on door",
    "hand catch",
    "pick up and throw",
    "jogging",
    "walking",
    "sit to stand",
    "stand to sit",
    "forward lunge (left foot forward)",
    "squat",
)

NATOPS_CLASSES = (
    "I Have Command",
    "All Clear",
    "Not Clear",
    "Spread Wings",
    "Fold Wings",
    "Lock Wings",
    "Up Hook",
    "Down Hook",
    "Remove Tiedowns",
    "Remove Chocks",
    "Insert Chocks",
    "Move Ahead",
    "Turn Left",
    "Turn Right",
    "Next Marshaller",
    "Slow Down",
    "Stop",
    "Nosegear Steering",
    "Hot Brakes",
    "Brakes On",
    "Brakes Off",
    "Install Tiedowns",
    "Fire",
    "Cut Engine",
)

DATASET_CLASSES = {"mug": MUG_CLASSES, "mhad": MHAD_CLASSES, "natops": NATOPS_CLASSES}


_CACHE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "assets")


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


class WordPieceTokenizer:
    """BERT tokenizer (basic + WordPiece) over a `vocab.txt`: the
    `bert-base-cased` pipeline the reference reaches through torch.hub
    (DM/modules/text.py:17-50: special tokens and batch padding), with the
    transformers `BasicTokenizer` rules: clean, NFD accent strip only when
    lower-casing, punctuation and CJK split, greedy longest-match WordPiece.
    """

    def __init__(self, vocab_file: str, do_lower_case: bool = False):
        with open(vocab_file, encoding="utf-8") as f:
            tokens = [line.rstrip("\n") for line in f]
        self.vocab = {t: i for i, t in enumerate(tokens)}
        self.do_lower_case = do_lower_case
        self.pad_id = self.vocab["[PAD]"]
        self.cls_id = self.vocab["[CLS]"]
        self.sep_id = self.vocab["[SEP]"]
        self.unk = "[UNK]"

    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD:
                continue
            cat = unicodedata.category(ch)
            if cat in ("Cc", "Cf") and ch not in "\t\n\r":
                continue
            if ch in "\t\n\r" or cat == "Zs":
                out.append(" ")
            elif _is_cjk(cp):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    def _split_punct(self, word: str) -> list[str]:
        pieces, cur = [], []
        for ch in word:
            if _is_punct(ch):
                if cur:
                    pieces.append("".join(cur))
                    cur = []
                pieces.append(ch)
            else:
                cur.append(ch)
        if cur:
            pieces.append("".join(cur))
        return pieces

    def _wordpiece(self, word: str) -> list[str]:
        if len(word) > 100:
            return [self.unk]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> list[str]:
        if self.do_lower_case:
            text = unicodedata.normalize("NFD", text.lower())
            text = "".join(c for c in text if unicodedata.category(c) != "Mn")
        words = []
        for w in self._clean(text).split():
            words.extend(self._split_punct(w))
        out = []
        for w in words:
            out.extend(self._wordpiece(w))
        return out

    def encode_batch(self, texts: list[str]) -> np.ndarray:
        """`[CLS] tokens [SEP]`, 0-padded to the longest: the reference
        tokenize() output (text.py:36-50), int32 `[B, N]`."""
        unk = self.vocab[self.unk]
        ids = [[self.cls_id] + [self.vocab.get(t, unk) for t in self.tokenize(x)] + [self.sep_id]
               for x in texts]
        n = max(len(r) for r in ids)
        out = np.full((len(ids), n), self.pad_id, np.int32)
        for i, r in enumerate(ids):
            out[i, : len(r)] = r
        return out


def load_bert_checkpoint(path: str, device=None):
    """`(BertEncoder in eval mode on device, WordPieceTokenizer)` of a local
    HF checkpoint directory: `config.json`, `vocab.txt` (and
    `tokenizer_config.json`'s `do_lower_case`, default False as for
    `bert-base-cased`), and `model.safetensors` or `pytorch_model.bin`
    (read with `weights_only=True`). Nothing is fetched: a name that is not
    a directory raises `FileNotFoundError`."""
    import torch

    from cvpr23_lfdm_torch.models.bert import BertEncoder, BertSpec, convert_hf_bert
    from cvpr23_lfdm_torch.utils.device import resolve_device
    from cvpr23_lfdm_torch.utils.safetensors import load_file

    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"BERT checkpoint {path!r}: not a local directory (config.json, vocab.txt and "
            f"model.safetensors or pytorch_model.bin); the port fetches nothing")
    with open(os.path.join(path, "config.json")) as f:
        spec = BertSpec.from_hf_config(json.load(f))
    lower = False
    tok_cfg = os.path.join(path, "tokenizer_config.json")
    if os.path.isfile(tok_cfg):
        with open(tok_cfg) as f:
            lower = bool(json.load(f).get("do_lower_case", False))
    tokenizer = WordPieceTokenizer(os.path.join(path, "vocab.txt"), do_lower_case=lower)
    st, pt = os.path.join(path, "model.safetensors"), os.path.join(path, "pytorch_model.bin")
    if os.path.isfile(st):
        sd = load_file(st)
    elif os.path.isfile(pt):
        sd = torch.load(pt, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(f"BERT checkpoint {path!r}: no model.safetensors or pytorch_model.bin")
    encoder = BertEncoder(spec)
    encoder.load_state_dict(convert_hf_bert(sd, spec))
    return encoder.eval().requires_grad_(False).to(resolve_device(device)), tokenizer


def bert_masked_mean_embed(texts: list[str], model_name_or_path: str = "bert-base-cased",
                           device=None) -> np.ndarray:
    """Reference `bert_embed(tokenize(texts))` semantics
    (DM/modules/text.py:56-89): final hidden states, masked mean over the
    tokens excluding [CLS], eps 1e-8, as float32 `[B, 768]`. The port's BERT
    on `device` (the CUDA card unless it says otherwise) over the local
    checkpoint directory `model_name_or_path` (:func:`load_bert_checkpoint`).
    """
    from cvpr23_lfdm_torch.models.bert import bert_embed

    encoder, tokenizer = load_bert_checkpoint(model_name_or_path, device)
    ids = tokenizer.encode_batch(list(texts))[:, : encoder.spec.max_position_embeddings]
    return bert_embed(encoder, ids).cpu().numpy().astype(np.float32)


class TextEmbedder:
    """Embedding table over a fixed vocabulary + NULL text.

    `__call__(texts)` -> (`[B, 768]` embeddings, `[B]` bool none-mask).
    """

    def __init__(self, classes: tuple[str, ...], table: np.ndarray):
        self.classes = tuple(classes)
        self.table = table
        self.index = {c: i for i, c in enumerate(self.classes)}

    @staticmethod
    def cache_path(dataset: str) -> str:
        return os.path.abspath(os.path.join(_CACHE_DIR, f"bert_{dataset}.npz"))

    @classmethod
    def build(cls, dataset: str, recompute: bool = False,
              model_name_or_path: str = "bert-base-cased", device=None) -> "TextEmbedder":
        """Load the cached table of a dataset (the JAX package's `.npz`:
        `classes`, `table`), or compute it with :func:`bert_masked_mean_embed`
        when it is missing, was built for other classes, or `recompute`, and
        write the cache."""
        classes = DATASET_CLASSES[dataset]
        path = cls.cache_path(dataset)
        if os.path.exists(path) and not recompute:
            data = np.load(path, allow_pickle=True)
            if tuple(data["classes"].tolist()) == tuple(classes):
                return cls(classes, data["table"].astype(np.float32))
        table = bert_masked_mean_embed(list(classes), model_name_or_path, device)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.savez(path, classes=np.array(classes, dtype=object), table=table)
        return cls(classes, table)

    @classmethod
    def random_for_testing(cls, classes: tuple[str, ...], seed: int = 0) -> "TextEmbedder":
        rng = np.random.RandomState(seed)
        return cls(classes, rng.randn(len(classes), BERT_MODEL_DIM).astype(np.float32))

    def __call__(self, texts: list[str]) -> tuple[np.ndarray, np.ndarray]:
        none_mask = np.array([t == NULL_TEXT for t in texts], dtype=bool)
        idx = np.array([0 if m else self.index[t] for t, m in zip(texts, none_mask)])
        emb = self.table[idx]
        emb[none_mask] = 0.0  # value irrelevant; forced to the null embedding downstream
        return emb.astype(np.float32), none_mask

    def ids(self, texts: list[str]) -> np.ndarray:
        return np.array([self.index[t] for t in texts], dtype=np.int32)


class TorchBertTextEncoder:
    """Free-text conditioning on the card (counterpart of
    `JaxBertTextEncoder`): the host tokenizer and the port's BERT over a
    local checkpoint directory, on `device` (the CUDA card unless it says
    otherwise). `__call__(texts)` -> (`[B, 768]` float32, `[B]` none-mask).
    """

    def __init__(self, model_name_or_path: str = "bert-base-cased", device=None):
        self.encoder, self.tokenizer = load_bert_checkpoint(model_name_or_path, device)

    def __call__(self, texts: list[str]) -> tuple[np.ndarray, np.ndarray]:
        from cvpr23_lfdm_torch.models.bert import bert_embed

        none_mask = np.array([t == NULL_TEXT for t in texts], dtype=bool)
        ids = self.tokenizer.encode_batch(list(texts))[:, : self.encoder.spec.max_position_embeddings]
        emb = bert_embed(self.encoder, ids).cpu().numpy().astype(np.float32)
        emb[none_mask] = 0.0
        return emb, none_mask
