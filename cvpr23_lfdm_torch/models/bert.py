"""BERT encoder for free-text conditioning (counterpart of
`cvpr23_lfdm_tpu/models/bert.py`).

Reference: DM/modules/text.py — a frozen HF `bert-base-cased` whose masked
token mean (excluding [CLS]) is the 768-d conditioning vector. The HF
`BertModel` forward: learned positions, token type 0, post-LN encoder
layers with exact-erf GELU, and the attention mask as an additive
`(1 - mask) * -1e9` bias. The attention is the JAX formula in plain torch
(einsum, softmax); the JAX package computes it outside any kernel.

Parameters are named after the JAX tree (`word_embeddings.weight`,
`embeddings_ln.weight`, `layer_{i}.query.weight`, ...), so
`utils/bench_ckpt.py::from_jax_params` carries JAX BERT params across;
:func:`convert_hf_bert` maps an HF `BertModel` state dict.
"""

from __future__ import annotations

import dataclasses
import math
import re

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F


@dataclasses.dataclass(frozen=True)
class BertSpec:
    vocab_size: int = 28996  # bert-base-cased
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @classmethod
    def from_hf_config(cls, config: dict) -> "BertSpec":
        """The spec of an HF `config.json` (a dict)."""
        return cls(
            vocab_size=config["vocab_size"], hidden_size=config["hidden_size"],
            num_layers=config["num_hidden_layers"], num_heads=config["num_attention_heads"],
            intermediate_size=config["intermediate_size"],
            max_position_embeddings=config["max_position_embeddings"],
            type_vocab_size=config.get("type_vocab_size", 2),
            layer_norm_eps=config.get("layer_norm_eps", 1e-12),
        )


class BertLayer(nn.Module):
    def __init__(self, spec: BertSpec):
        super().__init__()
        self.spec = spec
        h, i = spec.hidden_size, spec.intermediate_size
        self.query, self.key, self.value = nn.Linear(h, h), nn.Linear(h, h), nn.Linear(h, h)
        self.attn_out = nn.Linear(h, h)
        self.attn_ln = nn.LayerNorm(h, eps=spec.layer_norm_eps)
        self.intermediate = nn.Linear(h, i)
        self.output = nn.Linear(i, h)
        self.out_ln = nn.LayerNorm(h, eps=spec.layer_norm_eps)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor) -> torch.Tensor:
        s = self.spec
        b, n, _ = x.shape
        d = s.hidden_size // s.num_heads

        def heads(t):
            return t.reshape(b, n, s.num_heads, d).permute(0, 2, 1, 3)

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        sim = torch.einsum("bhid,bhjd->bhij", q, k) / math.sqrt(d)
        attn = torch.softmax(sim + attn_bias, dim=-1)  # attn_bias [B, 1, 1, N]
        ctx = torch.einsum("bhij,bhjd->bhid", attn, v)
        ctx = ctx.permute(0, 2, 1, 3).reshape(b, n, s.hidden_size)
        x = self.attn_ln(x + self.attn_out(ctx))
        inter = F.gelu(self.intermediate(x), approximate="none")
        return self.out_ln(x + self.output(inter))


class BertEncoder(nn.Module):
    def __init__(self, spec: BertSpec = BertSpec()):
        super().__init__()
        self.spec = spec
        h = spec.hidden_size
        self.word_embeddings = nn.Embedding(spec.vocab_size, h)
        self.position_embeddings = nn.Embedding(spec.max_position_embeddings, h)
        self.token_type_embeddings = nn.Embedding(spec.type_vocab_size, h)
        self.embeddings_ln = nn.LayerNorm(h, eps=spec.layer_norm_eps)
        for i in range(spec.num_layers):
            self.add_module(f"layer_{i}", BertLayer(spec))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor | None = None
                ) -> torch.Tensor:
        """input_ids `[B, N]` integer -> final hidden states `[B, N, H]`."""
        n = input_ids.shape[1]
        if attention_mask is None:
            attention_mask = (input_ids != 0).float()
        pos = torch.arange(n, device=input_ids.device)[None]
        x = (self.word_embeddings(input_ids) + self.position_embeddings(pos)
             + self.token_type_embeddings(torch.zeros_like(input_ids)))
        x = self.embeddings_ln(x)
        attn_bias = (1.0 - attention_mask.float()[:, None, None, :]) * -1e9
        for i in range(self.spec.num_layers):
            x = getattr(self, f"layer_{i}")(x, attn_bias)
        return x


@torch.no_grad()
def bert_embed(encoder: BertEncoder, input_ids) -> torch.Tensor:
    """Reference `bert_embed` semantics (DM/modules/text.py:56-89): final
    hidden states, masked mean over the tokens EXCLUDING [CLS], eps 1e-8.
    `input_ids` `[B, N]` (numpy or tensor) -> `[B, H]` on the encoder's
    device."""
    device = next(encoder.parameters()).device
    ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long, device=device)
    if ids.shape[1] > encoder.spec.max_position_embeddings:
        raise ValueError("sequence longer than max_position_embeddings: tokenize with truncation")
    hidden = encoder(ids)
    mask = (ids != 0).to(hidden.dtype)[:, 1:, None]
    return (hidden[:, 1:] * mask).sum(dim=1) / (mask.sum(dim=1) + 1e-8)


_HF_LEAF = re.compile(r"\.(gamma|beta)$")  # the LayerNorm names of older HF checkpoints


def convert_hf_bert(sd: dict, spec: BertSpec = BertSpec()) -> dict[str, torch.Tensor]:
    """HF `BertModel.state_dict()` (tensors or numpy; an optional `bert.`
    prefix is dropped, LayerNorm `gamma`/`beta` are read as `weight`/`bias`)
    -> a :class:`BertEncoder` state dict. The pooler is unused (the
    reference takes hidden states)."""
    sd = {_HF_LEAF.sub(lambda m: {"gamma": ".weight", "beta": ".bias"}[m.group(1)],
                       k.removeprefix("bert.")): v for k, v in sd.items()}

    def w(key):
        t = sd[key]
        return torch.as_tensor(np.asarray(t) if not torch.is_tensor(t) else t).float().contiguous()

    out = {
        "word_embeddings.weight": w("embeddings.word_embeddings.weight"),
        "position_embeddings.weight": w("embeddings.position_embeddings.weight"),
        "token_type_embeddings.weight": w("embeddings.token_type_embeddings.weight"),
        "embeddings_ln.weight": w("embeddings.LayerNorm.weight"),
        "embeddings_ln.bias": w("embeddings.LayerNorm.bias"),
    }
    names = {"query": "attention.self.query", "key": "attention.self.key",
             "value": "attention.self.value", "attn_out": "attention.output.dense",
             "attn_ln": "attention.output.LayerNorm", "intermediate": "intermediate.dense",
             "output": "output.dense", "out_ln": "output.LayerNorm"}
    for i in range(spec.num_layers):
        for ours, theirs in names.items():
            for leaf in ("weight", "bias"):
                out[f"layer_{i}.{ours}.{leaf}"] = w(f"encoder.layer.{i}.{theirs}.{leaf}")
    return out
