"""Background motion predictor: a global 3x3 transform from an image pair
(counterpart of `cvpr23_lfdm_tpu/models/bg_predictor.py`).

Encoder over concat(source, driving), fp32 global mean pool of the coarsest
scale, and an FC head initialised to the identity transform (zero kernel,
identity bias). Eval mode only.
"""

from __future__ import annotations

import torch
from torch import nn

from cvpr23_lfdm_torch.models.blocks import Dense, Encoder

_IDENTITY_BIAS = {
    "perspective": [1, 0, 0, 0, 1, 0, 0, 0],
    "affine": [1, 0, 0, 0, 1, 0],
    "shift": [0, 0],
}


class BGMotionPredictor(nn.Module):
    def __init__(self, num_channels: int = 3, block_expansion: int = 32,
                 max_features: int = 1024, num_blocks: int = 5, bg_type: str = "affine",
                 dtype=None):
        super().__init__()
        if bg_type not in ("zero", "shift", "affine", "perspective"):
            raise ValueError(f"bg_type {bg_type!r}")
        self.bg_type = bg_type
        if bg_type == "zero":
            return
        self.encoder = Encoder(block_expansion, 2 * num_channels, num_blocks, max_features, dtype)
        width = min(max_features, block_expansion * (2 ** num_blocks))
        self.fc = Dense(width, len(_IDENTITY_BIAS[bg_type]))
        nn.init.zeros_(self.fc.weight)
        with torch.no_grad():
            self.fc.bias.copy_(torch.tensor(_IDENTITY_BIAS[bg_type], dtype=torch.float32))

    def forward(self, source: torch.Tensor, driving: torch.Tensor) -> torch.Tensor:
        """`[B, H, W, 3]` x2 -> `[B, 3, 3]` transform (identity rows appended)."""
        b = source.shape[0]
        out = torch.eye(3, dtype=torch.float32, device=source.device).repeat(b, 1, 1)
        if self.bg_type == "zero":
            return out
        feats = self.encoder(torch.cat([source, driving], dim=-1))
        pred = self.fc(feats[-1].float().mean(dim=(1, 2)))
        if self.bg_type == "shift":
            out[:, :2, 2] = pred
        elif self.bg_type == "affine":
            out[:, :2, :] = pred.reshape(b, 2, 3)
        else:  # perspective
            out[:, :2, :] = pred[:, :6].reshape(b, 2, 3)
            out[:, 2, :2] = pred[:, 6:].reshape(b, 2)
        return out
