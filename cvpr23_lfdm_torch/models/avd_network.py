"""AVD (animation via disentanglement) network (counterpart of
`cvpr23_lfdm_tpu/models/avd_network.py`).

Identity and pose MLP encoders over flattened region parameters (shift 2 +
affine 4 per region) and a decoder that reconstructs region parameters;
`revert_axis_swap` sign-corrects the identity affine against the pose
affine. The LFAE entry scripts build it, the training loss does not use
it. Parameters are named after the JAX variable paths (`pose_encoder.fc_0`,
`.bn_0`, ..., `.out`), so `from_jax_params` loads a JAX tree; the module's
`train`/`eval` mode is the JAX `train` argument (its BatchNorms over `[B,
F]`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cvpr23_lfdm_torch.models.blocks import BatchNorm, Dense
from cvpr23_lfdm_torch.ops.eig2x2 import inv_2x2


class _MLP(nn.Module):
    """Dense -> BatchNorm -> ReLU stack, then a Dense head."""

    def __init__(self, cin: int, features: tuple[int, ...], out_features: int):
        super().__init__()
        self.depth = len(features)
        for i, f in enumerate(features):
            setattr(self, f"fc_{i}", Dense(cin, f))
            setattr(self, f"bn_{i}", BatchNorm(f))
            cin = f
        self.out = Dense(cin, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = F.relu(getattr(self, f"bn_{i}")(getattr(self, f"fc_{i}")(x)))
        return self.out(x)


def region_params_to_emb(params: dict) -> torch.Tensor:
    """`{shift [B, K, 2], affine [B, K, 2, 2]}` -> `[B, 6K]`."""
    b, k = params["shift"].shape[:2]
    return torch.cat([params["shift"], params["affine"].reshape(b, k, 4)], dim=-1).reshape(b, -1)


def emb_to_region_params(emb: torch.Tensor, num_regions: int) -> dict:
    """`[B, 6K]` -> `{shift, affine}`."""
    b = emb.shape[0]
    emb = emb.reshape(b, num_regions, 6)
    return {"shift": emb[..., :2], "affine": emb[..., 2:].reshape(b, num_regions, 2, 2)}


class AVDNetwork(nn.Module):
    def __init__(self, num_regions: int = 10, id_bottle_size: int = 64,
                 pose_bottle_size: int = 64, revert_axis_swap: bool = True):
        super().__init__()
        self.num_regions = num_regions
        self.revert_axis_swap = revert_axis_swap
        emb = (2 + 4) * num_regions
        hidden = (256, 512, 1024)
        self.pose_encoder = _MLP(emb, hidden, pose_bottle_size)
        self.id_encoder = _MLP(emb, hidden, id_bottle_size)
        self.decoder = _MLP(pose_bottle_size + id_bottle_size, hidden[::-1], emb)
        self.eval()  # the JAX `train=False` default

    def forward(self, x_id: dict, x_pose: dict) -> dict:
        """Region parameters of the identity and the pose images -> the
        reconstructed `{shift, affine, covar}`."""
        if self.revert_axis_swap:
            affine = x_id["affine"] @ inv_2x2(x_pose["affine"])
            sign = torch.sign(affine[:, :, 0:1, 0:1])
            x_id = {"affine": x_id["affine"] * sign, "shift": x_id["shift"]}
        pose_emb = self.pose_encoder(region_params_to_emb(x_pose))
        id_emb = self.id_encoder(region_params_to_emb(x_id))
        rec = self.decoder(torch.cat([pose_emb, id_emb], dim=1))
        out = emb_to_region_params(rec, self.num_regions)
        out["covar"] = out["affine"] @ out["affine"].transpose(-1, -2)
        return out
