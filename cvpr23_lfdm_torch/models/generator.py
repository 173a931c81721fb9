"""Warping generator, the LFAE decoder (counterpart of
`cvpr23_lfdm_tpu/models/generator.py`), eval mode.

Serving entry points: `compute_fea` (encoder -> 1/4-res reference feature)
and `decode_video_with_flow` (one encoder pass per video, then warps +
decoder stack for all F frames). With a pixelwise flow predictor
(`pixelwise_flow_params`), also the frozen forwards of DM training:
`forward_flow_video` (encoder feature + dense flow/occlusion of all F
frames, the pseudo-ground-truth of the diffusion loss), `forward_video`
(the same plus the warped reconstruction, for monitoring), `forward` and
`forward_with_flow` (single frame per source).

Warp plan (as `Generator._decode_warp_stack` in the JAX package):
* the one bottleneck-scale warp also serves the first up-skip;
* the full-res skip and the source image are warped together;
* `deformed` is fp32 in the final blend;
* flow and occlusion are resized once per scale.
Every warp is :func:`cvpr23_lfdm_torch.ops.warp.warp_video`, exact for
any flow, at every scale.
"""

from __future__ import annotations

import torch
from torch import nn

from cvpr23_lfdm_torch.models.blocks import (
    Conv2d, DownBlock2d, ResBlock2d, SameBlock2d, UpBlock2d,
)
from cvpr23_lfdm_torch.models.pixelwise_flow import PixelwiseFlowPredictor
from cvpr23_lfdm_torch.ops import warp as warp_ops
from cvpr23_lfdm_torch.ops.resize import resize_bilinear


class Generator(nn.Module):
    def __init__(self, num_channels: int = 3, block_expansion: int = 64,
                 max_features: int = 512, num_down_blocks: int = 2,
                 num_bottleneck_blocks: int = 6, skips: bool = True,
                 num_regions: int = 10, revert_axis_swap: bool = True,
                 pixelwise_flow_params: dict | None = None, dtype=None):
        super().__init__()
        if not skips:
            raise NotImplementedError("the port's generator decodes with skips (all presets)")
        self.num_down_blocks = num_down_blocks
        self.num_bottleneck_blocks = num_bottleneck_blocks
        self.pixelwise_flow_predictor = None
        if pixelwise_flow_params is not None:
            self.pixelwise_flow_predictor = PixelwiseFlowPredictor(
                num_regions=num_regions, num_channels=num_channels,
                revert_axis_swap=revert_axis_swap, **pixelwise_flow_params,
            )
        self.first = SameBlock2d(num_channels, block_expansion, 7, dtype=dtype)
        cin = block_expansion
        for i in range(num_down_blocks):
            cout = min(max_features, block_expansion * (2 ** (i + 1)))
            setattr(self, f"down_blocks_{i}", DownBlock2d(cin, cout, 3, dtype=dtype))
            cin = cout
        for i in range(num_down_blocks):
            cout = min(max_features, block_expansion * (2 ** (num_down_blocks - i - 1)))
            setattr(self, f"up_blocks_{i}", UpBlock2d(cin, cout, 3, dtype=dtype))
            cin = cout
        bottleneck_ch = min(max_features, block_expansion * (2 ** num_down_blocks))
        for i in range(num_bottleneck_blocks):
            setattr(self, f"bottleneck_r{i}", ResBlock2d(bottleneck_ch, 3, dtype=dtype))
        self.final = Conv2d(block_expansion, num_channels, 7, dtype=dtype)

    def _blocks(self, prefix: str, n: int):
        return [getattr(self, f"{prefix}{i}") for i in range(n)]

    def _encode(self, source_image):
        out = self.first(source_image)
        skip_feats = [out]
        for blk in self._blocks("down_blocks_", self.num_down_blocks):
            out = blk(out)
            skip_feats.append(out)
        return out, skip_feats

    def compute_fea(self, source_image: torch.Tensor) -> torch.Tensor:
        """`[B, H, W, 3]` -> bottleneck feature `[B, H/4, W/4, 256]`."""
        return self._encode(source_image)[0]

    def _predict_motion(self, source_image, driving_params, source_params, bg_params, frames):
        if self.pixelwise_flow_predictor is None:
            raise RuntimeError("this Generator was built without a pixelwise flow predictor")
        return self.pixelwise_flow_predictor(
            source_image, driving_params, source_params, bg_params, frames=frames)

    def forward_flow_video(self, source_image, driving_params, source_params,
                           bg_params=None, frames: int = 1) -> dict:
        """Encoder bottleneck + dense flow/occlusion, without the warping
        decoder. `source_image [B, H, W, 3]`; the parameter dicts carry
        `B*frames` pair entries (every video's frames share its reference
        frame), so the outputs are `[B*frames, h, w, .]`."""
        motion = self._predict_motion(source_image, driving_params, source_params,
                                      bg_params, frames)
        return {
            "bottle_neck_feat": self.compute_fea(source_image),
            "optical_flow": motion["optical_flow"],
            "occlusion_map": motion.get("occlusion_map"),
        }

    def forward_video(self, source_image, driving_params, source_params,
                      bg_params=None, frames: int = 1) -> dict:
        """:meth:`forward_flow_video` plus the warped reconstruction
        (`prediction`, `deformed`: `[B*frames, H, W, 3]`)."""
        bottleneck_feat, skip_feats = self._encode(source_image)
        motion = self._predict_motion(source_image, driving_params, source_params,
                                      bg_params, frames)
        flow, occlusion = motion["optical_flow"], motion.get("occlusion_map")
        prediction, deformed = self._decode_warp_stack(
            bottleneck_feat, skip_feats, source_image, flow, occlusion, frames)
        out = {"bottle_neck_feat": bottleneck_feat, "optical_flow": flow,
               "prediction": prediction, "deformed": deformed}
        if occlusion is not None:
            out["occlusion_map"] = occlusion
        return out

    def forward(self, source_image, driving_params, source_params, bg_params=None) -> dict:
        """Full forward with the internal flow predictor, one driving frame
        per source."""
        return self.forward_video(source_image, driving_params, source_params, bg_params, 1)

    def forward_with_flow(self, source_image, optical_flow, occlusion_map=None) -> dict:
        """Decode with an externally supplied flow `[B, h, w, 2]` and
        occlusion `[B, h, w, 1]`."""
        bottleneck_feat, skip_feats = self._encode(source_image)
        prediction, deformed = self._decode_warp_stack(
            bottleneck_feat, skip_feats, source_image, optical_flow, occlusion_map, 1)
        return {"prediction": prediction, "deformed": deformed,
                "bottle_neck_feat": bottleneck_feat}

    def decode_video_with_flow(self, source_image, optical_flow, occlusion_map=None) -> dict:
        """Args: `source_image [B, H, W, 3]`, `optical_flow [B, F, h, w, 2]`,
        `occlusion_map [B, F, h, w, 1]` or None.

        Returns `prediction`/`deformed` `[B, F, H, W, 3]` and
        `bottle_neck_feat` `[B, H/4, W/4, C]`."""
        b, f = optical_flow.shape[:2]
        bottleneck_feat, skip_feats = self._encode(source_image)
        fold = lambda x: x.reshape((b * f,) + x.shape[2:])
        flow = fold(optical_flow)
        occ = None if occlusion_map is None else fold(occlusion_map)
        prediction, deformed = self._decode_warp_stack(
            bottleneck_feat, skip_feats, source_image, flow, occ, f
        )
        unfold = lambda x: x.reshape((b, f) + x.shape[1:])
        return {
            "prediction": unfold(prediction),
            "deformed": unfold(deformed),
            "bottle_neck_feat": bottleneck_feat,
        }

    def _decode_warp_stack(self, bottleneck_feat, skip_feats, source_image, flow, occlusion, f):
        b = source_image.shape[0]
        flows = {}

        def prep(res):
            """flow/occlusion resized to `res`, once per scale."""
            if res not in flows:
                fl = flow if tuple(flow.shape[1:3]) == res else resize_bilinear(flow, res)
                oc = occlusion
                if oc is not None and tuple(oc.shape[1:3]) != res:
                    oc = resize_bilinear(oc, res)
                flows[res] = (fl, oc)
            return flows[res]

        def warp_from(src_b, res):
            """Sample the per-video source `[B, H, W, C]` at the per-frame
            grids of scale `res` -> `[B*F, H, W, C]`."""
            hh, ww, cc = src_b.shape[1:]
            fl = prep(res)[0].float().reshape(b, f, hh, ww, 2).contiguous()
            return warp_ops.warp_video(src_b.contiguous(), fl).reshape(b * f, hh, ww, cc)

        def blend(warped, oc, previous):
            if oc is None:
                return warped
            if previous is None:
                return warped * oc
            return warped * oc + previous * (1.0 - oc)

        res32 = tuple(bottleneck_feat.shape[1:3])
        w32 = warp_from(bottleneck_feat, res32)
        occ32 = prep(res32)[1]
        out = blend(w32, occ32, None)
        for blk in self._blocks("bottleneck_r", self.num_bottleneck_blocks):
            out = blk(out)
        for i, blk in enumerate(self._blocks("up_blocks_", self.num_down_blocks)):
            if i == 0:
                # skip_feats[-1] IS bottleneck_feat: reuse its warp
                out = blend(w32, occ32, out)
            else:
                skip = skip_feats[-(i + 1)]
                res = tuple(skip.shape[1:3])
                out = blend(warp_from(skip, res), prep(res)[1], out)
            out = blk(out)
        skip0 = skip_feats[0]
        res0 = tuple(skip0.shape[1:3])
        occ0 = prep(res0)[1]
        pack = torch.cat([skip0, source_image.to(skip0.dtype)], dim=-1)
        wpack = warp_from(pack, res0)
        wskip0 = wpack[..., : skip0.shape[-1]]
        deformed = wpack[..., skip0.shape[-1]:].float()
        out = blend(wskip0, occ0, out)
        out = torch.sigmoid(self.final(out).float())
        out = blend(deformed, None if occ0 is None else occ0.float(), out)
        return out, deformed
