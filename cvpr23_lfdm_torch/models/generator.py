"""Warping generator, the LFAE decoder (counterpart of
`cvpr23_lfdm_tpu/models/generator.py`).

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
`skips=False` (the JAX package's no-skip decode, `Generator.skips`): the
bottleneck warp alone, the up blocks without skip blends, the final
sigmoid with no blend; `deformed` is the fp32 source warped at full
resolution by the resized flow, as the JAX package's `warp_with_occlusion`
(no occlusion). It has no band mode: `shard_generator` refuses it.
The module's `train`/`eval` mode is the JAX package's `train` argument, and
it picks the warp by path, as the JAX generator does: in eval mode every
warp is the kernel :func:`cvpr23_lfdm_torch.ops.warp.warp_video`, exact for
any flow, at every scale (forward-only: it raises on a CUDA tensor when a
gradient is asked for); in train mode (LFAE training) every warp is the
differentiable :func:`cvpr23_lfdm_torch.ops.warp.train_warp`.

Band mode (`shard_generator`, the `space` axis of a serving mesh; the JAX
package's GSPMD partitions the same convolutions by height): each rank of
a space group encodes and decodes its contiguous band of the image's rows.
Every conv of the encoder and decoder takes its neighbours' rows
(`models/blocks.py::Conv2d`); BatchNorm in eval mode, ReLU, the pool,
the upsample and the blends are local to a band. Each warp source (the
bottleneck, the middle skip, the full-resolution skip packed with the
image) is gathered whole once, since a band's grid may sample any source
row; the flow and occlusion are resized whole and cut to the band; row 3
warps the band's output rows only. The outputs are gathered, so callers
see whole frames. Serving only, as in the JAX package: train mode refuses
it.
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
from cvpr23_lfdm_torch.parallel.mesh import gather_band, local_band, replicate

# rows of a neighbour that the widest conv of the encoder and decoder needs
# (the 7x7 `first` and `final`)
SP_HALO = 3


def check_sp(size: int, frame_shape: int, num_down_blocks: int = 2, halo: int = SP_HALO) -> None:
    """The port's spatial partitioning cuts the image height into `size`
    whole bands that stay whole and even at every scale down to the
    bottleneck (`frame_shape / 2^num_down_blocks`), each at least `halo`
    rows at full resolution; else a `ValueError` that names the rule."""
    step = 2 ** num_down_blocks * size
    if size < 1 or frame_shape % step or frame_shape // size < halo:
        raise ValueError(
            f"sp={size}: the port's spatial partitioning cuts the {frame_shape}-row image into {size} "
            f"bands that stay whole and even down to the 1/{2 ** num_down_blocks} bottleneck, so sp x "
            f"{2 ** num_down_blocks} must divide the height {frame_shape}, and each band must hold the "
            f"{halo}-row halo of the 7x7 convs (the JAX package pads an uneven split; the port does not)")


class Generator(nn.Module):
    def __init__(self, num_channels: int = 3, block_expansion: int = 64,
                 max_features: int = 512, num_down_blocks: int = 2,
                 num_bottleneck_blocks: int = 6, skips: bool = True,
                 num_regions: int = 10, revert_axis_swap: bool = True,
                 pixelwise_flow_params: dict | None = None, dtype=None):
        super().__init__()
        self.skips = skips
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
        self.sp = None  # the mesh of band mode (`shard_generator`)
        self.eval()  # the JAX `train=False` default

    def train(self, mode: bool = True) -> "Generator":
        if mode and self.sp is not None:
            raise ValueError("the generator is in band mode (a `space` mesh): sp is serving only, "
                             "as in the JAX package; train a generator that is not sharded")
        return super().train(mode)

    def band_convs(self) -> list:
        """The convs of the encoder and decoder (not the flow predictor's)."""
        mods = [self.first, *self._blocks("down_blocks_", self.num_down_blocks),
                *self._blocks("bottleneck_r", self.num_bottleneck_blocks),
                *self._blocks("up_blocks_", self.num_down_blocks), self.final]
        return [m for mod in mods for m in mod.modules() if isinstance(m, Conv2d)]

    def _blocks(self, prefix: str, n: int):
        return [getattr(self, f"{prefix}{i}") for i in range(n)]

    def _encode(self, source_image):
        """Bottleneck and skips of `source_image [B, H, W, 3]`; in band mode
        those of this rank's band of rows."""
        if self.sp is not None:
            check_sp(self.sp.space_size, source_image.shape[1], self.num_down_blocks)
            source_image = local_band(source_image, self.sp)
        out = self.first(source_image)
        skip_feats = [out]
        for blk in self._blocks("down_blocks_", self.num_down_blocks):
            out = blk(out)
            skip_feats.append(out)
        return out, skip_feats

    def compute_fea(self, source_image: torch.Tensor) -> torch.Tensor:
        """`[B, H, W, 3]` -> bottleneck feature `[B, H/4, W/4, 256]`."""
        return gather_band(self._encode(source_image)[0], self.sp)

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
        bottleneck_feat = gather_band(bottleneck_feat, self.sp)
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
        bottleneck_feat = gather_band(bottleneck_feat, self.sp)
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
        bottleneck_feat = gather_band(bottleneck_feat, self.sp)
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
        """`bottleneck_feat` and `source_image` whole, `skip_feats` from
        `_encode` (this rank's bands in band mode), `flow` / `occlusion`
        `[B*F, h, w, .]` whole -> `prediction`, `deformed` `[B*F, H, W, 3]`."""
        sp = self.sp
        b = source_image.shape[0]
        flows = {}

        def prep(res):
            """flow/occlusion resized whole to `res`, once per scale, and cut
            to this rank's band."""
            if res not in flows:
                fl = flow if tuple(flow.shape[1:3]) == res else resize_bilinear(flow, res)
                oc = occlusion
                if oc is not None and tuple(oc.shape[1:3]) != res:
                    oc = resize_bilinear(oc, res)
                flows[res] = (local_band(fl, sp), None if oc is None else local_band(oc, sp))
            return flows[res]

        def warp_from(src_b, res):
            """Sample the whole per-video source `[B, H, W, C]` at the
            per-frame grids of scale `res` (this rank's `h` rows of them)
            -> `[B*F, h, W, C]`."""
            hh, ww, cc = src_b.shape[1:]
            if self.training:
                grid = prep(res)[0].reshape(b, f * hh, ww, 2)
                out = warp_ops.train_warp(src_b, grid).to(src_b.dtype)
                return out.reshape(b * f, hh, ww, cc)
            fl = prep(res)[0]
            ho = fl.shape[1]
            fl = fl.float().reshape(b, f, ho, ww, 2).contiguous()
            return warp_ops.warp_video(src_b.contiguous(), fl).reshape(b * f, ho, ww, cc)

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
            if self.skips and i == 0:
                # skip_feats[-1] IS bottleneck_feat: reuse its warp
                out = blend(w32, occ32, out)
            elif self.skips:
                skip = gather_band(skip_feats[-(i + 1)], sp)
                res = tuple(skip.shape[1:3])
                out = blend(warp_from(skip, res), prep(res)[1], out)
            out = blk(out)
        if not self.skips:
            out = torch.sigmoid(self.final(out).float())
            res0 = tuple(source_image.shape[1:3])
            return out, warp_from(source_image, res0).float()
        skip0 = skip_feats[0]
        c0 = skip0.shape[-1]
        pack = gather_band(torch.cat([skip0, local_band(source_image, sp).to(skip0.dtype)], dim=-1), sp)
        res0 = tuple(pack.shape[1:3])
        occ0 = prep(res0)[1]
        wpack = warp_from(pack, res0)
        wskip0 = wpack[..., :c0]
        deformed = wpack[..., c0:].float()
        out = blend(wskip0, occ0, out)
        out = torch.sigmoid(self.final(out).float())
        out = blend(deformed, None if occ0 is None else occ0.float(), out)
        return gather_band(out, sp), gather_band(deformed, sp)


def shard_generator(generator: Generator, mesh) -> Generator:
    """Put the generator into band mode over `mesh`'s `space` axis, in place,
    and return it (a no-op on a space axis of one rank, or for a generator
    already in band mode on `mesh`): every rank of the space group first
    takes the first rank's weights, then every conv of the encoder and
    decoder exchanges halos with its neighbours (`Conv2d.space`). The
    weights stay whole: sp shards activations, not parameters. The input
    height must pass `check_sp`, which `_encode` checks on each call."""
    if mesh is None or mesh.space_size == 1 or generator.sp is mesh:
        return generator
    if generator.sp is not None:
        raise ValueError("shard_generator: the generator is already in band mode on another mesh")
    if not generator.skips:
        raise ValueError("shard_generator: band mode is the skip decode's; a generator built with "
                         "skips=False (the JAX package's no-skip decode) runs on one rank")
    if generator.training:
        raise ValueError("shard_generator: sp is serving only, as in the JAX package; the generator "
                         "is in train mode")
    convs = generator.band_convs()
    for conv in convs:
        k = conv.weight.shape[-1]
        if conv.stride != 1 or conv.padding != k // 2:
            raise ValueError(f"shard_generator: a {k}x{k} conv of stride {conv.stride}, padding "
                             f"{conv.padding} has no band mode")
    replicate(generator, mesh, axis="space")
    for conv in convs:
        conv.space = mesh
    generator.sp = mesh
    return generator
