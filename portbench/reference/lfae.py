"""The LFAE of the reference (region, background and pixelwise-flow
predictors and the warping generator), fp32, channel-last: a frozen copy
of the port's plain versions (`models/{region_predictor,bg_predictor,
pixelwise_flow,generator}.py`) without band mode or compute dtype. Every
warp is `layers.grid_sample`.
"""

from __future__ import annotations

import torch
from torch import nn

from portbench.reference.layers import (
    AntiAliasDownsample, Conv2d, Dense, DownBlock2d, Encoder, Hourglass, ResBlock2d, SameBlock2d,
    UpBlock2d, from_homogeneous, grid_sample, inv_2x2, make_coordinate_grid, region2gaussian,
    resize_bilinear, sqrt_psd_2x2, to_homogeneous,
)


class RegionPredictor(nn.Module):
    """PCA-based region parameters: `shift`, `covar`, `affine`, `heatmap`."""

    def __init__(self, num_regions=10, num_channels=3, block_expansion=32, max_features=1024,
                 num_blocks=5, temperature=0.1, scale_factor=0.25, pad=3):
        super().__init__()
        self.temperature = temperature
        self.down = AntiAliasDownsample(scale_factor)
        self.predictor = Hourglass(block_expansion, num_channels, num_blocks, max_features)
        self.regions = Conv2d(self.predictor.out_filters, num_regions, 7, padding=pad)

    def forward(self, image):
        prediction = self.regions(self.predictor(self.down(image)))
        b, hh, wh, k = prediction.shape
        region = torch.softmax(prediction.reshape(b, hh * wh, k) / self.temperature, dim=1)
        grid = make_coordinate_grid((hh, wh), device=image.device).reshape(1, hh * wh, 1, 2)
        shift = (region[..., None] * grid).sum(dim=1)
        diff = grid - shift[:, None]
        covar = torch.einsum("bzk,bzki,bzkj->bkij", region, diff, diff)
        return {"shift": shift, "heatmap": region.reshape(b, hh, wh, k), "covar": covar,
                "affine": sqrt_psd_2x2(covar)}


class BGMotionPredictor(nn.Module):
    """Global affine background transform `[B, 3, 3]`."""

    def __init__(self, num_channels=3, block_expansion=32, max_features=1024, num_blocks=5):
        super().__init__()
        self.encoder = Encoder(block_expansion, 2 * num_channels, num_blocks, max_features)
        self.fc = Dense(min(max_features, block_expansion * (2 ** num_blocks)), 6)
        with torch.no_grad():
            self.fc.bias.copy_(torch.tensor([1.0, 0, 0, 0, 1, 0]))

    def forward(self, source, driving):
        b = source.shape[0]
        out = torch.eye(3, dtype=torch.float32, device=source.device).repeat(b, 1, 1)
        feats = self.encoder(torch.cat([source, driving], dim=-1))
        out[:, :2, :] = self.fc(feats[-1].mean(dim=(1, 2))).reshape(b, 2, 3)
        return out


class PixelwiseFlowPredictor(nn.Module):
    """Dense flow and occlusion at 1/4 resolution from K+1 sparse motions."""

    def __init__(self, num_regions=10, num_channels=3, block_expansion=64, num_blocks=5,
                 max_features=1024, scale_factor=0.25, revert_axis_swap=True):
        super().__init__()
        self.num_regions = num_regions
        self.revert_axis_swap = revert_axis_swap
        self.down = AntiAliasDownsample(scale_factor)
        kp1 = num_regions + 1
        self.hourglass = Hourglass(block_expansion, kp1 * (1 + num_channels), num_blocks, max_features)
        self.mask = Conv2d(self.hourglass.out_filters, kp1, 7)
        self.occlusion = Conv2d(self.hourglass.out_filters, 1, 7)

    def forward(self, source_image, driving_params, source_params, bg_params, frames=1):
        source_image = self.down(source_image)
        b0, h, w, c = source_image.shape
        kp1 = self.num_regions + 1
        g_d = region2gaussian(driving_params["shift"], driving_params["covar"], (h, w))
        g_s = region2gaussian(source_params["shift"], source_params["covar"], (h, w))
        heatmap = (g_d - g_s).permute(0, 2, 3, 1)
        heatmap = torch.cat([torch.zeros_like(heatmap[..., :1]), heatmap], dim=-1)

        shift_d = driving_params["shift"]
        b = shift_d.shape[0]
        identity = make_coordinate_grid((h, w), device=shift_d.device)
        coord = identity[None, None] - shift_d[:, :, None, None]
        affine = source_params["affine"] @ inv_2x2(driving_params["affine"])
        if self.revert_axis_swap:
            affine = affine * torch.sign(affine[:, :, 0:1, 0:1])
        coord = torch.einsum("bkij,bkhwj->bkhwi", affine, coord)
        d2s = coord + source_params["shift"][:, :, None, None]
        bg_grid = from_homogeneous(torch.einsum("bij,bhwj->bhwi", bg_params,
                                                to_homogeneous(identity[None].expand(b, h, w, 2))))
        sparse = torch.cat([bg_grid[:, None], d2s], dim=1)  # [B*frames, K+1, h, w, 2]

        grids = sparse.reshape(b0, frames * kp1 * h, w, 2)
        deformed = grid_sample(source_image, grids).reshape(b, kp1, h, w, c)
        per_region = torch.cat([heatmap.permute(0, 3, 1, 2)[..., None], deformed], dim=-1)
        prediction = self.hourglass(per_region.permute(0, 2, 3, 1, 4).reshape(b, h, w, kp1 * (1 + c)))
        mask = torch.softmax(self.mask(prediction), dim=-1)
        return {"optical_flow": torch.einsum("bkhwc,bhwk->bhwc", sparse, mask),
                "occlusion_map": torch.sigmoid(self.occlusion(prediction))}


class Generator(nn.Module):
    """The warping generator: `compute_fea`, the frozen forwards of DM
    training and the video decode, with skips."""

    def __init__(self, num_channels=3, block_expansion=64, max_features=512, num_down_blocks=2,
                 num_bottleneck_blocks=6, num_regions=10, revert_axis_swap=True,
                 with_flow_predictor=True, pixelwise=None):
        super().__init__()
        self.num_down_blocks, self.num_bottleneck_blocks = num_down_blocks, num_bottleneck_blocks
        self.pixelwise_flow_predictor = None
        if with_flow_predictor:
            self.pixelwise_flow_predictor = PixelwiseFlowPredictor(
                num_regions=num_regions, num_channels=num_channels,
                revert_axis_swap=revert_axis_swap, **(pixelwise or {}))
        self.first = SameBlock2d(num_channels, block_expansion, 7)
        cin = block_expansion
        for i in range(num_down_blocks):
            cout = min(max_features, block_expansion * (2 ** (i + 1)))
            setattr(self, f"down_blocks_{i}", DownBlock2d(cin, cout, 3))
            cin = cout
        for i in range(num_down_blocks):
            cout = min(max_features, block_expansion * (2 ** (num_down_blocks - i - 1)))
            setattr(self, f"up_blocks_{i}", UpBlock2d(cin, cout, 3))
            cin = cout
        bottleneck = min(max_features, block_expansion * (2 ** num_down_blocks))
        for i in range(num_bottleneck_blocks):
            setattr(self, f"bottleneck_r{i}", ResBlock2d(bottleneck, 3))
        self.final = Conv2d(block_expansion, num_channels, 7)

    def _encode(self, image):
        out = self.first(image)
        skips = [out]
        for i in range(self.num_down_blocks):
            out = getattr(self, f"down_blocks_{i}")(out)
            skips.append(out)
        return out, skips

    def compute_fea(self, image):
        return self._encode(image)[0]

    def motion(self, source_image, driving_params, source_params, bg_params, frames):
        return self.pixelwise_flow_predictor(source_image, driving_params, source_params, bg_params, frames)

    def decode(self, image, flow, occlusion, frames):
        """`image [B, H, W, 3]`, `flow [B*F, h, w, 2]`, `occlusion [B*F, h, w, 1]`
        -> `prediction`, `deformed` `[B*F, H, W, 3]`."""
        b = image.shape[0]
        bottleneck, skips = self._encode(image)
        cache = {}

        def prep(res):
            if res not in cache:
                cache[res] = (resize_bilinear(flow, res), resize_bilinear(occlusion, res))
            return cache[res]

        def warp_from(src, res):
            hh, ww, cc = src.shape[1:]
            grid = prep(res)[0].reshape(b, frames * hh, ww, 2)
            return grid_sample(src, grid).reshape(b * frames, hh, ww, cc)

        def blend(warped, oc, previous):
            return warped * oc if previous is None else warped * oc + previous * (1.0 - oc)

        res32 = tuple(bottleneck.shape[1:3])
        w32, occ32 = warp_from(bottleneck, res32), prep(res32)[1]
        out = blend(w32, occ32, None)
        for i in range(self.num_bottleneck_blocks):
            out = getattr(self, f"bottleneck_r{i}")(out)
        for i in range(self.num_down_blocks):
            if i == 0:
                out = blend(w32, occ32, out)
            else:
                skip = skips[-(i + 1)]
                res = tuple(skip.shape[1:3])
                out = blend(warp_from(skip, res), prep(res)[1], out)
            out = getattr(self, f"up_blocks_{i}")(out)
        skip0 = skips[0]
        c0 = skip0.shape[-1]
        pack = torch.cat([skip0, image.float()], dim=-1)
        res0 = tuple(pack.shape[1:3])
        occ0 = prep(res0)[1]
        wpack = warp_from(pack, res0)
        deformed = wpack[..., c0:]
        out = blend(wpack[..., :c0], occ0, out)
        out = torch.sigmoid(self.final(out))
        return blend(deformed, occ0, out), deformed
