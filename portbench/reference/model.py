"""The reference's whole entries: the serving video and the DM training
loss, built from a configuration's plain dict
(`portbench/configs/<name>.json`, key `experiment`), fp32, with every
input and random draw given.
"""

from __future__ import annotations

import torch
from torch import nn

from portbench.reference import diffusion, lfae
from portbench.reference.unet import Unet3D


def build_unet(exp: dict) -> Unet3D:
    d, g = exp["diffusion"], exp["lfae"]["generator"]
    return Unet3D(dim=d["dim"], cond_dim=d["cond_dim"], dim_mults=tuple(d["dim_mults"]),
                  attn_heads=d["attn_heads"], attn_dim_head=d["attn_dim_head"],
                  learn_null_cond=d["learn_null_cond"], use_deconv=d["use_deconv"],
                  use_final_activation=d["use_final_activation"],
                  fea_channels=min(g["max_features"], g["block_expansion"] * 2 ** g["num_down_blocks"]))


def build_generator(exp: dict, with_flow_predictor: bool) -> lfae.Generator:
    a, g = exp["lfae"], exp["lfae"]["generator"]
    pf = g["pixelwise_flow"]
    return lfae.Generator(
        num_channels=a["num_channels"], block_expansion=g["block_expansion"],
        max_features=g["max_features"], num_down_blocks=g["num_down_blocks"],
        num_bottleneck_blocks=g["num_bottleneck_blocks"], num_regions=a["num_regions"],
        revert_axis_swap=a["revert_axis_swap"], with_flow_predictor=with_flow_predictor,
        pixelwise={"block_expansion": pf["block_expansion"], "num_blocks": pf["num_blocks"],
                   "max_features": pf["max_features"], "scale_factor": pf["scale_factor"]})


def build_motion(exp: dict) -> tuple[nn.Module, nn.Module]:
    a = exp["lfae"]
    rp, bp = a["region_predictor"], a["bg_predictor"]
    region = lfae.RegionPredictor(
        num_regions=a["num_regions"], num_channels=a["num_channels"],
        block_expansion=rp["block_expansion"], max_features=rp["max_features"],
        num_blocks=rp["num_blocks"], temperature=rp["temperature"],
        scale_factor=rp["scale_factor"], pad=rp["pad"])
    bg = lfae.BGMotionPredictor(num_channels=a["num_channels"], block_expansion=bp["block_expansion"],
                                max_features=bp["max_features"], num_blocks=bp["num_blocks"])
    return region, bg


class Serving(nn.Module):
    """`unet` and `generator` (no flow predictor): the serving video."""

    def __init__(self, exp: dict):
        super().__init__()
        self.exp = exp
        self.unet = build_unet(exp)
        self.generator = build_generator(exp, with_flow_predictor=False)
        self.eval()

    def sample_video(self, ref_img, cond, init_img, noise_seq, sampling_steps: int):
        d = self.exp["diffusion"]
        sched = diffusion.Schedule(d["timesteps"], ref_img.device)
        fea = self.generator.compute_fea(ref_img)
        latent = diffusion.ddim_sample(self.unet, sched, sampling_steps, d["ddim_sampling_eta"],
                                       d["dynamic_thres_percentile"], fea, cond, init_img, noise_seq)
        b, f = latent.shape[:2]
        flow = latent[..., :2].reshape(b * f, *latent.shape[2:4], 2)
        conf = ((latent[..., 2:3] + 1.0) * 0.5).reshape(b * f, *latent.shape[2:4], 1)
        video, _ = self.generator.decode(ref_img, flow, conf, f)
        return latent, video.reshape(b, f, *video.shape[1:])


class DMTraining(nn.Module):
    """`unet` and the frozen LFAE (`region_predictor`, `bg_predictor`,
    `generator` with its flow predictor, eval mode): the DM loss."""

    def __init__(self, exp: dict):
        super().__init__()
        self.exp = exp
        self.unet = build_unet(exp)
        self.region_predictor, self.bg_predictor = build_motion(exp)
        self.generator = build_generator(exp, with_flow_predictor=True)
        for m in (self.region_predictor, self.bg_predictor, self.generator):
            m.eval().requires_grad_(False)

    @torch.no_grad()
    def pseudo_ground_truth(self, ref_img, real_vid):
        """`x_start [B, F, h, w, 3]` and `ref_fea [B, h, w, C]` of a real video."""
        b, f = real_vid.shape[:2]
        frames = real_vid.reshape(b * f, *real_vid.shape[2:])
        source = self.region_predictor(ref_img)
        driving = self.region_predictor(frames)
        bg = self.bg_predictor(ref_img.repeat_interleave(f, dim=0), frames)
        source = {k: v.repeat_interleave(f, dim=0) for k, v in source.items()}
        motion = self.generator.motion(ref_img, driving, source, bg, f)
        flow = motion["optical_flow"].reshape(b, f, *motion["optical_flow"].shape[1:])
        conf = motion["occlusion_map"].reshape(b, f, *motion["occlusion_map"].shape[1:])
        return torch.cat([flow, conf * 2.0 - 1.0], dim=-1), self.generator.compute_fea(ref_img)

    def loss(self, ref_img, real_vid, cond, t, noise, null_mask):
        x_start, fea = self.pseudo_ground_truth(ref_img, real_vid)
        sched = diffusion.Schedule(self.exp["diffusion"]["timesteps"], ref_img.device)
        return diffusion.p_losses(self.unet, sched, x_start, fea, cond, t, noise, null_mask)

