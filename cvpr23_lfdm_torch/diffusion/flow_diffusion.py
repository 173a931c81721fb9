"""FlowDiffusion: frozen LFAE + conditional 3D-UNet diffusion (counterpart
of `cvpr23_lfdm_tpu/diffusion/flow_diffusion.py`).

Serving: reference-frame feature -> DDIM/DDPM sampling of the latent flow
volume -> frame-batched warp decode. Training (`training=True`): the
frozen LFAE's pseudo-ground-truth flow volume of a real video, all frames
folded into one batched pass, and the diffusion loss on it.

The JAX orchestrator is stateless over variable pytrees; here the modules
own their weights (`generator`, `unet` and, for training, `region_predictor`
and `bg_predictor`), loaded with :meth:`FlowDiffusion.load_jax_variables`
or `utils/bench_ckpt.py`. Latent volumes are channel-last
`[B, F, h, w, 3]` = (flow_x, flow_y, conf*2-1).
"""

from __future__ import annotations

import torch
from torch import nn

from cvpr23_lfdm_torch.config import DiffusionConfig, LFAEConfig
from cvpr23_lfdm_torch.diffusion.gaussian_diffusion import GaussianDiffusion
from cvpr23_lfdm_torch.models.flow_autoenc import build_generator, build_lfae_modules
from cvpr23_lfdm_torch.models.unet3d import Unet3D, resolve_attn_impl
from cvpr23_lfdm_torch.ops.grid import identity_flow_volume
from cvpr23_lfdm_torch.utils.device import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _fold(x: torch.Tensor) -> torch.Tensor:
    """[B, F, ...] -> [B*F, ...]"""
    return x.reshape((-1,) + x.shape[2:])


def _unfold(x: torch.Tensor, b: int) -> torch.Tensor:
    """[B*F, ...] -> [B, F, ...]"""
    return x.reshape((b, -1) + x.shape[1:])


def build_unet(lfae_cfg: LFAEConfig, cfg: DiffusionConfig, training: bool,
               fused_norm: bool | None = None) -> Unet3D:
    """The denoiser of a config, freshly initialised, on the CPU, in the
    form `cfg.temporal_attn_impl` names (`"auto"`: `pallas2` for training,
    `pallas3` for serving; :func:`models.unet3d.resolve_attn_impl`)."""
    g = lfae_cfg.generator
    return Unet3D(
        dim=cfg.dim, cond_dim=cfg.cond_dim, dim_mults=tuple(cfg.dim_mults),
        attn_heads=cfg.attn_heads, attn_dim_head=cfg.attn_dim_head,
        learn_null_cond=cfg.learn_null_cond, use_deconv=cfg.use_deconv,
        use_final_activation=cfg.use_final_activation,
        dtype=_DTYPES[cfg.compute_dtype],
        fea_channels=min(g.max_features, g.block_expansion * (2 ** g.num_down_blocks)),
        temporal_attn_impl=resolve_attn_impl(cfg.temporal_attn_impl, training),
        fused_norm=fused_norm,
    )


class FlowDiffusion(nn.Module):
    """Frozen LFAE + conditional 3D UNet on `device` (the CUDA card unless
    `device` says otherwise), all in eval mode.

    `training=False` (serving): the generator without its flow predictor,
    nothing requires a gradient. `training=True`: also the region and
    background predictors and the generator's pixelwise flow predictor
    (frozen), and the UNet's parameters trainable. The UNet takes the form
    the config's `temporal_attn_impl` names (`xla`, `pallas`, `pallas2`,
    `pallas3`); `"auto"` gives serving the forward-only `pallas3` form and
    training the differentiable `pallas2` form
    (:func:`models.unet3d.resolve_attn_impl`). Training needs a
    differentiable form (`pallas2` or `xla`): the kernels of the others
    raise when a gradient is asked of them on the card."""

    def __init__(self, lfae_cfg: LFAEConfig, cfg: DiffusionConfig, device=None,
                 training: bool = False):
        super().__init__()
        self.device = resolve_device(device)
        self.lfae_cfg, self.cfg = lfae_cfg, cfg
        if training:
            self.region_predictor, self.bg_predictor, self.generator = build_lfae_modules(lfae_cfg)
        else:
            self.generator = build_generator(lfae_cfg, with_flow_predictor=False)
        self.unet = build_unet(lfae_cfg, cfg, training)
        self.diffusion = GaussianDiffusion.create(cfg, device=self.device)
        self.to(self.device)
        self.eval()
        self.requires_grad_(False)
        self.unet.requires_grad_(training)

    def train(self, mode: bool = True) -> "FlowDiffusion":
        """The UNet follows `mode`; the frozen LFAE stays in eval mode (its
        running statistics and the decode warp), as the JAX package computes
        the pseudo-ground truth with `train=False`."""
        super().train(mode)
        for name in ("region_predictor", "bg_predictor", "generator"):
            if hasattr(self, name):
                getattr(self, name).eval()
        return self

    def load_jax_variables(self, unet_vars: dict, lfae_vars: dict) -> None:
        """Load the JAX package's variable trees (numpy leaves): the UNet's
        `{"params": ...}` and the LFAE's `{"params"|"batch_stats":
        {"region_predictor", "bg_predictor", "generator"}}`. Every module
        this model holds is loaded strictly; a serving model ignores the
        subtrees of the modules it does not hold."""
        from cvpr23_lfdm_torch.utils.bench_ckpt import from_jax_params, lfae_subtree

        self.unet.load_state_dict(from_jax_params(unet_vars))
        with_flow = self.generator.pixelwise_flow_predictor is not None
        self.generator.load_state_dict(
            from_jax_params(lfae_subtree(lfae_vars, "generator", with_flow)))
        for name in ("region_predictor", "bg_predictor"):
            if hasattr(self, name):
                getattr(self, name).load_state_dict(
                    from_jax_params(lfae_subtree(lfae_vars, name)))

    # ------------------------------------------------------------ pseudo GT

    @torch.no_grad()
    def pseudo_ground_truth(self, ref_img, real_vid, with_decode: bool = True) -> dict:
        """The frozen LFAE's latent flow volume for a real video, all
        frames in one batched pass.

        Args:
          ref_img: `[B, H, W, 3]` (frame 0 of each video in training).
          real_vid: `[B, F, H, W, 3]`.
          with_decode: also decode the LFAE reconstruction (`out_vid`,
            `warped_vid`); the diffusion loss needs only flow, conf and
            `ref_fea`.

        Returns `vid_grid [B, F, h, w, 2]`, `vid_conf [B, F, h, w, 1]`,
        `ref_fea [B, h, w, C]` and (with_decode) `out_vid`/`warped_vid`
        `[B, F, H, W, 3]`, all without a graph.
        """
        b, f = real_vid.shape[:2]
        source_params = self.region_predictor(ref_img)
        frames = _fold(real_vid)
        driving_params = self.region_predictor(frames)
        bg_params = self.bg_predictor(ref_img.repeat_interleave(f, dim=0), frames)
        source_rep = {k: v.repeat_interleave(f, dim=0) for k, v in source_params.items()}
        forward = self.generator.forward_video if with_decode else self.generator.forward_flow_video
        generated = forward(ref_img, driving_params, source_rep, bg_params, frames=f)
        out = {
            "vid_grid": _unfold(generated["optical_flow"], b),
            "vid_conf": _unfold(generated["occlusion_map"], b),
            "ref_fea": generated["bottle_neck_feat"],
        }
        if with_decode:
            out["out_vid"] = _unfold(generated["prediction"], b)
            out["warped_vid"] = _unfold(generated["deformed"], b)
        return out

    # ------------------------------------------------------------ latent codec

    def encode_latent(self, vid_grid, vid_conf):
        """(flow, conf) -> diffusion space `[B, F, h, w, 3]`."""
        if self.cfg.use_residual_flow:
            b, f, h, w = vid_grid.shape[:4]
            vid_grid = vid_grid - identity_flow_volume(b, f, h, w, vid_grid.dtype, vid_grid.device)
        return torch.cat([vid_grid, vid_conf * 2.0 - 1.0], dim=-1)

    def decode_latent(self, x):
        """Diffusion space -> (flow `[B, F, h, w, 2]`, conf `[B, F, h, w, 1]`)."""
        vid_grid = x[..., :2]
        if self.cfg.use_residual_flow:
            b, f, h, w = vid_grid.shape[:4]
            vid_grid = vid_grid + identity_flow_volume(b, f, h, w, vid_grid.dtype, vid_grid.device)
        vid_conf = (x[..., 2:3] + 1.0) * 0.5
        return vid_grid, vid_conf

    # ------------------------------------------------------------ decode

    @torch.no_grad()
    def decode_flow_video(self, ref_img, vid_grid, vid_conf):
        """Warp-decode all frames against one encoder pass of `ref_img`.
        Returns (out_vid, warped_vid) `[B, F, H, W, 3]`."""
        out = self.generator.decode_video_with_flow(ref_img, vid_grid, vid_conf)
        return out["prediction"], out["deformed"]

    def denoise(self, x, t, cond, null_cond_mask, fea):
        return self.unet(x, t, cond, null_cond_mask, fea=fea)

    # ------------------------------------------------------------ training

    def loss(self, ref_img, real_vid, cond, none_cond_mask=None,
             with_monitoring: bool = True, only_use_flow: bool = True,
             t=None, noise=None, null_mask=None, generator=None):
        """Full training forward: pseudo-ground-truth, diffusion loss and,
        with monitoring, the decode of the predicted x0 with its
        reconstruction losses. `t`, `noise` and `null_mask` inject the random
        draws of `p_losses`; what is missing comes from `generator`.

        Returns `(total training loss, aux dict)`. The decode of `pred_x0`
        carries no gradient even when `only_use_flow` is False (a quirk of
        the reference, kept): the reconstruction losses then only change
        the reported total, the gradient is the diffusion loss's either way.
        """
        gt = self.pseudo_ground_truth(ref_img, real_vid, with_decode=with_monitoring)
        x_start = self.encode_latent(gt["vid_grid"], gt["vid_conf"])
        loss, dm_aux = self.diffusion.p_losses(
            self.denoise, x_start, gt["ref_fea"], cond, none_cond_mask,
            t=t, noise=noise, null_mask=null_mask, generator=generator,
        )
        aux = {"loss": loss, **gt}
        total = loss
        if with_monitoring or not only_use_flow:
            fake_grid, fake_conf = self.decode_latent(dm_aux["pred_x0"])
            fake_out, fake_warped = self.decode_flow_video(ref_img, fake_grid, fake_conf)
            rec_loss = (real_vid - fake_out).abs().mean()
            rec_warp_loss = (real_vid - fake_warped).abs().mean()
            aux.update(
                fake_out_vid=fake_out, fake_warped_vid=fake_warped,
                fake_vid_grid=fake_grid, fake_vid_conf=fake_conf,
                rec_loss=rec_loss, rec_warp_loss=rec_warp_loss,
            )
            if not only_use_flow:
                total = loss + rec_loss + rec_warp_loss
        return total, aux

    # ------------------------------------------------------------ sampling

    @torch.no_grad()
    def sample_video(self, sample_img, cond, cond_scale: float = 1.0,
                     init_img=None, noise_seq=None, generator=None) -> dict:
        """Encoder feature -> sampler -> frame-batched decode.

        Args:
          sample_img: `[B, H, W, 3]` reference frame in [0, 1].
          cond: `[B, cond_dim]` class-text embedding.
          init_img / noise_seq: injected gaussians, `[B, F, h, w, 3]` and
            `[steps, B, F, h, w, 3]`; else drawn from `generator`.

        Returns `vid_grid`, `vid_conf`, `out_vid`, `warped_vid`.
        """
        fea = self.generator.compute_fea(sample_img)
        pred = self.diffusion.sample(
            self.denoise, fea, cond=cond, cond_scale=cond_scale,
            num_frames=self.cfg.num_frames, image_size=self.cfg.img_size,
            init_img=init_img, noise_seq=noise_seq, generator=generator,
        )
        vid_grid, vid_conf = self.decode_latent(pred)
        out_vid, warped_vid = self.decode_flow_video(sample_img, vid_grid, vid_conf)
        return {
            "vid_grid": vid_grid, "vid_conf": vid_conf,
            "out_vid": out_vid, "warped_vid": warped_vid,
        }
