"""DM training: `DMTrainer.train_step` on batches from a synthetic corpus.

Traffic keys (`TRAFFIC`; any other is refused): `batch` videos a step; a
corpus of `corpus_videos` videos of `corpus_frames` frames made on the
device from the seed; `reference_rows` and `trace_units`. Each step takes
`batch` distinct videos and `num_frames` frames of each by the
configuration's `dm_train.frame_sampling` (`very_random`, the one this
driver draws: a sorted with-replacement draw, frame 0 pinned; the first
frame is the reference frame), the class embedding of
each video, and the step's timesteps, gaussian and null-condition dropout,
all drawn from `(seed, step)` and injected. Steps are enqueued back to back
as a training loop does; the window ends with one synchronise.

`correct`: set-up drives the trainer through `check.CHECKED_STEPS` steps
(the same call and feed as the window's, steps 0-2; the window goes on
from step 3) and keeps the readings of `harness/check.py`; after the
window the fp32 reference follows those steps. The comparison covers the
frozen LFAE's pseudo ground truth, the UNet forward and backward (rows 4
and 5), the loss and the Adam update.
"""

from __future__ import annotations

import contextlib
import gc

import torch

from portbench.harness import check as hck
from portbench.harness import config as hc
from portbench.harness import counts
from portbench.harness.core import sync
from portbench.harness.frames import blob_videos
from portbench.harness.weights import generator, seeded_state
from portbench.reference.model import DMTraining

PARTS = ("unet", "region_predictor", "bg_predictor", "generator")
TRAFFIC = {"batch", "corpus_videos", "corpus_frames", "reference_rows", "trace_units"}


class Driver:
    closed_loop = False

    def __init__(self, ctx):
        self.ctx = ctx
        dev = ctx.device
        self.traffic = hc.traffic(ctx, TRAFFIC)
        self.exp = hc.experiment(ctx.cell.config, ctx.overrides)
        if self.exp["dm_train"]["frame_sampling"] != "very_random":
            raise ValueError(f"frame_sampling {self.exp['dm_train']['frame_sampling']!r}: "
                             "this driver draws 'very_random' only")
        self.form = {**ctx.cell.config["forms"]["dm_train"], **ctx.overrides.get("form", {})}
        hc.set_tf32(self.form)
        self.trace_units = self.traffic["trace_units"]
        cfg = hc.program_config(self.exp, self.form)
        d = self.exp["diffusion"]
        self.corpus = blob_videos(ctx.seed, "dm_corpus", self.traffic["corpus_videos"],
                                  self.traffic["corpus_frames"], self.exp["lfae"]["frame_shape"], dev)
        g = generator(ctx.seed, "classes", device=dev)
        self.table = torch.randn(ctx.cell.config["num_classes"], d["cond_dim"], generator=g, device=dev)
        self.video_class = torch.randint(0, self.table.shape[0], (self.corpus.shape[0],), generator=g, device=dev)

        from cvpr23_lfdm_torch.diffusion.flow_diffusion import FlowDiffusion
        from cvpr23_lfdm_torch.train.dm_trainer import DMTrainer, DMTrainState

        model = FlowDiffusion(cfg.lfae, cfg.diffusion, device=dev, training=True)
        weights = self.weights()
        for n in PARTS:
            getattr(model, n).load_state_dict(weights[n])
        del weights
        self.trainer = DMTrainer(cfg, steps_per_epoch=10 ** 9, model=model)
        self.state = DMTrainState(step=0)
        self.losses = []
        fault = ctx.overrides.get("fault")
        if fault:
            fault(self)
        adam = self.trainer.optimizer.adam
        named = {n: p for n, p in model.unet.named_parameters() if p.requires_grad}
        self.readings = hck.program_readings(
            self.step, named, lambda p: adam.state.get(p, {}).get("exp_avg"), cfg.dm_train.adam_betas[0])
        self.losses.clear()
        sync(dev)

    def weights(self) -> dict:
        with torch.device(self.ctx.device):
            ref = DMTraining(self.exp)
        return {n: seeded_state(getattr(ref, n), self.ctx.seed, n, self.ctx.device) for n in PARTS}

    def batch(self, k: int) -> dict:
        """Step k's rows and draws."""
        dev, b, d = self.ctx.device, self.traffic["batch"], self.exp["diffusion"]
        g = generator(self.ctx.seed, "step", k, device=dev)
        videos = torch.randperm(self.corpus.shape[0], generator=g, device=dev)[:b]
        frames = torch.randint(0, self.corpus.shape[1], (b, d["num_frames"]), generator=g, device=dev)
        frames = frames.sort(dim=1).values
        frames[:, 0] = 0
        real = self.corpus[videos[:, None], frames].float() / 255.0
        return {"ref_img": real[:, 0], "real_vid": real, "cond": self.table[self.video_class[videos]],
                "t": torch.randint(0, d["timesteps"], (b,), generator=g, device=dev),
                "noise": torch.randn((b, d["num_frames"], d["img_size"], d["img_size"], 3),
                                     generator=g, device=dev),
                "null_mask": torch.rand(b, generator=g, device=dev) < d["null_cond_prob"]}

    def step(self, k: int) -> torch.Tensor:
        x = self.batch(k)
        self.state, m = self.trainer.train_step(
            self.state, None, {key: x[key] for key in ("ref_img", "real_vid", "cond")},
            t=x["t"], noise=x["noise"], null_mask=x["null_mask"])
        self.losses.append(m["loss"])
        return m["loss"]

    def unit(self, n: int) -> None:
        self.step(hck.CHECKED_STEPS + n)

    def after_window(self, units: int) -> tuple[int, int]:
        return units, int((~torch.isfinite(torch.stack(self.losses))).sum())

    def end_to_end(self, window_s: float, units: int) -> dict:
        return {"train_step_ms": window_s / units * 1e3}

    def install(self, inst) -> None:
        from cvpr23_lfdm_torch.ops import attention

        inst.span(self.trainer.model, "pseudo_ground_truth", "pseudo_ground_truth")
        inst.span(self.trainer.optimizer, "step", "optimizer")
        inst.record_calls(attention, "headpacked_temporal_attention", counts.HEADPACKED)

    def flops(self) -> float:
        """Product FLOPs of one step (the frozen LFAE's forward, the UNet's
        forward and backward), counted over the reference on `meta`."""
        with torch.device("meta"):
            ref = DMTraining(self.exp)
            ref.unet.requires_grad_(True)
            b, d = self.traffic["batch"], self.exp["diffusion"]
            s = self.exp["lfae"]["frame_shape"]
            shape = (b, d["num_frames"], d["img_size"], d["img_size"], 3)

            def step():
                loss = ref.loss(torch.empty(b, s, s, 3), torch.empty(b, d["num_frames"], s, s, 3),
                                torch.empty(b, d["cond_dim"]), torch.zeros(b, dtype=torch.long),
                                torch.empty(shape), torch.zeros(b, dtype=torch.bool))
                loss.backward()

            return counts.meta_flops(step)

    def check(self) -> dict:
        del self.trainer, self.losses
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        return hck.training_numbers(self.readings, self.reference())

    def reference(self, precision=None) -> dict:
        """The reference's readings over the checked steps, the batch in
        blocks of `reference_rows` rows (the loss is a mean over rows, so
        the blocks' gradients add up to the batch's). Under `precision`
        (the control) the UNet is computed in it and the frozen fp32 LFAE
        with TF32, each the precision below the configuration's."""
        from portbench.reference import diffusion
        from portbench.reference.precision import emulate, tf32

        with torch.device(self.ctx.device):
            ref = DMTraining(self.exp)
        weights = self.weights()
        for n in PARTS:
            getattr(ref, n).load_state_dict(weights[n])
        del weights
        ref.unet.requires_grad_(True)
        b, rows = self.traffic["batch"], self.traffic["reference_rows"]
        sched = diffusion.Schedule(self.exp["diffusion"]["timesteps"], self.ctx.device)

        def loss_and_backward(k):
            x = self.batch(k)
            total = 0.0
            for r in range(0, b, rows):
                s = slice(r, min(r + rows, b))
                with tf32(precision is not None):
                    x_start, fea = ref.pseudo_ground_truth(x["ref_img"][s], x["real_vid"][s])
                with emulate(precision) if precision else contextlib.nullcontext():
                    loss = diffusion.p_losses(ref.unet, sched, x_start, fea, x["cond"][s], x["t"][s],
                                              x["noise"][s], x["null_mask"][s]) * ((s.stop - s.start) / b)
                loss.backward()
                total += float(loss.detach())
            return total

        t = self.exp["dm_train"]
        return hck.reference_readings(loss_and_backward, dict(ref.unet.named_parameters()), t["lr"], t["adam_betas"])
