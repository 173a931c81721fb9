"""Serving: a closed loop of `FlowDiffusion.sample_video` calls.

Traffic keys (`TRAFFIC`; any other is refused): `batch` videos per call,
`frame_pool` synthetic reference frames, `warmup_calls`, `checked_calls`,
`reference_rows` and `trace_units`. One client waits for each call before
it sends the next (`closed_loop`). Call i
takes `batch` distinct frames of the pool and `batch` class embeddings of
the configuration's classes, and its sampler's gaussians, all drawn on the
device from `(seed, i)` and injected, so that the reference can make the
same inputs again.

`correct`: after the window, `checked_calls` calls drawn from the seed
among those finished (a reservoir kept while the window runs) are run
again by the fp32 reference from the same inputs, `reference_rows` videos
at a time (each video is sampled on its own: the threshold and the norms
are per video). `latent_gap` is the relative L2 gap of the sampled latent
volumes (flow and occlusion in the diffusion's space), `video_rel_gap`
that of the videos (`numbers`). Together they cover the encoder feature, the DDIM sampler with its
dynamic threshold through the UNet (rows 1 and 2) and the decode (row 3).
"""

from __future__ import annotations

import contextlib
import gc
import random

import torch

from portbench.harness import config as hc
from portbench.harness import counts
from portbench.harness.check import rel_gap
from portbench.harness.core import sync
from portbench.harness.frames import blob_videos
from portbench.harness.weights import generator, seeded_state, sub_seed
from portbench.reference.model import Serving


TRAFFIC = {"batch", "frame_pool", "warmup_calls", "checked_calls", "reference_rows", "trace_units"}


class Driver:
    closed_loop = True

    def __init__(self, ctx):
        self.ctx = ctx
        dev = ctx.device
        self.traffic = hc.traffic(ctx, TRAFFIC)
        self.exp = hc.experiment(ctx.cell.config, ctx.overrides)
        self.form = {**ctx.cell.config["forms"]["serve"], **ctx.overrides.get("form", {})}
        hc.set_tf32(self.form)
        self.trace_units = self.traffic["trace_units"]
        cfg = hc.program_config(self.exp, self.form)
        self.frames_per_video = cfg.diffusion.num_frames

        from cvpr23_lfdm_torch.diffusion.flow_diffusion import FlowDiffusion

        self.model = FlowDiffusion(cfg.lfae, cfg.diffusion, device=dev)
        weights = self.weights()
        self.model.unet.load_state_dict(weights["unet"])
        self.model.generator.load_state_dict(weights["generator"])
        del weights
        size = self.exp["lfae"]["frame_shape"]
        self.pool = blob_videos(ctx.seed, "serve_pool", self.traffic["frame_pool"], 1, size, dev)[:, 0]
        self.table = torch.randn(ctx.cell.config["num_classes"], self.exp["diffusion"]["cond_dim"],
                                 generator=generator(ctx.seed, "classes", device=dev), device=dev)
        self.kept, self.rng = {}, random.Random(sub_seed(ctx.seed, "checked"))
        self.window_units = float("inf")
        self.bad = torch.zeros((), dtype=torch.long, device=dev)
        for i in range(self.traffic["warmup_calls"]):
            self.call(-1 - i)
        sync(dev)
        fault = ctx.overrides.get("fault")
        if fault:
            fault(self)

    def weights(self) -> dict:
        """The seeded weights of the serving modules (the reference's names)."""
        with torch.device(self.ctx.device):
            ref = Serving(self.exp)
        return {n: seeded_state(getattr(ref, n), self.ctx.seed, n, self.ctx.device) for n in ("unet", "generator")}

    def inputs(self, i: int) -> dict:
        dev, b, d = self.ctx.device, self.traffic["batch"], self.exp["diffusion"]
        g = generator(self.ctx.seed, "call", i, device=dev)
        rows = torch.randperm(self.pool.shape[0], generator=g, device=dev)[:b]
        classes = torch.randint(0, self.table.shape[0], (b,), generator=g, device=dev)
        shape = (b, d["num_frames"], d["img_size"], d["img_size"], 3)
        steps = self.form["sampling_timesteps"]
        return {"ref": self.pool[rows].float() / 255.0, "cond": self.table[classes],
                "init": torch.randn(shape, generator=g, device=dev),
                "noise": torch.randn((steps,) + shape, generator=g, device=dev)}

    def call(self, i: int) -> dict:
        x = self.inputs(i)
        return self.model.sample_video(x["ref"], x["cond"], self.form["cond_scale"],
                                       init_img=x["init"], noise_seq=x["noise"])

    def unit(self, n: int) -> None:
        out = self.call(n)
        self.bad += (~torch.isfinite(out["out_vid"].flatten(1)).all(1)).sum()
        k = self.traffic["checked_calls"]
        out = {key: out[key] for key in ("vid_grid", "vid_conf", "out_vid")}
        if n >= self.window_units:  # a traced call after the window: not a request of it
            return
        if n < k:
            self.kept[n] = out
        else:
            j = self.rng.randrange(n + 1)
            if j < k:
                self.kept.pop(sorted(self.kept)[j])
                self.kept[n] = out

    def after_window(self, units: int) -> tuple[int, int]:
        self.window_units = units
        return units * self.traffic["batch"], int(self.bad)

    def end_to_end(self, window_s: float, units: int) -> dict:
        return {"frames_per_s": units * self.traffic["batch"] * self.frames_per_video / window_s}

    def install(self, inst) -> None:
        from cvpr23_lfdm_torch.ops import attention

        inst.span(self.model.generator, "compute_fea", "compute_fea")
        inst.span(self.model.diffusion, "sample", "sample")
        inst.span(self.model, "decode_latent", "decode_latent")
        inst.span(self.model, "decode_flow_video", "decode")
        inst.record_calls(attention, "fused_temporal_layer", counts.temporal_layer)
        inst.record_calls(attention, "fused_spatial_linear_layer", counts.linear_layer)

    def flops(self) -> float:
        """Product FLOPs of one call, counted over the reference on `meta`."""
        with torch.device("meta"):
            ref = Serving(self.exp)
            b, d = self.traffic["batch"], self.exp["diffusion"]
            s = self.exp["lfae"]["frame_shape"]
            shape = (b, d["num_frames"], d["img_size"], d["img_size"], 3)
            steps = self.form["sampling_timesteps"]
            return counts.meta_flops(lambda: ref.sample_video(
                torch.empty(b, s, s, 3), torch.empty(b, d["cond_dim"]), torch.empty(shape),
                torch.empty((steps,) + shape), steps))

    def check(self) -> dict:
        """Free the program, then run the reference over the kept calls."""
        kept = self.outputs()
        del self.model, self.kept
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        return numbers(kept, self.reference(sorted(kept)))

    def outputs(self) -> dict:
        """The kept calls' latent volumes (diffusion space) and videos."""
        return {i: {"latent": torch.cat([o["vid_grid"], o["vid_conf"] * 2.0 - 1.0], dim=-1).float(),
                    "video": o["out_vid"].float()} for i, o in self.kept.items()}

    @torch.no_grad()
    def reference(self, calls, precision=None) -> dict:
        """The reference's outputs for the given calls' inputs; under
        `precision` (`reference.precision.fp8_e4m3`), the control's."""
        from portbench.reference.precision import emulate

        with torch.device(self.ctx.device):
            ref = Serving(self.exp)
        weights = self.weights()
        ref.unet.load_state_dict(weights["unet"])
        ref.generator.load_state_dict(weights["generator"])
        out, rows = {}, self.traffic.get("reference_rows", self.traffic["batch"])
        with emulate(precision) if precision else contextlib.nullcontext():
            for i in calls:
                x = self.inputs(i)
                parts = [ref.sample_video(x["ref"][r:r + rows], x["cond"][r:r + rows], x["init"][r:r + rows],
                                          x["noise"][:, r:r + rows], self.form["sampling_timesteps"])
                         for r in range(0, self.traffic["batch"], rows)]
                out[i] = {"latent": torch.cat([p[0] for p in parts]), "video": torch.cat([p[1] for p in parts])}
        return out


def numbers(outputs: dict, reference: dict) -> dict:
    """`latent_gap` and `video_rel_gap`, |Δ| / |ref| over all compared
    calls of the latent volumes and of the videos, and `video_gap`, the
    widest gap of a pixel."""
    calls = sorted(reference)
    cat = lambda d, key: torch.cat([d[i][key] for i in calls])  # noqa: E731
    return {"latent_gap": rel_gap(cat(outputs, "latent"), cat(reference, "latent")),
            "video_rel_gap": rel_gap(cat(outputs, "video"), cat(reference, "video")),
            "video_gap": max(float((outputs[i]["video"] - reference[i]["video"]).abs().max()) for i in calls)}
