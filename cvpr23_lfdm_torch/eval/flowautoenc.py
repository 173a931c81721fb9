"""LFAE self-reconstruction evaluation (counterpart of
`cvpr23_lfdm_tpu/eval/flowautoenc.py`).

Reference: LFAE/test_flowautoenc_{mug,mhad,natops}.py: reconstruct every
frame of held-out videos from frame 0, accumulate the summed L1 of the
`prediction` and `deformed` outputs, and report per-pixel losses normalized
by `num_samples * H * W * 3` (test_flowautoenc_mug.py:208-215; the reference
does not divide by the frame count, kept for metric parity).

Frames fold into the batch `frame_chunk` at a time, one `FlowAE` call per
chunk in eval mode: on the card each call's warps are the decode-warp kernel
(`ops/warp.py::warp_video`, four launches: three decode scales and the
deformed source).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from cvpr23_lfdm_torch.config import LFAEConfig
from cvpr23_lfdm_torch.models.flow_autoenc import FlowAE
from cvpr23_lfdm_torch.utils.device import resolve_device

OUTPUTS = ("prediction", "deformed", "optical_flow", "occlusion_map")


def make_reconstruct_fn(lfae: FlowAE):
    """`(ref [B, H, W, 3], vid [B, F, H, W, 3]) -> {prediction, deformed,
    optical_flow, occlusion_map}`, each `[B, F, ...]`, from one frame-batched
    eval-mode call of `lfae` on its device."""

    @torch.no_grad()
    def run(ref_img: torch.Tensor, real_vid: torch.Tensor) -> dict:
        lfae.eval()
        b, f = real_vid.shape[:2]
        frames = real_vid.reshape((b * f,) + tuple(real_vid.shape[2:]))
        out = lfae(ref_img.repeat_interleave(f, dim=0), frames)
        return {k: out[k].reshape((b, f) + tuple(out[k].shape[1:])) for k in OUTPUTS}

    return run


def evaluate(lfae_state: dict, cfg: LFAEConfig, dataset, batch_size: int = 10,
             num_batches: int | None = None, save_video_dir: str | None = None,
             image_size: int = 128, frame_chunk: int = 8, device=None) -> dict:
    """Run the eval over a dataset (any object with `len` and `[i]` or
    `sample(i, epoch)` giving `{"video": [F, H, W, 3], "name": ...}`; the
    test split, uniform sampling, no jitter) and return `{"out_loss",
    "warp_loss"}`. `lfae_state`: a `FlowAE(cfg)` state dict (from
    `from_jax_params`, `load_lfae_from_torch` or a trainer); the model runs
    on `device`, the CUDA card unless it says otherwise.

    A ragged last chunk of frames runs at its natural size."""
    from cvpr23_lfdm_torch.data.loader import PrefetchLoader
    from cvpr23_lfdm_torch.utils.viz import conf2fig, grid2fig, save_gif, to_uint8

    dev = resolve_device(device)
    lfae = FlowAE(cfg)
    lfae.load_state_dict(lfae_state)
    run = make_reconstruct_fn(lfae.to(dev))
    # shuffle=False so the default pass covers exactly the test split once
    # (the reference evaluates the whole split in order,
    # test_flowautoenc_mug.py:131-171); ceil so the tail partial batch of
    # the infinite loader's first epoch is included, not dropped
    loader = PrefetchLoader(dataset, batch_size, shuffle=False, num_workers=4, drop_last=False)
    out_loss = warp_loss = 0.0
    num_sample = 0
    total = num_batches if num_batches is not None else max(1, -(-len(dataset) // batch_size))
    fetch = OUTPUTS if save_video_dir else ("prediction", "deformed")
    it = iter(loader)
    cnt = 0
    for _ in range(total):
        batch = next(it)
        v = np.asarray(batch["video"])
        vid = torch.from_numpy(v).to(dev, torch.float32)
        ref = vid[:, 0]
        chunks = []
        for s in range(0, v.shape[1], frame_chunk):
            piece = run(ref, vid[:, s: s + frame_chunk])
            chunks.append({k: piece[k].cpu().numpy() for k in fetch})
        out = {k: np.concatenate([c[k] for c in chunks], axis=1) for k in fetch}
        out_loss += np.abs(v - out["prediction"]).sum()
        warp_loss += np.abs(v - out["deformed"]).sum()
        num_sample += v.shape[0]
        if save_video_dir:
            os.makedirs(save_video_dir, exist_ok=True)
            for bi in range(v.shape[0]):
                frames = []
                for fi in range(v.shape[1]):
                    frames.append(np.concatenate([
                        to_uint8(v[bi, fi]),
                        to_uint8(out["prediction"][bi, fi]),
                        to_uint8(out["deformed"][bi, fi]),
                        grid2fig(out["optical_flow"][bi, fi], img_size=image_size),
                        np.repeat(conf2fig(out["occlusion_map"][bi, fi], image_size)[..., None], 3,
                                  axis=-1),
                    ], axis=1))
                save_gif(os.path.join(save_video_dir, f"{cnt:04d}_{batch['name'][bi]}.gif"),
                         np.stack(frames))
                cnt += 1

    denom = num_sample * image_size * image_size * 3
    return {"out_loss": float(out_loss / denom), "warp_loss": float(warp_loss / denom)}


def write_json(result: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(result, f)
