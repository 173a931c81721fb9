"""Full-scale parity of the UNet's forms on the serving path.

Counterpart of the JAX package's `scripts/check_kernel_parity.py`: runs the
MUG-scale sampling pipeline (128² frames, 32² latent, 40 frames, DDIM-10,
cond_scale 1) once per UNet form on identical weights (the bench
checkpoint), the checkpoint's reference frame and condition, and an
identical injected noise sequence, and reports the largest difference of
every output against the first form. The forms compute one function; the
CPU tests pin that at toy shapes through the plain versions, this checks
the kernels at the real shapes and precision.

Usage: python -m cvpr23_lfdm_torch.scripts.check_kernel_parity
           [--dtype float32|bfloat16] [--impls xla pallas pallas3]
Exit code 1 if a max |diff| exceeds the dtype's tolerance (5e-4 in fp32,
where TF32 is switched off for the run; 5e-2 in bf16).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from cvpr23_lfdm_torch.config import mug_config
from cvpr23_lfdm_torch.scripts._common import BENCH_CKPT, add_device_arg, card_line, emit
from cvpr23_lfdm_torch.utils.bench_ckpt import apply_bench_ckpt
from cvpr23_lfdm_torch.utils.device import resolve_device

TOL = {"float32": 5e-4, "bfloat16": 5e-2}
KEYS = ("vid_grid", "vid_conf", "out_vid", "warped_vid")


def run(dtype: str = "float32", impls=("xla", "pallas", "pallas3"), device=None) -> dict:
    """Sample one video per form; `{"diffs": {impl: {key: max-abs vs
    impls[0]}}, "tol", "ok"}`."""
    device = resolve_device(device)
    base = mug_config()
    d = base.diffusion
    steps = 10
    rng = np.random.RandomState(0)
    shape = (1, d.num_frames, d.img_size, d.img_size, 3)
    init = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device)
    noises = torch.from_numpy(rng.randn(steps, *shape).astype(np.float32)).to(device)

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    if dtype == "float32":  # a TF32 product rounds each form differently
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        outs = {}
        for impl in impls:
            c = base.replace(
                diffusion=dataclasses.replace(d, sampling_timesteps=steps, compute_dtype=dtype,
                                              temporal_attn_impl=impl),
                lfae=dataclasses.replace(base.lfae, compute_dtype=dtype),
            )
            _, model, cond, ref, _ = apply_bench_ckpt(BENCH_CKPT, c, device=device)
            out = model.sample_video(ref, cond, 1.0, init_img=init, noise_seq=noises)
            outs[impl] = {k: out[k].float().cpu() for k in KEYS}
            del model, out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    first = impls[0]
    diffs = {impl: {k: float((outs[impl][k] - outs[first][k]).abs().max()) for k in KEYS}
             for impl in impls[1:]}
    finite = all(bool(torch.isfinite(t).all()) for o in outs.values() for t in o.values())
    ok = finite and all(v <= TOL[dtype] for dd in diffs.values() for v in dd.values())
    return {"dtype": dtype, "against": first, "diffs": diffs, "tol": TOL[dtype],
            "finite": finite, "ok": ok, "card": card_line(device)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="float32", choices=list(TOL))
    ap.add_argument("--impls", nargs="+", default=["xla", "pallas", "pallas3"])
    add_device_arg(ap)
    args = ap.parse_args()
    res = run(args.dtype, tuple(args.impls), args.device)
    for impl, dd in res["diffs"].items():
        for key, v in dd.items():
            status = "ok" if v <= res["tol"] else "FAIL"
            print(f"{key:12s} max|{res['against']} - {impl}| = {v:.3e}  [{status}]")
    emit(res)
    sys.exit(0 if res["ok"] else 1)


if __name__ == "__main__":
    main()
