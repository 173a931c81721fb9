"""Shared pieces of the port's bench scripts: the `--device` flag, the
repository's bench checkpoint, the temporal layer's serving shapes, one JSON
object per output line."""

from __future__ import annotations

import json
import os
import subprocess

import torch


ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH_CKPT = os.path.join(ROOT, "assets", "bench_ckpt")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (C, HW) of the temporal layer's calls in one `pallas3` UNet eval of the MUG
# config (B=1, F=40, 8 heads of 32) and their count per eval
TEMPORAL_SHAPES = {(64, 1024): 3, (128, 256): 1, (64, 256): 1, (256, 64): 1,
                   (128, 64): 1, (512, 16): 2, (256, 16): 1}


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises when there is none); "
                         "'cpu' rehearses the script on the kernels' plain versions")


def card_line(device: torch.device) -> str:
    """The card's name and power limit as `nvidia-smi` prints them, or
    `cpu` for a CPU rehearsal."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    return out[device.index or 0]


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)
