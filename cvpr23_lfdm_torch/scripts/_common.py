"""Shared pieces of the port's bench scripts: the `--device` flag, the
repository's bench checkpoint, the two fused layers' serving shapes and
their one bench (`run_layer`), one JSON object per output line."""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
from typing import Callable, NamedTuple

import torch


ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH_CKPT = os.path.join(ROOT, "assets", "bench_ckpt")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (C, HW) of the temporal layer's calls in one `pallas3` UNet eval of the MUG
# config (B=1, F=40, 8 heads of 32) and their count per eval
TEMPORAL_SHAPES = {(64, 1024): 3, (128, 256): 1, (64, 256): 1, (256, 64): 1,
                   (128, 64): 1, (512, 16): 2, (256, 16): 1}
# the same for the linear-attention layer's calls
LINEAR_SHAPES = {(64, 1024): 2, (128, 256): 1, (256, 64): 1, (512, 16): 1,
                 (256, 16): 1, (128, 64): 1, (64, 256): 1}
F, HEADS, D = 40, 8, 32  # frames, heads and channels per head of those calls
DDIM_STEPS = 10  # UNet evals per serving video


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


def layer_inputs(c: int, hw: int, device, seed: int = 0):
    """Seeded inputs that both fused layers take, at `[1, F, HW, C]`: x,
    W_qkv and W_out in bf16, gamma in fp32; and the generator, for the
    layer's own inputs after them."""
    g = torch.Generator().manual_seed(seed)
    hd = HEADS * D
    to = lambda t, dt=torch.bfloat16: t.to(device=device, dtype=dt)
    x = to(torch.randn(1, F, hw, c, generator=g))
    gamma = to(1 + 0.1 * torch.randn(c, generator=g), torch.float32)
    wqkv = to(torch.randn(c, 3 * hd, generator=g) * c ** -0.5)
    wout = to(torch.randn(hd, c, generator=g) * hd ** -0.5)
    return g, (x, gamma, wqkv, wout)


class LayerBench(NamedTuple):
    """One fused layer's bench (`run_layer`): its function and plain
    version, `make_args(c, hw, device)`, its serving shapes {(C, HW): calls
    per eval}, its device launches per call, the name of its plan in
    `ops.attention`, `scan(hw)` -> {label: keyword arguments of the plan}
    (the plans `--scan` forces), and the parts of its kernels' names whose
    device time is read apart (`by`)."""
    name: str
    fn: Callable
    plain: Callable
    make_args: Callable
    shapes: dict
    launches: int
    plan: str
    scan: Callable
    by: tuple = ()


def run_layer(layer: LayerBench, scan: bool = False) -> list:
    """Lines of one layer's reading, bf16 on the card: one per serving shape
    (device ms per call from torch.profiler over 10 calls, and per launch
    with `layer.by`; call ms by CUDA events around the function, its host
    work included; with `scan` the device time and max abs error against
    the plain layer under each plan `layer.scan` forces), then the sum of
    the device times over one serving video. Uses only the layer's public
    function and plan, so it can time another checkout of the package."""
    from cvpr23_lfdm_torch.ops import attention as attn_ops
    from cvpr23_lfdm_torch.utils.profiling import device_ms, time_fn

    if not torch.cuda.is_available():
        raise RuntimeError(f"{layer.name}: the bench reads device time; needs the card")

    def reading(call) -> dict:
        ms = device_ms(call, launches=layer.launches, by=layer.by)
        if ms is None:
            raise RuntimeError(f"{layer.name}: the profiler lost kernels; read again")
        if not layer.by:
            return {"device_ms": ms}
        return {"device_ms": ms["total"], "device_ms_by_launch": {k: ms[k] for k in layer.by}}

    lines, per_video = [], 0.0
    with torch.no_grad():
        for (c, hw), n_eval in layer.shapes.items():
            args = layer.make_args(c, hw, "cuda")
            call = lambda: layer.fn(*args)
            line = {"shape": [1, F, hw, c], "calls_per_video": n_eval * DDIM_STEPS,
                    **reading(call), "call_ms": time_fn(call)["median_ms"]}
            per_video += n_eval * DDIM_STEPS * line["device_ms"]
            if scan:
                ref = layer.plain(*args).float()
                saved = getattr(attn_ops, layer.plan)
                line["plan_scan"] = {}
                for label, kwargs in layer.scan(hw).items():
                    setattr(attn_ops, layer.plan, functools.partial(saved, **kwargs))
                    try:
                        err = float((call().float() - ref).abs().max())
                        line["plan_scan"][label] = {**reading(call), "max_abs_err": err}
                    except (RuntimeError, ValueError) as e:
                        line["plan_scan"][label] = str(e)[:80]
                    finally:
                        setattr(attn_ops, layer.plan, saved)
            lines.append(line)
    lines.append({"device_ms_per_video": per_video,
                  "calls_per_video": sum(layer.shapes.values()) * DDIM_STEPS})
    return lines


def layer_main(layer: LayerBench, doc: str) -> None:
    """Command line of a layer bench: `[--scan]`, card only."""
    from cvpr23_lfdm_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--scan", action="store_true", help="also every plan the layer's scan forces")
    add_device_arg(ap)
    args = ap.parse_args()
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise RuntimeError(f"{layer.name}: the bench reads device time; needs the card")
    card = card_line(device)
    for line in run_layer(layer, args.scan):
        emit({**line, "dtype": "bfloat16", "card": card})
