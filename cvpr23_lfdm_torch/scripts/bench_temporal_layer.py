"""Device time of the fused temporal-attention layer at the serving shapes.

Times `ops.attention.fused_temporal_layer` (`csrc/fused_temporal_layer.cu`)
at the seven shapes one `pallas3` UNet eval gives it (`_common.
TEMPORAL_SHAPES`: B=1, F=40, 8 heads of 32 channels, bf16; seeded inputs):
per call its device time alone (torch.profiler over 10 calls, one kernel per
call) and its time by CUDA events around the wrapper (the wrapper's host
work included), and the sum of the device times over the 100 calls of one
serving video (10 DDIM evals).

The reading uses only the layer's public function, so the file can time
another checkout of the package (this version or a later one) in turns with
this one: run it by path with that checkout first on PYTHONPATH.
`--scan` also times the bf16 kernel under every cluster size K that divides
the 8 heads, forced through `ops.attention.temporal_layer_plan(...,
cluster=K)`, each against the plain layer (max abs error). The ablation
builds at these shapes: `bench_attn_ablate --serving`.

Usage: python -m cvpr23_lfdm_torch.scripts.bench_temporal_layer [--scan]
"""

from __future__ import annotations

import argparse
import functools

import torch

from cvpr23_lfdm_torch.ops import attention as attn_ops
from cvpr23_lfdm_torch.scripts._common import TEMPORAL_SHAPES, add_device_arg, card_line, emit
from cvpr23_lfdm_torch.utils.device import resolve_device
from cvpr23_lfdm_torch.utils.profiling import device_ms, time_fn

F, HEADS, D = 40, 8, 32
DDIM_STEPS = 10


def make_args(c: int, hw: int, device, seed: int = 0):
    """Seeded arguments of one layer at `[1, F, HW, C]`, bf16."""
    g = torch.Generator().manual_seed(seed)
    hd = HEADS * D
    to = lambda t, dt=torch.bfloat16: t.to(device=device, dtype=dt)
    x = to(torch.randn(1, F, hw, c, generator=g))
    gamma = to(1 + 0.1 * torch.randn(c, generator=g), torch.float32)
    wqkv = to(torch.randn(c, 3 * hd, generator=g) * c ** -0.5)
    wout = to(torch.randn(hd, c, generator=g) * hd ** -0.5)
    bias = attn_ops.build_bias_flat(to(torch.randn(HEADS, F, F, generator=g), torch.float32), 1, F)
    cos_t, sin_t = attn_ops.rotary_tables(F, HEADS, D, D ** -0.5, torch.bfloat16, device)
    return (x, gamma, wqkv, wout, bias, cos_t, sin_t, HEADS, D)


def kernel_ms(call) -> float:
    """Device ms per call of `call` (one kernel); raises when torch.profiler
    lost kernels twice."""
    ms = device_ms(call, launches=1)
    if ms is None:
        raise RuntimeError("bench_temporal_layer: the profiler lost kernels; read again")
    return ms


def run(scan: bool = False) -> list:
    """Lines of the reading: one per shape (`device_ms`, `call_ms`, and with
    `scan` the device time under each cluster size), then the sum over one
    serving video."""
    lines, per_video = [], 0.0
    with torch.no_grad():
        for (c, hw), n_eval in TEMPORAL_SHAPES.items():
            args = make_args(c, hw, "cuda")
            call = lambda: attn_ops.fused_temporal_layer(*args)
            line = {"shape": [1, F, hw, c], "calls_per_video": n_eval * DDIM_STEPS,
                    "device_ms": kernel_ms(call), "call_ms": time_fn(call)["median_ms"]}
            per_video += n_eval * DDIM_STEPS * line["device_ms"]
            if scan:
                ref = attn_ops.fused_temporal_layer_plain(*args).float()
                line["cluster_scan"] = {}
                for k in (d for d in range(1, 9) if HEADS % d == 0):
                    plan = functools.partial(attn_ops.temporal_layer_plan, cluster=k)
                    saved, attn_ops.temporal_layer_plan = attn_ops.temporal_layer_plan, plan
                    try:
                        err = float((call().float() - ref).abs().max())
                        line["cluster_scan"][f"K={k}"] = {"device_ms": kernel_ms(call),
                                                         "max_abs_err": err}
                    except (RuntimeError, ValueError) as e:
                        line["cluster_scan"][f"K={k}"] = str(e)[:80]
                    finally:
                        attn_ops.temporal_layer_plan = saved
            lines.append(line)
    lines.append({"device_ms_per_video": per_video,
                  "calls_per_video": sum(TEMPORAL_SHAPES.values()) * DDIM_STEPS})
    return lines


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scan", action="store_true", help="also every cluster size K")
    add_device_arg(ap)
    args = ap.parse_args()
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise RuntimeError("bench_temporal_layer: reads device time; needs the card")
    card = card_line(device)
    for line in run(args.scan):
        emit({**line, "dtype": "bfloat16", "card": card})


if __name__ == "__main__":
    main()
