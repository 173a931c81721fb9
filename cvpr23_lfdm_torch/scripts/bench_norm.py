"""Row 7's bench: the fused GroupNorm+FiLM+SiLU at the UNet's Block shapes.

For each Block shape of one `fused_norm` UNet eval at the MUG serving
width (`NORM_SHAPES`: F = 40, bf16), with and without FiLM, at each batch
size: the device time per call of `ops.norm.groupnorm_film_silu`
(torch.profiler, the kernels alone, over 10 calls), the device launches
per call (every device activity of the call, casts and copies included),
and the call time (CUDA events around the function, its host work
included); then the sums over one eval. The FiLM pair goes in as the UNet
passes it: the bf16 halves of one `[B, 1, 1, 1, 2C]` tensor. The script
uses only the public function and the package's timing helpers, so it can
time another checkout of the package: `PYTHONPATH=<checkout> python
<this file>`.

Usage: python -m cvpr23_lfdm_torch.scripts.bench_norm [--batch 1 8]
"""

from __future__ import annotations

import argparse

import torch

from cvpr23_lfdm_torch.ops import norm as norm_ops
from cvpr23_lfdm_torch.scripts._common import add_device_arg, card_line, emit
from cvpr23_lfdm_torch.utils.device import resolve_device
from cvpr23_lfdm_torch.utils.profiling import profile_rows, time_fn

F = 40
# Blocks of one UNet eval: (H, C) -> (Blocks with FiLM, Blocks without)
NORM_SHAPES = {(32, 64): (4, 8), (16, 128): (2, 2), (16, 64): (2, 2), (8, 256): (2, 2),
               (8, 128): (2, 2), (4, 512): (4, 4), (4, 256): (2, 2)}
BLOCKS_PER_EVAL = 40  # 20 ResnetBlocks of two Blocks each


def make_args(b: int, h: int, c: int, film: bool, device, seed: int = 0):
    """Seeded arguments of one Block's call, laid out as the bf16 UNet
    passes them: x `[B, F, H, H, C]` bf16, fp32 gamma and beta, and the FiLM
    pair as the two bf16 halves of one `[B, 1, 1, 1, 2C]` tensor."""
    g = torch.Generator().manual_seed(seed)
    x = (1.5 * torch.randn(b, F, h, h, c, generator=g) + 0.3).to(device, torch.bfloat16)
    gamma = (1 + 0.3 * torch.randn(c, generator=g)).to(device)
    beta = (0.2 * torch.randn(c, generator=g)).to(device)
    ss = ()
    if film:
        ss = torch.randn(b, 1, 1, 1, 2 * c, generator=g).to(device, torch.bfloat16).chunk(2, dim=-1)
    return (x, gamma, beta, *ss)


def device_reading(call, reps: int = 10, kernel: str = "groupnorm_film_silu_kernel"):
    """(device ms per call, device activities per call, those of them not
    named `kernel` per call) of `call` under torch.profiler over `reps`
    calls after a warm-up call. The profiler now and then records only part
    of a run's kernels, or none, and never more than ran: so the reading is
    taken until two in a row agree on a count that is not 0 (at most four
    times); the time and count are the reading with the most activities,
    the other activities (casts, copies) the most any reading saw."""
    from torch.profiler import ProfilerActivity, profile

    readings = []
    while len(readings) < 4 and not (len(readings) >= 2 and readings[-1][0] == readings[-2][0] > 0):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        rows = [r for r in profile_rows(prof) if r["on_device"]]
        readings.append((sum(r["count"] for r in rows) / reps, sum(r["device_ms"] for r in rows) / reps,
                         sum(r["count"] for r in rows if kernel not in r["name"]) / reps))
    n, ms, _ = max(readings)
    return ms, n, max(r[2] for r in readings)


def one_launch(n: float, other: float, launches: int = 1) -> bool:
    """Whether a `device_reading` shows `launches` launches of the kernel per
    call and nothing else: no other activity, and a count in (0, launches]
    (the profiler may lose some kernels, never add one)."""
    return other == 0 and 0 < n <= launches


def run(batches=(1, 8), device="cuda") -> list:
    """Lines of the reading: one per (batch, shape, FiLM), then one per
    batch with the sums over one eval."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_norm reads device time; needs the card")
    lines = []
    with torch.no_grad():
        for b in batches:
            per_eval, launches = 0.0, 0.0
            for (h, c), counts in NORM_SHAPES.items():
                for film, calls in zip((True, False), counts):
                    args = make_args(b, h, c, film, device)
                    call = lambda: norm_ops.groupnorm_film_silu(*args)
                    ms, n, other = device_reading(call)
                    lines.append({"batch": b, "shape": [b, F, h, h, c], "film": film,
                                  "calls_per_eval": calls, "device_ms": ms, "launches_per_call": n,
                                  "other_launches_per_call": other,
                                  "call_ms": time_fn(call)["median_ms"]})
                    per_eval += calls * ms
                    launches += calls * n
            lines.append({"batch": b, "device_ms_per_eval": per_eval,
                          "launches_per_eval": launches, "calls_per_eval": BLOCKS_PER_EVAL})
    return lines


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 8])
    add_device_arg(ap)
    args = ap.parse_args()
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise RuntimeError("bench_norm reads device time; needs the card")
    card = card_line(device)
    for line in run(tuple(args.batch), device):
        emit({**line, "dtype": "bfloat16", "card": card})


if __name__ == "__main__":
    main()
