"""Row 7's bench: the fused GroupNorm+FiLM+SiLU at the UNet's Block shapes.

For each Block shape of one `fused_norm` UNet eval at the MUG serving
width (`NORM_SHAPES`: F = 40, bf16), with and without FiLM, at each batch
size: the device time per call of `ops.norm.groupnorm_film_silu`
(torch.profiler, the kernels alone, over 10 calls), the device launches
per call (every device activity of the call, casts and copies included),
the call time (CUDA events around the function, its host work included),
the plain version's call time, and the byte bound (x read once, y written
once, at 3.35 TB/s); then the sums over one eval and the device time's
share of the bound. The arguments go in as the bf16 UNet passes them: the
FiLM pair as the halves of one `[B, 1, 1, 1, 2C]` tensor, the conv bias
as `pre_bias`. The device time is read once more without the bias
(`device_ms_no_bias`), the form an fp32 Block runs.

Usage: python -m cvpr23_lfdm_torch.scripts.bench_norm [--batch 1 8 32]
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM


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


def pre_bias(c: int, device, seed: int = 0):
    """A seeded bf16 conv bias `[C]`, as a bf16 Block's convolution leaves
    it to add after its rounded product."""
    g = torch.Generator().manual_seed(seed + 1)
    return (0.5 * torch.randn(c, generator=g)).to(device, torch.bfloat16)


def bound_ms(b: int, h: int, c: int, esz: int = 2) -> float:
    """The least time of one call: x read once and y written once."""
    return 2 * b * F * h * h * c * esz / HBM_BYTES_PER_S * 1e3


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
    fn, plain = norm_ops.groupnorm_film_silu, norm_ops.groupnorm_film_silu_plain
    keys = ("device_ms", "device_ms_no_bias", "call_ms", "plain_ms", "bound_ms", "launches_per_call")
    lines = []
    with torch.no_grad():
        for b in batches:
            per_eval = dict.fromkeys(keys, 0.0)
            for (h, c), counts in NORM_SHAPES.items():
                for film, calls in zip((True, False), counts):
                    args = make_args(b, h, c, film, device)
                    bias = pre_bias(c, device)
                    call = lambda: fn(*args, pre_bias=bias)
                    ms, n, other = device_reading(call)
                    line = {"batch": b, "shape": [b, F, h, h, c], "film": film, "calls_per_eval": calls,
                            "device_ms": ms, "device_ms_no_bias": device_reading(lambda: fn(*args))[0],
                            "launches_per_call": n, "other_launches_per_call": other,
                            "call_ms": time_fn(call)["median_ms"],
                            "plain_ms": time_fn(lambda: plain(*args, pre_bias=bias))["median_ms"],
                            "bound_ms": bound_ms(b, h, c)}
                    lines.append(line)
                    for k in keys:
                        per_eval[k] += calls * line[k]
            lines.append({"batch": b, **{f"{k.removesuffix('_per_call')}_per_eval": v for k, v in per_eval.items()},
                          "bound_share_pct": 100.0 * per_eval["bound_ms"] / per_eval["device_ms"],
                          "calls_per_eval": BLOCKS_PER_EVAL})
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
