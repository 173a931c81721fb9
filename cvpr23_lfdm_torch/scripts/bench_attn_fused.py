"""Kernel-level sweep of the fused temporal-attention layer.

Counterpart of the JAX package's `scripts/bench_attn_fused.py`: times ONE
PreNorm temporal-attention layer at the serving hot shape
(`[8, 40, 1024, 64]` bf16) as `pallas2` plus its glue (LayerNorm, the qkv
product, row 4's head-packed kernel `csrc/headpacked_attention.cu`, the
out-projection and the residual, as the JAX script's `pallas2_layer`)
against the fused layer, row 1 (`csrc/fused_temporal_layer.cu`), under its
own launch plan and, with `--cluster`, under each cluster size K forced
through `ops/attention.py::temporal_layer_plan(..., cluster=K)`. Ten
chained layers per timing (CUDA events, median of 10 after 3 warm-ups).
Each variant also gives its max-abs error against the plain layer
(`fused_temporal_layer_plain`) on the same input.

The JAX script's `--pm` (pixels per matmul) and `--pack` are tiling knobs of
the TPU kernel with no counterpart here; the port's knob is the cluster
size, `--cluster`. Either flag at another value than its default raises.

Usage: python -m cvpr23_lfdm_torch.scripts.bench_attn_fused [--cluster 1 2 4 8]
           [--batch 8] [--hw 1024] [--dim 64] [--frames 40] [--device cpu]
"""

from __future__ import annotations

import argparse
import functools

import torch

from cvpr23_lfdm_torch.ops import attention as attn_ops
from cvpr23_lfdm_torch.scripts._common import add_device_arg, card_line, emit
from cvpr23_lfdm_torch.utils.device import resolve_device
from cvpr23_lfdm_torch.utils.profiling import time_fn

HEADS, D = 8, 32
STEPS = 10  # chained layers per timing
# the fused layer against the plain layer, elementwise |out - ref| <= atol +
# rtol * |ref|: both round to bf16 at the same points, a value on the other
# side of a rounding boundary moves by one bf16 ulp (`chip_smoke.py`'s TOL)
TOL = {"atol": 3e-2, "rtol": 2e-2}
JAX_DEFAULTS = {"pm": [1, 2, 4], "pack": [32]}


def layer_args(b: int, f: int, hw: int, c: int, device, dtype=torch.bfloat16, seed: int = 0):
    """Seeded arguments of one layer (`fused_temporal_layer`'s order)."""
    hd = HEADS * D
    g = torch.Generator().manual_seed(seed)
    to = lambda t, dt=dtype: t.to(device=device, dtype=dt)
    x = to(torch.randn(b, f, hw, c, generator=g))
    gamma = to(1 + 0.1 * torch.randn(c, generator=g), torch.float32)
    wqkv = to(torch.randn(c, 3 * hd, generator=g) * c ** -0.5)
    wout = to(torch.randn(hd, c, generator=g) * hd ** -0.5)
    pos_bias = to(torch.randn(HEADS, f, f, generator=g), torch.float32)
    bias_flat = attn_ops.build_bias_flat(pos_bias, b, f)
    cos_t, sin_t = attn_ops.rotary_tables(f, HEADS, D, D ** -0.5, dtype, device)
    return (x, gamma, wqkv, wout, bias_flat, cos_t, sin_t, HEADS, D)


def pallas2_layer(x, gamma, wqkv, wout, bias_flat, cos_t, sin_t, heads, d, eps: float = 1e-5):
    """LN (fp32 statistics, normalised in x's dtype) -> qkv -> row 4 ->
    out-projection + residual, as the JAX script's `pallas2_layer`."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    xn = (x - mean.to(x.dtype)) * torch.rsqrt(var + eps).to(x.dtype) * gamma.to(x.dtype)
    o = attn_ops.headpacked_temporal_attention(xn @ wqkv, bias_flat, cos_t, sin_t, heads, d)
    return x + o @ wout


def check_unported(args) -> None:
    """The TPU kernel's tiling flags raise at any value but their defaults."""
    for flag, default in JAX_DEFAULTS.items():
        if getattr(args, flag) != default:
            raise SystemExit(f"--{flag}: a tiling knob of the TPU kernel with no counterpart on "
                             "the card; the port's knob is the cluster size, --cluster")


def run(batch: int = 8, hw: int = 1024, dim: int = 64, frames: int = 40, clusters=(),
        device=None, iters: int = 10, warmup: int = 3) -> list:
    """One record per variant: `{"variant", "layer_ms", "max_abs_err",
    "within_tol"}` (`fused_cluster{K}` for each forced K that divides the
    heads; `within_tol`: the fused layer's output against the plain layer's
    at `TOL`, None for `pallas2+glue`, which rounds at other points)."""
    device = resolve_device(device)
    args = layer_args(batch, frames, hw, dim, device)
    for k in clusters:
        if k < 1 or HEADS % k:
            raise ValueError(f"--cluster {k}: must divide the {HEADS} heads")
    with torch.no_grad():
        ref = attn_ops.fused_temporal_layer_plain(*args).float()
        variants = [("pallas2+glue", lambda x: pallas2_layer(x, *args[1:])),
                    ("fused", lambda x: attn_ops.fused_temporal_layer(x, *args[1:]))]
        variants += [(f"fused_cluster{k}", lambda x: attn_ops.fused_temporal_layer(x, *args[1:]), k)
                     for k in clusters]
        records = []
        for label, fn, *forced in variants:
            saved = attn_ops.temporal_layer_plan
            if forced:
                attn_ops.temporal_layer_plan = functools.partial(saved, cluster=forced[0])
            try:
                diff = (fn(args[0]).float() - ref).abs()
                within = None if label == "pallas2+glue" else bool(
                    (diff <= TOL["atol"] + TOL["rtol"] * ref.abs()).all())

                def loop(fn=fn):
                    h = args[0]
                    for _ in range(STEPS):
                        h = fn(h).to(h.dtype)
                    return h

                res = time_fn(loop, iters=iters, warmup=warmup, device=device)
            finally:
                attn_ops.temporal_layer_plan = saved
            records.append({"variant": label, "layer_ms": res["median_ms"] / STEPS,
                            "max_abs_err": float(diff.max()), "within_tol": within, "clock": res["clock"]})
    return records


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cluster", type=int, nargs="*", default=[],
                    help="also the fused layer under each cluster size K (K divides the 8 heads)")
    ap.add_argument("--pm", type=int, nargs="+", default=JAX_DEFAULTS["pm"],
                    help="TPU tiling knob: no counterpart (raises at another value)")
    ap.add_argument("--pack", type=int, nargs="+", default=JAX_DEFAULTS["pack"],
                    help="TPU tiling knob: no counterpart (raises at another value)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--hw", type=int, default=1024)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--frames", type=int, default=40)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    check_unported(args)
    device = resolve_device(args.device)
    card = card_line(device)
    records = run(args.batch, args.hw, args.dim, args.frames, tuple(args.cluster), device)
    shape = [args.batch, args.frames, args.hw, args.dim]
    for rec in records:
        emit({**rec, "shape": shape, "dtype": "bfloat16", "card": card})
    return records


if __name__ == "__main__":
    main()
