"""Time attribution for the fused temporal-attention kernel.

Counterpart of the JAX package's `scripts/bench_attn_ablate.py`: times
ablated builds of `csrc/fused_temporal_layer.cu` at the serving hot shape
(`[8, 40, 1024, 64]` bf16). Each variant is the kernel compiled with one of
its stages removed (LayerNorm, qkv projection, rotary, scores, softmax,
p.v, out-projection; `ops.attention.ABLATIONS`); `full - variant` attributes
device time to that stage. The variants are NOT numerically meaningful:
timing only. `full` is the serving kernel itself, and the script checks
that its output equals `ops.attention.fused_temporal_layer`'s bit for bit.
The TPU script's `kvbuild`, `kt` and `kt_vm` variants ablate the TPU
kernel's head-tiled K/V construction, which the CUDA kernel does not have.

All builds are started together (one `nvcc` each). The ablation builds exist
only as CUDA kernels, so this script needs the card.

Usage: python -m cvpr23_lfdm_torch.scripts.bench_attn_ablate [--variants full scores ...]
"""

from __future__ import annotations

import argparse

import torch

from cvpr23_lfdm_torch.ops import _build
from cvpr23_lfdm_torch.ops import attention as attn_ops
from cvpr23_lfdm_torch.scripts._common import add_device_arg, card_line, emit
from cvpr23_lfdm_torch.utils.device import resolve_device
from cvpr23_lfdm_torch.utils.profiling import time_fn

HEADS, D = 8, 32
VARIANTS = ("full",) + attn_ops.ABLATIONS


def make_args(shape=(8, 40, 1024, 64), dtype=torch.bfloat16, device="cuda", seed: int = 0):
    """Seeded arguments of one layer at `shape = [B, F, HW, C]`."""
    b, f, hw, c = shape
    hd = HEADS * D
    g = torch.Generator().manual_seed(seed)
    to = lambda t, dt=dtype: t.to(device=device, dtype=dt)
    x = to(torch.randn(b, f, hw, c, generator=g))
    gamma = to(torch.ones(c), torch.float32)
    wqkv = to(torch.randn(c, 3 * hd, generator=g) * c ** -0.5)
    wout = to(torch.randn(hd, c, generator=g) * hd ** -0.5)
    pos_bias = to(torch.randn(HEADS, f, f, generator=g), torch.float32)
    bias_flat = attn_ops.build_bias_flat(pos_bias, b, f)
    cos_t, sin_t = attn_ops.rotary_tables(f, HEADS, D, D ** -0.5, dtype, device)
    return (x, gamma, wqkv, wout, bias_flat, cos_t, sin_t, HEADS, D)


def run(variants=VARIANTS, shape=(8, 40, 1024, 64), device=None, iters: int = 10,
        warmup: int = 3) -> list:
    """Build the variants, time each; rows `{"variant", "layer_ms",
    "delta_vs_full"}` (`full` first; its row also says whether it is
    bit-equal to the serving kernel)."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("bench_attn_ablate: the ablation builds are CUDA kernels; needs the card")
    variants = ("full",) + tuple(v for v in variants if v != "full")
    built = _build.build([("fused_temporal_layer", attn_ops.ablation_defines(v)) for v in variants])
    args = make_args(shape, device=device)
    rows, base = [], None
    with torch.no_grad():
        for v in variants:
            res = time_fn(lambda: attn_ops.fused_temporal_layer_ablated(v, *args),
                          iters=iters, warmup=warmup)
            row = {"variant": v, "layer_ms": res["median_ms"]}
            if v == "full":
                base = res["median_ms"]
                row["bit_equal_to_serving_kernel"] = bool(torch.equal(
                    attn_ops.fused_temporal_layer_ablated("full", *args),
                    attn_ops.fused_temporal_layer(*args)))
            row["delta_vs_full"] = base - res["median_ms"]
            rows.append(row)
    rows[0]["build_s"] = built["seconds"]
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    add_device_arg(ap)
    args = ap.parse_args()
    device = resolve_device(args.device)
    for row in run(tuple(args.variants), device=device):
        emit({**row, "shape": [8, 40, 1024, 64], "dtype": "bfloat16", "card": card_line(device)})


if __name__ == "__main__":
    main()
