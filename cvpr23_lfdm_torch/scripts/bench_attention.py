"""Microbenchmark: the temporal-attention forms, one layer at a time.

Counterpart of the JAX package's `scripts/bench_attention.py`: times one
`TemporalAttention` layer of the UNet in each form at the JAX script's
shapes (F=40, 8 heads of 32; HW = 32² dominates): `xla` (plain einsums, no
kernel), `pallas` (row 6, `csrc/packed_attention.cu`, rotary outside) and
`pallas2` (row 4's forward, `csrc/headpacked_attention.cu`). Each form
works on the normalised input, as the JAX layer does. `pallas3` is the
whole PreNorm layer (LN + attention + residual, row 1,
`csrc/fused_temporal_layer.cu`), the only way the port's
`TemporalAttention` takes that form, so its line holds against
`x + xla(LN(x))`. Ten layers are chained per timing (CUDA events, median
of 10 after 3 warm-ups; the host clock with `--device cpu`, which runs the
plain versions). Each line also gives every form's max-abs distance from
the `xla` form on the same input.

Prints one JSON line per shape.

Usage: python -m cvpr23_lfdm_torch.scripts.bench_attention [--impls xla,pallas,pallas2]
           [--dtype bfloat16] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from cvpr23_lfdm_torch.models.unet3d import ATTN_IMPLS, ChannelLayerNorm, TemporalAttention
from cvpr23_lfdm_torch.scripts._common import DTYPES, add_device_arg, card_line, emit
from cvpr23_lfdm_torch.utils.device import resolve_device
from cvpr23_lfdm_torch.utils.profiling import time_fn

F, HEADS, DH = 40, 8, 32
SHAPES = [  # (B, HW, dim): the UNet's temporal-attention sites at MUG scale
    (1, 1024, 64),
    (1, 256, 128),
    (8, 1024, 64),
]
CHAINED = 10  # layers per timing


def layers(dim: int, impls, dtype, device, seed: int = 0) -> dict:
    """One seeded `TemporalAttention` per form, all with the same weights,
    and the LayerNorm of the `pallas3` form."""
    for impl in impls:
        if impl not in ATTN_IMPLS:
            raise ValueError(f"bench_attention: form {impl!r} is not one of {ATTN_IMPLS}")
    torch.manual_seed(seed)
    first = TemporalAttention(dim, HEADS, DH, dtype=dtype, impl="xla")
    out = {}
    for impl in ("xla", *impls):
        layer = TemporalAttention(dim, HEADS, DH, dtype=dtype, impl=impl)
        layer.load_state_dict(first.state_dict())
        out[impl] = layer.to(device).eval().requires_grad_(False)
    norm = ChannelLayerNorm(dim)
    with torch.no_grad():
        norm.gamma.copy_(1 + 0.1 * torch.randn(dim))
    return {"attn": out, "norm": norm.to(device).requires_grad_(False)}


def run(shapes=SHAPES, impls=("xla", "pallas", "pallas2"), dtype: str = "bfloat16",
        device=None, frames: int = F, iters: int = 10, warmup: int = 3) -> list:
    """One record per shape: ms per layer of each form and each form's
    max-abs distance from `xla`."""
    device = resolve_device(device)
    dt = DTYPES[dtype]
    records = []
    for b, hw, dim in shapes:
        side = int(round(hw ** 0.5))
        g = torch.Generator().manual_seed(0)
        x = torch.randn(b, frames, side, side, dim, generator=g).to(device=device, dtype=dt)
        pos_bias = torch.randn(HEADS, frames, frames, generator=g).to(device)
        mods = layers(dim, impls, dt, device)
        norm = mods["norm"]

        def form(impl):
            attn = mods["attn"][impl]
            if impl == "pallas3":
                return lambda h: attn(h, prenorm_gamma=norm.gamma, pos_bias=pos_bias)
            return lambda h: attn(h, pos_bias=pos_bias)

        with torch.no_grad():
            ref = form("xla")(x).float()
            ref_pre = (x + mods["attn"]["xla"](norm(x), pos_bias=pos_bias)).float()
            rec = {"B": b, "HW": hw, "dim": dim, "frames": frames, "dtype": dtype, "ms": {},
                   "max_abs_vs_xla": {}}
            for impl in impls:
                call = form(impl)
                want = ref_pre if impl == "pallas3" else ref
                rec["max_abs_vs_xla"][impl] = float((call(x).float() - want).abs().max())

                def chained(call=call):
                    h = x
                    for _ in range(CHAINED):
                        h = call(h)
                    return h

                res = time_fn(chained, iters=iters, warmup=warmup, device=device)
                rec["ms"][impl] = res["median_ms"] / CHAINED
            rec["clock"] = res["clock"]
        records.append(rec)
    return records


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--impls", default="xla,pallas,pallas2",
                    help=f"comma-separated forms of {ATTN_IMPLS}")
    ap.add_argument("--dtype", default="bfloat16", choices=list(DTYPES))
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = card_line(device)
    records = run(impls=tuple(args.impls.split(",")), dtype=args.dtype, device=device)
    for rec in records:
        emit({**rec, "card": card})
    return records


if __name__ == "__main__":
    main()
