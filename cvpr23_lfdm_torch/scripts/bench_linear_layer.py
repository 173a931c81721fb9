"""Device time of the fused linear-attention layer at the serving shapes.

Times `ops.attention.fused_spatial_linear_layer`
(`csrc/fused_spatial_linear_layer.cu`) at the seven shapes one `pallas3` UNet
eval gives it (`_common.LINEAR_SHAPES`: B=1, F=40, 8 heads of 32 channels,
bf16; seeded inputs): per call its device time alone (torch.profiler over 10
calls, two kernels per call; and the share of each kernel, the context and
the output launch, from the same profile) and its time by CUDA events around
the wrapper (the wrapper's host work included), and the sum of the device
times over the 80 calls of one serving video (10 DDIM evals). The reading is
`_common.run_layer`, shared with `bench_temporal_layer`.

The reading uses only the layer's public function, so the file can time
another checkout of the package (from the one that added
`_common.run_layer` on) in turns with this one: run it by path with that
checkout first on PYTHONPATH. `--scan` also times the bf16 kernels under
every head grouping G (the output launch's cluster size; at most 8 heads
per group) and tile of R rows forced through
`ops.attention.linear_layer_plan(..., cluster=G, rows=R)`, each against the
plain layer (max abs error).

Usage: python -m cvpr23_lfdm_torch.scripts.bench_linear_layer [--scan]
"""

from __future__ import annotations

import torch

from cvpr23_lfdm_torch.ops import attention as attn_ops
from cvpr23_lfdm_torch.scripts._common import D, HEADS, LINEAR_SHAPES, LayerBench, layer_inputs, layer_main


def make_args(c: int, hw: int, device, seed: int = 0):
    """Seeded arguments of one layer at `[1, F, HW, C]`, bf16."""
    g, (x, gamma, wqkv, wout) = layer_inputs(c, hw, device, seed)
    bout = (0.1 * torch.randn(c, generator=g)).to(device)
    return (x, gamma, wqkv, wout, bout, HEADS, D)


def scan(hw: int) -> dict:
    """Every head grouping G and tile of R rows that the frame can take."""
    return {f"G={g},R={rows}": {"cluster": g, "rows": rows}
            for g in range(1, 9) if HEADS % g == 0
            for rows in (16, 32, 64, 128) if rows <= 16 * -(-hw // 16)}


LAYER = LayerBench(
    "bench_linear_layer", attn_ops.fused_spatial_linear_layer,
    attn_ops.fused_spatial_linear_layer_plain, make_args, LINEAR_SHAPES, launches=2,
    plan="linear_layer_plan", scan=scan, by=("context", "output"))

if __name__ == "__main__":
    layer_main(LAYER, __doc__)
