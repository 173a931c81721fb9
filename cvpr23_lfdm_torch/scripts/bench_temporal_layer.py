"""Device time of the fused temporal-attention layer at the serving shapes.

Times `ops.attention.fused_temporal_layer` (`csrc/fused_temporal_layer.cu`)
at the seven shapes one `pallas3` UNet eval gives it (`_common.
TEMPORAL_SHAPES`: B=1, F=40, 8 heads of 32 channels, bf16; seeded inputs):
per call its device time alone (torch.profiler over 10 calls, one kernel per
call) and its time by CUDA events around the wrapper (the wrapper's host
work included), and the sum of the device times over the 100 calls of one
serving video (10 DDIM evals). The reading is `_common.run_layer`, shared
with `bench_linear_layer`.

The reading uses only the layer's public function, so the file can time
another checkout of the package (from the one that added
`_common.run_layer` on) in turns with this one: run it by path with that
checkout first on PYTHONPATH. `--scan` also times the bf16 kernel under
every cluster size K that divides the 8 heads, forced through
`ops.attention.temporal_layer_plan(..., cluster=K)`, each against the plain
layer (max abs error). The ablation builds at these shapes:
`bench_attn_ablate --serving`.

Usage: python -m cvpr23_lfdm_torch.scripts.bench_temporal_layer [--scan]
"""

from __future__ import annotations

import torch

from cvpr23_lfdm_torch.ops import attention as attn_ops
from cvpr23_lfdm_torch.scripts._common import (D, F, HEADS, TEMPORAL_SHAPES, LayerBench, layer_inputs,
                                               layer_main)


def make_args(c: int, hw: int, device, seed: int = 0):
    """Seeded arguments of one layer at `[1, F, HW, C]`, bf16."""
    g, (x, gamma, wqkv, wout) = layer_inputs(c, hw, device, seed)
    bias = attn_ops.build_bias_flat(torch.randn(HEADS, F, F, generator=g).to(device), 1, F)
    cos_t, sin_t = attn_ops.rotary_tables(F, HEADS, D, D ** -0.5, torch.bfloat16, device)
    return (x, gamma, wqkv, wout, bias, cos_t, sin_t, HEADS, D)


LAYER = LayerBench(
    "bench_temporal_layer", attn_ops.fused_temporal_layer, attn_ops.fused_temporal_layer_plain,
    make_args, TEMPORAL_SHAPES, launches=1, plan="temporal_layer_plan",
    scan=lambda hw: {f"K={k}": {"cluster": k} for k in range(1, 9) if HEADS % k == 0})

if __name__ == "__main__":
    layer_main(LAYER, __doc__)
