"""Tiny sizes of the cells for the CPU tests: every width shrunk, the
code paths as at full size (the port's plain versions on the CPU)."""

from __future__ import annotations

LFAE = {
    "frame_shape": 32,
    "generator": {"block_expansion": 8, "max_features": 32, "num_bottleneck_blocks": 1,
                  "pixelwise_flow": {"block_expansion": 8, "max_features": 32, "num_blocks": 2}},
    "region_predictor": {"block_expansion": 8, "max_features": 32, "num_blocks": 2},
    "bg_predictor": {"block_expansion": 8, "max_features": 32, "num_blocks": 2},
}
DIFFUSION = {"dim": 8, "dim_mults": [1, 2], "attn_heads": 2, "attn_dim_head": 8, "cond_dim": 16,
             "num_frames": 4, "img_size": 8}

OVERRIDES = {
    "mug-serve-b32": {"experiment": {"lfae": LFAE, "diffusion": DIFFUSION},
                      "traffic": {"batch": 2, "frame_pool": 4, "warmup_calls": 1, "trace_units": 1}},
    "natops-dmtrain-b20": {"experiment": {"lfae": LFAE, "diffusion": DIFFUSION},
                           "traffic": {"batch": 2, "corpus_videos": 4, "corpus_frames": 8,
                                       "reference_rows": 1, "trace_units": 1}},
}
