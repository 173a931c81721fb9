"""Ops of the port: plain PyTorch functions and the hand-written CUDA kernels
behind them. Every kernel wrapper counts its launches in an attribute of
itself; this module is the one table of those counters."""

from __future__ import annotations


def kernel_counters() -> dict:
    """name -> (wrapper, counter attribute) of every kernel wrapper (the
    `_partial` entries: the head-shard launches among the wrapper's; the
    `_band` entry: the launches on a band of output rows)."""
    from cvpr23_lfdm_torch.ops import attention as A
    from cvpr23_lfdm_torch.ops import norm as N
    from cvpr23_lfdm_torch.ops import warp as W

    return {"fused_temporal_layer": (A.fused_temporal_layer, "launches"),
            "fused_spatial_linear_layer": (A.fused_spatial_linear_layer, "launches"),
            "fused_temporal_layer_partial": (A.fused_temporal_layer, "partial_launches"),
            "fused_spatial_linear_layer_partial": (A.fused_spatial_linear_layer, "partial_launches"),
            "warp_video": (W.warp_video, "launches"),
            "warp_video_band": (W.warp_video, "band_launches"),
            "headpacked_attention_fwd": (A.headpacked_temporal_attention, "launches"),
            "headpacked_attention_bwd": (A.headpacked_temporal_attention, "backward_launches"),
            "packed_temporal_attention": (A.packed_temporal_attention, "launches"),
            "groupnorm_film_silu": (N.groupnorm_film_silu, "launches"),
            "warp_onehot": (W.warp_onehot, "launches"),
            "warp_gather": (W.warp_gather, "launches"),
            "fused_temporal_layer_ablate": (A.fused_temporal_layer_ablated, "launches")}


def read_counters() -> dict:
    """name -> launches since the last reset."""
    return {name: getattr(fn, attr) for name, (fn, attr) in kernel_counters().items()}


def reset_counters() -> None:
    for fn, attr in kernel_counters().values():
        setattr(fn, attr, 0)
