"""Device kernels grouped by name: a copy of the port's
`utils/profiling.py::KERNEL_GROUPS` as the benchmark reads it, kept here so
that a rename in the program does not move the yardstick.
"""

from __future__ import annotations

# (group, parts of device kernel names), first match wins: the port's own
# kernels by their rows, then the library's kernels
KERNEL_GROUPS = (
    ("fused_temporal_layer", ("fused_temporal_layer_mma_kernel", "fused_temporal_layer_kernel")),
    ("fused_spatial_linear_layer", ("linear_context_mma_kernel", "linear_output_mma_kernel",
                                    "::context_kernel<", "::output_kernel<")),
    ("warp_blend", ("warp_blend_kernel",)),
    ("headpacked_fwd", ("headpacked_fwd_mma_kernel", "headpacked_fwd_kernel")),
    ("headpacked_bwd", ("headpacked_bwd_mma_kernel", "headpacked_bwd_kernel",
                        "headpacked_dbias_kernel")),
    ("packed_attention", ("packed_attention_mma_kernel", "packed_attention_kernel")),
    ("groupnorm_film_silu", ("groupnorm_film_silu_kernel",)),
    ("grid_sample", ("grid_sampler",)),
    ("conv_gemm", ("xmma", "cudnn", "fft", "implicit_gemm", "region_transform", "gemm", "gemv",
                   "dgrad", "wgrad", "cutlass", "flip_filter", "nchwToNhwc", "nhwcToNchw")),
    ("adam", ("multi_tensor", "foreach", "adam")),
    ("kthvalue", ("kthvalue", "gatherKthValue")),
    ("reduction", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("copy", ("Memcpy", "Memset", "copy")),
)


def group_name(kernel: str) -> str:
    """The group of a device kernel's name (`other` when none matches)."""
    return next((g for g, keys in KERNEL_GROUPS if any(k in kernel for k in keys)), "other")
