"""Operations and bytes: the card's peaks, each hand-written kernel's work
from the shapes of its call, and a whole entry's FLOPs counted over the
reference on the `meta` device.

A kernel's bound is the larger of its products' FLOPs over the bf16 (or
fp32) peak and its bytes over the memory bandwidth, with every input byte
read once and every output byte written once. Only matrix products count
as FLOPs, as in the whole-entry count (`torch.utils.flop_counter`), so
the two numerators are alike.
"""

from __future__ import annotations

from torch.utils.flop_counter import FlopCounterMode

# one NVIDIA H100 SXM (NVIDIA's data sheet): dense tensor-core bf16, fp32
# outside the tensor cores, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take for the work."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def temporal_layer(x, gamma, wqkv, wout, bias_flat, cos_t, sin_t, heads, dim_head, **_):
    """Row 1 (LN, qkv, rotary, attention over frames, out-projection,
    residual): `(flops, bytes)` of one call on `x [B, F, HW, C]`."""
    b, f, hw, c = x.shape
    hd = heads * dim_head
    flops = 2 * b * f * hw * c * 3 * hd + 2 * 2 * b * hw * heads * f * f * dim_head + 2 * b * f * hw * hd * c
    ins = (x, gamma, wqkv, wout, bias_flat, cos_t, sin_t)
    nbytes = sum(t.numel() * t.element_size() for t in ins) + x.numel() * x.element_size()
    return flops, nbytes


def linear_layer(x, gamma, wqkv, wout, bout, heads, dim_head, **_):
    """Row 2 (LN, qkv, softmax-kernel linear attention over pixels,
    out-projection, residual): `(flops, bytes)` of one call."""
    b, f, n, c = x.shape
    hd = heads * dim_head
    flops = 2 * b * f * n * c * 3 * hd + 2 * 2 * b * f * heads * n * dim_head * dim_head + 2 * b * f * n * hd * c
    ins = (x, gamma, wqkv, wout, bout)
    nbytes = sum(t.numel() * t.element_size() for t in ins) + x.numel() * x.element_size()
    return flops, nbytes


def headpacked_forward(qkv, bias_flat, cos_t, sin_t, heads, dim_head):
    """Row 4 (attention over frames on the raw qkv, rotary folded in):
    `(flops, bytes)` of one forward call on `qkv [B, F, HW, 3hd]`."""
    b, f, hw, _ = qkv.shape
    flops = 2 * 2 * b * hw * heads * f * f * dim_head
    out = b * f * hw * heads * dim_head * qkv.element_size()
    return flops, sum(t.numel() * t.element_size() for t in (qkv, bias_flat, cos_t, sin_t)) + out


def headpacked_backward(qkv, bias_flat, cos_t, sin_t, heads, dim_head):
    """Row 5 (the recompute-based backward): the scores again and four
    products (dp, dq, dk, dv); reads qkv, the bias, the tables and the
    output's cotangent, writes dqkv and dbias."""
    b, f, hw, _ = qkv.shape
    flops = 5 * 2 * b * hw * heads * f * f * dim_head
    dout = b * f * hw * heads * dim_head * qkv.element_size()
    ins = sum(t.numel() * t.element_size() for t in (qkv, bias_flat, cos_t, sin_t)) + dout
    return flops, ins + qkv.numel() * qkv.element_size() + bias_flat.numel() * bias_flat.element_size()


class Counted:
    """A kernel entry's forward count and, where it has a backward kernel,
    the backward's (both from the forward call's arguments)."""

    def __init__(self, forward, backward=None):
        self.forward = forward
        if backward is not None:
            self.backward = backward

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)


HEADPACKED = Counted(headpacked_forward, headpacked_backward)


def meta_flops(fn) -> float:
    """The matrix-product FLOPs of `fn()` (run on `meta` tensors)."""
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())
