"""The operation and byte counts against hand counts at one small shape."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.harness import counts


def _t(*shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype)


def test_temporal_layer_by_hand():
    # B=1, F=2, HW=3, C=4, one head of 2: qkv 2*6*4*6, scores and PV 2*2*(3*2*2*2), out 2*6*2*4
    b, f, hw, c, h, d = 1, 2, 3, 4, 1, 2
    x = _t(b, f, hw, c)
    flops, nbytes = counts.temporal_layer(x, _t(c, dtype=torch.float32), _t(c, 3 * h * d), _t(h * d, c),
                                          _t(b, f, h * f, dtype=torch.float32), _t(f, 3 * h * d), _t(f, 3 * h * d),
                                          h, d, partial=False)
    assert flops == 2 * 6 * 4 * 6 + 2 * 2 * (3 * 2 * 2 * 2) + 2 * 6 * 2 * 4 == 480
    # x 24*2, gamma 4*4, wqkv 24*2, wout 8*2, bias 4*4, cos+sin 2*12*2, out 24*2
    assert nbytes == 48 + 16 + 48 + 16 + 16 + 48 + 48


def test_linear_layer_by_hand():
    b, f, n, c, h, d = 1, 2, 3, 4, 1, 2
    flops, nbytes = counts.linear_layer(_t(b, f, n, c), _t(c, dtype=torch.float32), _t(c, 6), _t(2, c),
                                        _t(c, dtype=torch.float32), h, d)
    # qkv 2*6*4*6, context and output 2*2*(2*3*2*2), out 2*6*2*4
    assert flops == 288 + 2 * 2 * 24 + 96 == 480
    assert nbytes == 48 + 16 + 48 + 16 + 16 + 48


def test_headpacked_by_hand():
    b, f, hw, h, d = 1, 2, 3, 1, 2
    qkv, bias, cs = _t(b, f, hw, 3 * h * d), _t(b, f, h * f, dtype=torch.float32), _t(f, 3 * h * d)
    fwd = counts.HEADPACKED(qkv, bias, cs, cs, h, d)
    bwd = counts.HEADPACKED.backward(qkv, bias, cs, cs, h, d)
    one = 2 * b * hw * h * f * f * d  # one F x F x d product per pixel and head
    assert fwd == (2 * one, 36 * 2 + 16 + 2 * 24 + 12 * 2)
    assert bwd == (5 * one, 36 * 2 + 16 + 2 * 24 + 12 * 2 + 36 * 2 + 16)


def test_meta_flops_counts_products():
    w = torch.empty(5, 3, device="meta")
    x = torch.empty(7, 3, device="meta")
    assert counts.meta_flops(lambda: F.linear(x, w)) == 2 * 7 * 3 * 5
    k = torch.empty(4, 3, 3, 3, device="meta")
    img = torch.empty(2, 3, 8, 8, device="meta")
    assert counts.meta_flops(lambda: F.conv2d(img, k, padding=1)) == 2 * 2 * 4 * 8 * 8 * 3 * 9


def test_bound_is_the_larger():
    assert counts.bound_s(989e12, 0, "bfloat16") == 1.0
    assert counts.bound_s(0, 3.35e12, "float32") == 1.0
