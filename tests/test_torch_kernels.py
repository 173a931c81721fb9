"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips without a CUDA device (decided inside the
test). On a machine with the card and `nvcc`, where JAX is absent (the
suite's conftest imports it):
`python -m pytest --noconftest tests/test_torch_kernels.py -q`.
Shapes are small versions of the serving and training shapes; tolerances as in
`chip_smoke.py` (fp32: sums in another order; bf16: one bf16 rounding step
at the same points).
"""

import pytest
import torch

from cvpr23_lfdm_torch.ops import attention as A
from cvpr23_lfdm_torch.ops import norm as N
from cvpr23_lfdm_torch.ops import warp as W

TOL = {torch.float32: (2e-4, 1e-4), torch.bfloat16: (3e-2, 2e-2)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(out, ref, dtype):
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,hw,focus", [(64, 256, False), (512, 16, False), (128, 64, True)])
def test_fused_temporal_layer_kernel(dev, dtype, c, hw, focus):
    g = torch.Generator(device=dev).manual_seed(0)
    b, f, heads = 2, 40, 8
    x = torch.randn(b, f, hw, c, generator=g, device=dev).to(dtype)
    gamma = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
    wqkv = (torch.randn(c, 768, generator=g, device=dev) / c ** 0.5).to(dtype)
    wout = (torch.randn(256, c, generator=g, device=dev) / 16).to(dtype)
    mask = torch.tensor([True, False], device=dev) if focus else None
    bias = A.build_bias_flat(torch.randn(heads, f, f, generator=g, device=dev), b, f, mask)
    cos_t, sin_t = A.rotary_tables(f, heads, 32, 32 ** -0.5, dtype, dev)
    args = (x, gamma, wqkv, wout, bias, cos_t, sin_t, heads, 32)
    before = A.fused_temporal_layer.launches
    out = A.fused_temporal_layer(*args)
    assert A.fused_temporal_layer.launches == before + 1
    _close(out, A.fused_temporal_layer_plain(*args), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,n", [(64, 1024), (256, 16)])
def test_fused_spatial_linear_layer_kernel(dev, dtype, c, n):
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(1, 6, n, c, generator=g, device=dev).to(dtype)
    gamma = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
    wqkv = (torch.randn(c, 768, generator=g, device=dev) / c ** 0.5).to(dtype)
    wout = (torch.randn(256, c, generator=g, device=dev) / 16).to(dtype)
    bout = 0.1 * torch.randn(c, generator=g, device=dev)
    args = (x, gamma, wqkv, wout, bout, 8, 32)
    _close(A.fused_spatial_linear_layer(*args), A.fused_spatial_linear_layer_plain(*args), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_warp_video_kernel(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(2)
    src = torch.randn(2, 24, 20, 67, generator=g, device=dev).to(dtype)
    grid = 1.4 * torch.rand(2, 5, 24, 20, 2, generator=g, device=dev) * 2 - 1.4
    out = W.warp_video(src, grid)
    atol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), W.warp_video_plain(src, grid).float(), atol=atol, rtol=atol)


@pytest.mark.cuda
def test_kernel_wrappers_check_arguments(dev):
    src = torch.randn(1, 8, 8, 4, device=dev)
    with pytest.raises(TypeError):
        W.warp_video(src, torch.zeros(1, 2, 8, 8, 2, device=dev, dtype=torch.float64))
    with pytest.raises(ValueError):
        W.warp_video(src, torch.zeros(1, 2, 4, 4, 2, device=dev))


def _headpacked_inputs(dev, dtype, b, f, hw, heads, focus, seed=3, gap=0.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(b, f, hw, 3 * heads * 32, generator=g, device=dev).to(dtype)
    pos_bias = torch.randn(heads, f, f, generator=g, device=dev)
    mask = torch.tensor([True] + [False] * (b - 1), device=dev) if focus else None
    bias = A.build_bias_flat(pos_bias, b, f, mask)
    bias[..., :f] += gap  # head 0's logits `gap` above the others'
    cos_t, sin_t = A.rotary_tables(f, heads, 32, 32 ** -0.5, dtype, dev)
    do = torch.randn(b, f, hw, heads * 32, generator=g, device=dev).to(dtype)
    return qkv, bias, cos_t, sin_t, do


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,f,hw,heads,focus,gap", [
    (2, 40, 64, 8, False, 0.0), (3, 40, 16, 8, True, 0.0), (1, 64, 8, 8, False, 0.0),
    (2, 7, 130, 8, True, 0.0),
    # frames padded to a multiple of 16; HW not a multiple of the pixels a
    # backward warp walks; units of a block spanning pixels (heads 1 and 3)
    (2, 1, 7, 8, False, 0.0), (2, 16, 7, 3, False, 0.0), (1, 17, 130, 1, True, 0.0),
    (2, 33, 7, 3, True, 0.0), (1, 48, 130, 8, False, 0.0), (2, 64, 7, 1, False, 0.0),
    # one head's bias ~300 above the others' (a max per head)
    (2, 40, 130, 8, False, 300.0), (1, 33, 16, 3, False, 300.0),
])
def test_headpacked_attention_kernels(dev, dtype, b, f, hw, heads, focus, gap):
    """Forward and backward kernels against the plain forward and backward
    (dbias: an fp32 sum over HW pixels, tolerance scaled by sqrt(HW))."""
    qkv, bias, cos_t, sin_t, do = _headpacked_inputs(dev, dtype, b, f, hw, heads, focus, gap=gap)
    outs = []
    for fn in (A.headpacked_temporal_attention, A.headpacked_temporal_attention_plain):
        q = qkv.clone().requires_grad_()
        bb = bias.clone().requires_grad_()
        fwd0 = A.headpacked_temporal_attention.launches
        bwd0 = A.headpacked_temporal_attention.backward_launches
        out = fn(q, bb, cos_t, sin_t, heads, 32)
        # a non-contiguous cotangent, as autograd may hand over
        out.backward(do.transpose(1, 2).contiguous().transpose(1, 2))
        kernel = fn is A.headpacked_temporal_attention
        assert A.headpacked_temporal_attention.launches - fwd0 == int(kernel)
        assert A.headpacked_temporal_attention.backward_launches - bwd0 == int(kernel)
        outs.append((out.detach(), q.grad, bb.grad))
    (out, dq, db), (pout, pdq, pdb) = outs
    _close(out, pout, dtype)
    _close(dq, pdq, dtype)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(db, pdb, atol=atol * hw ** 0.5, rtol=rtol)
    assert torch.isfinite(dq.float()).all() and torch.isfinite(db).all()


@pytest.mark.cuda
def test_headpacked_backward_is_bit_reproducible_and_honours_needs_grad(dev):
    qkv, bias, cos_t, sin_t, do = _headpacked_inputs(dev, torch.bfloat16, 2, 40, 256, 8, False)
    grads = []
    for _ in range(2):
        q, bb = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
        A.headpacked_temporal_attention(q, bb, cos_t, sin_t, 8, 32).backward(do)
        grads.append((q.grad, bb.grad))
    assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][1], grads[1][1])
    q = qkv.clone().requires_grad_()
    A.headpacked_temporal_attention(q, bias, cos_t, sin_t, 8, 32).backward(do)
    assert torch.equal(q.grad, grads[0][0]) and bias.grad is None


@pytest.mark.cuda
def test_headpacked_wrapper_checks_arguments(dev):
    qkv, bias, cos_t, sin_t, _ = _headpacked_inputs(dev, torch.float32, 1, 8, 4, 2, False)
    with pytest.raises(ValueError):
        A.headpacked_temporal_attention(qkv, bias, cos_t, sin_t, 4, 16)  # d != 32
    with pytest.raises(TypeError):
        A.headpacked_temporal_attention(qkv, bias.double(), cos_t, sin_t, 2, 32)
    with pytest.raises(ValueError):
        A.headpacked_temporal_attention(qkv.transpose(1, 2), bias, cos_t, sin_t, 2, 32)
    with pytest.raises(TypeError):
        A.headpacked_temporal_attention(qkv.half(), bias, cos_t, sin_t, 2, 32)
    # the bf16 kernels move 16-byte vectors
    bf = torch.empty(qkv.numel() + 1, device=dev, dtype=torch.bfloat16)[1:].view(qkv.shape)
    with pytest.raises(ValueError, match="aligned"):
        A.headpacked_temporal_attention(bf, bias, cos_t.bfloat16(), sin_t.bfloat16(), 2, 32)


@pytest.mark.cuda
def test_forward_only_kernels_raise_when_a_gradient_is_asked(dev):
    g = torch.Generator(device=dev).manual_seed(4)
    c, f, heads = 64, 8, 8
    x = torch.randn(1, f, 16, c, generator=g, device=dev)
    gamma = torch.ones(c, device=dev)
    wqkv = torch.randn(c, 768, generator=g, device=dev) / 8
    wout = torch.randn(256, c, generator=g, device=dev) / 16
    bias = A.build_bias_flat(torch.zeros(heads, f, f, device=dev), 1, f)
    cos_t, sin_t = A.rotary_tables(f, heads, 32, 32 ** -0.5, torch.float32, dev)
    bout = torch.zeros(c, device=dev)
    src = torch.randn(1, 8, 8, 4, device=dev)
    grid = torch.zeros(1, 2, 8, 8, 2, device=dev)
    with pytest.raises(RuntimeError, match="forward-only"):
        A.fused_temporal_layer(x, gamma, wqkv.requires_grad_(), wout, bias, cos_t, sin_t, heads, 32)
    with pytest.raises(RuntimeError, match="forward-only"):
        A.fused_spatial_linear_layer(x.clone().requires_grad_(), gamma, wqkv.detach(), wout, bout, heads, 32)
    with pytest.raises(RuntimeError, match="forward-only"):
        W.warp_video(src.requires_grad_(), grid)
    with torch.no_grad():  # the serving path
        A.fused_temporal_layer(x, gamma, wqkv, wout, bias, cos_t, sin_t, heads, 32)
        W.warp_video(src, grid)
    # the plain versions stay differentiable
    A.fused_temporal_layer_plain(x, gamma, wqkv, wout, bias, cos_t, sin_t, heads, 32).sum().backward()
    assert wqkv.grad is not None


# ------------------------------------------------ packed attention, norm, warp+blend, ablation


def _packed_inputs(dev, dtype, b, hw, f, heads, focus, seed=5):
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(b, hw, f, 3 * heads * 32, generator=g, device=dev).to(dtype)
    pos_bias = torch.randn(heads, f, f, generator=g, device=dev)
    mask = torch.tensor([True] + [False] * (b - 1), device=dev) if focus else None
    pack = A.pick_pack(hw, f)
    return qkv, A.build_bias(pos_bias, b, pack, f, mask), pack


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,hw,f,focus", [(1, 64, 40, False), (2, 16, 40, True), (2, 6, 7, True),
                                          (1, 8, 64, False), (1, 1024, 40, False),
                                          (1, 1024, 7, False), (2, 16, 33, True), (1, 6, 48, False),
                                          (1, 16, 64, True), (1, 1024, 64, False)])
def test_packed_attention_kernel(dev, dtype, b, hw, f, focus):
    heads = 8
    qkv, bias, pack = _packed_inputs(dev, dtype, b, hw, f, heads, focus)
    before = A.packed_temporal_attention.launches
    with torch.no_grad():
        out = A.packed_temporal_attention(qkv, bias, heads, 32, pack)
        again = A.packed_temporal_attention(qkv, bias, heads, 32, pack)
    assert A.packed_temporal_attention.launches == before + 2
    assert out.shape == (b, hw, f, heads * 32) and out.dtype == dtype
    assert torch.equal(out, again)  # no atomics, one order of sums: the same bits
    _close(out, A.packed_temporal_attention_plain(qkv, bias, heads, 32, pack), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("sms,hw,f", [(12, 1024, 40), (12, 200, 40), (28, 96, 64), (12, 1024, 7),
                                      (200, 1024, 7)])
def test_packed_attention_kernel_at_uneven_chunks(dev, monkeypatch, sms, hw, f):
    """Chunk counts that do not divide HW and chunk starts that are not
    multiples of P: the card's SM count, which sizes the chunks, is faked."""
    heads = 8
    monkeypatch.setattr(A, "_sm_count", lambda index: sms)
    qkv, bias, pack = _packed_inputs(dev, torch.bfloat16, 1, hw, f, heads, False)
    chunks = A._packed_chunks(hw, 1, heads, f, pack, sms)
    assert hw % chunks and -(-hw // chunks) % pack
    with torch.no_grad():
        out = A.packed_temporal_attention(qkv, bias, heads, 32, pack)
    _close(out, A.packed_temporal_attention_plain(qkv, bias, heads, 32, pack), torch.bfloat16)


# (hw, batch, heads, F, pack, SMs): the serving shapes on 132 SMs, uneven
# splits, a large P at F = 64 (bias slots capped by shared memory), odd sizes
@pytest.mark.parametrize("hw,batch,heads,f,pack,sms", [
    (1024, 1, 8, 40, 4, 132), (256, 1, 8, 40, 4, 132), (64, 1, 8, 40, 4, 132),
    (16, 1, 8, 40, 4, 132), (1024, 1, 8, 40, 4, 12), (1024, 1, 8, 7, 32, 132),
    (4096, 1, 1, 64, 4096, 132), (6, 2, 8, 48, 2, 132), (1000, 2, 3, 33, 8, 132)])
def test_packed_chunks_cover_every_pixel_once(hw, batch, heads, f, pack, sms):
    """`_packed_chunks` against the kernel's split: block `chunk` owns pixels
    `[chunk * ppb, min((chunk + 1) * ppb, hw))`, `ppb = ceil(hw / chunks)`, and
    its `min(8, ppb)` warps take `ceil(ppb / warps)` consecutive pixels each.
    Every pixel is covered once, no chunk is empty, the chunk count is near two
    blocks per SM (or what shared memory allows) and the block fits."""
    chunks = A._packed_chunks(hw, batch, heads, f, pack, sms)
    ppb = -(-hw // chunks)
    warps = max(1, min(8, ppb))
    px = -(-ppb // warps)
    seen = []
    for chunk in range(chunks):
        x0, x1 = min(chunk * ppb, hw), min((chunk + 1) * ppb, hw)
        assert x1 > x0
        for w in range(warps):
            wx0 = min(x0 + w * px, x1)
            seen.extend(range(wx0, min(wx0 + px, x1)))
    assert sorted(seen) == list(range(hw))
    target = max(1, min(hw, -(-2 * sms // (batch * heads))))
    assert chunks >= -(-hw // -(-hw // target))  # more only where shared memory caps a chunk
    slots = min(pack, ppb)
    smem = -(-slots * f * f * 4 // 128) * 128 + warps * 3 * 16 * -(-f // 16) * 64
    assert smem <= A._MAX_SMEM


@pytest.mark.cuda
def test_packed_attention_wrapper_checks_arguments(dev):
    qkv, bias, pack = _packed_inputs(dev, torch.float32, 1, 8, 8, 2, False)
    with pytest.raises(ValueError):
        A.packed_temporal_attention(qkv, bias, 4, 16, pack)  # d != 32
    with pytest.raises(TypeError):
        A.packed_temporal_attention(qkv, bias.double(), 2, 32, pack)
    with pytest.raises(TypeError):
        A.packed_temporal_attention(qkv.half(), bias, 2, 32, pack)
    with pytest.raises(ValueError):
        A.packed_temporal_attention(qkv.transpose(1, 2), bias, 2, 32, pack)
    with pytest.raises(ValueError):
        A.packed_temporal_attention(qkv, bias, 2, 32, 3)  # pack does not divide HW
    with pytest.raises(RuntimeError, match="forward-only"):
        A.packed_temporal_attention(qkv.clone().requires_grad_(), bias, 2, 32, pack)
    # bf16 moves 16-byte vectors: a view that starts 2 bytes in raises, no fallback
    flat = torch.zeros(qkv.numel() + 1, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        A.packed_temporal_attention(flat[1:].view(qkv.shape), bias, 2, 32, pack)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("shape,groups", [((1, 40, 8, 8, 64), 8), ((2, 5, 4, 4, 512), 8),
                                          ((2, 3, 5, 7, 24), 4), ((1, 2, 3, 3, 768), 8)])
def test_groupnorm_film_silu_kernel(dev, dtype, film, shape, groups):
    g = torch.Generator(device=dev).manual_seed(6)
    b, c = shape[0], shape[-1]
    x = (1.5 * torch.randn(*shape, generator=g, device=dev) + 0.3).to(dtype)
    gamma = 1 + 0.3 * torch.randn(c, generator=g, device=dev)
    beta = 0.2 * torch.randn(c, generator=g, device=dev)
    ss = tuple(torch.randn(b, 1, 1, 1, c, generator=g, device=dev) for _ in range(2)) if film else ()
    before = N.groupnorm_film_silu.launches
    with torch.no_grad():
        out = N.groupnorm_film_silu(x, gamma, beta, *ss, groups=groups)
        again = N.groupnorm_film_silu(x, gamma, beta, *ss, groups=groups)
    assert N.groupnorm_film_silu.launches == before + 2
    assert torch.equal(out, again)  # no atomics: the same bits
    _close(out, N.groupnorm_film_silu_plain(x, gamma, beta, *ss, groups=groups), dtype)


@pytest.mark.cuda
def test_groupnorm_film_silu_wrapper_checks_arguments(dev):
    x = torch.randn(1, 2, 4, 4, 16, device=dev)
    gamma, beta = torch.ones(16, device=dev), torch.zeros(16, device=dev)
    with pytest.raises(TypeError):
        N.groupnorm_film_silu(x.double(), gamma, beta)
    with pytest.raises(ValueError):
        N.groupnorm_film_silu(x, gamma, beta, groups=3)
    with pytest.raises(ValueError):
        N.groupnorm_film_silu(x, gamma, beta, scale=torch.zeros(1, 16, device=dev))
    with pytest.raises(ValueError):
        N.groupnorm_film_silu(x.transpose(2, 3), gamma, beta)
    with pytest.raises(ValueError):
        N.groupnorm_film_silu(x[0], gamma, beta)
    with pytest.raises(RuntimeError, match="forward-only"):
        N.groupnorm_film_silu(x, gamma.requires_grad_(), beta)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("blend", ["none", "occlusion", "previous"])
@pytest.mark.parametrize("fn", ["warp_onehot", "warp_gather"])
@pytest.mark.parametrize("c,w,offset", [(67, 20, 0), (1, 21, 0), (4, 21, 0), (67, 21, 0),
                                        (128, 21, 0), (256, 21, 0), (128, 21, 1)])
def test_warp_blend_kernel(dev, dtype, blend, fn, c, w, offset):
    """Channel counts below, at and above a warp, the float4 path (C % 4 == 0)
    and, with `offset`, inputs that start one element in (the float path);
    odd W; grids out to +-1.4."""
    g = torch.Generator(device=dev).manual_seed(7)
    b, h = 2, 24

    def make(*shape, rand=False):
        n = torch.Size(shape).numel()
        buf = (torch.rand if rand else torch.randn)(n + offset, generator=g, device=dev)
        return buf[offset:].view(shape).to(dtype)

    img = make(b, h, w, c)
    grid = 1.4 * torch.rand(b, h, w, 2, generator=g, device=dev) * 2 - 1.4
    occ = make(b, h, w, 1, rand=True) if blend != "none" else None
    prev = make(b, h, w, c) if blend == "previous" else None
    wrapper = getattr(W, fn)
    before = wrapper.launches
    with torch.no_grad():
        out = wrapper(img, grid, occ, prev)
    assert wrapper.launches == before + 1 and out.dtype == torch.float32
    # both sides work on the same fp32 casts: fp32 tolerance for either input dtype
    torch.testing.assert_close(out, W.warp_blend_plain(img, grid, occ, prev), atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_warp_blend_wrapper_checks_arguments(dev):
    img = torch.randn(1, 8, 8, 4, device=dev)
    grid = torch.zeros(1, 8, 8, 2, device=dev)
    with pytest.raises(ValueError):
        W.warp_onehot(img, torch.zeros(1, 4, 4, 2, device=dev))
    with pytest.raises(ValueError):
        W.warp_gather(img, grid, torch.zeros(1, 8, 8, 4, device=dev))  # occlusion has one channel
    with pytest.raises(TypeError):
        W.warp_onehot(img, grid.long())
    with pytest.raises(ValueError):
        W.warp_onehot(img.transpose(1, 2), grid)
    with pytest.raises(ValueError):
        W.warp_onehot(img, grid, blend="previous")
    with pytest.raises(RuntimeError, match="forward-only"):
        W.warp_onehot(img.clone().requires_grad_(), grid)
    # one image of 2^31 elements: beyond the kernel's 32-bit offsets, it raises
    big = torch.empty(1, 1024, 1024, 2048, device=dev)
    with pytest.raises(ValueError, match="32-bit"):
        W.warp_onehot(big, torch.zeros(1, 1024, 1024, 2, device=dev))


@pytest.mark.cuda
def test_ablated_temporal_layer_full_is_the_serving_kernel(dev):
    g = torch.Generator(device=dev).manual_seed(8)
    c, f, hw, heads = 64, 40, 64, 8
    x = torch.randn(1, f, hw, c, generator=g, device=dev).to(torch.bfloat16)
    gamma = torch.ones(c, device=dev)
    wqkv = (torch.randn(c, 768, generator=g, device=dev) / 8).to(torch.bfloat16)
    wout = (torch.randn(256, c, generator=g, device=dev) / 16).to(torch.bfloat16)
    bias = A.build_bias_flat(torch.randn(heads, f, f, generator=g, device=dev), 1, f)
    cos_t, sin_t = A.rotary_tables(f, heads, 32, 32 ** -0.5, torch.bfloat16, dev)
    args = (x, gamma, wqkv, wout, bias, cos_t, sin_t, heads, 32)
    with torch.no_grad():
        want = A.fused_temporal_layer(*args)
        before = (A.fused_temporal_layer.launches, A.fused_temporal_layer_ablated.launches)
        assert torch.equal(A.fused_temporal_layer_ablated("full", *args), want)
        out = A.fused_temporal_layer_ablated("scores", *args)  # builds, launches; values mean nothing
    assert out.shape == want.shape
    assert (A.fused_temporal_layer.launches, A.fused_temporal_layer_ablated.launches) == (
        before[0], before[1] + 2)
    with pytest.raises(ValueError):
        A.fused_temporal_layer_ablated("kvbuild", *args)
