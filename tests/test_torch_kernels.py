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
from cvpr23_lfdm_torch.scripts.bench_train_warp import STEP_WARPS, make_case

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


# (C, HW, focus, F, heads): the first three in both dtypes; then clusters of 2
# blocks (heads 2) and of 8 with two heads per block (heads 16), F = 7, 33,
# 64 (1, 3, 4 query strips per pixel), HW = 6 and 130, which no power-of-two
# chunk of pixels divides, focus rows; C = 16, 32, 48 (rows of 2, 4, 6
# 16-byte chunks: a narrower swizzle), 192 and 320 (24 and 40 chunks: the
# LayerNorm's lanes per row a power of two below C / 8); F = 64 at C = 512 in
# bf16 only (the fp32 kernel keeps [F, C] fp32 rows in shared memory and
# cannot place it)
_TEMPORAL_CASES = [(64, 256, False, 40, 8), (512, 16, False, 40, 8), (128, 64, True, 40, 8),
                   (64, 6, False, 40, 2), (128, 6, True, 33, 16), (64, 16, False, 7, 8),
                   (256, 16, True, 64, 8), (512, 6, False, 33, 8), (64, 130, False, 33, 8),
                   (16, 6, False, 40, 8), (32, 16, True, 40, 8), (48, 6, False, 7, 2),
                   (192, 16, False, 40, 8), (192, 6, True, 33, 16), (320, 16, False, 40, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,c,hw,focus,f,heads",
                         [(d, *case) for case in _TEMPORAL_CASES for d in DTYPES]
                         + [(torch.bfloat16, 512, 6, False, 64, 8)])
def test_fused_temporal_layer_kernel(dev, dtype, c, hw, focus, f, heads):
    """Kernel against the plain layer, and the same bits when run twice (no
    atomics: the bf16 cluster sums its blocks' partials in rank order)."""
    args = _temporal_args(dev, dtype, 2, f, hw, c, heads, focus, seed=0)
    before = A.fused_temporal_layer.launches
    out = A.fused_temporal_layer(*args)
    assert A.fused_temporal_layer.launches == before + 1
    _close(out, A.fused_temporal_layer_plain(*args), dtype)
    assert torch.equal(out, A.fused_temporal_layer(*args))


def _temporal_args(dev, dtype, b, f, hw, c, heads, focus, seed, branch=False):
    """Seeded layer arguments. With unit inputs the attention branch has rms
    ~0.34 against the residual's 1, about ten times the bf16 gate's atol.
    `branch` makes it O(1) and the residual small, as row 2's
    `_linear_args` does: x / 16 (the LayerNorm does not see the scale) and
    W_out * 3 (branch rms ~1.0, residual ~0.06)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    hd = heads * 32
    xs, ws = (1 / 16, 3.0) if branch else (1.0, 1.0)
    x = (xs * torch.randn(b, f, hw, c, generator=g, device=dev)).to(dtype)
    gamma = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
    wqkv = (torch.randn(c, 3 * hd, generator=g, device=dev) / c ** 0.5).to(dtype)
    wout = (ws * torch.randn(hd, c, generator=g, device=dev) / hd ** 0.5).to(dtype)
    mask = torch.tensor([True, False], device=dev) if focus else None
    bias = A.build_bias_flat(torch.randn(heads, f, f, generator=g, device=dev), b, f, mask)
    cos_t, sin_t = A.rotary_tables(f, heads, 32, 32 ** -0.5, dtype, dev)
    return (x, gamma, wqkv, wout, bias, cos_t, sin_t, heads, 32)


def _close_temporal_branch(out, args, dtype):
    """`out` against the plain layer, after checking that the attention
    branch (plain - x) is ten times the gate's atol or more."""
    ref = A.fused_temporal_layer_plain(*args)
    rms = float((ref.float() - args[0].float()).pow(2).mean().sqrt())
    assert rms >= 10 * TOL[dtype][0], rms
    _close(out, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,c,hw,focus,f,heads",
                         [(d, *case) for case in _TEMPORAL_CASES for d in DTYPES]
                         + [(torch.bfloat16, 512, 6, False, 64, 8)])
def test_fused_temporal_layer_kernel_on_branch_inputs(dev, dtype, c, hw, focus, f, heads):
    """Every case of `test_fused_temporal_layer_kernel` again on inputs whose
    attention branch is O(1), so that the gate holds the branch itself."""
    args = _temporal_args(dev, dtype, 2, f, hw, c, heads, focus, seed=0, branch=True)
    out = A.fused_temporal_layer(*args)
    _close_temporal_branch(out, args, dtype)
    assert torch.equal(out, A.fused_temporal_layer(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("heads,k,focus", [(8, 2, False), (8, 4, True), (8, 8, False), (16, 8, True),
                                           (16, 2, False), (2, 2, True), (3, 3, False)])
def test_fused_temporal_layer_kernel_at_every_cluster_size(dev, monkeypatch, heads, k, focus):
    """The bf16 kernel under a cluster size forced through the plan: one head
    per block (K = heads) or several, K = 3 (uneven column slices of the
    reduction); against the plain layer, and the same bits twice, with unit
    inputs and with an O(1) attention branch."""
    import functools

    monkeypatch.setattr(A, "temporal_layer_plan", functools.partial(A.temporal_layer_plan, cluster=k))
    args = _temporal_args(dev, torch.bfloat16, 2, 40, 24, 128, heads, focus, seed=9)
    out = A.fused_temporal_layer(*args)
    _close(out, A.fused_temporal_layer_plain(*args), torch.bfloat16)
    assert torch.equal(out, A.fused_temporal_layer(*args))
    bargs = _temporal_args(dev, torch.bfloat16, 2, 40, 24, 128, heads, focus, seed=9, branch=True)
    out = A.fused_temporal_layer(*bargs)
    _close_temporal_branch(out, bargs, torch.bfloat16)
    assert torch.equal(out, A.fused_temporal_layer(*bargs))


@pytest.mark.cuda
def test_temporal_layer_smem_mirrors_the_kernel(dev):
    """`temporal_layer_smem` is the kernel's own layout, byte for byte."""
    import ctypes

    from cvpr23_lfdm_torch.ops import _build

    fn = _build.load("fused_temporal_layer").fused_temporal_layer_bf16_smem
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int] * 4
    for f in (1, 7, 16, 33, 40, 64):
        for c in (16, 32, 48, 64, 128, 192, 320, 512):
            for p in range(1, 8 // -(-f // 16) + 1):
                for hpb in (1, 2):
                    assert fn(f, c, p, hpb) == A.temporal_layer_smem(f, c, p, hpb), (f, c, p, hpb)


# (B, F, HW, C, heads, SMs): the seven serving shapes on 132 SMs, F = 64, the
# ablation shape, heads 2 / 3 / 16, HW that no power of two divides, a small
# card, C = 32, 192, 320
@pytest.mark.parametrize("b,f,hw,c,heads,sms", [
    (1, 40, 1024, 64, 8, 132), (1, 40, 256, 128, 8, 132), (1, 40, 256, 64, 8, 132),
    (1, 40, 64, 256, 8, 132), (1, 40, 64, 128, 8, 132), (1, 40, 16, 512, 8, 132),
    (1, 40, 16, 256, 8, 132), (1, 64, 16, 512, 8, 132), (1, 64, 1024, 64, 8, 132),
    (8, 40, 1024, 64, 8, 132), (2, 40, 6, 64, 2, 132), (2, 33, 6, 128, 16, 132),
    (2, 7, 130, 64, 8, 132), (1, 40, 100, 64, 3, 132), (1, 17, 1000, 128, 8, 12),
    (1, 40, 16, 32, 8, 132), (2, 33, 6, 192, 16, 132), (1, 40, 64, 320, 8, 132),
    # the serving shapes at a tp rank's 4 and 2 heads (the head-shard mode)
    *[(1, 40, hw, c, h, 132) for c, hw in ((64, 1024), (128, 256), (64, 256), (256, 64), (128, 64),
                                           (512, 16), (256, 16)) for h in (4, 2)]])
def test_temporal_layer_plan_covers_every_pixel_once(b, f, hw, c, heads, sms):
    """The bf16 launch plan: cluster y of batch entry z owns pixels [y P,
    min((y+1) P, HW)), none empty, every pixel once; K divides heads and is
    at most 8; of the clusters (K >= 2) the smallest whose grid has a block
    for every two SMs (else the largest that fits), unless K = 1 fits and
    its waves times heads are at most the cluster's waves times (heads per
    block + 1); one warp per 16-row query strip, at most 8; the ranks'
    column slices of the reduction cover the C/4 float4 columns once; the
    block fits the card's shared memory; P is cut only to keep two blocks
    per SM."""
    plan = A.temporal_layer_plan(b, f, hw, c, heads, sms)
    p, k = plan["pixels"], plan["cluster"]
    ks = [d for d in range(1, 9) if heads % d == 0]
    assert k in ks and plan["heads_per_block"] * k == heads
    fits = lambda kk: A.temporal_layer_smem(f, c, 1, heads // kk) <= A._MAX_SMEM
    forced = {kk: A.temporal_layer_plan(b, f, hw, c, heads, sms, kk) for kk in ks if fits(kk)}
    clustered = [kk for kk in forced if kk > 1]
    small = [kk for kk in clustered if b * forced[kk]["grid"][1] * kk >= sms / 2]
    best = small[0] if small else (clustered[-1] if clustered else None)
    one_wins = 1 in forced and (best is None or forced[1]["waves"] * heads
                                <= forced[best]["waves"] * (heads // best + 1))
    assert k == (1 if one_wins else best)
    assert plan["warps"] == p * -(-f // 16) <= 8
    assert plan["grid"] == (k, -(-hw // p), b)
    seen = []
    for y in range(plan["grid"][1]):
        x0, x1 = y * p, min((y + 1) * p, hw)
        assert x1 > x0
        seen.extend(range(x0, x1))
    assert seen == list(range(hw))
    cols = [ch for r in range(k) for ch in range(r * (c // 4) // k, (r + 1) * (c // 4) // k)]
    assert cols == list(range(c // 4))
    assert plan["smem"] == A.temporal_layer_smem(f, c, p, heads // k) <= A._MAX_SMEM
    if p < min(8 // -(-f // 16), hw) and A.temporal_layer_smem(f, c, p + 1, heads // k) <= A._MAX_SMEM:
        assert b * -(-hw // (p + 1)) * k < 2 * sms


@pytest.mark.parametrize("c,hw,k", [(64, 1024, 1), (128, 256, 1), (64, 256, 2), (256, 64, 2),
                                    (128, 64, 2), (512, 16, 8), (256, 16, 8)])
def test_temporal_layer_plan_at_the_serving_shapes(c, hw, k):
    """At B=1 on the H100's 132 SMs the plan takes, at each serving shape,
    the cluster size that the cluster scan read fastest (or within 3% of
    it, (128, 64)): K = 1 at the two largest levels, 8 at 16 pixels."""
    assert A.temporal_layer_plan(1, 40, hw, c, 8, 132)["cluster"] == k


def test_bench_temporal_layer_reads_the_serving_shapes():
    """`scripts/bench_temporal_layer.py`, `bench_attn_ablate --serving` and
    `chip_smoke.py` read the serving shapes from one table
    (`_common.TEMPORAL_SHAPES`): ten calls per eval, the 100 launches per
    video that `chip_smoke.py` counts; the script's layer arguments are ones
    the layer takes; it reads through the one layer bench
    (`_common.run_layer`), one launch per call; its reading needs the
    card."""
    import chip_smoke
    from cvpr23_lfdm_torch.scripts import _common, bench_attn_ablate
    from cvpr23_lfdm_torch.scripts import bench_temporal_layer as bench

    assert sum(_common.TEMPORAL_SHAPES.values()) * _common.DDIM_STEPS == 100
    assert bench.LAYER.shapes is _common.TEMPORAL_SHAPES is bench_attn_ablate.TEMPORAL_SHAPES
    assert (_common.F, _common.HEADS, _common.D, _common.DDIM_STEPS) == (
        chip_smoke.F_FRAMES, chip_smoke.HEADS, chip_smoke.DH, chip_smoke.DDIM_STEPS)
    assert bench.LAYER.launches == 1 and bench.LAYER.fn is A.fused_temporal_layer
    assert list(bench.LAYER.scan(16)) == ["K=1", "K=2", "K=4", "K=8"]
    args = bench.make_args(64, 4, "cpu")
    assert args[0].dtype == torch.bfloat16 and tuple(args[0].shape) == (1, bench.F, 4, 64)
    assert A.fused_temporal_layer(*args).shape == args[0].shape
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            bench_attn_ablate.run_serving()
        with pytest.raises(RuntimeError):
            _common.run_layer(bench.LAYER)


def test_bench_linear_layer_reads_the_serving_shapes():
    """`scripts/bench_linear_layer.py` and `chip_smoke.py` read the linear
    layer's serving shapes from one table (`_common.LINEAR_SHAPES`): eight
    calls per eval, the 80 launches per video that `chip_smoke.py` counts;
    the script's layer arguments are ones the layer takes; it reads through
    the one layer bench (`_common.run_layer`), two launches per call, split
    by kernel name; its scan forces only tiles the frame can take; its
    reading needs the card."""
    import inspect

    import chip_smoke
    from cvpr23_lfdm_torch.scripts import _common
    from cvpr23_lfdm_torch.scripts import bench_linear_layer as bench

    assert sum(_common.LINEAR_SHAPES.values()) * _common.DDIM_STEPS == 80
    assert bench.LAYER.shapes is _common.LINEAR_SHAPES
    assert not hasattr(chip_smoke, "LINEAR_SHAPES")
    assert "import LINEAR_SHAPES, TEMPORAL_SHAPES" in inspect.getsource(chip_smoke.check_kernels)
    assert bench.LAYER.launches == 2 and bench.LAYER.by == ("context", "output")
    assert bench.LAYER.fn is A.fused_spatial_linear_layer
    assert list(bench.scan(16)) == ["G=1,R=16", "G=2,R=16", "G=4,R=16", "G=8,R=16"]
    assert len(bench.scan(1024)) == 16
    args = bench.make_args(64, 4, "cpu")
    assert args[0].dtype == torch.bfloat16 and tuple(args[0].shape) == (1, _common.F, 4, 64)
    assert A.fused_spatial_linear_layer(*args).shape == args[0].shape
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            _common.run_layer(bench.LAYER)


def test_temporal_layer_plan_raises_when_no_block_fits():
    with pytest.raises(ValueError, match="shared memory"):
        A.temporal_layer_plan(1, 64, 16, 1024, 16, 132)


def _linear_args(dev, dtype, b, f, n, c, heads=8, seed=1, branch=False):
    """Seeded layer arguments. With unit inputs (x ~ N(0, 1), W_out / sqrt(hd))
    the attention term W_out·o is ~0.2 / sqrt(HW), below one bf16 ulp of
    the residual, so a fault in the context (its split merge, its scale, a
    head's context for another's) hides under the bf16 gate. `branch` makes
    that term O(1) and the residual small: x / 16 (the LayerNorm does not
    see the scale) and W_out * 2 sqrt(HW), so the gate holds the attention
    branch itself (its rms is 0.36-0.55 at every case here)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    hd = heads * 32
    xs, ws = (1 / 16, 2 * n ** 0.5) if branch else (1.0, 1.0)
    x = (xs * torch.randn(b, f, n, c, generator=g, device=dev)).to(dtype)
    gamma = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
    wqkv = (torch.randn(c, 3 * hd, generator=g, device=dev) / c ** 0.5).to(dtype)
    wout = (ws * torch.randn(hd, c, generator=g, device=dev) / hd ** 0.5).to(dtype)
    bout = 0.1 * torch.randn(c, generator=g, device=dev)
    return (x, gamma, wqkv, wout, bout, heads, 32)


def _close_linear(out, args, dtype, branch):
    """`out` against the plain layer; with branch inputs, first that the
    attention branch (plain - x) is ten times the gate's atol or more."""
    ref = A.fused_spatial_linear_layer_plain(*args)
    if branch:
        rms = float((ref.float() - args[0].float()).pow(2).mean().sqrt())
        assert rms >= 10 * TOL[dtype][0], rms
    _close(out, ref, dtype)


# (B, F, HW, C): the seven serving shapes (B=1, F=40); C = 16, 48 (rows of
# 2 and 6 16-byte chunks: a narrower swizzle), 192 and 320 (the LayerNorm's
# lanes per row a power of two below C / 8); HW = 1, 8, 48 and 100 (a short
# last tile, whose pad rows must not enter the k softmax; 48 and 100 raised
# before the tail was masked); B = 2
_LINEAR_CASES = [(1, 40, 1024, 64), (1, 40, 256, 128), (1, 40, 256, 64), (1, 40, 64, 256),
                 (1, 40, 64, 128), (1, 40, 16, 512), (1, 40, 16, 256),
                 (1, 6, 64, 16), (1, 6, 100, 48), (1, 6, 64, 192), (1, 6, 48, 320),
                 (1, 6, 1, 64), (1, 6, 8, 128), (1, 6, 48, 64), (1, 6, 100, 128), (2, 6, 256, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["unit", "branch"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,f,n,c", _LINEAR_CASES)
def test_fused_spatial_linear_layer_kernel(dev, dtype, b, f, n, c, inputs):
    """Kernel against the plain layer, one count per call, and the same bits
    when run twice (no atomics: the bf16 splits merge in rank order); with
    unit inputs and with inputs that make the attention branch O(1)
    (`_linear_args`)."""
    args = _linear_args(dev, dtype, b, f, n, c, branch=inputs == "branch")
    before = A.fused_spatial_linear_layer.launches
    out = A.fused_spatial_linear_layer(*args)
    assert A.fused_spatial_linear_layer.launches == before + 1
    _close_linear(out, args, dtype, inputs == "branch")
    assert torch.equal(out, A.fused_spatial_linear_layer(*args))


# the head-shard mode of tensor parallelism: (C, HW) of the serving shapes
# (and HW = 6, no power-of-two chunk), at 4 and 2 heads per rank
_HEAD_SHARD_CASES = [(64, 1024), (128, 256), (256, 64), (512, 16), (64, 6)]


def _rank_args(args, row, rank, size):
    """One model rank's slice of 8-head layer arguments: q, k and v columns
    of its heads in W_qkv, its rows of W_out, of the bias and the tables."""
    from cvpr23_lfdm_torch.parallel.mesh import shard_index

    heads = args[-2]
    hl, hd = heads // size, heads * 32
    x, gamma, wqkv, wout = args[:4]
    cols = shard_index(3 * hd, 3, size, rank).to(x.device)
    wq = wqkv.index_select(1, cols).contiguous()
    wo = wout[rank * hl * 32:(rank + 1) * hl * 32].contiguous()
    if row == 2:
        return (x, gamma, wq, wo, args[4], hl, 32)
    b, f = args[4].shape[:2]
    bias = args[4].reshape(b, f, heads, f)[:, :, rank * hl:(rank + 1) * hl].reshape(b, f, hl * f).contiguous()
    cos_t, sin_t = (t.index_select(1, cols).contiguous() for t in args[5:7])
    return (x, gamma, wq, wo, bias, cos_t, sin_t, hl, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["unit", "branch"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("heads", [4, 2])
@pytest.mark.parametrize("row", [1, 2])
@pytest.mark.parametrize("c,hw", _HEAD_SHARD_CASES)
def test_head_shard_mode_kernel(dev, row, dtype, heads, c, hw, inputs):
    """`partial=True` on one rank's heads (8 heads over 8 / `heads` ranks):
    each rank's fp32 out-projection partial against the plain version's, a
    launch and a head-shard launch counted, the same bits twice; the
    partials summed (+ bout), rounded and added to x against the whole
    layer's kernel."""
    branch = inputs == "branch"
    if row == 1:
        full = _temporal_args(dev, dtype, 1, 40, hw, c, 8, False, seed=3, branch=branch)
        fn, plain = A.fused_temporal_layer, A.fused_temporal_layer_plain
    else:
        full = _linear_args(dev, dtype, 1, 40, hw, c, seed=3, branch=branch)
        fn, plain = A.fused_spatial_linear_layer, A.fused_spatial_linear_layer_plain
    total = 0.0
    for rank in range(8 // heads):
        args = _rank_args(full, row, rank, 8 // heads)
        before = (fn.launches, fn.partial_launches)
        out = fn(*args, partial=True)
        assert (fn.launches, fn.partial_launches) == (before[0] + 1, before[1] + 1)
        assert out.dtype == torch.float32 and out.shape == full[0].shape
        _close(out, plain(*args, partial=True), dtype)
        assert torch.equal(out, fn(*args, partial=True))
        total = total + out
    if row == 2:
        total = total + full[4]
    _close(full[0] + total.to(dtype), fn(*full), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster,rows,heads,n,c", [
    (1, 16, 8, 100, 64), (2, 32, 8, 100, 128), (4, 64, 8, 48, 64), (8, 128, 8, 300, 64),
    (8, 16, 8, 20, 512), (2, 128, 8, 1100, 64), (1, 48, 4, 70, 192), (3, 16, 3, 33, 48),
    (2, 32, 16, 40, 64), (8, 16, 8, 30, 16)])
@pytest.mark.parametrize("inputs", ["unit", "branch"])
def test_fused_spatial_linear_layer_kernel_at_forced_plans(dev, monkeypatch, cluster, rows, heads, n, c,
                                                           inputs):
    """The bf16 kernel under a head grouping and tile forced through the
    plan: one head per block (G = heads) or several, G = 3 (uneven column
    slices), ranks with no column (C = 16, G = 8), a frame of more than 8
    tiles (splits that take two), 16 heads; against the plain layer, with
    unit inputs and with an O(1) attention branch, and the same bits
    twice."""
    import functools

    monkeypatch.setattr(A, "linear_layer_plan",
                        functools.partial(A.linear_layer_plan, cluster=cluster, rows=rows))
    args = _linear_args(dev, torch.bfloat16, 2, 5, n, c, heads, seed=9, branch=inputs == "branch")
    out = A.fused_spatial_linear_layer(*args)
    _close_linear(out, args, torch.bfloat16, inputs == "branch")
    assert torch.equal(out, A.fused_spatial_linear_layer(*args))


@pytest.mark.cuda
def test_fused_spatial_linear_layer_bf16_needs_c_multiple_of_16(dev):
    args = _linear_args(dev, torch.bfloat16, 1, 2, 16, 40)
    with pytest.raises(ValueError, match="C % 16"):
        A.fused_spatial_linear_layer(*args)
    f32 = _linear_args(dev, torch.float32, 1, 2, 16, 40)  # fp32 takes any C
    _close(A.fused_spatial_linear_layer(*f32), A.fused_spatial_linear_layer_plain(*f32), torch.float32)


def _linear_smem_spec(kernel, c, rows, heads, groups):
    """The bf16 linear-layer blocks' shared memory as this test reads the
    kernel's layout (`csrc/fused_spatial_linear_layer.cu`, `ctx_layout` and
    `out_layout`); `test_linear_layer_smem_spec_is_the_kernels` holds it to
    the library's own count on the card. Regions start on 128 bytes."""
    up = lambda nbytes: -(-nbytes // 128) * 128
    hpb = heads // groups
    if kernel == 0:  # W_k|W_v [C][64] per head (later per head max|sum|context fp32), x [R][C], gamma
        return up(max(hpb * c * 128, hpb * (64 + 1024) * 4)) + up(rows * c * 2) + c * 4
    cw = 16 * -(-(c // 16) // groups)  # W_q [C][32] and context [32][32] per head, W_out slice,
    return (up(hpb * c * 64) + hpb * 2048 + up(heads * 32 * cw * 2)  # x [R][C], o [R][hd],
            + up(rows * c * 2) + up(rows * heads * 64) + up(c * 4) + cw * 4)  # gamma, b_out slice


@pytest.mark.cuda
def test_linear_layer_smem_spec_is_the_kernels(dev):
    smem = A.linear_layer_smem()
    for c in (16, 48, 64, 128, 192, 320, 512):
        for rows in (16, 32, 48, 64, 128):
            for heads, groups in ((8, 1), (8, 2), (8, 4), (8, 8), (3, 3), (16, 2)):
                for kernel in (0, 1):
                    assert smem(kernel, c, rows, heads, groups) == _linear_smem_spec(
                        kernel, c, rows, heads, groups), (kernel, c, rows, heads, groups)


# (C, HW) -> context (rows, head groups, splits), output (rows, cluster):
# B=1, F=40, 8 heads on the H100's 132 SMs; at each shape the scan's fastest
# forced (G, R) or, at (128, 256), within 2% of it (`bench_linear_layer
# --scan`, which forces both launches alike)
_LINEAR_PLANS = {(64, 1024): ((128, 1, 8), (128, 1)), (128, 256): ((128, 1, 2), (96, 1)),
                 (64, 256): ((128, 1, 2), (128, 1)), (256, 64): ((64, 2, 1), (64, 2)),
                 (128, 64): ((32, 1, 2), (32, 1)), (512, 16): ((16, 4, 1), (16, 4)),
                 (256, 16): ((16, 2, 1), (16, 2))}


@pytest.mark.parametrize("c,hw", list(_LINEAR_PLANS))
def test_linear_layer_plan_at_the_serving_shapes(c, hw):
    """The plan of each serving shape: tile rows, head groups (clusters of
    the output launch), splits of a frame per context cluster, and each
    block's shared memory, which fits the card."""
    plan = A.linear_layer_plan(1, 40, hw, c, 8, 132, _linear_smem_spec)
    ctx, out = plan["context"], plan["output"]
    assert (ctx["rows"], ctx["head_groups"], ctx["splits"]) == _LINEAR_PLANS[(c, hw)][0]
    assert (out["rows"], out["cluster"]) == _LINEAR_PLANS[(c, hw)][1]
    assert ctx["smem"] == _linear_smem_spec(0, c, ctx["rows"], 8, ctx["head_groups"]) <= A._MAX_SMEM
    assert out["smem"] == _linear_smem_spec(1, c, out["rows"], 8, out["cluster"]) <= A._MAX_SMEM


@pytest.mark.parametrize("b,f,hw,c,heads,sms", [
    (1, 40, 1024, 64, 8, 132), (1, 40, 16, 512, 8, 132), (2, 6, 100, 48, 8, 132),
    (1, 6, 1, 64, 8, 132), (1, 40, 5000, 128, 8, 132), (2, 5, 33, 48, 3, 132),
    (1, 17, 1000, 320, 16, 12), (8, 40, 1024, 64, 8, 132), (1, 2, 70, 1024, 8, 132),
    (1, 40, 200, 128, 8, 132), (1, 3, 1000, 64, 8, 132),
    # the serving shapes at a tp rank's 4 and 2 heads (the head-shard mode)
    *[(1, 40, hw, c, h, 132) for c, hw in ((64, 1024), (128, 256), (64, 256), (256, 64), (128, 64),
                                           (512, 16), (256, 16)) for h in (4, 2)]])
def test_linear_layer_plan_covers_every_row_once(b, f, hw, c, heads, sms):
    """The bf16 plan: head groups G divide `heads` with at most 8 heads (one
    context warp each) per group, the smallest whose block fits; tiles of R
    rows (a multiple of 16, at most 128, the least for their count) cover
    the frame's rows once; R is the largest that fits unless the grid of a
    larger one had fewer blocks than half the SMs; the KS splits of a
    context cluster (at most 8) take every KS-th tile, none idle when the
    frame has KS tiles or more; both blocks fit the card's shared
    memory."""
    plan = A.linear_layer_plan(b, f, hw, c, heads, sms, _linear_smem_spec)
    groups = [g for g in range(1, 9) if heads % g == 0 and heads // g <= 8]
    strips = -(-hw // 16)
    for key, gk, kernel in (("context", "head_groups", 0), ("output", "cluster", 1)):
        p = plan[key]
        r, g = p["rows"], p[gk]
        fits = lambda rr, gg: _linear_smem_spec(kernel, c, rr, heads, gg) <= A._MAX_SMEM
        assert g == min(gg for gg in groups if fits(16, gg))
        assert 16 <= r <= 16 * min(8, strips) and r % 16 == 0 and fits(r, g)
        tiles = -(-hw // r)
        assert r == 16 * -(-strips // tiles)  # even tiles
        blocks = lambda rr: (A.linear_layer_plan(b, f, hw, c, heads, sms, _linear_smem_spec, g, rr)
                             [key]["grid"])
        larger = [rr for rr in range(r + 16, 16 * min(8, strips) + 1, 16)
                  if fits(rr, g) and -(-hw // rr) < tiles]
        for rr in larger:  # a larger tile was cut for too few blocks
            assert blocks(rr)[0] * blocks(rr)[1] * b * f < sms / 2
    tiles = -(-hw // plan["context"]["rows"])
    ks = plan["context"]["splits"]
    assert ks == min(8, tiles) and plan["context"]["grid"] == (plan["context"]["head_groups"], ks, b * f)
    seen = sorted(t for y in range(ks) for t in range(y, tiles, ks))
    assert seen == list(range(tiles))
    r2 = plan["output"]["rows"]
    assert plan["output"]["grid"] == (plan["output"]["cluster"], -(-hw // r2), b * f)
    assert heads // plan["context"]["head_groups"] <= 8  # a warp per head


def test_linear_layer_plan_raises_when_no_block_fits():
    with pytest.raises(ValueError, match="shared memory"):
        A.linear_layer_plan(1, 40, 16, 4096, 8, 132, _linear_smem_spec)
    with pytest.raises(ValueError, match="cluster"):
        A.linear_layer_plan(1, 40, 16, 64, 8, 132, _linear_smem_spec, cluster=3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_warp_video_kernel(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(2)
    src = torch.randn(2, 24, 20, 67, generator=g, device=dev).to(dtype)
    grid = 1.4 * torch.rand(2, 5, 24, 20, 2, generator=g, device=dev) * 2 - 1.4
    out = W.warp_video(src, grid)
    atol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), W.warp_video_plain(src, grid).float(), atol=atol, rtol=atol)


def _warp_video_inputs(dev, dtype, c, w, offset, b=2, f=5, h=24, seed=9):
    g = torch.Generator(device=dev).manual_seed(seed)
    n = b * h * w * c
    src = torch.randn(n + offset, generator=g, device=dev).to(dtype)[offset:].view(b, h, w, c)
    grid = 1.4 * torch.rand(b, f, h, w, 2, generator=g, device=dev) * 2 - 1.4
    return src, grid


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,w,offset", [(1, 21, 0), (3, 21, 0), (67, 21, 0), (128, 21, 0),
                                        (256, 21, 0), (8, 20, 0), (128, 21, 1), (67, 20, 1)])
def test_warp_video_kernel_is_bit_equal_to_plain(dev, dtype, c, w, offset):
    """The decode warp on the warp core: C below a unit, odd, and whole
    16-byte units (C = 8, 128, 256 in bf16; 128, 256 in fp32), odd W, grids
    out to +-1.4 (corners off the image), and a source that starts one
    element in (the scalar path); the same values as the plain version, bit
    for bit, in one launch."""
    src, grid = _warp_video_inputs(dev, dtype, c, w, offset)
    before = W.warp_video.launches
    with torch.no_grad():
        out = W.warp_video(src, grid)
    assert W.warp_video.launches == before + 1 and out.dtype == dtype
    assert torch.equal(out, W.warp_video_plain(src, grid))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,c", [(32, 256), (64, 128), (128, 67)])
def test_warp_video_kernel_on_a_band_of_rows(dev, dtype, h, c):
    """Row 3 on a band of output rows (`Ho < Hs`), at the three decode
    scales (B=1, F=40): each band of sp=2 and a band of 3 rows inside the
    image, bit-equal to plain and to those rows of the whole-height call
    (itself bit-equal to plain), one device launch, counted in
    `band_launches`."""
    g = torch.Generator(device=dev).manual_seed(h + c)
    src = torch.randn(1, h, h, c, generator=g, device=dev).to(dtype)
    lin = torch.linspace(-1, 1, h, device=dev)
    ident = torch.stack(torch.meshgrid(lin, lin, indexing="xy"), -1)
    grid = (ident[None, None] + 0.3 * torch.randn(1, 40, h, h, 2, generator=g, device=dev)).contiguous()
    with torch.no_grad():
        whole = W.warp_video(src, grid)
        assert torch.equal(whole, W.warp_video_plain(src, grid))
        for lo, hi in ((0, h // 2), (h // 2, h), (5, 8)):
            band_grid = grid[:, :, lo:hi].contiguous()
            before = (W.warp_video.launches, W.warp_video.band_launches)
            band = W.warp_video(src, band_grid)
            assert (W.warp_video.launches, W.warp_video.band_launches) == (before[0] + 1, before[1] + 1)
            assert band.shape == (1, 40, hi - lo, h, c) and band.dtype == dtype
            assert torch.equal(band, W.warp_video_plain(src, band_grid))
            assert torch.equal(band, whole[:, :, lo:hi])
            assert _one_launch(lambda: W.warp_video(src, band_grid))


@pytest.mark.cuda
def test_kernel_wrappers_check_arguments(dev):
    src = torch.randn(1, 8, 8, 4, device=dev)
    with pytest.raises(TypeError):
        W.warp_video(src, torch.zeros(1, 2, 8, 8, 2, device=dev, dtype=torch.float64))
    with pytest.raises(ValueError):
        W.warp_video(src, torch.zeros(1, 2, 4, 4, 2, device=dev))
    with pytest.raises(ValueError):  # an output band taller than the source
        W.warp_video(src, torch.zeros(1, 2, 9, 8, 2, device=dev))


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


@pytest.mark.parametrize("b,hw,heads", [(b, hw, h) for b in (2, 5) for hw in (1024, 256, 64, 16)
                                         for h in (8, 4, 2)])
def test_headpacked_chunks_at_a_tp_ranks_heads(monkeypatch, b, hw, heads):
    """The head-packed launch's pixel chunks per (batch, head) at 8 heads and
    at a tp rank's 4 and 2 (the training step's HW, B=5 and the tp step's
    B=2): a bf16 grid of about four blocks per SM of the H100, each chunk
    one pixel or more, none past HW; the fp32 backward's chunks of up to 16
    pixels."""
    monkeypatch.setattr(A, "_sm_count", lambda index: 132)
    bf16 = A._headpacked_chunks(torch.empty(b, 1, hw, 3 * heads * 32, dtype=torch.bfloat16), heads)
    assert 1 <= bf16 <= hw and bf16 == min(hw, -(-4 * 132 // (b * heads)))
    fp32 = A._headpacked_chunks(torch.empty(b, 1, hw, 3 * heads * 32), heads)
    assert -(-hw // fp32) <= 16 and fp32 == -(-hw // max(1, min(16, hw // 64)))


# (hw, batch, heads, F, pack, SMs): the serving shapes on 132 SMs, uneven
# splits, a large P at F = 64 (bias slots capped by shared memory), odd sizes
@pytest.mark.parametrize("hw,batch,heads,f,pack,sms", [
    (1024, 1, 8, 40, 4, 132), (256, 1, 8, 40, 4, 132), (64, 1, 8, 40, 4, 132),
    (16, 1, 8, 40, 4, 132), (1024, 1, 8, 40, 4, 12), (1024, 1, 8, 7, 32, 132),
    (4096, 1, 1, 64, 4096, 132), (6, 2, 8, 48, 2, 132), (1000, 2, 3, 33, 8, 132),
    # a tp rank's 4 and 2 heads at the serving shapes
    *[(hw, 1, h, 40, 4, 132) for hw in (1024, 256, 64, 16) for h in (4, 2)]])
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


def _norm_args(dev, dtype, b, f, h, c, film, offset=0, seed=10):
    g = torch.Generator(device=dev).manual_seed(seed)
    n = b * f * h * h * c
    x = (1.5 * torch.randn(n + offset, generator=g, device=dev) + 0.3).to(dtype)
    x = x[offset:].view(b, f, h, h, c)
    gamma = 1 + 0.3 * torch.randn(c, generator=g, device=dev)
    beta = 0.2 * torch.randn(c, generator=g, device=dev)
    ss = ()
    if film == "unet":  # as the bf16 UNet passes it: halves of one [B, 1, 1, 1, 2C] tensor
        ss = torch.randn(b, 1, 1, 1, 2 * c, generator=g, device=dev).to(dtype).chunk(2, dim=-1)
    elif film == "bf16":  # bf16 tables beside an fp32 x, gamma and beta in bf16 too
        ss = tuple(torch.randn(b, c, generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
        gamma, beta = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)
    return (x, gamma, beta, *ss)


def _one_launch(call) -> bool:
    """One device launch of the norm kernel per call, and no other."""
    from cvpr23_lfdm_torch.scripts.bench_norm import device_reading, one_launch

    return one_launch(*device_reading(call, reps=3)[1:])


# (B, F, H, C): every Block shape of a B=1 serving eval, B=8 at (32², 64)
# (42 MB of bf16: more than the blocks' shared memory holds, so part of it is
# read twice), C = 24 (the scalar path) and C = 768
_NORM_CASES = [(1, 40, 32, 64), (1, 40, 16, 128), (1, 40, 16, 64), (1, 40, 8, 256),
               (1, 40, 8, 128), (1, 40, 4, 512), (1, 40, 4, 256), (8, 40, 32, 64),
               (2, 3, 5, 24), (1, 2, 3, 768)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("film", ["none", "unet"])
@pytest.mark.parametrize("b,f,h,c", _NORM_CASES)
def test_groupnorm_film_silu_kernel_at_the_unet_shapes(dev, dtype, film, b, f, h, c):
    """One device launch per call (no cast or copy of the tables), the same
    bits when run again, and within the card's tolerance of the plain
    version."""
    groups = 4 if c == 24 else 8
    args = _norm_args(dev, dtype, b, f, h, c, film)
    call = lambda: N.groupnorm_film_silu(*args, groups=groups)
    with torch.no_grad():
        out = call()
        assert torch.equal(out, call())
        assert _one_launch(call)
    _close(out, N.groupnorm_film_silu_plain(*args, groups=groups), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("offset,film", [(1, "unet"), (0, "bf16"), (1, "none")])
def test_groupnorm_film_silu_kernel_scalar_path_and_tables(dev, dtype, offset, film):
    """An x that starts one element in takes the scalar path; bf16 tables
    beside an fp32 x are read as they are."""
    args = _norm_args(dev, dtype, 1, 40, 8, 128, film, offset)
    assert N.norm_vec(128, 8, args[0].element_size(), args[0].data_ptr()) == (1 if offset else 16 // args[0].element_size())
    with torch.no_grad():
        out = N.groupnorm_film_silu(*args)
        assert _one_launch(lambda: N.groupnorm_film_silu(*args))
    _close(out, N.groupnorm_film_silu_plain(*args), dtype)


@pytest.mark.cuda
def test_groupnorm_film_silu_smem_limit_is_the_kernels(dev):
    from cvpr23_lfdm_torch.ops import _build

    assert _build.bind("groupnorm_film_silu", "groupnorm_film_silu_smem_limit", [])() == N._SMEM
    for bf16 in (False, True):
        for vec in (False, True):
            assert N._blocks_per_sm(dev.index or 0, bf16, vec) >= 1


@pytest.mark.parametrize("b,f,h,c,groups,esz", [
    (1, 40, 32, 64, 8, 2), (8, 40, 32, 64, 8, 2), (1, 40, 4, 256, 8, 2), (1, 40, 4, 512, 8, 4),
    (2, 3, 5, 24, 4, 4), (1, 2, 3, 768, 8, 2), (8, 40, 32, 64, 8, 4), (3, 7, 9, 2048, 8, 4)])
@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("sms,per_sm", [(132, 2), (132, 1), (16, 2)])
def test_norm_plan_covers_every_row_once(b, f, h, c, groups, esz, vec, sms, per_sm):
    """Every row of a batch entry in one block, no empty block, the grid
    within what the card holds at once, the held rows and the scratch
    within the block's shared memory."""
    n = f * h * h
    v = 16 // esz if vec else 1
    plan = N.norm_plan(b, n, c, groups, esz, v, sms, per_sm)
    assert plan.vec == v and plan.blocks >= 1 and b * plan.blocks <= sms * per_sm
    assert plan.blocks * plan.rows >= n > (plan.blocks - 1) * plan.rows
    assert 0 <= plan.hold_rows <= plan.rows and plan.smem <= N._SMEM
    assert plan.smem == N._scratch(c, groups, v) + plan.hold_rows * c * esz
    assert plan.smem % 16 == 0 or c * esz % 16  # rows of whole vectors stay 16-byte aligned
    if plan.hold_rows < plan.rows:  # a block takes every row that fits
        assert plan.smem + c * esz > N._SMEM


def test_norm_plan_at_the_unet_shapes():
    """On 132 SMs at two blocks each: B=1 holds every row in shared memory
    (the largest shape, (32², 64), on 263 blocks), small shapes take few
    blocks (8192 elements or more each), and B=8 at (32², 64) holds 863 of
    each block's 1242 rows (about 29 MB over the card) and reads the rest
    twice."""
    from cvpr23_lfdm_torch.scripts.bench_norm import NORM_SHAPES

    for (h, c) in NORM_SHAPES:
        plan = N.norm_plan(1, 40 * h * h, c, 8, 2, 8, 132, 2)
        assert plan.hold_rows == plan.rows
        assert plan.blocks == min(263 if (h, c) == (32, 64) else 264, -(-40 * h * h * c // 8192))
    big = N.norm_plan(8, 40 * 32 * 32, 64, 8, 2, 8, 132, 2)
    assert (big.blocks, big.rows, big.hold_rows) == (33, 1242, 863)
    assert 8 * big.blocks * big.hold_rows * 64 * 2 > 29e6
    with pytest.raises(ValueError, match="blocks the card holds"):
        N.norm_plan(300, 64, 64, 8, 2, 8, 132, 2)


@pytest.mark.parametrize("c,groups,esz,ptr,vec", [
    (64, 8, 2, 0, 8), (64, 8, 4, 0, 4), (24, 4, 4, 0, 1), (24, 4, 2, 0, 1), (768, 8, 2, 0, 8),
    (128, 8, 2, 2, 1), (128, 8, 4, 4, 1), (128, 8, 4, 16, 4), (32, 8, 2, 0, 1), (32, 8, 4, 0, 4)])
def test_norm_vec_takes_the_path_by_shape_and_alignment(c, groups, esz, ptr, vec):
    """16-byte vectors where C and C / groups are whole vectors and x
    starts on 16 bytes (y always does); else the scalar path."""
    assert N.norm_vec(c, groups, esz, ptr) == vec


def test_bench_norm_reads_the_unet_shapes():
    """`scripts/bench_norm.py` and `chip_smoke.py` read the Block shapes
    from one table: 40 calls per eval; the script's arguments are laid out
    as the bf16 UNet passes them; the launch gate they share; its reading
    needs the card."""
    import inspect

    import chip_smoke
    from cvpr23_lfdm_torch.scripts import bench_norm

    assert sum(sum(v) for v in bench_norm.NORM_SHAPES.values()) == bench_norm.BLOCKS_PER_EVAL == 40
    assert not hasattr(chip_smoke, "NORM_SHAPES")
    assert "import NORM_SHAPES" in inspect.getsource(chip_smoke.check_new_kernels)
    x, gamma, beta, scale, shift = bench_norm.make_args(2, 4, 16, True, "cpu")
    assert x.dtype == scale.dtype == torch.bfloat16 and tuple(x.shape) == (2, bench_norm.F, 4, 4, 16)
    assert not scale.is_contiguous() and scale.stride()[0] == 32 and shift.storage_offset() == 16
    assert N.groupnorm_film_silu(x, gamma, beta, scale, shift).shape == x.shape
    # the launch gate: the kernel alone, a count the profiler may have cut but not raised
    assert bench_norm.one_launch(1, 0) and bench_norm.one_launch(0.9, 0)
    assert bench_norm.one_launch(38.33, 0, 40) and bench_norm.one_launch(40, 0, 40)
    assert not any((bench_norm.one_launch(0, 0), bench_norm.one_launch(2, 0),
                    bench_norm.one_launch(1, 1), bench_norm.one_launch(40, 36, 40)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            bench_norm.run()


# (H, C): one Block shape of each resolution of a B=32 serving eval
_B32_SHAPES = [(32, 64), (16, 128), (8, 256), (4, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("h,c", _B32_SHAPES)
def test_groupnorm_film_silu_kernel_with_pre_bias_at_the_b32_serving_shapes(dev, h, c):
    """bf16, the FiLM pair and the bf16 conv bias as the serving UNet passes
    them, at B=32 (at 32² most rows are read twice): one device launch per
    call, the same bits again, within the card's tolerance of the plain
    version."""
    from cvpr23_lfdm_torch.scripts.bench_norm import pre_bias

    args = _norm_args(dev, torch.bfloat16, 32, 40, h, c, "unet")
    bias = pre_bias(c, dev)
    call = lambda: N.groupnorm_film_silu(*args, pre_bias=bias)
    with torch.no_grad():
        out = call()
        assert torch.equal(out, call())
        assert _one_launch(call)
    _close(out, N.groupnorm_film_silu_plain(*args, pre_bias=bias), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_groupnorm_film_silu_kernel_pre_bias_in_other_layouts_and_a_clamped_variance(dev, dtype):
    """A pre_bias in fp32 beside either x (the sum rounded to x's dtype), in
    bf16 at stride 2 and in bf16 one element in (off the 16-byte load of a
    unit-stride bf16 bias), on the 16-byte path and on the scalar path
    (C = 24, and a view one element in); and a constant x whose variance
    may cancel below 0, with and without a pre_bias: finite, as the plain
    version."""
    for c, offset in ((128, 0), (24, 0), (128, 1)):
        args = _norm_args(dev, dtype, 2, 40, 8, c, "unet", offset=offset)
        wide = 0.5 * torch.randn(2 * c + 1, device=dev)
        for bias in (wide[:c], wide.to(torch.bfloat16)[: 2 * c : 2], wide.to(torch.bfloat16)[1 : c + 1]):
            with torch.no_grad():
                out = N.groupnorm_film_silu(*args, pre_bias=bias)
            _close(out, N.groupnorm_film_silu_plain(*args, pre_bias=bias), dtype)
    flat = torch.full((1, 2, 4, 4, 16), 370.1754455566406, device=dev).to(dtype)
    ones, halves = torch.ones(16, device=dev), 0.5 * torch.ones(16, device=dev)
    for pre in (None, torch.zeros(16, device=dev)):
        with torch.no_grad():
            out = N.groupnorm_film_silu(flat, ones, halves, pre_bias=pre)
        assert torch.isfinite(out).all()


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
    with pytest.raises(ValueError):
        N.groupnorm_film_silu(x, gamma, beta, pre_bias=torch.zeros(8, device=dev))
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
        for stage in ("scores", "reduce"):  # builds, launches; values mean nothing
            out = A.fused_temporal_layer_ablated(stage, *args)
            assert out.shape == want.shape
    assert (A.fused_temporal_layer.launches, A.fused_temporal_layer_ablated.launches) == (
        before[0], before[1] + 3)
    with pytest.raises(ValueError):
        A.fused_temporal_layer_ablated("kvbuild", *args)


# ---------------------------------------------------------------- LFAE training


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in STEP_WARPS if c[5]], ids=lambda c: c[0])
def test_train_warp_matches_plain_at_the_step_shapes(dev, case):
    """The LFAE training path's differentiable warp (`train_warp`, one
    `F.grid_sample`) against the plain `grid_sample` at each warp of a MUG
    training step (B=4), forward and both gradients. Forward 1e-5 (fp32,
    four weighted corners); gradients 1e-4 of their largest value (both add
    with atomics in another order; the grid's sums over C channels)."""
    name, image_shape, grid_shape, image_grad, _, _ = case
    image, grid = make_case(4, image_shape, grid_shape, dev)
    cot = torch.randn(4, *grid_shape, image_shape[2], device=dev,
                      generator=torch.Generator(device=dev).manual_seed(1))
    results = []
    for fn in (W.train_warp, W.grid_sample):
        img = image.clone().requires_grad_(image_grad)
        g = grid.clone().requires_grad_()
        out = fn(img, g)
        out.backward(cot)
        results.append([out.detach(), g.grad] + ([img.grad] if image_grad else []))
    torch.testing.assert_close(results[0][0], results[1][0], atol=1e-5, rtol=0)
    for got, want in zip(results[0][1:], results[1][1:]):
        torch.testing.assert_close(got, want, atol=1e-4 * float(want.abs().max()), rtol=0)


def _tiny_lfae_cfg():
    from cvpr23_lfdm_torch import config as C

    narrow = dict(block_expansion=8, max_features=32)
    lfae = C.LFAEConfig(
        frame_shape=32, num_regions=4,
        region_predictor=C.RegionPredictorConfig(num_regions=4, num_blocks=2, **narrow),
        bg_predictor=C.BGPredictorConfig(num_blocks=2, **narrow),
        generator=C.GeneratorConfig(num_bottleneck_blocks=1, **narrow,
                                    pixelwise_flow=C.PixelwiseFlowConfig(num_blocks=2, **narrow)))
    return C.ExperimentConfig(lfae=lfae, lfae_train=C.LFAETrainConfig(scales=(1.0, 0.5)))


@pytest.mark.cuda
def test_lfae_reconstruct_runs_row3_and_train_step_runs_none(dev, monkeypatch):
    """`LFAETrainer.reconstruct` (eval) launches the decode warp (row 3) four
    times (three decode scales, the deformed source) and matches the plain
    warps' reconstruction within 1e-4 (fp32, TF32 off: row 3 is bit-equal to
    plain; the convolutions are the same calls); a `train_step` launches no
    kernel of the port and has finite losses."""
    from cvpr23_lfdm_torch.train.dm_trainer import step_generator
    from cvpr23_lfdm_torch.train.lfae_trainer import LFAETrainer

    trainer = LFAETrainer(_tiny_lfae_cfg(), steps_per_epoch=10, device=dev)
    state = trainer.init_state(seed=0)
    g = torch.Generator(device=dev).manual_seed(2)
    batch = {k: torch.rand(2, 32, 32, 3, generator=g, device=dev) for k in ("source", "driving")}
    before = W.warp_video.launches
    state, m = trainer.train_step(state, step_generator(0, 0, dev), batch)
    assert W.warp_video.launches == before
    assert all(torch.isfinite(v) for v in m.values())
    out = trainer.reconstruct(state, batch["source"], batch["driving"])
    assert W.warp_video.launches == before + 4
    monkeypatch.setattr(W, "warp_video", W.warp_video_plain)
    plain = trainer.reconstruct(state, batch["source"], batch["driving"])
    torch.testing.assert_close(out["prediction"], plain["prediction"], atol=1e-4, rtol=0)
