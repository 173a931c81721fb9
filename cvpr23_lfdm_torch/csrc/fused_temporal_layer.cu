// Whole PreNorm temporal-attention layer of the UNet in one launch:
//   out = x + W_out . MHA(rotary(W_qkv . LN(x)))
// with attention over the F frames of each pixel, per head of D = 32.
//
// Replaces the Pallas TPU kernel cvpr23_lfdm_tpu/ops/attention_pallas.py::
// fused_temporal_layer (_fused_layer_kernel). See ops/attention.py for the
// plain version this kernel is held against.
//
// Bound on the H100: operations (~7 GFLOP for 10 MB of activations at the
// 64-channel 32x32 level): the two projections are most of the work.
//
// bf16 (the `pallas3` serving form): tensor cores, heads spread over the
// blocks of a thread-block cluster. The K blocks of a cluster share a chunk
// of P pixels of one batch entry, each with heads / K of the heads; the
// wrapper picks K (a divisor of heads up to 8) and P (ops/attention.py::
// temporal_layer_plan): one warp per 16-row query strip, P * ceil(F / 16) <=
// 8 of them; K = 1 (no exchange) where the grid fills the card in as few
// waves of whole-layer blocks, at the two largest levels; else the smallest
// K whose grid still has a block for every two SMs (K = 2 at the middle
// levels, where fewer blocks per cluster recompute the LN and exchange less;
// K = 8, one head per block, at the 16-pixel levels, so that 16 pixels still
// give 128 blocks). Each block, in order: copies its x
// rows [P * FP, C] (FP = 16 * ceil(F / 16), pixel-major, pad rows zero) and
// gamma with 16-byte cp.async into an XOR-swizzled bf16 tile, and
// LayerNorms them in place (fp32 statistics, var = E[x^2] - mean^2, rounded
// to bf16 as the plain version rounds LN(x); every block of a cluster
// recomputes it: R * C work that saves an exchange). Then per head: the
// head's 96 q|k|v columns of W_qkv, staged whole by cp.async (the next
// head's during this head's attention), times the tile on
// mma.sync.m16n8k16 (bf16 operands, fp32 sums; a warp owns one 16-row strip
// and one 32-column part at a time); rotary (q-scale folded into the table,
// whose entries for the warp's rows are loaded into registers before the
// product) on the C fragments, whose pair (c[0], c[1]) is exactly one
// interleaved rotary pair, rounded to bf16 into swizzled q, k, v tiles;
// attention per pixel with mma.cuh's strips (scores, the [F, F] bias slice
// of bias_flat for (batch, head), a max per head, e = exp(s - m) rounded to
// bf16 both as the A fragments of p.v and in the denominator, o = num / den
// rounded afterwards: the rounding points of _fused_layer_kernel); and
// o [16, 32] times the head's rows of W_out on mma.sync, added into the
// block's fp32 partial [P * F, C] in shared memory (with one head per block
// it takes the place of the x tile and W_qkv, dead by then). Last, the
// cluster reduction in a fixed order: after cluster.sync(), the block of
// rank r sums columns [r C / K, (r + 1) C / K) of the K partials through
// distributed shared memory (mapa + ld.shared::cluster, all K loads in
// flight) in rank order 0..K-1 and writes out = x + round(sum); a second
// cluster.sync() keeps every block's shared memory alive until all have
// read it. The fp32 sums change order only; no atomics, so the output is the
// same bit for bit from run to run. Needs C % 16 == 0 and 16-byte aligned
// tensors; the wrapper raises where a plan does not fit (it never reroutes).
//
// fp32: CUDA cores (mma on fp32 operands would be TF32, ten mantissa bits,
// against the fp32 gates' 2e-4). One block owns P pixels of one batch entry
// (P*C <= 256, so the rows R = P*F fit shared memory) and runs the whole
// layer there: LN of the R rows; then per head the 96 q|k|v columns of the
// projection (tiled FMA product over shared memory), rotary, softmax
// attention over the F frames (one warp per query row, lanes over keys, a
// max per head, the additive bias from bias_flat, which carries the
// focus-present NEG_INF entries), and that head's slice of the
// out-projection accumulated in fp32; finally the residual.
//
// Layouts: x, out [B, F, HW, C]; gamma [C] fp32; wqkv [C, 3*heads*D];
// wout [heads*D, C]; bias_flat [B, F, heads*F] fp32; cos/sin [F, 3*heads*D].
//
// Ablation builds (timing only, the output is NOT the layer's): compiling
// with one of -DLFDM_ABLATE_LAYERNORM, _QKV, _ROTARY, _SCORES, _SOFTMAX, _PV,
// _OUTPROJ removes that stage of the kernel (named after the stages above),
// so that `full - variant` attributes device time to it; -DLFDM_ABLATE_REDUCE
// (bf16 only) has each block write its own partial's columns with no
// distributed-shared-memory sum and no cluster barrier, so that `full -
// reduce` prices the cluster exchange. They stand in for the variants of the
// TPU's scripts/bench_attn_ablate.py (make_kernel, call); its kvbuild, kt and
// kt_vm variants ablate the TPU kernel's head-tiled K/V construction, which
// this kernel does not have. Without a define this file compiles to the
// serving kernel.

#include <cooperative_groups.h>

#include "cluster_launch.cuh"
#include "common.cuh"
#include "mma.cuh"

namespace lfdm {
namespace {

constexpr int D = 32;           // dim_head
constexpr int HS = 3 * D + 1;   // head-buffer row stride (odd: conflict-free)

struct QkvCols {  // column n in [0, 96) of head g -> column of wqkv
  int hd, g;
  __device__ int operator()(int n) const { return (n / D) * hd + g * D + (n % D); }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_temporal_layer_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                            const T* __restrict__ wqkv, const T* __restrict__ wout,
                            const float* __restrict__ bias_flat, const T* __restrict__ cos_t,
                            const T* __restrict__ sin_t, T* __restrict__ out, int F, int HW,
                            int C, int heads, int P, float eps) {
  extern __shared__ float smem[];
  const int hd = heads * D;
  const int R = P * F;  // row r = p * F + f
  const int ldx = C + 1;
  float* xn = smem;             // [R][C+1] LN(x), rounded to T
  float* acc = xn + R * ldx;    // [R][C]   out-projection accumulator
  float* hb = acc + R * C;      // [R][HS]  head g's q|k|v; o replaces q
  float* Bs = hb + R * HS;      // [32][64] staged weight tile

  const int b = blockIdx.y;
  const int p0 = blockIdx.x * P;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  auto row_ptr = [=](int r) {
    return x + (((long long)b * F + r % F) * HW + p0 + r / F) * C;
  };

#ifdef LFDM_ABLATE_LAYERNORM
  for (int e = threadIdx.x; e < R * C; e += kThreads)
    xn[(e / C) * ldx + e % C] = to_f<T>(row_ptr(e / C)[e % C]);
  __syncthreads();
#else
  layer_norm_rows<T>(row_ptr, R, C, gamma, eps, xn, ldx);
#endif
  for (int e = threadIdx.x; e < R * C; e += kThreads) acc[e] = 0.f;

  for (int g = 0; g < heads; ++g) {
#ifdef LFDM_ABLATE_QKV
    __syncthreads();
    for (int e = threadIdx.x; e < R * 3 * D; e += kThreads)
      hb[(e / (3 * D)) * HS + e % (3 * D)] = xn[(e / (3 * D)) * ldx + e % C];
    __syncthreads();
#else
    block_gemm<T, 4, false>(xn, ldx, R, C, wqkv, 3 * hd, 3 * D, QkvCols{hd, g}, hb, HS, Bs);
#endif

    // rotary on interleaved pairs: (a0, a1) -> (a0 c0 - a1 s0, a1 c1 + a0 s1);
    // the v columns have cos 1, sin 0. Rounded to T as the Pallas kernel does.
#ifndef LFDM_ABLATE_ROTARY
    for (int e = threadIdx.x; e < R * (3 * D / 2); e += kThreads) {
      const int r = e / (3 * D / 2), n = 2 * (e % (3 * D / 2));
      const long long t = (long long)(r % F) * 3 * hd + QkvCols{hd, g}(n);
      const float a0 = hb[r * HS + n], a1 = hb[r * HS + n + 1];
      hb[r * HS + n] = rnd<T>(a0 * to_f<T>(cos_t[t]) - a1 * to_f<T>(sin_t[t]));
      hb[r * HS + n + 1] = rnd<T>(a1 * to_f<T>(cos_t[t + 1]) + a0 * to_f<T>(sin_t[t + 1]));
    }
    __syncthreads();
#endif

    // attention: one warp per query row (p, i); lanes hold keys j and j+32
    for (int r = warp; r < R; r += kThreads / 32) {
      const int p = r / F, i = r % F;
      const float* q = hb + r * HS;
      const float* bias = bias_flat + ((long long)blockIdx.y * F + i) * heads * F + g * F;
      float s[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = lane + 32 * h;
        s[h] = -INFINITY;
        if (j < F) {
          const float* k = hb + (p * F + j) * HS + D;
          float d = 0.f;
#ifdef LFDM_ABLATE_SCORES
          d = q[0] + k[0];
#else
#pragma unroll
          for (int t = 0; t < D; ++t) d = fmaf(q[t], k[t], d);
#endif
          s[h] = d + bias[j];
        }
      }
#ifdef LFDM_ABLATE_SOFTMAX
      const float e0 = lane < F ? s[0] : 0.f;
      const float e1 = lane + 32 < F ? s[1] : 0.f;
      const float den = 1.f;
#else
      const float m = warp_max(fmaxf(s[0], s[1]));
      const float e0 = lane < F ? rnd<T>(expf(s[0] - m)) : 0.f;
      const float e1 = lane + 32 < F ? rnd<T>(expf(s[1] - m)) : 0.f;
      const float den = fmaxf(warp_sum(e0 + e1), 1.17549435e-38f);
#endif
      float o = 0.f;
#ifdef LFDM_ABLATE_PV
      o = e0 + e1 + hb[r * HS + 2 * D + lane];
#else
      for (int j = 0; j < F; ++j) {
        const float ej = __shfl_sync(kFull, j < 32 ? e0 : e1, j & 31);
        o = fmaf(ej, hb[(p * F + j) * HS + 2 * D + lane], o);
      }
#endif
      __syncwarp();
      hb[r * HS + lane] = rnd<T>(o / den);  // this row's q is no longer read
    }
    __syncthreads();

#ifdef LFDM_ABLATE_OUTPROJ
    for (int e = threadIdx.x; e < R * C; e += kThreads) acc[e] += hb[(e / C) * HS + e % D];
    __syncthreads();
#else
    block_gemm<T, 4, true>(hb, HS, R, D, wout + (long long)g * D * C, C, C, Identity{}, acc,
                           C, Bs);
#endif
  }

  for (int e = threadIdx.x; e < R * C; e += kThreads) {
    const int r = e / C, c = e % C;
    const long long gi = (((long long)b * F + r % F) * HW + p0 + r / F) * C + c;
    out[gi] = from_f<T>(to_f<T>(x[gi]) + rnd<T>(acc[e]));
  }
}

// ---------------------------------------------------------------- bf16: tensor cores

using bf16 = __nv_bfloat16;
namespace cg = cooperative_groups;

constexpr int kMaxSmem = 232448;  // dynamic shared memory of one block on the H100
constexpr int kMaxWarps = 8;      // query strips (warps) of a block
constexpr int kMaxCluster = 8;    // blocks of a cluster (portable size)

// A block's shared memory, byte offsets (mirrored by ops/attention.py::
// temporal_layer_smem): the x tile [P*FP][C] bf16, the head's W_qkv columns
// as three [C][32] bf16 tiles, the fp32 partial [P*F][C+8] (with one head per
// block it overlays the x tile and W_qkv, both dead by then), the head's
// W_out rows [32][C] bf16, the q, k, v tiles [P*FP][32] bf16, the [F, F]
// fp32 bias and the LN gamma [C] fp32.
struct Layout {
  int x, w, part, wout, tiles, bias, gamma, total;
};

__host__ __device__ inline Layout layout(int F, int C, int P, int hpb) {
  const int FP = 16 * ((F + 15) / 16);
  const int xb = P * FP * C * 2, wb = 3 * C * 64;
  const int pb = (P * F * (C + 8) * 4 + 127) / 128 * 128;
  Layout L;
  L.x = 0;
  L.w = xb;
  L.part = hpb == 1 ? 0 : xb + wb;
  int top = hpb == 1 ? (xb + wb > pb ? xb + wb : pb) : xb + wb + pb;
  L.wout = top;
  top += 64 * C;
  L.tiles = top;
  top += 3 * P * FP * 64;
  L.bias = top;
  top += (F * F * 4 + 127) / 128 * 128;
  L.gamma = top;
  top += 4 * C;
  L.total = top;
  return L;
}

// NT = ceil(F / 8) key tiles of 8, KT = ceil(F / 16) query strips of 16 per
// pixel. Grid (K, ceil(HW / P), B), clusters of (K, 1, 1), P * KT warps.
template <int NT>
__global__ void __launch_bounds__(kMaxWarps * 32)
fused_temporal_layer_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                                const bf16* __restrict__ wqkv, const bf16* __restrict__ wout,
                                const float* __restrict__ bias_flat, const bf16* __restrict__ cos_t,
                                const bf16* __restrict__ sin_t, bf16* __restrict__ out, int F,
                                int HW, int C, int heads, int P, int K, float eps) {
  constexpr int KT = (NT + 1) / 2, FP = 16 * KT;
  extern __shared__ __align__(128) char tl_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int hpb = heads / K, hd = heads * D, RB = 2 * C, LDP = C + 8, SM = swz_mask(C / 8);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, q2 = 2 * (lane & 3);
  const int pix0 = blockIdx.y * P, np = min(P, HW - pix0);
  const long long b = blockIdx.z;
  const Layout L = layout(F, C, P, hpb);
  char* sx = tl_smem + L.x;
  float* spart = reinterpret_cast<float*>(tl_smem + L.part);
  char* tiles = tl_smem + L.tiles;
  float* sbias = reinterpret_cast<float*>(tl_smem + L.bias);
  const float* sgamma = reinterpret_cast<const float*>(tl_smem + L.gamma);
  const uint32_t ux = smem_u32(sx), uw = smem_u32(tl_smem + L.w), uwo = smem_u32(tl_smem + L.wout);
  const uint32_t uq = smem_u32(tiles);
  const int TB = P * FP * 64;  // bytes of one of the q, k, v tiles
  const int WT = C * 64;       // bytes of one part's [C][32] W_qkv tile
  // this warp's strip: rows 16 s .. 16 s + 15 of pixel p
  const int p = warp / KT, s = warp % KT;
  const bool active = p < np;
  const int row0 = p * FP + 16 * s;
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;  // the row this lane addresses for ldmatrix

  // x rows of the block's pixels (pad rows and absent pixels zero)
  for (int idx = threadIdx.x; idx < P * FP * (C / 8); idx += blockDim.x) {
    const int r = idx / (C / 8), c = idx % (C / 8), pp = r / FP, f = r % FP;
    if (pp < np && f < F)
      cp_async_16(ux + swzw(r, c, RB, SM), x + ((b * F + f) * HW + pix0 + pp) * C + c * 8);
    else
      *reinterpret_cast<uint4*>(sx + swzw(r, c, RB, SM)) = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int c = threadIdx.x; c < C / 4; c += blockDim.x)
    cp_async_16(smem_u32(sgamma + 4 * c), gamma + 4 * c);

  // the W_qkv columns of head g: three [C][32] tiles
  const auto stage_w = [&](int g) {
#ifndef LFDM_ABLATE_QKV
    for (int idx = threadIdx.x; idx < C * 12; idx += blockDim.x) {
      const int k = idx / 12, t = (idx >> 2) % 3, c = idx & 3;
      cp_async_16(uw + t * WT + swz(k, c), wqkv + (long long)k * 3 * hd + t * hd + g * D + c * 8);
    }
#endif
  };

  for (int hh = 0; hh < hpb; ++hh) {
    const int g = rank * hpb + hh;
    // the head's bias slice and W_out rows (with the x rows for the first head); its W_qkv
    // columns in a group of their own (a later head's were issued during the previous one)
    const int vec = F % 4 == 0 ? 4 : 1;
    for (int idx = threadIdx.x; idx < F * F / vec; idx += blockDim.x) {
      const int i = idx * vec / F, j = idx * vec % F;
      const float* src = bias_flat + (b * F + i) * (long long)heads * F + g * F + j;
      if (vec == 4)
        cp_async_16(smem_u32(sbias + i * F + j), src);
      else
        cp_async_4(smem_u32(sbias + i * F + j), src);
    }
    for (int idx = threadIdx.x; idx < 32 * (C / 8); idx += blockDim.x) {
      const int r = idx / (C / 8), c = idx % (C / 8);
      cp_async_16(uwo + swzw(r, c, RB, SM), wout + (long long)(g * D + r) * C + c * 8);
    }
    cp_async_commit();
    if (hh == 0) {
      stage_w(g);
      cp_async_commit();
    }
    // the rotary tables of the warp's rows for the head's three parts, in flight meanwhile:
    // tab[t][n][h] = (cos, sin) pairs of columns 8n + q2, +1 of part t at frame 16s + grp + 8h
    uint32_t tab[3][4][2][2] = {};
#ifndef LFDM_ABLATE_ROTARY
    if (active) {
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int f = 16 * s + grp + 8 * h;
            if (f < F) {
              const long long ti = (long long)f * 3 * hd + t * hd + g * D + 8 * n + q2;
              tab[t][n][h][0] = __ldg(reinterpret_cast<const unsigned int*>(cos_t + ti));
              tab[t][n][h][1] = __ldg(reinterpret_cast<const unsigned int*>(sin_t + ti));
            }
          }
    }
#endif

    // the x rows (first head) or this head's W_qkv (a later head: its bias and W_out rows
    // may still be in flight; the attention waits for them)
    cp_async_wait<1>();
    if (hh == 0) {
      __syncthreads();
#ifndef LFDM_ABLATE_LAYERNORM
      layer_norm_tile(sx, sgamma, np * F, C, SM, eps, [=](int r) { return (r / F) * FP + r % F; });
#endif
      cp_async_wait<0>();
    }
    __syncthreads();

    // q|k|v = LN(x) W_qkv for the warp's strip, one part (16 x 32) at a time; then rotary
    // on the C fragments: (a0, a1) -> (a0 c0 - a1 s0, a1 c1 + a0 s1) in fp32 with the
    // table of the row's frame, rounded to bf16 (pad rows zero) into the q, k, v tiles
    if (active) {
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        float acc[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#ifdef LFDM_ABLATE_QKV
        uint32_t a[4];
        ldmatrix_x4(a, ux + swzw(row0 + lrow, lane >> 4, RB, SM));
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float2 lo = bf2(a[0]), hi = bf2(a[1]);
          acc[n][0] = lo.x, acc[n][1] = lo.y, acc[n][2] = hi.x, acc[n][3] = hi.y;
        }
#else
        const uint32_t wt = uw + t * WT;
#pragma unroll 4
        for (int j = 0; j < C / 16; ++j) {
          uint32_t a[4];
          ldmatrix_x4(a, ux + swzw(row0 + lrow, 2 * j + (lane >> 4), RB, SM));
#pragma unroll
          for (int pp = 0; pp < 2; ++pp) {
            uint32_t bv[4];
            ldmatrix_x4_trans(bv, wt + swz(16 * j + lrow, 2 * pp + (lane >> 4)));
            mma_bf16(acc[2 * pp], a, bv[0], bv[1]);
            mma_bf16(acc[2 * pp + 1], a, bv[2], bv[3]);
          }
        }
#endif
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int f = 16 * s + grp + 8 * h;
            float a0 = acc[n][2 * h], a1 = acc[n][2 * h + 1];
            uint32_t v = 0u;
            if (f < F) {
#ifndef LFDM_ABLATE_ROTARY
              const float2 co = bf2(tab[t][n][h][0]), si = bf2(tab[t][n][h][1]);
              const float r0 = __fadd_rn(__fmul_rn(a0, co.x), -__fmul_rn(a1, si.x));
              const float r1 = __fadd_rn(__fmul_rn(a1, co.y), __fmul_rn(a0, si.y));
              a0 = r0;
              a1 = r1;
#endif
              v = pack_bf16(a0, a1);
            }
            *reinterpret_cast<uint32_t*>(tiles + t * TB + swz(p * FP + f, n) + 2 * q2) = v;
          }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    if (hh + 1 < hpb) {  // the next head's W_qkv, in flight during this head's attention
      stage_w(g + 1);
      cp_async_commit();
    }

    // attention over the pixel's frames for the warp's 16 query rows, then o W_out
    if (active) {
      const uint32_t tq = uq + p * FP * 64, tk = tq + TB, tv = tk + TB;
      float sc[NT][4];
#ifdef LFDM_ABLATE_SCORES
#pragma unroll
      for (int n = 0; n < NT; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#else
      strip_abT<NT>(tq, tk, s, lane, sc);
#endif
      float l0 = 1.f, l1 = 1.f;
#ifndef LFDM_ABLATE_SOFTMAX
      float m0, m1;
      bias_max<NT>(sc, sbias, s, F, lane, m0, m1);
      l0 = l1 = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // e = exp(s - m), rounded to bf16 for p.v and the sum alike
          sc[n][e] = __bfloat162float(__float2bfloat16(__expf(sc[n][e] - m0)));
          sc[n][2 + e] = __bfloat162float(__float2bfloat16(__expf(sc[n][2 + e] - m1)));
          l0 += sc[n][e];
          l1 += sc[n][2 + e];
        }
      l0 = fmaxf(quad_sum(l0), 1.17549435e-38f);
      l1 = fmaxf(quad_sum(l1), 1.17549435e-38f);
#endif
      float o[4][4] = {};
#ifdef LFDM_ABLATE_PV
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = sc[n % NT][e];
#else
      uint32_t pa[KT][4];
      to_a<NT>(sc, pa);
      strip_pv<KT>(pa, tv, lane, o);
#endif
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        o[n][0] = o[n][0] / l0;
        o[n][1] = o[n][1] / l0;
        o[n][2] = o[n][2] / l1;
        o[n][3] = o[n][3] / l1;
      }
      uint32_t oa[2][4];
      to_a<4>(o, oa);  // o rounded to bf16

      const int f0 = 16 * s + grp, f1 = f0 + 8;
      float* pr0 = spart + (p * F + f0) * LDP + q2;
      float* pr1 = spart + (p * F + f1) * LDP + q2;
      const auto put = [&](float* dst, float v0, float v1) {
        float2* d2 = reinterpret_cast<float2*>(dst);
        if (hh == 0) {
          *d2 = make_float2(v0, v1);
        } else {
          const float2 w = *d2;
          *d2 = make_float2(w.x + v0, w.y + v1);
        }
      };
#pragma unroll 2
      for (int m = 0; m < C / 16; ++m) {
        float c0[4] = {}, c1[4] = {};
#ifdef LFDM_ABLATE_OUTPROJ
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          c0[e] = bf2(oa[m & 1][e]).x;
          c1[e] = bf2(oa[m & 1][e]).y;
        }
#else
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, uwo + swzw(16 * h + lrow, 2 * m + (lane >> 4), RB, SM));
          mma_bf16(c0, oa[h], bv[0], bv[1]);
          mma_bf16(c1, oa[h], bv[2], bv[3]);
        }
#endif
        if (f0 < F) {
          put(pr0 + 16 * m, c0[0], c0[1]);
          put(pr0 + 16 * m + 8, c1[0], c1[1]);
        }
        if (f1 < F) {
          put(pr1 + 16 * m, c0[2], c0[3]);
          put(pr1 + 16 * m + 8, c1[2], c1[3]);
        }
      }
    }
    __syncthreads();  // the next head overwrites the tiles, W rows and bias
  }

  // out = x + round(sum of the K partials in rank order) for this block's columns
  const int nch = C / 4, c0 = rank * nch / K, w = (rank + 1) * nch / K - c0;
#ifndef LFDM_ABLATE_REDUCE
  cluster.sync();
#endif
  for (int idx = threadIdx.x; idx < np * F * w; idx += blockDim.x) {
    const int r = idx / w, ch = c0 + idx % w, f = r % F;
    const int off = r * LDP + 4 * ch;
    const long long gi = ((b * F + f) * HW + pix0 + r / F) * C + 4 * ch;
    const uint2 xv = *reinterpret_cast<const uint2*>(x + gi);
#ifdef LFDM_ABLATE_REDUCE
    const float4 sum = *reinterpret_cast<const float4*>(spart + off);
#else
    float4 v[kMaxCluster];  // all K loads in flight before the sums
    const uint32_t local = smem_u32(spart + off);
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < K) v[q] = ld_cluster_f4(map_rank(local, q));
    float4 sum = v[0];
#pragma unroll
    for (int q = 1; q < kMaxCluster; ++q)
      if (q < K) {
        sum.x += v[q].x;
        sum.y += v[q].y;
        sum.z += v[q].z;
        sum.w += v[q].w;
      }
#endif
    const float2 x01 = bf2(xv.x), x23 = bf2(xv.y);
    uint2 ov;
    ov.x = pack_bf16(x01.x + rnd<bf16>(sum.x), x01.y + rnd<bf16>(sum.y));
    ov.y = pack_bf16(x23.x + rnd<bf16>(sum.z), x23.y + rnd<bf16>(sum.w));
    *reinterpret_cast<uint2*>(out + gi) = ov;
  }
#ifndef LFDM_ABLATE_REDUCE
  cluster.sync();  // no block leaves while another may still read its partial
#endif
}

template <int NT>
cudaError_t launch_mma(const bf16* x, const float* gamma, const bf16* wqkv, const bf16* wout,
                       const float* bias, const bf16* cos_t, const bf16* sin_t, bf16* out, int B,
                       int F, int HW, int C, int heads, int P, int K, float eps, cudaStream_t st) {
  const Layout L = layout(F, C, P, heads / K);
  if (L.total > kMaxSmem) return cudaErrorInvalidValue;  // the wrapper sizes P to fit
  return launch_cluster(fused_temporal_layer_mma_kernel<NT>, dim3(K, (HW + P - 1) / P, B),
                        dim3(K, 1, 1), 32 * P * ((NT + 1) / 2), L.total, st, x, gamma, wqkv, wout,
                        bias, cos_t, sin_t, out, F, HW, C, heads, P, K, eps);
}

int launch_bf16(const void* x, const void* gamma, const void* wqkv, const void* wout,
                const void* bias, const void* cos_t, const void* sin_t, void* out, int B, int F,
                int HW, int C, int heads, int P, int K, float eps, void* stream) {
  if (B < 1 || F < 1 || F > 64 || HW < 1 || C < 16 || C % 16 != 0 || K < 1 ||
      heads % K != 0 || P < 1 || P * ((F + 15) / 16) > kMaxWarps || K > kMaxCluster || B > 65535 ||
      (HW + P - 1) / P > 65535)
    return cudaErrorInvalidValue;
  auto xs = static_cast<const bf16*>(x);
  auto gs = static_cast<const float*>(gamma);
  auto wq = static_cast<const bf16*>(wqkv);
  auto wo = static_cast<const bf16*>(wout);
  auto bi = static_cast<const float*>(bias);
  auto co = static_cast<const bf16*>(cos_t);
  auto si = static_cast<const bf16*>(sin_t);
  auto o = static_cast<bf16*>(out);
  auto st = static_cast<cudaStream_t>(stream);
#define LFDM_CASE(n) \
  case n: return launch_mma<n>(xs, gs, wq, wo, bi, co, si, o, B, F, HW, C, heads, P, K, eps, st);
  switch ((F + 7) / 8) {
    LFDM_CASE(1) LFDM_CASE(2) LFDM_CASE(3) LFDM_CASE(4)
    LFDM_CASE(5) LFDM_CASE(6) LFDM_CASE(7) LFDM_CASE(8)
  }
#undef LFDM_CASE
  return cudaErrorInvalidValue;
}

int launch_f32(const void* x, const void* gamma, const void* wqkv, const void* wout,
               const void* bias, const void* cos_t, const void* sin_t, void* out, int B, int F,
               int HW, int C, int heads, float eps, void* stream) {
  if (F < 1 || F > 64 || HW < 1 || C < 1 || heads < 1 || B < 1) return cudaErrorInvalidValue;
  int P = 1;  // pixels per block: P * C <= 256 and P | HW
  while (2 * P * C <= 256 && HW % (2 * P) == 0) P *= 2;
  const int R = P * F;
  const size_t smem = sizeof(float) * ((size_t)R * (C + 1) + (size_t)R * C + (size_t)R * HS + 2048);
  auto kernel = fused_temporal_layer_kernel<float>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(HW / P, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(wqkv), static_cast<const float*>(wout),
      static_cast<const float*>(bias), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<float*>(out), F, HW, C, heads, P, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace lfdm

extern "C" int launch_fused_temporal_layer_f32(const void* x, const void* gamma,
                                               const void* wqkv, const void* wout,
                                               const void* bias, const void* cos_t,
                                               const void* sin_t, void* out, int B, int F,
                                               int HW, int C, int heads, float eps,
                                               void* stream) {
  return lfdm::launch_f32(x, gamma, wqkv, wout, bias, cos_t, sin_t, out, B, F, HW, C, heads, eps,
                          stream);
}

// P pixels per cluster, K blocks (head groups) per cluster: ops/attention.py::temporal_layer_plan
extern "C" int launch_fused_temporal_layer_bf16(const void* x, const void* gamma,
                                                const void* wqkv, const void* wout,
                                                const void* bias, const void* cos_t,
                                                const void* sin_t, void* out, int B, int F,
                                                int HW, int C, int heads, int P, int K,
                                                float eps, void* stream) {
  return lfdm::launch_bf16(x, gamma, wqkv, wout, bias, cos_t, sin_t, out, B, F, HW, C, heads, P,
                           K, eps, stream);
}

// Dynamic shared memory of one bf16 block (the test of temporal_layer_smem's mirror)
extern "C" int fused_temporal_layer_bf16_smem(int F, int C, int P, int heads_per_block) {
  return lfdm::layout(F, C, P, heads_per_block).total;
}
