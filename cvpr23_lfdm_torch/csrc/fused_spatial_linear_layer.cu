// Whole PreNorm linear-attention layer of the UNet, per frame:
//   out = x + W_out . linattn(W_qkv . LN(x)) + b_out
// where q is softmaxed over each head's D = 32 channels and scaled by
// D^-1/2, k is softmaxed over the frame's N pixels, the per-head context is
// k^T v (32 x 32), and the attention output is q . context.
//
// Replaces the Pallas TPU kernel cvpr23_lfdm_tpu/ops/attention_pallas.py::
// fused_spatial_linear_layer (_fused_linear_kernel). See ops/attention.py
// for the plain version this kernel is held against.
//
// Bound on the H100: operations (the two projections). The k-softmax
// reduces over all N pixels of a frame, so the layer is a chain of two
// launches, the context first, then the output; the only intermediate in
// device memory is the per-head context [B*F, heads, 32, 32] in x's dtype.
// Both launches take any N >= 1: a tile's rows past N are zero in the x
// tile, take no part in the k softmax (-inf in its max, 0 in its sum and in
// p) and are not written.
//
// bf16 (the `pallas3` serving form): tensor cores (mma.sync.m16n8k16, bf16
// operands, fp32 sums), C % 16 == 0, tensors 16-byte aligned; the wrapper
// plans both grids (ops/attention.py::linear_layer_plan) from the shared
// memory this file computes (fused_spatial_linear_layer_bf16_smem) and
// raises where no plan fits (it never reroutes).
//  Every block has 8 warps, whatever its heads: the copies (division-free
//  loops), the LayerNorm, the merge and the gather are shared by all 256
//  threads (with a warp per head alone, 2-warp blocks spent most of their
//  time there).
//  1. linear_context_mma_kernel: grid (KH, KS, B*F), clusters of (1, KS, 1).
//     The block of cluster rank y owns the frame's R-row tiles y, y + KS, ...
//     and heads / KH of its heads, its first heads / KH warps one head
//     each. It stages its heads' W_k and W_v columns once by cp.async into
//     swizzled [C][32] tiles; per tile it copies the x rows into a swizzled
//     bf16 tile and LayerNorms them in place, once per row for all its heads
//     (mma.cuh::layer_norm_tile).
//     Per 16-row strip a warp projects its head's k|v on mma.sync, keeps an
//     online softmax of k over the rows in the C fragments (the column max
//     by shuffles per strip, each lane's sum over its own rows, summed over
//     the column at the end; the context rescaled when the max grows), and
//     adds p^T v on mma.sync: p = exp(k - max) and v rounded to bf16 and
//     transposed in registers by movmatrix, the context [32][32] in fp32 C
//     fragments. The KS blocks' (max, sum, context) partials then meet in
//     shared memory (over the weights, dead by then: a block of 8 heads at
//     C = 64 takes ~80 KB, so two fit an SM) and are merged in rank order
//     through distributed shared memory (each block a slice of the
//     entries), and the normalized context is stored rounded to bf16, as
//     the plain version rounds it: no atomics, the same bits on every run.
//  2. linear_output_mma_kernel: grid (K, ceil(N / R), B*F), clusters of
//     (K, 1, 1). The block of rank r owns an R-row tile, heads [r, r + 1)
//     * heads / K for the q side, and a slice of 16-column blocks of the
//     output. It stages its heads' W_q columns and contexts and the W_out
//     rows of its slice by cp.async, LayerNorms its x rows in place, and per
//     (head, 16-row strip) work item of a warp: the q projection on
//     mma.sync, the q-softmax in the C fragments (quad shuffles; e = exp
//     rounded to bf16, e / sum rounded, times D^-1/2 rounded: the plain
//     version's points; the division a multiplication by the row sum's
//     reciprocal), q . context on mma.sync (the context as the B
//     operand) and o rounded to bf16 into the block's o tile [R][heads*32].
//     The cluster then gathers the other blocks' head columns of o through
//     distributed shared memory, and each block runs the out-projection of
//     its column slice over all heads on mma.sync (fp32 sums in registers),
//     adds b_out, rounds, and adds the residual: no partial sums cross
//     blocks, so the output is the same bit for bit from run to run.
//
// fp32: CUDA cores (mma on fp32 operands would be TF32, ten mantissa bits,
// against the fp32 gates' 2e-4). The same two launches with tiled FMA
// products over shared memory (common.cuh::block_gemm): context_kernel, one
// block per (batch*frame, head), streams the frame in tiles of up to 32
// pixels and keeps the online softmax in shared memory; output_kernel, one
// block per (tile of up to 32 pixels, batch*frame), runs the q side, the
// out-projection and the residual.
//
// Layouts: x, out [B, F, N, C]; gamma [C] fp32; wqkv [C, 3*heads*D];
// wout [heads*D, C]; bout [C] fp32; ctx [B*F, heads, D, D] in x's dtype.
//
// Head-shard mode (`partial` != 0; tensor parallelism over the `model` axis,
// ops/attention.py::fused_spatial_linear_layer(..., partial=True)): the
// launches get one rank's heads (their W_qkv columns and W_out rows) and
// the output launch writes the fp32 out-projection sum over those heads
// [B, F, N, C], with no b_out and no residual (`out` fp32; bout is not
// read): the caller sums the ranks' partials in fp32, adds b_out, rounds
// once and adds x, as the output launch does for all heads.

#include <cooperative_groups.h>

#include "cluster_launch.cuh"
#include "common.cuh"
#include "mma.cuh"

namespace lfdm {
namespace {

constexpr int D = 32;
constexpr int KV = 2 * D + 1;  // k|v tile row stride

struct KvCols {  // column n in [0, 64) of head g -> column of wqkv (k then v)
  int hd, g;
  __device__ int operator()(int n) const { return (n / D + 1) * hd + g * D + (n % D); }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
context_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
               const T* __restrict__ wqkv, T* __restrict__ ctx, int N, int C, int heads,
               int NT, float eps) {
  extern __shared__ float smem[];
  const int hd = heads * D;
  const int ldx = C + 1;
  float* xn = smem;              // [NT][C+1]
  float* kv = xn + NT * ldx;     // [NT][KV]: k (then exp(k - max)) | v
  float* cx = kv + NT * KV;      // [32][32] running context
  float* mx = cx + D * D;        // [32] running max of k per channel
  float* sm = mx + D;            // [32] running sum of exp(k - max)
  float* sc = sm + D;            // [32] rescale factor of this tile
  float* Bs = sc + D;            // [32][64]

  const long long bf = blockIdx.x;  // batch * F + frame
  const int g = blockIdx.y;
  const T* xf = x + bf * N * C;
  for (int e = threadIdx.x; e < D * D; e += kThreads) cx[e] = 0.f;
  if (threadIdx.x < D) {
    mx[threadIdx.x] = -INFINITY;
    sm[threadIdx.x] = 0.f;
  }

  for (int n0 = 0; n0 < N; n0 += NT) {
    const int nv = min(NT, N - n0);  // rows of this tile (the last may be short)
    layer_norm_rows<T>([=](int r) { return xf + (long long)(n0 + r) * C; }, nv, C, gamma, eps,
                       xn, ldx);
    block_gemm<T, 2, false>(xn, ldx, nv, C, wqkv, 3 * hd, 2 * D, KvCols{hd, g}, kv, KV, Bs);
    if (threadIdx.x < D) {  // one lane per k channel d
      const int d = threadIdx.x;
      float tmax = -INFINITY;
      for (int n = 0; n < nv; ++n) tmax = fmaxf(tmax, kv[n * KV + d]);
      const float mnew = fmaxf(mx[d], tmax);
      const float scale = expf(mx[d] - mnew);  // 0 on the first tile
      float s = 0.f;
      for (int n = 0; n < nv; ++n) {
        const float p = expf(kv[n * KV + d] - mnew);
        kv[n * KV + d] = p;
        s += p;
      }
      sm[d] = sm[d] * scale + s;
      mx[d] = mnew;
      sc[d] = scale;
    }
    for (int e = threadIdx.x; e < nv * D; e += kThreads) {  // v rounded to T
      const int n = e / D, c = D + e % D;
      kv[n * KV + c] = rnd<T>(kv[n * KV + c]);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < D * D; e += kThreads) {
      const int d = e / D, c = e % D;
      float a = cx[e] * sc[d];
      for (int n = 0; n < nv; ++n) a = fmaf(kv[n * KV + d], kv[n * KV + D + c], a);
      cx[e] = a;
    }
    __syncthreads();
  }
  T* out = ctx + (bf * heads + g) * D * D;
  for (int e = threadIdx.x; e < D * D; e += kThreads) out[e] = from_f<T>(cx[e] / sm[e / D]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
output_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const T* __restrict__ wqkv, const T* __restrict__ wout,
              const float* __restrict__ bout, const T* __restrict__ ctx,
              T* __restrict__ out, int N, int C, int heads, int NT, int partial, float eps) {
  extern __shared__ float smem[];
  const int hd = heads * D;
  const int ldx = C + 1, ldq = hd + 1;
  float* xn = smem;              // [NT][C+1] LN(x); later the projection
  float* q = xn + NT * ldx;      // [NT][hd+1]
  float* o = q + NT * ldq;       // [NT][hd+1]
  float* cx = o + NT * ldq;      // [heads][32][33]
  float* Bs = cx + heads * D * (D + 1);

  const long long bf = blockIdx.y;
  const int n0 = blockIdx.x * NT, nv = min(NT, N - n0);
  const T* xf = x + (bf * N + n0) * C;
  const T* cf = ctx + bf * heads * D * D;
  for (int e = threadIdx.x; e < heads * D * D; e += kThreads)
    cx[(e / D) * (D + 1) + e % D] = to_f<T>(cf[e]);

  layer_norm_rows<T>([=](int r) { return xf + (long long)r * C; }, nv, C, gamma, eps, xn, ldx);
  block_gemm<T, 2, false>(xn, ldx, nv, C, wqkv, 3 * hd, hd, Identity{}, q, ldq, Bs);

  // q-softmax over each head's 32 channels: one warp per (pixel, head)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float qscale = 0.17677669529663687f;  // D^-1/2, rounded once
  for (int w = warp; w < nv * heads; w += kThreads / 32) {
    float* qr = q + (w / heads) * ldq + (w % heads) * D;
    const float v = qr[lane];
    const float e = rnd<T>(expf(v - warp_max(v)));
    const float den = fmaxf(warp_sum(e), 1.17549435e-38f);
    qr[lane] = rnd<T>(rnd<T>(e / den) * qscale);
  }
  __syncthreads();

  // o[n][g*32 + c] = sum_d q[n][g*32 + d] * ctx[g][d][c], rounded to T
  for (int e = threadIdx.x; e < nv * hd; e += kThreads) {
    const int n = e / hd, col = e % hd, g = col / D, c = col % D;
    const float* qr = q + n * ldq + g * D;
    const float* cc = cx + g * D * (D + 1) + c;
    float a = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) a = fmaf(qr[d], cc[d * (D + 1)], a);
    o[n * ldq + col] = rnd<T>(a);
  }

  block_gemm<T, 2, false>(o, ldq, nv, hd, wout, C, C, Identity{}, xn, ldx, Bs);
  for (int e = threadIdx.x; e < nv * C; e += kThreads) {
    const int n = e / C, c = e % C;
    const long long gi = (bf * N + n0 + n) * C + c;
    out[gi] = partial ? from_f<T>(xn[n * ldx + c])
                      : from_f<T>(to_f<T>(x[gi]) + rnd<T>(xn[n * ldx + c] + bout[c]));
  }
}

int launch_f32(const void* x, const void* gamma, const void* wqkv, const void* wout,
               const void* bout, void* ctx, void* out, int B, int F, int N, int C, int heads,
               int partial, float eps, void* stream) {
  const int NT = N < 32 ? N : 32;  // pixels per tile; the last tile may be short
  if (B < 1 || F < 1 || N < 1 || C < 1 || heads < 1) return cudaErrorInvalidValue;
  const int hd = heads * D;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem1 = sizeof(float) * ((size_t)NT * (C + 1) + NT * KV + D * D + 3 * D + 2048);
  const size_t smem2 = sizeof(float) * ((size_t)NT * (C + 1) + 2 * (size_t)NT * (hd + 1) +
                                        (size_t)heads * D * (D + 1) + 2048);
  auto k1 = context_kernel<float>;
  auto k2 = output_kernel<float>;
  cudaError_t err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return err;
  const float* xt = static_cast<const float*>(x);
  const float* gt = static_cast<const float*>(gamma);
  const float* wq = static_cast<const float*>(wqkv);
  k1<<<dim3(B * F, heads), kThreads, smem1, s>>>(xt, gt, wq, static_cast<float*>(ctx), N, C,
                                                 heads, NT, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k2<<<dim3((N + NT - 1) / NT, B * F), kThreads, smem2, s>>>(
      xt, gt, wq, static_cast<const float*>(wout), static_cast<const float*>(bout),
      static_cast<const float*>(ctx), static_cast<float*>(out), N, C, heads, NT, partial, eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16: tensor cores

using bf16 = __nv_bfloat16;
namespace cg = cooperative_groups;

constexpr int kMaxSmem = 232448;   // dynamic shared memory of one block on the H100
constexpr int kWarps = 8;          // warps of every block: copies, LayerNorm, merge and gather
                                   // are shared by all 256 threads, whatever the heads per block
constexpr int kMaxCluster = 8;     // blocks of a cluster (portable size)
constexpr int kPart = 2 * D + D * D;  // floats of a head's partial: max, sum, k^T v

__host__ __device__ inline int up128(int bytes) { return (bytes + 127) / 128 * 128; }

// Columns of the output slice of one block of a K-cluster: 16 * ceil(C / 16 / K)
// (the last ranks may have fewer, or none).
__host__ __device__ inline int slice_width(int C, int K) { return 16 * ((C / 16 + K - 1) / K); }

// Shared memory of a context block, byte offsets: for each of its hpb heads
// the W_k and W_v columns as two [C][32] bf16 tiles, and over them, once
// the rows are done, per head the partial (max and sum per k channel, the
// context [32][32]) fp32; the x tile [R][C] bf16; the LN gamma [C] fp32.
struct CtxLayout {
  int w, part, x, gamma, total;
};

__host__ __device__ inline CtxLayout ctx_layout(int C, int R, int hpb) {
  const int wb = hpb * C * 128, pb = hpb * kPart * 4;
  CtxLayout L;
  L.w = L.part = 0;
  L.x = up128(wb > pb ? wb : pb);
  L.gamma = L.x + up128(R * C * 2);
  L.total = L.gamma + C * 4;
  return L;
}

// Shared memory of an output block of a K-cluster: the W_q columns of its
// heads / K heads ([C][32] bf16 each) and their contexts ([32][32] bf16
// each), the W_out rows of all heads for its column slice ([heads*32][CW]
// bf16, CW = slice_width), the x tile [R][C] bf16, the attention output of
// all heads [R][heads*32] bf16, the LN gamma [C] and the slice of b_out [CW]
// fp32.
struct OutLayout {
  int wq, ctx, wo, x, o, gamma, bout, total;
};

__host__ __device__ inline OutLayout out_layout(int C, int R, int heads, int K) {
  const int hpb = heads / K, hd = heads * D, cw = slice_width(C, K);
  OutLayout L;
  L.wq = 0;
  L.ctx = up128(hpb * C * 64);
  L.wo = L.ctx + hpb * 2048;
  L.x = L.wo + up128(hd * cw * 2);
  L.o = L.x + up128(R * C * 2);
  L.gamma = L.o + up128(R * hd * 2);
  L.bout = L.gamma + up128(C * 4);
  L.total = L.bout + cw * 4;
  return L;
}

// f(r, c) for every r < rows and c < cols, spread over the block's threads
// with no division per element (the copy loops' index arithmetic was most of
// their time in 2-warp blocks)
template <typename F>
__device__ __forceinline__ void for_each_2d(int rows, int cols, F f) {
  const int T = blockDim.x, t = threadIdx.x;
  if (cols < 1) return;  // a rank of a cluster may own no output column
  if (cols >= T) {
    for (int r = 0; r < rows; ++r)
      for (int c = t; c < cols; c += T) f(r, c);
  } else if (t < T / cols * cols) {
    for (int r = t / cols, c = t % cols; r < rows; r += T / cols) f(r, c);
  }
}

// x rows [n0, n0 + nv) of one frame into the swizzled tile of R rows (the rest zero)
__device__ __forceinline__ void copy_rows(char* sx, const bf16* xt, int R, int nv, int C, int m) {
  const uint32_t ux = smem_u32(sx);
  for_each_2d(R, C / 8, [&](int r, int c) {
    if (r < nv)
      cp_async_16(ux + swzw(r, c, 2 * C, m), xt + (long long)r * C + c * 8);
    else
      *reinterpret_cast<uint4*>(sx + swzw(r, c, 2 * C, m)) = make_uint4(0u, 0u, 0u, 0u);
  });
}

struct SameRow {
  __device__ int operator()(int r) const { return r; }
};

// two blocks per SM where shared memory allows (128 registers)
__global__ void __launch_bounds__(kWarps * 32, 2)
linear_context_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                          const bf16* __restrict__ wqkv, bf16* __restrict__ ctx, int N, int C,
                          int heads, int R, int KS, float eps) {
  extern __shared__ __align__(128) char lc_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();  // = blockIdx.y: the grid's y is KS
  const int hpb = heads / gridDim.x, hd = heads * D, RB = 2 * C, SM = swz_mask(C / 8);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, q2 = 2 * (lane & 3), lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int g0 = blockIdx.x * hpb;
  const long long bf = blockIdx.z;
  const CtxLayout L = ctx_layout(C, R, hpb);
  char* sx = lc_smem + L.x;
  float* sgamma = reinterpret_cast<float*>(lc_smem + L.gamma);
  float* spart = reinterpret_cast<float*>(lc_smem + L.part);
  const uint32_t uw = smem_u32(lc_smem + L.w), ux = smem_u32(sx);
  const int WT = C * 64;  // bytes of one [C][32] weight tile

  // W_k (t = 0) and W_v (t = 1) columns of head g0 + h: tile 2h + t
  for (int h = 0; h < hpb; ++h)
    for_each_2d(C, 8, [&](int k, int tc) {
      const int t = tc >> 2, c = tc & 3;
      cp_async_16(uw + (2 * h + t) * WT + swz(k, c),
                  wqkv + (long long)k * 3 * hd + (1 + t) * hd + (g0 + h) * D + c * 8);
    });
  for (int c = threadIdx.x; c < C / 4; c += blockDim.x)
    cp_async_16(smem_u32(sgamma + 4 * c), gamma + 4 * c);

  // the warp's head over the block's rows: the running max of k channel
  // 8n + q2 + e in mx[n][e] (the same in every lane of a quad column), the
  // sum of exp(k - max) over the lane's own rows in sm[n][e]; the context k^T v as C fragments cx[ms][u] (rows d = 16 ms + grp
  // and + 8, columns e = 8u + q2, + 1)
  float mx[4][2], sm[4][2], cx[2][4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    mx[n][0] = mx[n][1] = -INFINITY;
    sm[n][0] = sm[n][1] = 0.f;
  }
#pragma unroll
  for (int ms = 0; ms < 2; ++ms)
#pragma unroll
    for (int u = 0; u < 4; ++u) cx[ms][u][0] = cx[ms][u][1] = cx[ms][u][2] = cx[ms][u][3] = 0.f;
  const uint32_t wk = uw + 2 * warp * WT, wv = wk + WT;  // used by warps < hpb only

  const int ntiles = (N + R - 1) / R;
  for (int t = split; t < ntiles; t += KS) {
    const int n0 = t * R, nv = min(R, N - n0);
    copy_rows(sx, x + (bf * N + n0) * C, R, nv, C, SM);
    cp_async_wait_all();
    __syncthreads();
    layer_norm_tile(sx, sgamma, nv, C, SM, eps, SameRow{});
    __syncthreads();

    for (int s0 = 0; warp < hpb && s0 < nv; s0 += 16) {  // warp h: head g0 + h
      // k | v of the strip: acc[0..3] k channels 8n.., acc[4..7] v channels
      float acc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll 1
      for (int j = 0; j < C / 16; ++j) {
        uint32_t a[4];
        ldmatrix_x4(a, ux + swzw(s0 + lrow, 2 * j + (lane >> 4), RB, SM));
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, (pp < 2 ? wk : wv) + swz(16 * j + lrow, 2 * (pp & 1) + (lane >> 4)));
          mma_bf16(acc[2 * pp], a, bv[0], bv[1]);
          mma_bf16(acc[2 * pp + 1], a, bv[2], bv[3]);
        }
      }
      // online softmax of k over the rows: rows past N are -inf in the max and 0 in p
      const bool ok0 = s0 + grp < nv, ok1 = s0 + grp + 8 < nv;
      float rs[4][2];  // the old sums' rescale per channel
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float cm = fmaxf(ok0 ? acc[n][e] : -INFINITY, ok1 ? acc[n][2 + e] : -INFINITY);
          cm = fmaxf(cm, __shfl_xor_sync(kFull, cm, 4));
          cm = fmaxf(cm, __shfl_xor_sync(kFull, cm, 8));
          cm = fmaxf(cm, __shfl_xor_sync(kFull, cm, 16));
          const float mn = fmaxf(mx[n][e], cm);  // finite: row s0 is in the frame
          rs[n][e] = __expf(mx[n][e] - mn);      // 0 on the first strip
          mx[n][e] = mn;
          const float p0 = ok0 ? __expf(acc[n][e] - mn) : 0.f;
          const float p1 = ok1 ? __expf(acc[n][2 + e] - mn) : 0.f;
          acc[n][e] = p0;
          acc[n][2 + e] = p1;
          sm[n][e] = sm[n][e] * rs[n][e] + (p0 + p1);  // the lane's rows; the column's at the end
        }
      // context row d = 8t + grp takes the rescale of channel d, held by lane grp / 2
      float rd[4];
#pragma unroll
      for (int t2 = 0; t2 < 4; ++t2) {
        const float a0 = __shfl_sync(kFull, rs[t2][0], grp >> 1);
        const float a1 = __shfl_sync(kFull, rs[t2][1], grp >> 1);
        rd[t2] = (grp & 1) ? a1 : a0;
      }
      // p^T as A fragments (rows d, columns n) and v as B fragments (rows n,
      // columns e), both rounded to bf16 and transposed by movmatrix
      uint32_t pt[4][2], vt[4][2];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        pt[n][0] = movmatrix_trans(pack_bf16(acc[n][0], acc[n][1]));
        pt[n][1] = movmatrix_trans(pack_bf16(acc[n][2], acc[n][3]));
        vt[n][0] = movmatrix_trans(pack_bf16(acc[4 + n][0], acc[4 + n][1]));
        vt[n][1] = movmatrix_trans(pack_bf16(acc[4 + n][2], acc[4 + n][3]));
      }
#pragma unroll
      for (int ms = 0; ms < 2; ++ms) {
        const uint32_t pa[4] = {pt[2 * ms][0], pt[2 * ms + 1][0], pt[2 * ms][1], pt[2 * ms + 1][1]};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          cx[ms][u][0] *= rd[2 * ms];
          cx[ms][u][1] *= rd[2 * ms];
          cx[ms][u][2] *= rd[2 * ms + 1];
          cx[ms][u][3] *= rd[2 * ms + 1];
          mma_bf16(cx[ms][u], pa, vt[u][0], vt[u][1]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites the x tile
  }
  cp_async_wait_all();  // a block without a tile still has its weights in flight
  __syncthreads();      // the partials overlay the weights

  // the warp's partial (a block without a tile leaves max -inf, sum and context 0)
  if (warp < hpb) {
    float* pw = spart + warp * kPart;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sm[n][e] += __shfl_xor_sync(kFull, sm[n][e], 4);
        sm[n][e] += __shfl_xor_sync(kFull, sm[n][e], 8);
        sm[n][e] += __shfl_xor_sync(kFull, sm[n][e], 16);
      }
    if (grp == 0) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          pw[8 * n + q2 + e] = mx[n][e];
          pw[D + 8 * n + q2 + e] = sm[n][e];
        }
    }
#pragma unroll
    for (int ms = 0; ms < 2; ++ms)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float* c0 = pw + 2 * D + (16 * ms + grp) * D + 8 * u + q2;
        *reinterpret_cast<float2*>(c0) = make_float2(cx[ms][u][0], cx[ms][u][1]);
        *reinterpret_cast<float2*>(c0 + 8 * D) = make_float2(cx[ms][u][2], cx[ms][u][3]);
      }
  }
  cluster.sync();

  // merge the KS partials in rank order: the block of rank y takes a slice of
  // the (head, d, 4 columns) entries; context = sum_q w_q c_q / sum_q w_q s_q,
  // w_q = exp(m_q - max_q m_q)
  const int E = hpb * D * (D / 4), e0 = split * E / KS, e1 = (split + 1) * E / KS;
  for (int idx = e0 + threadIdx.x; idx < e1; idx += blockDim.x) {
    const int h = idx / (D * D / 4), d = (idx / (D / 4)) % D, e = 4 * (idx % (D / 4));
    const float* hp = spart + h * kPart;
    const uint32_t um = smem_u32(hp + d), us = smem_u32(hp + D + d);
    const uint32_t uc = smem_u32(hp + 2 * D + d * D + e);
    float m[kMaxCluster], s[kMaxCluster];
    float4 c[kMaxCluster];
    float mmax = -INFINITY;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < KS) {  // all loads in flight before the sums
        m[q] = ld_cluster_f32(map_rank(um, q));
        s[q] = ld_cluster_f32(map_rank(us, q));
        c[q] = ld_cluster_f4(map_rank(uc, q));
      }
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < KS) mmax = fmaxf(mmax, m[q]);
    float den = 0.f;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < KS) {
        const float w = __expf(m[q] - mmax);
        den += s[q] * w;
        num.x += c[q].x * w;
        num.y += c[q].y * w;
        num.z += c[q].z * w;
        num.w += c[q].w * w;
      }
    uint2 v;
    v.x = pack_bf16(num.x / den, num.y / den);
    v.y = pack_bf16(num.z / den, num.w / den);
    *reinterpret_cast<uint2*>(ctx + ((bf * heads + g0 + h) * D + d) * D + e) = v;
  }
  cluster.sync();  // no block leaves while another may still read its partial
}

__global__ void __launch_bounds__(kWarps * 32)
linear_output_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                         const bf16* __restrict__ wqkv, const bf16* __restrict__ wout,
                         const float* __restrict__ bout, const bf16* __restrict__ ctx,
                         bf16* __restrict__ out, float* __restrict__ part, int N, int C, int heads,
                         int R, int K, float eps) {
  extern __shared__ __align__(128) char lo_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int hpb = heads / K, hd = heads * D, g0 = rank * hpb;
  const int RB = 2 * C, SM = swz_mask(C / 8), RBO = 2 * hd, SMO = swz_mask(hd / 8);
  const int CWM = slice_width(C, K), RBW = 2 * CWM, SMW = swz_mask(CWM / 8);
  const int nch = C / 16, c0 = 16 * (rank * nch / K), cw = 16 * ((rank + 1) * nch / K) - c0;
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, q2 = 2 * (lane & 3), lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const long long bf = blockIdx.z;
  const int n0 = blockIdx.y * R, nv = min(R, N - n0), ns = (nv + 15) / 16;
  const OutLayout L = out_layout(C, R, heads, K);
  char* sx = lo_smem + L.x;
  char* so = lo_smem + L.o;
  float* sgamma = reinterpret_cast<float*>(lo_smem + L.gamma);
  float* sbout = reinterpret_cast<float*>(lo_smem + L.bout);
  const uint32_t uwq = smem_u32(lo_smem + L.wq), ucx = smem_u32(lo_smem + L.ctx);
  const uint32_t uwo = smem_u32(lo_smem + L.wo), ux = smem_u32(sx), uo = smem_u32(so);
  const int WT = C * 64;

  for (int h = 0; h < hpb; ++h)  // W_q of head g0 + h
    for_each_2d(C, 4, [&](int k, int c) {
      cp_async_16(uwq + h * WT + swz(k, c), wqkv + (long long)k * 3 * hd + (g0 + h) * D + c * 8);
    });
  for_each_2d(hpb * D, 4, [&](int hd_, int c) {  // the heads' contexts, row d of head h = hd_ / 32
    cp_async_16(ucx + (hd_ >> 5) * 2048 + swz(hd_ & 31, c),
                ctx + ((bf * heads + g0) * D + hd_) * D + c * 8);
  });
  for_each_2d(hd, cw / 8, [&](int r, int c) {  // W_out, the block's columns
    cp_async_16(uwo + swzw(r, c, RBW, SMW), wout + (long long)r * C + c0 + c * 8);
  });
  for (int c = threadIdx.x; c < C / 4; c += blockDim.x)
    cp_async_16(smem_u32(sgamma + 4 * c), gamma + 4 * c);
  for (int c = threadIdx.x; c < cw / 4; c += blockDim.x)
    cp_async_16(smem_u32(sbout + 4 * c), bout + c0 + 4 * c);
  copy_rows(sx, x + (bf * N + n0) * C, R, nv, C, SM);
  cp_async_wait_all();
  __syncthreads();
  layer_norm_tile(sx, sgamma, nv, C, SM, eps, SameRow{});
  __syncthreads();

  // q side, one (head, strip) at a time per warp
  const float qscale = 0.17677669529663687f;  // D^-1/2, rounded once
  for (int it = warp; it < hpb * ns; it += warps) {
    const int h = it % hpb, s = it / hpb;
    float acc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    const uint32_t wt = uwq + h * WT;
#pragma unroll 4
    for (int j = 0; j < C / 16; ++j) {
      uint32_t a[4];
      ldmatrix_x4(a, ux + swzw(16 * s + lrow, 2 * j + (lane >> 4), RB, SM));
#pragma unroll
      for (int pp = 0; pp < 2; ++pp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, wt + swz(16 * j + lrow, 2 * pp + (lane >> 4)));
        mma_bf16(acc[2 * pp], a, bv[0], bv[1]);
        mma_bf16(acc[2 * pp + 1], a, bv[2], bv[3]);
      }
    }
    // softmax of each row over the head's 32 channels (the lane's 8 of rows grp and grp + 8)
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      m0 = fmaxf(m0, fmaxf(acc[n][0], acc[n][1]));
      m1 = fmaxf(m1, fmaxf(acc[n][2], acc[n][3]));
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        acc[n][e] = rnd<bf16>(__expf(acc[n][e] - m0));
        acc[n][2 + e] = rnd<bf16>(__expf(acc[n][2 + e] - m1));
        l0 += acc[n][e];
        l1 += acc[n][2 + e];
      }
    // e / sum as e times the sum's reciprocal (both correctly rounded): at most
    // one fp32 ulp from the quotient, so a bf16 rounding moves only for a
    // quotient within that ulp of a bf16 boundary
    l0 = __frcp_rn(fmaxf(quad_sum(l0), 1.17549435e-38f));
    l1 = __frcp_rn(fmaxf(quad_sum(l1), 1.17549435e-38f));
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        acc[n][e] = rnd<bf16>(rnd<bf16>(acc[n][e] * l0) * qscale);
        acc[n][2 + e] = rnd<bf16>(rnd<bf16>(acc[n][2 + e] * l1) * qscale);
      }
    uint32_t qa[2][4];
    to_a<4>(acc, qa);
    float o[4][4] = {};
    strip_pv<2>(qa, ucx + h * 2048, lane, o);
    const int r0 = 16 * s + grp;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int ch = (g0 + h) * 4 + n;  // 16-byte chunk of columns (g0 + h) * 32 + 8n
      *reinterpret_cast<uint32_t*>(so + swzw(r0, ch, RBO, SMO) + 2 * q2) = pack_bf16(o[n][0], o[n][1]);
      *reinterpret_cast<uint32_t*>(so + swzw(r0 + 8, ch, RBO, SMO) + 2 * q2) =
          pack_bf16(o[n][2], o[n][3]);
    }
  }

  if (K > 1) {
    cluster.sync();  // every block's heads are in its o tile
    const int own = hpb * 4;  // 16-byte chunks of a row that one block's heads fill
    for (int q = 0; q < K; ++q)
      if (q != rank)
        for_each_2d(16 * ns, own, [&](int r, int c) {
          const int off = swzw(r, q * own + c, RBO, SMO);
          *reinterpret_cast<uint4*>(so + off) = ld_cluster_u4(map_rank(uo + off, q));
        });
    cluster.sync();  // the gather is complete, and no block reads another's tile any more
  } else {
    __syncthreads();
  }

  // out-projection of the block's column slice over all heads: a warp takes a
  // (strip, 64-column group) at a time
  const int ngr = (cw + 63) / 64;
  for (int it = warp; it < ns * ngr; it += warps) {
    const int s = it / ngr, gq = it % ngr, nb = min(4, (cw - 64 * gq) / 16);
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll 4
    for (int j = 0; j < hd / 16; ++j) {
      uint32_t a[4];
      ldmatrix_x4(a, uo + swzw(16 * s + lrow, 2 * j + (lane >> 4), RBO, SMO));
#pragma unroll
      for (int p = 0; p < 4; ++p)
        if (p < nb) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, uwo + swzw(16 * j + lrow, 2 * (4 * gq + p) + (lane >> 4), RBW, SMW));
          mma_bf16(acc[2 * p], a, bv[0], bv[1]);
          mma_bf16(acc[2 * p + 1], a, bv[2], bv[3]);
        }
    }
    // out = x + round(acc + b_out), rounded (head-shard mode: part = acc)
#pragma unroll
    for (int p = 0; p < 4; ++p)
      if (p < nb) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int cl = 64 * gq + 16 * p + 8 * hh + q2;  // column within the slice
          const float b0 = sbout[cl], b1 = sbout[cl + 1];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = 16 * s + grp + 8 * half;
            if (r < nv) {
              const long long gi = (bf * N + n0 + r) * C + c0 + cl;
              if (part != nullptr) {
                *reinterpret_cast<float2*>(part + gi) =
                    make_float2(acc[2 * p + hh][2 * half], acc[2 * p + hh][2 * half + 1]);
                continue;
              }
              const float2 xv = bf2(*reinterpret_cast<const uint32_t*>(x + gi));
              *reinterpret_cast<uint32_t*>(out + gi) =
                  pack_bf16(xv.x + rnd<bf16>(acc[2 * p + hh][2 * half] + b0),
                            xv.y + rnd<bf16>(acc[2 * p + hh][2 * half + 1] + b1));
            }
          }
        }
      }
  }
}

int launch_bf16(const void* x, const void* gamma, const void* wqkv, const void* wout,
                const void* bout, void* ctx, void* out, int B, int F, int N, int C, int heads,
                int R1, int KH, int KS, int R2, int K, int partial, float eps, void* stream) {
  if (B < 1 || F < 1 || B * F > 65535 || N < 1 || C < 16 || C % 16 != 0 || heads < 1 ||
      KH < 1 || heads % KH != 0 || heads / KH > kWarps || KS < 1 || KS > kMaxCluster ||
      R1 < 16 || R1 % 16 != 0 || R2 < 16 || R2 % 16 != 0 || R2 > 16 * kWarps || K < 1 ||
      K > kMaxCluster || heads % K != 0 || (N + R2 - 1) / R2 > 65535)
    return cudaErrorInvalidValue;
  const CtxLayout L1 = ctx_layout(C, R1, heads / KH);
  const OutLayout L2 = out_layout(C, R2, heads, K);
  if (L1.total > kMaxSmem || L2.total > kMaxSmem) return cudaErrorInvalidValue;
  auto xs = static_cast<const bf16*>(x);
  auto gs = static_cast<const float*>(gamma);
  auto wq = static_cast<const bf16*>(wqkv);
  auto cx = static_cast<bf16*>(ctx);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_cluster(linear_context_mma_kernel, dim3(KH, KS, B * F),
                                   dim3(1, KS, 1), 32 * kWarps, L1.total, st, xs, gs, wq,
                                   cx, N, C, heads, R1, KS, eps);
  if (err != cudaSuccess) return err;
  return launch_cluster(linear_output_mma_kernel, dim3(K, (N + R2 - 1) / R2, B * F),
                        dim3(K, 1, 1), 32 * kWarps, L2.total, st, xs, gs, wq,
                        static_cast<const bf16*>(wout), static_cast<const float*>(bout),
                        static_cast<const bf16*>(ctx), partial ? nullptr : static_cast<bf16*>(out),
                        partial ? static_cast<float*>(out) : nullptr, N, C, heads, R2, K, eps);
}

}  // namespace
}  // namespace lfdm

extern "C" int launch_fused_spatial_linear_layer_f32(const void* x, const void* gamma,
                                                     const void* wqkv, const void* wout,
                                                     const void* bout, void* ctx, void* out,
                                                     int B, int F, int N, int C, int heads,
                                                     int partial, float eps, void* stream) {
  return lfdm::launch_f32(x, gamma, wqkv, wout, bout, ctx, out, B, F, N, C, heads, partial, eps,
                          stream);
}

// Context launch: R1-row tiles, heads in KH groups, KS splits of a frame's
// tiles per cluster; output launch: R2-row tiles, clusters of K blocks
// (ops/attention.py::linear_layer_plan). Every block has 8 warps. `partial`:
// the head-shard mode, `out` fp32.
extern "C" int launch_fused_spatial_linear_layer_bf16(const void* x, const void* gamma,
                                                      const void* wqkv, const void* wout,
                                                      const void* bout, void* ctx, void* out,
                                                      int B, int F, int N, int C, int heads,
                                                      int R1, int KH, int KS, int R2, int K,
                                                      int partial, float eps, void* stream) {
  return lfdm::launch_bf16(x, gamma, wqkv, wout, bout, ctx, out, B, F, N, C, heads, R1, KH, KS,
                           R2, K, partial, eps, stream);
}

// Dynamic shared memory of one bf16 block: `kernel` 0, the context launch
// (R1 = rows, KH = groups); 1, the output launch (R2 = rows, K = groups).
// The wrapper's plan reads the layout from here.
extern "C" int fused_spatial_linear_layer_bf16_smem(int kernel, int C, int rows, int heads,
                                                    int groups) {
  return kernel == 0 ? lfdm::ctx_layout(C, rows, heads / groups).total
                     : lfdm::out_layout(C, rows, heads, groups).total;
}
