// Whole PreNorm temporal-attention layer of the UNet in one launch:
//   out = x + W_out . MHA(rotary(W_qkv . LN(x)))
// with attention over the F frames of each pixel, per head of D = 32.
//
// Replaces the Pallas TPU kernel cvpr23_lfdm_tpu/ops/attention_pallas.py::
// fused_temporal_layer (_fused_layer_kernel). See ops/attention.py for the
// plain version this kernel is held against.
//
// Bound on the H100: operations (~7 GFLOP for 10 MB of activations at the
// 64-channel 32x32 level). Design: one block owns P pixels of one batch
// entry (P*C <= 256, so the rows R = P*F fit shared memory) and runs the
// whole layer there: LN of the R rows; then per head the 96 q|k|v columns
// of the projection (tiled FMA product over shared memory), rotary with the
// q-scale folded into the table, softmax attention over the F frames (one
// warp per query row, lanes over keys, a max per head, the additive bias
// from bias_flat, which carries the focus-present NEG_INF entries), and that
// head's slice of the out-projection accumulated in fp32; finally the
// residual. Only x, the weights and the output touch device memory. No
// tensor cores yet (wgmma/mma.sync is later work).
//
// Layouts: x, out [B, F, HW, C]; gamma [C] fp32; wqkv [C, 3*heads*D];
// wout [heads*D, C]; bias_flat [B, F, heads*F] fp32; cos/sin [F, 3*heads*D].
//
// Ablation builds (timing only, the output is NOT the layer's): compiling
// with one of -DLFDM_ABLATE_LAYERNORM, _QKV, _ROTARY, _SCORES, _SOFTMAX, _PV,
// _OUTPROJ removes that stage of the kernel (named after the stages above),
// so that `full - variant` attributes device time to it. They stand in for
// the variants of the TPU's scripts/bench_attn_ablate.py (make_kernel, call);
// its kvbuild, kt and kt_vm variants ablate the TPU kernel's head-tiled K/V
// construction, which this kernel does not have. Without a define this file
// compiles to the serving kernel.

#include "common.cuh"

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

template <typename T>
int launch(const void* x, const void* gamma, const void* wqkv, const void* wout,
           const void* bias, const void* cos_t, const void* sin_t, void* out, int B, int F,
           int HW, int C, int heads, float eps, void* stream) {
  if (F < 1 || F > 64 || HW < 1 || C < 1 || heads < 1 || B < 1) return cudaErrorInvalidValue;
  int P = 1;  // pixels per block: P * C <= 256 and P | HW
  while (2 * P * C <= 256 && HW % (2 * P) == 0) P *= 2;
  const int R = P * F;
  const size_t smem = sizeof(float) * ((size_t)R * (C + 1) + (size_t)R * C + (size_t)R * HS + 2048);
  auto kernel = fused_temporal_layer_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(HW / P, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma), static_cast<const T*>(wqkv),
      static_cast<const T*>(wout), static_cast<const float*>(bias),
      static_cast<const T*>(cos_t), static_cast<const T*>(sin_t), static_cast<T*>(out), F, HW,
      C, heads, P, eps);
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
  return lfdm::launch<float>(x, gamma, wqkv, wout, bias, cos_t, sin_t, out, B, F, HW, C, heads,
                             eps, stream);
}

extern "C" int launch_fused_temporal_layer_bf16(const void* x, const void* gamma,
                                                const void* wqkv, const void* wout,
                                                const void* bias, const void* cos_t,
                                                const void* sin_t, void* out, int B, int F,
                                                int HW, int C, int heads, float eps,
                                                void* stream) {
  return lfdm::launch<__nv_bfloat16>(x, gamma, wqkv, wout, bias, cos_t, sin_t, out, B, F, HW,
                                     C, heads, eps, stream);
}
