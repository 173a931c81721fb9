// Fused GroupNorm + FiLM + SiLU of the UNet's Block (forward only):
//   y = silu(GroupNorm_G(x) * (scale + 1) + shift)
// with fp32 statistics per (batch, group) over (F, H, W, C/G), var =
// E[x^2] - mean^2, gamma, beta and the optional FiLM [B, C] folded into one
// multiply and one add per channel, and the result in x's dtype.
//
// Replaces the Pallas TPU kernel cvpr23_lfdm_tpu/ops/norm_pallas.py::
// groupnorm_film_silu (_kernel). The plain version this is held against is
// ops/norm.py::groupnorm_film_silu_plain.
//
// Bound on the H100: bytes (x read, y written). The TPU kernel holds one
// batch entry's whole activation in VMEM, one grid step per batch entry; a
// block per (batch, group) would be 8 blocks at B = 1. So the reduction is
// split: launch 1 gives each block a chunk of rows of one batch entry and
// writes that chunk's per-group sum and sum of squares; launch 2 lets every
// block add the chunks' partials in index order (a few hundred floats), fold
// the per-channel multiply and add into shared memory, and stream its share
// of the elements. x is read twice (the second read mostly from L2 at the
// UNet's sizes). No atomics: a repeated run gives the same bits.
//
// Layouts: x, y [B, N, C] (N = F*H*W rows, channels last); gamma, beta [C]
// fp32; scale, shift [B, C] fp32 or null; partial [B, chunks, G, 2] fp32.

#include "common.cuh"

namespace lfdm {
namespace {

constexpr int kMaxPerThread = 8;  // channels one thread can own: C <= 8 * 256

// Rows [chunk * rows_per_chunk, ...) of batch entry b. Thread t owns the
// channels col0 + 256k of the rows lane_row + rows_par * n, so each of its
// accumulators belongs to one channel; the block then adds them per group in
// a fixed order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_partial_kernel(const T* __restrict__ x, float* __restrict__ partial, long long N, int C, int G,
                  long long rows_per_chunk) {
  extern __shared__ float sm[];  // [rows_par][C] sums, then [rows_par][C] squares
  const int b = blockIdx.y, chunk = blockIdx.x;
  const int cols = C < kThreads ? C : kThreads;
  const int rows_par = kThreads / cols;
  const int lane_row = threadIdx.x / cols, col0 = threadIdx.x % cols;
  const long long r0 = chunk * rows_per_chunk;
  const long long r1 = r0 + rows_per_chunk < N ? r0 + rows_per_chunk : N;
  float s[kMaxPerThread], ss[kMaxPerThread];
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) s[k] = ss[k] = 0.f;
  if (lane_row < rows_par) {
    for (long long r = r0 + lane_row; r < r1; r += rows_par) {
      const T* row = x + ((long long)b * N + r) * C;
#pragma unroll
      for (int k = 0; k < kMaxPerThread; ++k) {
        const int c = col0 + k * kThreads;
        if (c < C) {
          const float v = to_f<T>(row[c]);
          s[k] += v;
          ss[k] += v * v;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxPerThread; ++k) {
      const int c = col0 + k * kThreads;
      if (c < C) {
        sm[lane_row * C + c] = s[k];
        sm[(rows_par + lane_row) * C + c] = ss[k];
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < G) {
    const int g = threadIdx.x, cg = C / G;
    float a = 0.f, aa = 0.f;
    for (int c = g * cg; c < (g + 1) * cg; ++c)
      for (int lr = 0; lr < rows_par; ++lr) {
        a += sm[lr * C + c];
        aa += sm[(rows_par + lr) * C + c];
      }
    float* dst = partial + (((long long)b * gridDim.x + chunk) * G + g) * 2;
    dst[0] = a;
    dst[1] = aa;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ partial,
                const float* __restrict__ gamma, const float* __restrict__ beta,
                const float* __restrict__ scale, const float* __restrict__ shift,
                T* __restrict__ y, long long N, int C, int G, int chunks, float eps) {
  extern __shared__ float sm[];  // mul [C], add [C], then mean [G], inv [G]
  float* mul = sm;
  float* add = sm + C;
  float* mean_g = add + C;
  float* inv_g = mean_g + G;
  const int b = blockIdx.y;
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float a = 0.f, aa = 0.f;
    for (int k = 0; k < chunks; ++k) {
      const float* src = partial + (((long long)b * chunks + k) * G + g) * 2;
      a += src[0];
      aa += src[1];
    }
    const float cnt = (float)N * (float)(C / G);
    const float mean = a / cnt;
    const float var = aa / cnt - mean * mean;
    mean_g[g] = mean;
    inv_g[g] = rsqrtf(var + eps);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const int g = c / (C / G);
    float m = inv_g[g] * gamma[c];
    float a = beta[c] - mean_g[g] * m;
    if (scale != nullptr) {
      const float sc = scale[(long long)b * C + c] + 1.f;
      m = m * sc;
      a = a * sc + shift[(long long)b * C + c];
    }
    mul[c] = m;
    add[c] = a;
  }
  __syncthreads();
  const unsigned total = (unsigned)(N * C);  // < 2^31, checked by the launcher
  const T* xb = x + (long long)b * total;
  T* yb = y + (long long)b * total;
  for (unsigned e = blockIdx.x * kThreads + threadIdx.x; e < total; e += gridDim.x * kThreads) {
    const unsigned c = e % (unsigned)C;
    const float v = to_f<T>(xb[e]) * mul[c] + add[c];
    yb[e] = from_f<T>(v * (1.f / (1.f + expf(-v))));
  }
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, const void* scale,
           const void* shift, void* partial, void* y, int B, long long N, int C, int G,
           int chunks, float eps, void* stream) {
  if (B < 1 || N < 1 || C < 1 || G < 1 || G > kThreads || C % G != 0 ||
      C > kMaxPerThread * kThreads || chunks < 1 || N * C > 2147483647LL ||
      (scale == nullptr) != (shift == nullptr))
    return cudaErrorInvalidValue;
  const long long rows_per_chunk = (N + chunks - 1) / chunks;
  const int cols = C < kThreads ? C : kThreads;
  const size_t smem1 = sizeof(float) * 2 * (size_t)(kThreads / cols) * C;
  auto st = static_cast<cudaStream_t>(stream);
  gn_partial_kernel<T><<<dim3(chunks, B), kThreads, smem1, st>>>(
      static_cast<const T*>(x), static_cast<float*>(partial), N, C, G, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long per_block = 8LL * kThreads;
  long long blocks = (N * C + per_block - 1) / per_block;
  if (blocks > 4096) blocks = 4096;
  const size_t smem2 = sizeof(float) * (2 * (size_t)C + 2 * (size_t)G);
  gn_apply_kernel<T><<<dim3((unsigned)blocks, B), kThreads, smem2, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(partial),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(scale), static_cast<const float*>(shift), static_cast<T*>(y), N,
      C, G, chunks, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace lfdm

extern "C" int launch_groupnorm_film_silu_f32(const void* x, const void* gamma, const void* beta,
                                              const void* scale, const void* shift,
                                              void* partial, void* y, int B, long long N, int C,
                                              int G, int chunks, float eps, void* stream) {
  return lfdm::launch<float>(x, gamma, beta, scale, shift, partial, y, B, N, C, G, chunks, eps,
                             stream);
}

extern "C" int launch_groupnorm_film_silu_bf16(const void* x, const void* gamma, const void* beta,
                                               const void* scale, const void* shift,
                                               void* partial, void* y, int B, long long N, int C,
                                               int G, int chunks, float eps, void* stream) {
  return lfdm::launch<__nv_bfloat16>(x, gamma, beta, scale, shift, partial, y, B, N, C, G,
                                     chunks, eps, stream);
}
