// Packed temporal attention (forward only): softmax attention over the F
// frames of each pixel x and head g (D = 32) on a qkv whose rotary and
// q-scale were applied outside,
//   s[i, j] = q_g[i] . k_g[j] + bias[b, g, (x % P) * F + i, (x % P) * F + j]
//   prob    = round_T(softmax_j(s))            (fp32 scores and softmax)
//   out[b, x, i, g*D:(g+1)*D] = round_T(sum_j prob[i, j] * v_g[j])
//
// Replaces the Pallas TPU kernel cvpr23_lfdm_tpu/ops/attention_pallas.py::
// packed_temporal_attention (_kernel). The plain version this is held
// against is ops/attention.py::packed_temporal_attention_plain.
//
// The TPU kernel packs P pixels into one [P*F, d] tile so that the scores are
// one matrix product, and masks the cross-pixel scores through an additive
// [P*F, P*F] bias. The masked entries are exactly 0 after exp, so on Hopper
// the unit of work is one (pixel, head) and the kernel reads only that
// pixel's [F, F] diagonal block of the bias tensor (which carries the
// rel-pos bias and, for focus rows, NEG_INF off the frame diagonal).
//
// Bound on the H100: bytes (qkv read once, out written once; ~0.2 MFLOP per
// unit). A block of four warps owns one unit; a unit's q, k, v rows are
// contiguous in F here ([B, HW, F, 3*heads*D]), 64 or 128 bytes each, loaded
// with lane = channel into fp32 rows of stride 33 in shared memory. The warps
// then split the query rows: lanes hold the keys for the scores and the
// softmax, the channels for the p.v sum. FMA loops on CUDA cores.
//
// Layouts: qkv [B, HW, F, 3*heads*D]; bias [B, heads, P*F, P*F] fp32;
// out [B, HW, F, heads*D].

#include "common.cuh"

namespace lfdm {
namespace {

constexpr int D = 32;        // dim_head == warp size: lane <-> channel
constexpr int LD = D + 1;    // shared-memory row stride
constexpr int kWarps = 4;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
packed_attention_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                        T* __restrict__ out, int F, long long HW, int heads, int P) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long unit = blockIdx.x;  // (b, x, g)
  const int hd = heads * D;
  const int g = (int)(unit % heads);
  const long long x = (unit / heads) % HW, b = unit / heads / HW;
  float* sq = smem;
  float* sk = sq + F * LD;
  float* sv = sk + F * LD;
  const T* base = qkv + (b * HW + x) * (long long)F * 3 * hd + g * D + lane;
  for (int f = warp; f < F; f += kWarps)
    for (int part = 0; part < 3; ++part)
      sq[part * F * LD + f * LD + lane] = to_f<T>(base[(long long)f * 3 * hd + part * hd]);
  __syncthreads();

  const long long PF = (long long)P * F;
  const long long off = (x % P) * F;  // this pixel's diagonal block
  const float* bias_blk = bias + ((b * heads + g) * PF + off) * PF + off;
  for (int i = warp; i < F; i += kWarps) {
    const float* q = sq + i * LD;
    const float* brow = bias_blk + i * PF;
    const int j1 = lane + 32;
    float s0 = -INFINITY, s1 = -INFINITY;
    if (lane < F) {
      const float* k = sk + lane * LD;
      float a = 0.f;
#pragma unroll
      for (int t = 0; t < D; ++t) a = fmaf(q[t], k[t], a);
      s0 = a + brow[lane];
    }
    if (j1 < F) {
      const float* k = sk + j1 * LD;
      float a = 0.f;
#pragma unroll
      for (int t = 0; t < D; ++t) a = fmaf(q[t], k[t], a);
      s1 = a + brow[j1];
    }
    const float m = warp_max(fmaxf(s0, s1));
    const float e0 = lane < F ? expf(s0 - m) : 0.f;
    const float e1 = j1 < F ? expf(s1 - m) : 0.f;
    const float den = warp_sum(e0 + e1);
    const float p0 = rnd<T>(e0 / den), p1 = rnd<T>(e1 / den);
    float o = 0.f;
    for (int j = 0; j < F; ++j) {
      const float pj = __shfl_sync(kFull, j < 32 ? p0 : p1, j & 31);
      o = fmaf(pj, sv[j * LD + lane], o);
    }
    out[((b * HW + x) * F + i) * hd + g * D + lane] = from_f<T>(o);
  }
}

template <typename T>
int launch(const void* qkv, const void* bias, void* out, int B, int F, int HW, int heads, int P,
           void* stream) {
  if (B < 1 || F < 1 || F > 64 || HW < 1 || heads < 1 || P < 1 || HW % P != 0)
    return cudaErrorInvalidValue;
  const long long units = (long long)B * HW * heads;
  if (units > 2147483647LL) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 3 * (size_t)F * LD;
  packed_attention_kernel<T><<<(unsigned)units, kWarps * 32, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias), static_cast<T*>(out), F,
      (long long)HW, heads, P);
  return cudaGetLastError();
}

}  // namespace
}  // namespace lfdm

extern "C" int launch_packed_attention_f32(const void* qkv, const void* bias, void* out, int B,
                                           int F, int HW, int heads, int P, void* stream) {
  return lfdm::launch<float>(qkv, bias, out, B, F, HW, heads, P, stream);
}

extern "C" int launch_packed_attention_bf16(const void* qkv, const void* bias, void* out, int B,
                                            int F, int HW, int heads, int P, void* stream) {
  return lfdm::launch<__nv_bfloat16>(qkv, bias, out, B, F, HW, heads, P, stream);
}
