// Head-packed temporal attention, forward and backward, for DM training:
//   blk = round_T(rotary(qkv))            (q-scale folded into the tables)
//   out[b, i, x, g*D:(g+1)*D] = softmax_j(q_g[i] . k_g[j] + bias[b, i, g*F + j]) . v_g[j]
// over the F frames of each pixel x and head g (D = 32), and the
// recompute-based backward that returns dqkv (gradient of the RAW qkv, with
// the rotary adjoint) and dbias summed over all pixels.
//
// Replaces the Pallas TPU kernels cvpr23_lfdm_tpu/ops/attention_pallas.py::
// _headpacked_kernel (forward, via _headpacked_call) and
// _headpacked_bwd_kernel (backward, via _headpacked_diff_bwd). The plain
// versions these are held against are in ops/attention.py.
//
// Bound on the H100: bytes. The forward reads qkv and writes out (0.42 GB at
// B=5, HW=1024, bf16); the backward reads qkv and do and writes dqkv (0.73
// GB); the products are 0.2 / 0.6 MFLOP per (pixel, head). Design: the unit
// of work is one (pixel, head): q, k, v are [F, 32] and the scores [F, F].
// A block of four warps owns a unit and keeps its q|k|v (and do in the
// backward) in shared memory as fp32 rows of stride 33 (conflict-free by row
// and by column); nothing but qkv, do, out and dqkv touches device memory.
// A warp works with lane = channel (loads, rotary with the pair partner by
// shuffle, the p.v / ds.k sums, stores) or lane = key frame (scores,
// softmax). The warps split the frames to load, then the query rows; the
// backward then rounds ds and prob into two [F, F] tiles, synchronises, and
// splits the key columns (dk_j = sum_i ds_ij q_i, dv_j = sum_i p_ij do_i),
// so no accumulator is shared between warps. Rounding to the storage type T
// happens where the Pallas kernels round: rotated qkv; exp before the
// numerator and denominator sums (forward); the denominator, prob.dp row sum,
// prob (for dv) and ds (for dq, dk) in the backward; dk and dv before the
// rotary adjoint. The row max is per head (the TPU kernel takes one across
// heads; the softmax is the same). FMA loops on CUDA cores; tensor cores
// (mma.sync/wgmma) are later work.
//
// dbias is deterministic: a backward block walks a chunk of pixels of one
// (batch, head) in order and accumulates ds in its own shared-memory [F, F]
// tile (each entry owned by one lane), writes it to partial[b, g, chunk], and
// a second kernel sums the chunks in index order. No atomics.
//
// Layouts: qkv, dqkv [B, F, HW, 3*heads*D]; out, do [B, F, HW, heads*D];
// bias, dbias [B, F, heads*F] fp32; cos/sin [F, 3*heads*D] (type T).

#include "common.cuh"

namespace lfdm {
namespace {

constexpr int D = 32;        // dim_head == warp size: lane <-> channel
constexpr int LD = D + 1;    // shared-memory row stride
constexpr float kTiny = 1.17549435e-38f;  // float32 tiny, the denominator clamp

// Load frame f of part `part` (0 q, 1 k, 2 v) of head g at pixel x, rotate,
// round to T and store as the fp32 row dst[f * LD + lane] (one warp, lane =
// channel; the pair partner comes by shuffle).
template <typename T>
__device__ __forceinline__ void load_rotated(const T* __restrict__ qkv, const T* __restrict__ cos_t,
                                             const T* __restrict__ sin_t, long long b, int f,
                                             long long x, int g, int part, int F, long long HW,
                                             int hd, float* dst, int lane) {
  const int col = part * hd + g * D + lane;
  const float v = to_f<T>(qkv[((b * F + f) * HW + x) * (3LL * hd) + col]);
  const float other = __shfl_xor_sync(kFull, v, 1);
  const float rot = (lane & 1) ? other : -other;
  const long long t = (long long)f * 3 * hd + col;
  dst[f * LD + lane] = rnd<T>(v * to_f<T>(cos_t[t]) + rot * to_f<T>(sin_t[t]));
}

// Scores of query row i against keys j = lane and lane + 32 (-inf past F).
__device__ __forceinline__ void scores(const float* sq, const float* sk, const float* bias_row,
                                       int i, int F, int lane, float& s0, float& s1) {
  const float* q = sq + i * LD;
  const int j1 = lane + 32;
  float a0 = 0.f, a1 = 0.f;
  if (lane < F) {
    const float* k = sk + lane * LD;
#pragma unroll
    for (int t = 0; t < D; ++t) a0 = fmaf(q[t], k[t], a0);
  }
  if (j1 < F) {
    const float* k = sk + j1 * LD;
#pragma unroll
    for (int t = 0; t < D; ++t) a1 = fmaf(q[t], k[t], a1);
  }
  s0 = lane < F ? a0 + bias_row[lane] : -INFINITY;
  s1 = j1 < F ? a1 + bias_row[j1] : -INFINITY;
}

constexpr int kWarps = 4;  // warps of a block; they share one unit's tiles

// One block per (batch, pixel, head): its warps split the frames to load,
// then the query rows.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
headpacked_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                      const T* __restrict__ cos_t, const T* __restrict__ sin_t,
                      T* __restrict__ out, int F, long long HW, int heads) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long unit = blockIdx.x;  // (b, x, g)
  const int hd = heads * D;
  const int g = (int)(unit % heads);
  const long long x = (unit / heads) % HW, b = unit / heads / HW;
  float* sq = smem;
  float* sk = sq + F * LD;
  float* sv = sk + F * LD;
  for (int f = warp; f < F; f += kWarps)
    for (int part = 0; part < 3; ++part)
      load_rotated<T>(qkv, cos_t, sin_t, b, f, x, g, part, F, HW, hd, sq + part * F * LD, lane);
  __syncthreads();

  for (int i = warp; i < F; i += kWarps) {
    float s0, s1;
    scores(sq, sk, bias + (b * F + i) * ((long long)heads * F) + (long long)g * F, i, F, lane,
           s0, s1);
    const float m = warp_max(fmaxf(s0, s1));
    const float e0 = lane < F ? rnd<T>(expf(s0 - m)) : 0.f;
    const float e1 = lane + 32 < F ? rnd<T>(expf(s1 - m)) : 0.f;
    const float den = fmaxf(warp_sum(e0 + e1), kTiny);
    float o = 0.f;
    for (int j = 0; j < F; ++j) {
      const float ej = __shfl_sync(kFull, j < 32 ? e0 : e1, j & 31);
      o = fmaf(ej, sv[j * LD + lane], o);
    }
    out[((b * F + i) * HW + x) * hd + g * D + lane] = from_f<T>(o / den);
  }
}

// One row of dqkv: the rotary adjoint dx*cos - rot(dx)*sin, lane = channel.
template <typename T>
__device__ __forceinline__ void store_adjoint(T* __restrict__ dqkv, const T* __restrict__ cos_t,
                                              const T* __restrict__ sin_t, long long b, int f,
                                              long long x, int g, int part, int F, long long HW,
                                              int hd, float dx, int lane) {
  const int col = part * hd + g * D + lane;
  const float other = __shfl_xor_sync(kFull, dx, 1);
  const float rot = (lane & 1) ? other : -other;
  const long long t = (long long)f * 3 * hd + col;
  dqkv[((b * F + f) * HW + x) * (3LL * hd) + col] =
      from_f<T>(dx * to_f<T>(cos_t[t]) - rot * to_f<T>(sin_t[t]));
}

// One block per (batch, chunk of pixels, head); its warps share the unit's
// q, k, v, do and split the work three ways per pixel: frames to load, query
// rows (scores, softmax backward, dq), then key columns (dk, dv).
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
headpacked_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                      const T* __restrict__ cos_t, const T* __restrict__ sin_t,
                      const T* __restrict__ dout, T* __restrict__ dqkv,
                      float* __restrict__ partial, int F, long long HW, int heads, int px,
                      int chunks) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long job = blockIdx.x;  // (b, chunk, g)
  const int hd = heads * D;
  const int g = (int)(job % heads);
  const int chunk = (int)((job / heads) % chunks);
  const long long b = job / heads / chunks;
  const int rows = F * LD, LS = F + 1;
  float* sq = smem;
  float* sk = sq + rows;
  float* sv = sk + rows;
  float* sdo = sv + rows;
  float* sds = sdo + rows;    // [F][F+1] ds rounded to T
  float* sp = sds + F * LS;   // [F][F+1] prob rounded to T
  float* sdb = sp + F * LS;   // [F][F] sum of ds over this block's pixels
  for (int e = threadIdx.x; e < F * F; e += kWarps * 32) sdb[e] = 0.f;

  const long long x_end = min((long long)(chunk + 1) * px, HW);
  for (long long x = (long long)chunk * px; x < x_end; ++x) {
    __syncthreads();  // the previous pixel's tiles are no longer read
    for (int f = warp; f < F; f += kWarps) {
      for (int part = 0; part < 3; ++part)
        load_rotated<T>(qkv, cos_t, sin_t, b, f, x, g, part, F, HW, hd, sq + part * rows, lane);
      sdo[f * LD + lane] = to_f<T>(dout[((b * F + f) * HW + x) * hd + g * D + lane]);
    }
    __syncthreads();

    // query rows: lanes hold keys j = lane and lane + 32
    for (int i = warp; i < F; i += kWarps) {
      const int j1 = lane + 32;
      float s0, s1;
      scores(sq, sk, bias + (b * F + i) * ((long long)heads * F) + (long long)g * F, i, F, lane,
             s0, s1);
      const float* doi = sdo + i * LD;
      float dp0 = 0.f, dp1 = 0.f;
      if (lane < F) {
        const float* v = sv + lane * LD;
#pragma unroll
        for (int t = 0; t < D; ++t) dp0 = fmaf(doi[t], v[t], dp0);
      }
      if (j1 < F) {
        const float* v = sv + j1 * LD;
#pragma unroll
        for (int t = 0; t < D; ++t) dp1 = fmaf(doi[t], v[t], dp1);
      }
      const float m = warp_max(fmaxf(s0, s1));
      const float e0 = lane < F ? expf(s0 - m) : 0.f;
      const float e1 = j1 < F ? expf(s1 - m) : 0.f;
      const float dl = fmaxf(warp_sum(rnd<T>(e0) + rnd<T>(e1)), kTiny);
      const float p0 = e0 / dl, p1 = e1 / dl;
      const float c = warp_sum(rnd<T>(p0 * dp0) + rnd<T>(p1 * dp1));
      const float ds0 = p0 * (dp0 - c), ds1 = p1 * (dp1 - c);
      const float r0 = rnd<T>(ds0), r1 = rnd<T>(ds1);
      if (lane < F) {
        sdb[i * F + lane] += ds0;
        sds[i * LS + lane] = r0;
        sp[i * LS + lane] = rnd<T>(p0);
      }
      if (j1 < F) {
        sdb[i * F + j1] += ds1;
        sds[i * LS + j1] = r1;
        sp[i * LS + j1] = rnd<T>(p1);
      }
      float dq = 0.f;  // lane = channel from here
      for (int j = 0; j < F; ++j) {
        const float dsj = __shfl_sync(kFull, j < 32 ? r0 : r1, j & 31);
        dq = fmaf(dsj, sk[j * LD + lane], dq);
      }
      store_adjoint<T>(dqkv, cos_t, sin_t, b, i, x, g, 0, F, HW, hd, dq, lane);
    }
    __syncthreads();

    // key columns: dk_j = sum_i ds_ij q_i, dv_j = sum_i p_ij do_i, lane = channel
    for (int j = warp; j < F; j += kWarps) {
      float dk = 0.f, dv = 0.f;
      for (int i = 0; i < F; ++i) {
        dk = fmaf(sds[i * LS + j], sq[i * LD + lane], dk);
        dv = fmaf(sp[i * LS + j], sdo[i * LD + lane], dv);
      }
      store_adjoint<T>(dqkv, cos_t, sin_t, b, j, x, g, 1, F, HW, hd, rnd<T>(dk), lane);
      store_adjoint<T>(dqkv, cos_t, sin_t, b, j, x, g, 2, F, HW, hd, rnd<T>(dv), lane);
    }
  }
  if (partial != nullptr) {
    __syncthreads();
    float* dst = partial + ((b * heads + g) * chunks + chunk) * ((long long)F * F);
    for (int e = threadIdx.x; e < F * F; e += kWarps * 32) dst[e] = sdb[e];
  }
}

// dbias[b, i, g*F + j] = sum over chunks (in index order) of partial[b, g, chunk, i, j]
__global__ void headpacked_dbias_kernel(const float* __restrict__ partial,
                                        float* __restrict__ dbias, long long total, int F,
                                        int heads, int chunks) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int j = (int)(idx % F);
  const int g = (int)((idx / F) % heads);
  const int i = (int)((idx / F / heads) % F);
  const long long b = idx / F / heads / F;
  const float* src = partial + (b * heads + g) * chunks * ((long long)F * F) + (long long)i * F + j;
  float acc = 0.f;
  for (int c = 0; c < chunks; ++c) acc += src[(long long)c * F * F];
  dbias[idx] = acc;
}

bool bad_shape(int B, int F, int HW, int heads) {
  return B < 1 || F < 1 || F > 64 || HW < 1 || heads < 1;
}

template <typename T>
int launch_fwd(const void* qkv, const void* bias, const void* cos_t, const void* sin_t, void* out,
               int B, int F, int HW, int heads, void* stream) {
  if (bad_shape(B, F, HW, heads)) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 3 * F * LD;
  auto kernel = headpacked_fwd_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long units = (long long)B * HW * heads;
  kernel<<<(unsigned)units, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias), static_cast<const T*>(cos_t),
      static_cast<const T*>(sin_t), static_cast<T*>(out), F, HW, heads);
  return cudaGetLastError();
}

// `partial` holds B*heads*chunks*F*F floats, or is null when dbias is not
// wanted (then `dbias` is not written either).
template <typename T>
int launch_bwd(const void* qkv, const void* bias, const void* cos_t, const void* sin_t,
               const void* dout, void* dqkv, void* partial, void* dbias, int B, int F, int HW,
               int heads, int px, void* stream) {
  if (bad_shape(B, F, HW, heads) || px < 1) return cudaErrorInvalidValue;
  const int chunks = (HW + px - 1) / px;
  const size_t smem = sizeof(float) * (4 * F * LD + 2 * F * (F + 1) + F * F);
  auto kernel = headpacked_bwd_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long jobs = (long long)B * chunks * heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<(unsigned)jobs, kWarps * 32, smem, st>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias), static_cast<const T*>(cos_t),
      static_cast<const T*>(sin_t), static_cast<const T*>(dout), static_cast<T*>(dqkv),
      static_cast<float*>(partial), F, HW, heads, px, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return err;
  const long long total = (long long)B * F * heads * F;
  headpacked_dbias_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(dbias), total, F, heads, chunks);
  return cudaGetLastError();
}

}  // namespace
}  // namespace lfdm

#define LFDM_HEADPACKED_EXPORTS(SUFFIX, TYPE)                                                     \
  extern "C" int launch_headpacked_fwd_##SUFFIX(const void* qkv, const void* bias,               \
                                                const void* cos_t, const void* sin_t, void* out, \
                                                int B, int F, int HW, int heads, void* stream) { \
    return lfdm::launch_fwd<TYPE>(qkv, bias, cos_t, sin_t, out, B, F, HW, heads, stream);        \
  }                                                                                               \
  extern "C" int launch_headpacked_bwd_##SUFFIX(                                                  \
      const void* qkv, const void* bias, const void* cos_t, const void* sin_t, const void* dout, \
      void* dqkv, void* partial, void* dbias, int B, int F, int HW, int heads, int px,           \
      void* stream) {                                                                             \
    return lfdm::launch_bwd<TYPE>(qkv, bias, cos_t, sin_t, dout, dqkv, partial, dbias, B, F, HW, \
                                  heads, px, stream);                                             \
  }

LFDM_HEADPACKED_EXPORTS(f32, float)
LFDM_HEADPACKED_EXPORTS(bf16, __nv_bfloat16)
