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
// rel-pos bias and, for focus rows, NEG_INF off the frame diagonal; NEG_INF
// is -0.7 * FLT_MAX, so adding a score cannot overflow).
//
// Bound on the H100: bytes (qkv read once, out written once, the bias table;
// 4 F^2 D FLOP per unit, 0.2 MFLOP at F = 40). What holds the kernel is the
// time a warp takes per unit: at the serving shapes a warp has one to four
// units, so the design keeps every step of a unit inside one warp, with no
// barrier after the block's prologue.
//
// bf16 (the `pallas` UNet form): tensor cores, mma.sync.m16n8k16 with bf16
// operands and fp32 sums (helpers in mma.cuh), the head-packed forward's
// design without the rotary. A block owns a chunk of pixels of one (batch,
// head) (`chunks` per (batch, head), chosen by the wrapper from the card's
// SM count) and copies the diagonal bias blocks its pixels use into shared
// memory once (16-byte cp.async where the rows allow it: with 4-byte copies
// this prologue was most of a call at HW <= 256). Slot s holds block
// (x0 + s) % P and pixel x reads slot (x - x0) % slots, so a chunk need not
// start at a multiple of P. Each warp walks its share of the pixels in
// order, one (pixel, head) unit at a time: it copies the unit's q, k, v rows
// (64 bytes each, at a stride of 3*heads*D) with 16-byte cp.async into
// XOR-swizzled [16*ceil(F/16)][32] bf16 tiles whose pad rows stay zero (a
// stale V pad row times a zero probability would be NaN), then runs query
// strips of 16 rows: S = Q K^T over ceil(F / 8) key tiles of 8 on ldmatrix
// fragments, the bias added and pad keys set to -inf in the C fragments,
// the row max and sum over a quad of lanes, each row's exp (__expf) scaled
// by the reciprocal of its sum and only then rounded to bf16 (the Pallas
// kernel's rounding point: prob.astype(v.dtype)) as the A fragments of P V;
// __expf and the reciprocal move a probability by a few fp32 ulps, below
// that rounding. The strip's output replaces its q rows in shared memory
// and leaves as 16-byte stores of whole 64-byte rows.
//
// fp32: CUDA cores (mma on fp32 operands would be TF32, ten mantissa bits,
// against the fp32 gates' 2e-4): a block of four warps per unit, q, k, v as
// fp32 rows of stride 33 in shared memory, lanes on keys for the scores and
// softmax and on channels for p.v, FMA loops.
//
// Layouts: qkv [B, HW, F, 3*heads*D]; bias [B, heads, P*F, P*F] fp32;
// out [B, HW, F, heads*D]. The bf16 kernel needs qkv and out 16-byte aligned.

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace lfdm {
namespace {

constexpr int D = 32;        // dim_head == warp size: lane <-> channel
constexpr int LD = D + 1;    // shared-memory row stride (fp32 kernel)
constexpr int kWarps = 4;    // warps of an fp32 block

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

// ---------------------------------------------------------------- bf16: tensor cores

using bf16 = __nv_bfloat16;

constexpr int kTileRow = 2 * D;   // bytes of a [FP][32] bf16 tile row
constexpr int kMaxWarps = 8;      // warps of a block
constexpr int kMaxSmem = 232448;  // dynamic shared memory of one block on the H100

// Shared memory of a block: its bias slots, then each warp's q, k, v tiles.
__host__ __device__ constexpr int bias_bytes(int slots, int F) {
  return (slots * F * F * 4 + 127) / 128 * 128;
}

__host__ __device__ constexpr int warp_bytes(int KT) { return 3 * 16 * KT * kTileRow; }

// NT = ceil(F / 8) tiles of 8 keys, KT = ceil(F / 16) strips of 16 query
// rows. (Bounds: two blocks of eight warps per SM.)
template <int NT>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
packed_attention_mma_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                            bf16* __restrict__ out, int F, int HW, int heads, int P, int chunks) {
  constexpr int KT = (NT + 1) / 2, FP = 16 * KT, TB = FP * kTileRow;
  extern __shared__ __align__(128) char tc_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  // block (b, g, chunk) owns pixels [x0, x1) of (batch b, head g); warp w
  // walks [wx0, wx1) of them
  const int chunk = blockIdx.x % chunks, g = (blockIdx.x / chunks) % heads;
  const long long b = blockIdx.x / chunks / heads;
  const int ppb = (HW + chunks - 1) / chunks, x0 = min(chunk * ppb, HW), x1 = min(x0 + ppb, HW);
  const int px = (ppb + warps - 1) / warps;
  const int wx0 = min(x0 + warp * px, x1), wx1 = min(wx0 + px, x1);
  const int slots = min(P, ppb), hd = heads * D;
  float* sbias = reinterpret_cast<float*>(tc_smem);
  char* tiles = tc_smem + bias_bytes(slots, F) + warp * warp_bytes(KT);
  const uint32_t sq = smem_u32(tiles), sk = sq + TB, sv = sk + TB;

  const long long PF = (long long)P * F;
  const float* bhead = bias + (b * heads + g) * PF * PF;
  // row i of slot s is F floats at bhead + (d + i) * PF + d: 16-byte copies where
  // F % 4 == 0 and the bias is 16-byte aligned (then every row is), else 4-byte
  const int vec = (F % 4 == 0 && reinterpret_cast<uintptr_t>(bias) % 16 == 0) ? 4 : 1;
  const int row_chunks = F / vec;
  for (int idx = threadIdx.x; idx < slots * F * row_chunks; idx += blockDim.x) {
    const int r = idx / row_chunks, j = (idx - r * row_chunks) * vec, s = r / F, i = r - s * F;
    const long long d = (long long)((x0 + s) % P) * F;
    const float* src = bhead + (d + i) * PF + d + j;
    if (vec == 4)
      cp_async_16(smem_u32(sbias + r * F + j), src);
    else
      cp_async_4(smem_u32(sbias + r * F + j), src);
  }
  // pad rows F..FP-1 of the three tiles: zero once, never written again
  for (int idx = lane; idx < 12 * (FP - F); idx += 32) {
    const int part = idx % 3, r = F + idx / 12, c = (idx / 3) & 3;
    *reinterpret_cast<uint4*>(tiles + part * TB + swz(r, c)) = make_uint4(0u, 0u, 0u, 0u);
  }
  // a unit's q, k, v rows f < F: chunk idx = (f * 3 + part) * 4 + c goes to lane idx % 32
  const auto load_unit = [&](int x) {
    const bf16* src = qkv + (b * HW + x) * (long long)F * 3 * hd + g * D;
    for (int idx = lane; idx < 12 * F; idx += 32) {
      const int f = idx / 12, part = (idx >> 2) % 3, c = idx & 3;
      cp_async_16(sq + part * TB + swz(f, c), src + (long long)f * 3 * hd + part * hd + c * 8);
    }
  };
  if (wx0 < wx1) load_unit(wx0);  // in flight with the bias copies
  cp_async_wait_all();
  __syncthreads();

  const int grp = lane >> 2, q2 = 2 * (lane & 3);
#pragma unroll 1
  for (int x = wx0; x < wx1; ++x) {
    if (x > wx0) {
      __syncwarp();  // the previous pixel's output has left the q tile
      load_unit(x);
      cp_async_wait_all();
    }
    __syncwarp();
    const float* sb = sbias + ((x - x0) % slots) * F * F;
#pragma unroll 1
    for (int s = 0; s < KT; ++s) {
      float sc[NT][4];
      strip_abT<NT>(sq, sk, s, lane, sc);
      float m0, m1;
      bias_max<NT>(sc, sb, s, F, lane, m0, m1);
      float l0 = 0.f, l1 = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[n][e] = __expf(sc[n][e] - m0);
          sc[n][2 + e] = __expf(sc[n][2 + e] - m1);
          l0 += sc[n][e];
          l1 += sc[n][2 + e];
        }
      const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[n][e] *= inv0;  // normalised, then rounded to bf16 in to_a
          sc[n][2 + e] *= inv1;
        }
      uint32_t pa[KT][4];
      to_a<NT>(sc, pa);
      float o[4][4] = {};
      strip_pv<KT>(pa, sv, lane, o);
      __syncwarp();  // the strip's q rows are read: its output takes their place
      const int r0 = 16 * s + grp, r1 = r0 + 8;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        if (r0 < F)
          *reinterpret_cast<uint32_t*>(tiles + swz(r0, n) + 2 * q2) = pack_bf16(o[n][0], o[n][1]);
        if (r1 < F)
          *reinterpret_cast<uint32_t*>(tiles + swz(r1, n) + 2 * q2) = pack_bf16(o[n][2], o[n][3]);
      }
    }
    __syncwarp();
    bf16* dst = out + (b * HW + x) * (long long)F * hd + g * D;
    for (int idx = lane; idx < 4 * F; idx += 32) {
      const int f = idx >> 2, c = idx & 3;
      *reinterpret_cast<uint4*>(dst + (long long)f * hd + c * 8) =
          *reinterpret_cast<const uint4*>(tiles + swz(f, c));
    }
  }
}

template <int NT>
cudaError_t launch_mma(const bf16* qkv, const float* bias, bf16* out, int B, int F, int HW,
                       int heads, int P, int chunks, cudaStream_t st) {
  const int ppb = (HW + chunks - 1) / chunks;
  const int w = std::max(1, std::min(kMaxWarps, ppb));
  const int smem = bias_bytes(std::min(P, ppb), F) + w * warp_bytes((NT + 1) / 2);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;  // the wrapper sizes chunks to fit
  auto kernel = packed_attention_mma_kernel<NT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)((long long)B * heads * chunks), w * 32, smem, st>>>(qkv, bias, out, F, HW,
                                                                          heads, P, chunks);
  return cudaGetLastError();
}

// A bf16 call runs one block per (batch, head, chunk of pixels); fp32 runs
// one block per (batch, pixel, head) and ignores `chunks`.
template <typename T>
int launch(const void* qkv, const void* bias, void* out, int B, int F, int HW, int heads, int P,
           int chunks, void* stream) {
  if (B < 1 || F < 1 || F > 64 || HW < 1 || heads < 1 || P < 1 || HW % P != 0 || chunks < 1 ||
      chunks > HW)
    return cudaErrorInvalidValue;
  const long long units = (long long)B * HW * heads;
  if (units > 2147483647LL) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same_v<T, bf16>) {
    auto q = static_cast<const bf16*>(qkv);
    auto bi = static_cast<const float*>(bias);
    auto o = static_cast<bf16*>(out);
    switch ((F + 7) / 8) {
      case 1: return launch_mma<1>(q, bi, o, B, F, HW, heads, P, chunks, st);
      case 2: return launch_mma<2>(q, bi, o, B, F, HW, heads, P, chunks, st);
      case 3: return launch_mma<3>(q, bi, o, B, F, HW, heads, P, chunks, st);
      case 4: return launch_mma<4>(q, bi, o, B, F, HW, heads, P, chunks, st);
      case 5: return launch_mma<5>(q, bi, o, B, F, HW, heads, P, chunks, st);
      case 6: return launch_mma<6>(q, bi, o, B, F, HW, heads, P, chunks, st);
      case 7: return launch_mma<7>(q, bi, o, B, F, HW, heads, P, chunks, st);
      default: return launch_mma<8>(q, bi, o, B, F, HW, heads, P, chunks, st);
    }
  } else {
    const size_t smem = sizeof(float) * 3 * (size_t)F * LD;
    packed_attention_kernel<T><<<(unsigned)units, kWarps * 32, smem, st>>>(
        static_cast<const T*>(qkv), static_cast<const float*>(bias), static_cast<T*>(out), F,
        (long long)HW, heads, P);
    return cudaGetLastError();
  }
}

}  // namespace
}  // namespace lfdm

extern "C" int launch_packed_attention_f32(const void* qkv, const void* bias, void* out, int B,
                                           int F, int HW, int heads, int P, int chunks,
                                           void* stream) {
  return lfdm::launch<float>(qkv, bias, out, B, F, HW, heads, P, chunks, stream);
}

extern "C" int launch_packed_attention_bf16(const void* qkv, const void* bias, void* out, int B,
                                            int F, int HW, int heads, int P, int chunks,
                                            void* stream) {
  return lfdm::launch<__nv_bfloat16>(qkv, bias, out, B, F, HW, heads, P, chunks, stream);
}
