// Fused conv bias + GroupNorm + FiLM + SiLU of the UNet's Block (forward only):
//   v = round_T(x + pre_bias)
//   y = silu(GroupNorm_G(v) * (scale + 1) + shift)
// with fp32 statistics per (batch, group) over (F, H, W, C/G), var =
// max(E[v^2] - mean^2, 0) (clamped as flax's GroupNorm), gamma, beta and the
// optional FiLM [B, C] folded into one multiply and one add per channel, and
// the result in x's dtype. The optional per-channel pre_bias is the conv's
// bias that a bf16 Block adds after the rounded product (flax's order,
// models/blocks.py::split_bias): v is rounded to T as that add rounds it.
//
// Replaces the Pallas TPU kernel cvpr23_lfdm_tpu/ops/norm_pallas.py::
// groupnorm_film_silu (_kernel). The plain version this is held against is
// ops/norm.py::groupnorm_film_silu_plain.
//
// Bound on the H100: bytes (x read once, y written once). The TPU kernel
// holds one batch entry's whole activation in VMEM, one grid step per batch
// entry. Here one cooperative launch spreads each batch entry over many
// blocks, all resident on the card at once (cudaLaunchCooperativeKernel
// refuses a grid that cannot be), and:
//   1. each block copies its chunk of rows into shared memory (16-byte
//      cp.async; as much as fits, ~110 KB a block, two blocks an SM: ~29 MB
//      over the card), then sums each of its columns in fp32 (a thread owns
//      fixed columns of 16 bytes, so its channels never change) and folds
//      the column sums per group in a fixed order, one warp per group. With
//      a pre_bias (each thread's channels loaded into registers beside the
//      rows), the sum reads v and writes it back over the held x, so that
//      step 4 streams the held rows as it does without one;
//   2. writes its (sum, sum of squares) per group to `partial` (a group's
//      partials side by side, so that step 3 reads them coalesced: every
//      block reads all of its batch entry's) and meets the other blocks at
//      the grid barrier (cooperative groups);
//   3. adds its batch entry's partials in a fixed order (one warp per group,
//      a shuffle tree), so a repeated call gives the same bits; float sums
//      never go through atomics;
//   4. folds mean, rstd, gamma, beta and the FiLM pair (copied to shared
//      memory while the rows load, so their latency hides behind the rows')
//      into a multiply and an add per owned channel, kept in registers, and
//      streams y from the
//      chunk still in shared memory with 16-byte stores. Rows that did not
//      fit are read a second time from device memory (mostly from L2).
// Where C, C/G or the pointers rule out 16-byte vectors (C = 24, a view that
// starts one element in), the same kernel runs on single elements: a thread
// then owns up to four columns. The wrapper chooses the path and the grid
// (ops/norm.py::norm_plan).
//
// Layouts: x, y [B, N, C] (N = F*H*W rows, channels last); gamma, beta,
// pre_bias [C] and scale, shift [B, C] in fp32 or bf16 at any strides (a
// FiLM half of the UNet's [B, 1, 1, 1, 2C] goes in as it is); partial
// [B, G, blocks, 2] fp32.

#include <cooperative_groups.h>

#include <cstdint>
#include <mutex>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace lfdm {
namespace {

constexpr int kNormThreads = 512;
constexpr int kNormSmem = 115712;  // two blocks fill an SM's 228 KB (1 KB reserved each)
constexpr int kMaxCols = 4;        // columns a thread owns on the scalar path: C <= 4 * 512

// A per-channel (gamma, beta) or per-(batch, channel) (scale, shift) table,
// read in its own dtype at its own strides.
struct Table {
  const void* p;
  long long sb, sc;
  int bf16;
  __device__ __forceinline__ float at(long long b, int c) const {
    const long long i = b * sb + c * sc;
    return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                : static_cast<const float*>(p)[i];
  }
};

// VEC consecutive elements of T, loaded and stored as one unit (16 bytes, or
// one element on the scalar path)
template <typename T, int VEC>
union Unit {
  std::conditional_t<VEC == 1, T, uint4> u;
  T e[VEC];
};

// Bytes of the block's scratch before its rows: gamma, beta, scale and shift
// per channel, per-(row lane, column) sums and sums of squares, then mean and
// rstd per group. ops/norm.py::_scratch mirrors it.
__host__ __device__ inline int scratch_bytes(int C, int G, int VEC) {
  const int cv = C / VEC, cols = cv < kNormThreads ? cv : kNormThreads;
  const int red = (kNormThreads / cols) * cv;
  return (4 * (2 * red + 2 * G + 4 * C) + 15) / 16 * 16;
}

template <typename T, int VEC, bool BIAS>
__global__ void __launch_bounds__(kNormThreads, 2)
groupnorm_film_silu_kernel(const T* __restrict__ x, T* __restrict__ y, Table gamma, Table beta,
                           Table scale, Table shift, Table pre_bias, float* __restrict__ partial,
                           long long N, int C, int G, int nb, long long rows, long long hold_rows,
                           float eps) {
  using U = Unit<T, VEC>;
  constexpr int KC = VEC == 1 ? kMaxCols : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int CV = C / VEC, cols = CV < kNormThreads ? CV : kNormThreads;
  const int rows_par = kNormThreads / cols;
  const int red = rows_par * CV;
  float* tab = reinterpret_cast<float*>(smem);  // [4][C]: gamma, beta, scale, shift
  float* red_s = tab + 4 * C;
  float* red_ss = red_s + red;
  float* mean_g = red_ss + red;
  float* inv_g = mean_g + G;
  T* sx = reinterpret_cast<T*>(smem + scratch_bytes(C, G, VEC));

  const int b = blockIdx.x / nb;
  const long long r0 = (long long)(blockIdx.x - b * nb) * rows;
  const int nrows = (int)(N - r0 < rows ? N - r0 : rows);  // rows < 2^31: checked by the launcher
  const int held = nrows < hold_rows ? nrows : (int)hold_rows;
  const T* xb = x + ((long long)b * N + r0) * C;
  T* yb = y + ((long long)b * N + r0) * C;

  // the per-channel tables -> shared memory, their loads in flight beside the rows'
  auto load_tables = [&] {
    for (int c = tid; c < C; c += kNormThreads) {
      const bool film = scale.p != nullptr;  // all four loads in flight before the stores
      const float v[4] = {gamma.at(0, c), beta.at(0, c), film ? scale.at(b, c) : 0.f,
                          film ? shift.at(b, c) : 0.f};
#pragma unroll
      for (int k = 0; k < 4; ++k) tab[k * C + c] = v[k];
    }
  };
  // thread -> (row lane, first column); its columns col0 + j * kNormThreads
  const int lrow = tid / cols, col0 = tid - lrow * cols;
  const bool active = lrow < rows_par;
  // the conv bias of the thread's channels
  float pb[KC][VEC];
  auto load_pb = [&] {
    if constexpr (std::is_same_v<T, __nv_bfloat16> && VEC == 8) {
      // a bf16 bias at unit stride (as a bf16 Block passes it): the thread's
      // 8 channels in one 16-byte load
      if (pre_bias.bf16 && pre_bias.sc == 1 && reinterpret_cast<uintptr_t>(pre_bias.p) % 16 == 0) {
        U v;
        v.u = static_cast<const uint4*>(pre_bias.p)[col0];
#pragma unroll
        for (int i = 0; i < VEC; ++i) pb[0][i] = to_f<T>(v.e[i]);
        return;
      }
    }
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const int c0 = (col0 + j * kNormThreads) * VEC;
#pragma unroll
      for (int i = 0; i < VEC; ++i) pb[j][i] = c0 + i < C ? pre_bias.at(0, c0 + i) : 0.f;
    }
  };
  if constexpr (BIAS) {
    if (active) load_pb();  // in flight beside the rows
  }

  // 1. the rows that fit -> shared memory
  if constexpr (VEC > 1) {
    const int n16 = (int)((long long)held * C * sizeof(T) / 16);
    const uint32_t dst = smem_u32(sx);
    for (int i = tid; i < n16; i += kNormThreads)
      cp_async_16(dst + 16 * i, reinterpret_cast<const char*>(xb) + 16LL * i);
    cp_async_commit();
    load_tables();
    cp_async_wait_all();
  } else {
    load_tables();
    const int n = held * C;
    for (int i = tid; i < n; i += kNormThreads) sx[i] = xb[i];
  }
  __syncthreads();

  float s[KC], ss[KC];
#pragma unroll
  for (int j = 0; j < KC; ++j) s[j] = ss[j] = 0.f;
  // `keep`: the rows are the held chunk, which takes v in place of x
  auto sums = [&](const T* src, int r_begin, int r_end, bool keep) {
#pragma unroll 4
    for (int r = r_begin; r < r_end; r += rows_par) {
      U* row = reinterpret_cast<U*>(const_cast<T*>(src) + (long long)r * C);
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const int col = col0 + j * kNormThreads;
        if (col < CV) {
          U v;
          v.u = row[col].u;
          if constexpr (BIAS) {
#pragma unroll
            for (int i = 0; i < VEC; ++i) v.e[i] = from_f<T>(to_f<T>(v.e[i]) + pb[j][i]);
            if (keep) row[col].u = v.u;
          }
          float a = 0.f, aa = 0.f;
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const float f = to_f<T>(v.e[i]);
            a += f;
            aa += f * f;
          }
          s[j] += a;
          ss[j] += aa;
        }
      }
    }
  };
  // the first row of this lane at or after `from`
  auto first = [&](int from) { return from + ((lrow - from) % rows_par + rows_par) % rows_par; };
  if (active) {
    sums(sx, lrow, held, true);
    sums(xb, first(held), nrows, false);
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const int col = col0 + j * kNormThreads;
      if (col < CV) {
        red_s[lrow * CV + col] = s[j];
        red_ss[lrow * CV + col] = ss[j];
      }
    }
  }
  __syncthreads();

  // 2. this block's sums per group, in a fixed order: one warp per group
  const int cgv = C / G / VEC;  // columns of a group
  for (int g = warp; g < G; g += kNormThreads / 32) {
    float a = 0.f, aa = 0.f;
    for (int i = lane; i < rows_par * cgv; i += 32) {
      const int lr = i / cgv, k = lr * CV + g * cgv + (i - lr * cgv);
      a += red_s[k];
      aa += red_ss[k];
    }
    a = warp_sum(a);
    aa = warp_sum(aa);
    if (lane == 0)  // [b][g][block]: a group's partials lie side by side
      reinterpret_cast<float2*>(partial)[((long long)b * G + g) * nb + blockIdx.x - b * nb] =
          make_float2(a, aa);
  }
  cooperative_groups::this_grid().sync();

  // 3. the batch entry's statistics from its blocks' partials, in a fixed order
  for (int g = warp; g < G; g += kNormThreads / 32) {
    float a = 0.f, aa = 0.f;
    const float2* p = reinterpret_cast<const float2*>(partial) + ((long long)b * G + g) * nb;
    for (int k = lane; k < nb; k += 32) {  // coalesced: 32 neighbouring partials a load
      const float2 v = __ldcg(p + k);
      a += v.x;
      aa += v.y;
    }
    a = warp_sum(a);
    aa = warp_sum(aa);
    if (lane == 0) {
      const float cnt = (float)(N * (C / G));
      const float mean = a / cnt;
      const float var = fmaxf(aa / cnt - mean * mean, 0.f);
      mean_g[g] = mean;
      inv_g[g] = rsqrtf(var + eps);
    }
  }
  __syncthreads();

  // 4. multiply and add per channel (in place of gamma and beta), then each
  // thread's in registers, and the stream
  const int cg = C / G;
  for (int c = tid; c < C; c += kNormThreads) {
    const int g = c / cg;
    float m = inv_g[g] * tab[c];
    float a = tab[C + c] - mean_g[g] * m;
    if (scale.p != nullptr) {
      const float sc = tab[2 * C + c] + 1.f;
      m = m * sc;
      a = a * sc + tab[3 * C + c];
    }
    tab[c] = m;
    tab[C + c] = a;
  }
  __syncthreads();
  if (!active) return;
  float mul[KC][VEC], add[KC][VEC];
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    const int c0 = (col0 + j * kNormThreads) * VEC;
    if constexpr (VEC > 1) {  // C % 4 == 0: the rows of tab are 16-byte aligned
#pragma unroll
      for (int i = 0; i < VEC; i += 4) {
        const float4 m = *reinterpret_cast<const float4*>(tab + c0 + i);
        const float4 a = *reinterpret_cast<const float4*>(tab + C + c0 + i);
        mul[j][i] = m.x, mul[j][i + 1] = m.y, mul[j][i + 2] = m.z, mul[j][i + 3] = m.w;
        add[j][i] = a.x, add[j][i + 1] = a.y, add[j][i + 2] = a.z, add[j][i + 3] = a.w;
      }
    } else {
      mul[j][0] = c0 < C ? tab[c0] : 0.f;
      add[j][0] = c0 < C ? tab[C + c0] : 0.f;
    }
  }
  // `bias`: the rows are x from device memory, to which pre_bias is added again
  auto apply = [&](const T* src, int r_begin, int r_end, bool bias) {
#pragma unroll 4
    for (int r = r_begin; r < r_end; r += rows_par) {
      const U* row = reinterpret_cast<const U*>(src + (long long)r * C);
      U* out = reinterpret_cast<U*>(yb + (long long)r * C);
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const int col = col0 + j * kNormThreads;
        if (col < CV) {
          U v;
          v.u = row[col].u;
          if constexpr (BIAS) {
            if (bias) {
#pragma unroll
              for (int i = 0; i < VEC; ++i) v.e[i] = from_f<T>(to_f<T>(v.e[i]) + pb[j][i]);
            }
          }
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const float t = to_f<T>(v.e[i]) * mul[j][i] + add[j][i];
            v.e[i] = from_f<T>(__fdividef(t, 1.f + __expf(-t)));
          }
          out[col].u = v.u;
        }
      }
    }
  };
  apply(sx, lrow, held, false);
  if constexpr (BIAS) {
    if (held < nrows) load_pb();
  }
  apply(xb, first(held), nrows, true);
}

template <typename T, int VEC>
const void* kernel_ptr(int bias) {
  return bias ? reinterpret_cast<const void*>(&groupnorm_film_silu_kernel<T, VEC, true>)
              : reinterpret_cast<const void*>(&groupnorm_film_silu_kernel<T, VEC, false>);
}

// The kernel of (dtype, path, pre_bias or none), its dynamic shared memory
// allowed up to kNormSmem once per process.
const void* kernel_for(int bf16, int vec, int bias, cudaError_t* err) {
  static std::once_flag once[8];
  const void* k = bf16 ? (vec ? kernel_ptr<__nv_bfloat16, 8>(bias) : kernel_ptr<__nv_bfloat16, 1>(bias))
                       : (vec ? kernel_ptr<float, 4>(bias) : kernel_ptr<float, 1>(bias));
  static cudaError_t set[8];
  const int i = 4 * (bias != 0) + 2 * (bf16 != 0) + (vec != 0);
  std::call_once(once[i], [&] {
    set[i] = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kNormSmem);
  });
  *err = set[i];
  return k;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
}  // namespace lfdm

// Blocks of the (dtype, path) kernel one SM holds at the largest dynamic
// shared memory a plan may give it (the plan's grid is at most this times
// the SM count), the fewer of its forms with and without a pre_bias; a
// negative CUDA error code on failure.
extern "C" int groupnorm_film_silu_blocks_per_sm(int bf16, int vec) {
  using namespace lfdm;
  int least = 0;
  for (int bias = 0; bias < 2; ++bias) {
    cudaError_t err;
    const void* k = kernel_for(bf16, vec, bias, &err);
    if (err != cudaSuccess) return -(int)err;
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, kNormThreads, kNormSmem);
    if (err != cudaSuccess) return -(int)err;
    least = bias == 0 || n < least ? n : least;
  }
  return least;
}

extern "C" int groupnorm_film_silu_smem_limit() { return lfdm::kNormSmem; }

// tables: bit 0 gamma, bit 1 beta, bit 2 scale, bit 3 shift, bit 4 pre_bias is bf16
// (else fp32); pre_bias may be null.
extern "C" int launch_groupnorm_film_silu(
    int bf16, int vec, const void* x, void* y, const void* gamma, const void* beta,
    const void* scale, const void* shift, const void* pre_bias, int tables, long long gamma_sc,
    long long beta_sc, long long scale_sb, long long scale_sc, long long shift_sb,
    long long shift_sc, long long pre_sc, void* partial, int B, long long N, int C, int G,
    int blocks, long long rows, long long hold_rows, int smem, float eps, void* stream) {
  using namespace lfdm;
  const int esz = bf16 ? 2 : 4, VEC = vec ? 16 / esz : 1;
  if (B < 1 || N < 1 || C < 1 || G < 1 || C % G != 0 || C > kMaxCols * kNormThreads ||
      blocks < 1 || rows < 1 || rows > 2147483647LL || (long long)blocks * rows < N ||
      (long long)(blocks - 1) * rows >= N ||
      hold_rows < 0 || smem > kNormSmem ||
      smem < scratch_bytes(C, G, VEC) + (hold_rows < rows ? hold_rows : rows) * C * esz ||
      (scale == nullptr) != (shift == nullptr))
    return cudaErrorInvalidValue;
  if (vec && (C % VEC != 0 || (C / G) % VEC != 0 || !aligned16(x) || !aligned16(y)))
    return cudaErrorInvalidValue;
  cudaError_t err;
  const void* k = kernel_for(bf16, vec, pre_bias != nullptr, &err);
  if (err != cudaSuccess) return err;
  Table tg{gamma, 0, gamma_sc, tables & 1}, tb{beta, 0, beta_sc, (tables >> 1) & 1};
  Table ts{scale, scale_sb, scale_sc, (tables >> 2) & 1}, th{shift, shift_sb, shift_sc, (tables >> 3) & 1};
  Table tp{pre_bias, 0, pre_sc, (tables >> 4) & 1};
  int nb = blocks;
  void* args[] = {&x, &y, &tg, &tb, &ts, &th, &tp, &partial, &N, &C, &G, &nb,
                  &rows, &hold_rows, &eps};
  err = cudaLaunchCooperativeKernel(k, dim3((unsigned)(B * blocks)), dim3(kNormThreads), args,
                                    (size_t)smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
