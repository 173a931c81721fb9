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
// B=5, HW=1024, bf16: 0.125 ms at 3.35 TB/s); the backward reads qkv and do
// and writes dqkv (0.73 GB, 0.22 ms). The products are 4 F^2 D (forward) and
// 10 F^2 D (backward) FLOP per (pixel, head): 0.2 / 0.5 MFLOP at F = 40,
// far below the tensor cores' rate per byte.
//
// bf16 (the training step): tensor cores, mma.sync.m16n8k16 with bf16
// operands and fp32 sums (helpers in mma.cuh). A block owns a chunk of
// pixels of one (batch, head), so it copies that head's cos/sin columns and
// its [F, F] bias into shared memory once; each of its warps (up to 8 in
// both kernels: a 10-warp backward block spilled, as ptxas sizes a 320-thread
// block's registers as 12 warps') walks its share of the pixels in order, one
// (pixel, head) unit at a time, with no block barrier in the loop. Per unit
// the warp copies the q, k, v rows (and do) with 16-byte cp.async into
// [FP][32] bf16 tiles, FP = F rounded up to 16 (pad rows zero), rows of 64
// bytes whose 16-byte chunks are XOR-swizzled so ldmatrix is free of bank
// conflicts; each lane then rotates the chunks it copied in place (the
// rotary partner is the neighbouring channel, so in the same 8-value
// vector). Query strips of 16 rows: S = Q K^T over ceil(F / 8) key tiles of
// 8 (ldmatrix fragments); bias added, pad keys -inf and the softmax in the
// C fragments, the row max and row sums over a quad of lanes (two
// shuffles); the exponentials packed to bf16 are the A fragments of P V
// (the C-to-A register path of FlashAttention-2). The backward forms dP =
// dO V^T the same way, packs round(ds) and round(prob) as A fragments for
// dQ = dS K, and, transposed in registers by movmatrix, for dK += dS^T Q and
// dV += P^T dO, whose sums stay in registers over the strips. Outputs
// leave through a 1 KB staging
// tile as 16-byte stores of whole 64-byte rows; the rotary adjoint is
// applied in registers (the pair is one C fragment's two columns). exp is
// __expf and a row is scaled by the reciprocal of its sum: a few fp32 ulps
// from expf and the division, below the bf16 rounding that follows.
//
// Rounding (both types): to T where the Pallas kernels round: rotated qkv;
// exp before the numerator and denominator sums (forward); the denominator,
// prob.dp before its row sum, prob (for dv) and ds (for dq, dk) in the
// backward; dk and dv before the rotary adjoint (dq goes to it unrounded).
// Every operand of every product is one of these bf16 values, so the tensor
// cores change only the order of the fp32 sums. The row max is per head (the
// TPU kernel takes one across heads; the softmax is the same).
//
// fp32 keeps the CUDA-core kernels below (lane = channel, fp32 rows of
// stride 33, FMA loops): mma on fp32 operands would be TF32, which keeps ten
// bits of mantissa and would not hold the fp32 gates (2e-4 against the
// plain version, the fp32 training step's parity and bit-identity).
//
// dbias is deterministic: a backward warp (bf16) or block (fp32) walks its
// pixels of one (batch, head) in order and accumulates ds in its own
// shared-memory [F, F] tile (each entry owned by one lane); a block writes
// partial[b, g, chunk] (bf16: its warps' tiles added in warp order), and a
// second kernel sums the chunks in index order. No atomics.
//
// Layouts: qkv, dqkv [B, F, HW, 3*heads*D]; out, do [B, F, HW, heads*D];
// bias, dbias [B, F, heads*F] fp32; cos/sin [F, 3*heads*D] (type T). The
// bf16 kernels need qkv, do, the tables, out and dqkv 16-byte aligned.

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace lfdm {
namespace {

constexpr int D = 32;        // dim_head
constexpr float kTiny = 1.17549435e-38f;  // float32 tiny, the denominator clamp

// ---------------------------------------------------------------- fp32: CUDA cores

constexpr int LD = D + 1;    // shared-memory row stride; lane <-> channel

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

// ---------------------------------------------------------------- bf16: tensor cores

using bf16 = __nv_bfloat16;

constexpr int kTileRow = 2 * D;   // bytes of a [FP][32] bf16 tile row
constexpr int kTabRow = 208;      // bytes of a table row: q, k, v chunks (192) + 16 of pad
constexpr int kMaxWarps = 8;      // warps of a block
constexpr int kMaxSmem = 232448;  // dynamic shared memory of one block on the H100

__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// Shared memory a block keeps for its (batch, head): cos and sin of the
// head's q, k, v columns as [F][kTabRow] bf16 rows, and its [F, F] bias.
__host__ __device__ constexpr int head_bytes(int F) {
  return (2 * F * kTabRow + F * F * 4 + 127) / 128 * 128;
}

// Block-wide: copy the head's tables (cp.async) and bias into shared
// memory, then a block barrier.
__device__ __forceinline__ void load_head(const bf16* cos_t, const bf16* sin_t, const float* bias,
                                          long long b, int g, int F, int heads, char* tab,
                                          float* sbias) {
  const int hd = heads * D;
  for (int idx = threadIdx.x; idx < 2 * F * 12; idx += blockDim.x) {
    const int t = idx / (12 * F), f = (idx / 12) % F, part = (idx % 12) >> 2, c = idx & 3;
    const bf16* src = (t ? sin_t : cos_t) + (long long)f * 3 * hd + part * hd + g * D + c * 8;
    cp_async_16(smem_u32(tab + (t * F + f) * kTabRow + part * kTileRow + c * 16), src);
  }
  const long long bstride = (long long)heads * F;
  for (int idx = threadIdx.x; idx < F * F; idx += blockDim.x)
    sbias[idx] = bias[(b * F + idx / F) * bstride + (long long)g * F + idx % F];
  cp_async_wait_all();
  __syncthreads();
}

// The chunks of one unit: rows f < F of q, k, v of head g (tiles 0..2) and,
// with NP == 4, of do (tile 3); chunk idx = (f * NP + part) * 4 + c goes to
// lane idx % 32. Zeroes the pad rows F..FP-1 first.
template <int NP>
__device__ __forceinline__ void load_unit(const bf16* qkv, const bf16* dout, long long b,
                                          long long x, int g, int F, int FP, long long HW, int hd,
                                          char* tiles, int lane) {
  const int tb = FP * kTileRow;
  for (int idx = lane; idx < 4 * NP * (FP - F); idx += 32) {
    const int part = idx % NP, r = F + idx / (4 * NP), c = (idx / NP) & 3;
    *reinterpret_cast<uint4*>(tiles + part * tb + swz(r, c)) = make_uint4(0u, 0u, 0u, 0u);
  }
  const uint32_t base = smem_u32(tiles);
  for (int idx = lane; idx < 4 * NP * F; idx += 32) {
    const int f = idx / (4 * NP), part = (idx >> 2) % NP, c = idx & 3;
    const long long row = (b * F + f) * HW + x;
    const bf16* src = part < 3 ? qkv + row * 3 * hd + part * hd + g * D + c * 8
                               : dout + row * hd + g * D + c * 8;
    cp_async_16(base + part * tb + swz(f, c), src);
  }
  cp_async_wait_all();
}

// Rotary in place on the q, k, v chunks this lane copied, in fp32, rounded to
// bf16: (x0, x1) -> (x0 c0 - x1 s0, x1 c1 + x0 s1), each product rounded as
// the plain version's.
template <int NP>
__device__ __forceinline__ void rotate_unit(const char* tab, int F, int FP, char* tiles, int lane) {
  const int tb = FP * kTileRow;
  for (int idx = lane; idx < 4 * NP * F; idx += 32) {
    const int f = idx / (4 * NP), part = (idx >> 2) % NP, c = idx & 3;
    if (part == 3) continue;  // do: no rotary
    const char* t = tab + f * kTabRow + part * kTileRow + c * 16;
    const uint4 cs = *reinterpret_cast<const uint4*>(t);
    const uint4 sn = *reinterpret_cast<const uint4*>(t + F * kTabRow);
    uint4* p = reinterpret_cast<uint4*>(tiles + part * tb + swz(f, c));
    uint4 v = *p;
    uint32_t* w = reinterpret_cast<uint32_t*>(&v);
    const uint32_t* cw = reinterpret_cast<const uint32_t*>(&cs);
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(&sn);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 xv = unpack_bf16(w[e]), cv = unpack_bf16(cw[e]), sv = unpack_bf16(sw[e]);
      w[e] = pack_bf16(__fadd_rn(__fmul_rn(xv.x, cv.x), __fmul_rn(-xv.y, sv.x)),
                       __fadd_rn(__fmul_rn(xv.y, cv.y), __fmul_rn(xv.x, sv.y)));
    }
    *p = v;
  }
  __syncwarp();
}

// acc = rows 16s..16s+15 of tile ta times the first 8 NT rows of tile tb,
// transposed, over the 32 channels: the [16, 8 NT] scores (forward,
// backward) or dP = dO V^T (backward).
template <int NT>
__device__ __forceinline__ void strip_abT(uint32_t ta, uint32_t tb, int s, int lane,
                                          float (&acc)[NT][4]) {
  const int r = 16 * s + (lane & 7) + ((lane >> 3) & 1) * 8;
  uint32_t a0[4], a1[4];
  ldmatrix_x4(a0, ta + swz(r, lane >> 4));
  ldmatrix_x4(a1, ta + swz(r, 2 + (lane >> 4)));
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    uint32_t bk[4];
    ldmatrix_x4(bk, tb + swz(8 * n + (lane & 7), lane >> 3));
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    mma_bf16(acc[n], a0, bk[0], bk[1]);
    mma_bf16(acc[n], a1, bk[2], bk[3]);
  }
}

// o += P tv over the FP rows of tile tv (keys), P given as A fragments per
// 16 keys (the forward's exp, the backward's ds).
template <int KT>
__device__ __forceinline__ void strip_pv(const uint32_t (&pa)[KT][4], uint32_t tv, int lane,
                                         float (&o)[4][4]) {
  const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, tv + swz(16 * j + r, 2 * p + (lane >> 4)));
      mma_bf16(o[2 * p], pa[j], bv[0], bv[1]);
      mma_bf16(o[2 * p + 1], pa[j], bv[2], bv[3]);
    }
}

// The C fragments of each 16 columns, rounded to bf16, as one A fragment;
// an odd NT leaves the last fragment's upper 8 columns zero.
template <int NT>
__device__ __forceinline__ void to_a(const float (&c)[NT][4], uint32_t (&a)[(NT + 1) / 2][4]) {
#pragma unroll
  for (int j = 0; j < (NT + 1) / 2; ++j) {
    a[j][0] = pack_bf16(c[2 * j][0], c[2 * j][1]);
    a[j][1] = pack_bf16(c[2 * j][2], c[2 * j][3]);
    a[j][2] = 2 * j + 1 < NT ? pack_bf16(c[2 * j + 1][0], c[2 * j + 1][1]) : 0u;
    a[j][3] = 2 * j + 1 < NT ? pack_bf16(c[2 * j + 1][2], c[2 * j + 1][3]) : 0u;
  }
}

// acc[a] += C^T tv_s: the strip's [16, 16 KT] product, as the A fragments
// of to_a transposed in registers (movmatrix), times rows 16s..16s+15 of
// tile tv, for the 16 keys of each a (dk from ds and q, dv from prob and do).
template <int KT>
__device__ __forceinline__ void strip_cT_v(const uint32_t (&c)[KT][4], uint32_t tv, int s,
                                           int lane, float (&acc)[KT][4][4]) {
  uint32_t bv[2][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
    ldmatrix_x4_trans(bv[p], tv + swz(16 * s + (lane & 7) + ((lane >> 3) & 1) * 8,
                                      2 * p + (lane >> 4)));
#pragma unroll
  for (int a = 0; a < KT; ++a) {
    const uint32_t at[4] = {movmatrix_trans(c[a][0]), movmatrix_trans(c[a][2]),
                            movmatrix_trans(c[a][1]), movmatrix_trans(c[a][3])};
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      mma_bf16(acc[a][2 * p], at, bv[p][0], bv[p][1]);
      mma_bf16(acc[a][2 * p + 1], at, bv[p][2], bv[p][3]);
    }
  }
}

// Adds the bias (sbias [F, F]) to the strip's scores, sets pad keys to
// -inf, and returns the maxima of the lane's two rows.
template <int NT>
__device__ __forceinline__ void bias_max(float (&acc)[NT][4], const float* sbias, int s,
                                         int F, int lane, float& m0, float& m1) {
  const int i0 = 16 * s + (lane >> 2), i1 = i0 + 8, q2 = 2 * (lane & 3);
  m0 = m1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 8 * n + q2 + e;
      const bool key = j < F;
      acc[n][e] = key ? acc[n][e] + (i0 < F ? sbias[i0 * F + j] : 0.f) : -INFINITY;
      acc[n][2 + e] = key ? acc[n][2 + e] + (i1 < F ? sbias[i1 * F + j] : 0.f) : -INFINITY;
      m0 = fmaxf(m0, acc[n][e]);
      m1 = fmaxf(m1, acc[n][2 + e]);
    }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
}

// Writes rows r0..r0+15 (< F) of one [16, 32] tile of C fragments as bf16
// (each column pair through `pair`) to dst + row * row_stride, staged in
// `stage` so every row leaves as four 16-byte stores.
template <typename Pair>
__device__ __forceinline__ void store_tile(const float (&acc)[4][4], Pair pair, bf16* dst,
                                           long long row_stride, int r0, int F, char* stage,
                                           int lane) {
  const int grp = lane >> 2, q2 = 2 * (lane & 3);
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int n = 0; n < 4; ++n)
      *reinterpret_cast<uint32_t*>(stage + swz(grp + 8 * h, n) + 2 * q2) =
          pair(r0 + grp + 8 * h, 8 * n + q2, acc[n][2 * h], acc[n][2 * h + 1]);
  __syncwarp();
#pragma unroll
  for (int idx = lane; idx < 64; idx += 32) {
    const int r = idx >> 2, c = idx & 3;
    if (r0 + r < F)
      *reinterpret_cast<uint4*>(dst + (long long)(r0 + r) * row_stride + c * 8) =
          *reinterpret_cast<const uint4*>(stage + swz(r, c));
  }
}

// A block's pixels: block (b, g, chunk) owns pixels [chunk * ppb, ...) of
// (batch b, head g), ppb = ceil(HW / chunks); warp w walks its share of them
// in order.
struct Work {
  long long b, x0, x1;
  int g, chunk;
};

__device__ __forceinline__ Work block_work(int heads, int chunks, long long HW, int warp,
                                           int warps) {
  Work w;
  w.chunk = blockIdx.x % chunks;
  w.g = (blockIdx.x / chunks) % heads;
  w.b = blockIdx.x / chunks / heads;
  const long long ppb = (HW + chunks - 1) / chunks, px = (ppb + warps - 1) / warps;
  const long long end = min((long long)(w.chunk + 1) * ppb, HW);
  w.x0 = min(w.chunk * ppb + warp * px, end);
  w.x1 = min(w.x0 + px, end);
  return w;
}

// NT = ceil(F / 8) tiles of 8 keys, KT = ceil(F / 16) strips of 16 query
// rows. (Bounds: two blocks of eight warps per SM.)
template <int NT>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
headpacked_fwd_mma_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                          const bf16* __restrict__ cos_t, const bf16* __restrict__ sin_t,
                          bf16* __restrict__ out, int F, long long HW, int heads, int chunks) {
  constexpr int KT = (NT + 1) / 2, FP = 16 * KT, TB = FP * kTileRow;
  extern __shared__ __align__(128) char tc_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Work wk = block_work(heads, chunks, HW, warp, blockDim.x / 32);
  const long long b = wk.b;
  const int g = wk.g, hd = heads * D;
  char* tab = tc_smem;
  float* sbias = reinterpret_cast<float*>(tab + 2 * F * kTabRow);
  char* tiles = tc_smem + head_bytes(F) + warp * 3 * TB;
  const uint32_t sq = smem_u32(tiles), sk = sq + TB, sv = sk + TB;
  load_head(cos_t, sin_t, bias, b, g, F, heads, tab, sbias);

  const int grp = lane >> 2, q2 = 2 * (lane & 3);
#pragma unroll 1
  for (long long x = wk.x0; x < wk.x1; ++x) {
    __syncwarp();  // the previous pixel's output is stored
    load_unit<3>(qkv, nullptr, b, x, g, F, FP, HW, hd, tiles, lane);
    rotate_unit<3>(tab, F, FP, tiles, lane);
#pragma unroll 1
    for (int s = 0; s < KT; ++s) {
      float sc[NT][4];
      strip_abT<NT>(sq, sk, s, lane, sc);
      float m0, m1;
      bias_max<NT>(sc, sbias, s, F, lane, m0, m1);
      float l0 = 0.f, l1 = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[n][e] = rnd<bf16>(__expf(sc[n][e] - m0));
          sc[n][2 + e] = rnd<bf16>(__expf(sc[n][2 + e] - m1));
          l0 += sc[n][e];
          l1 += sc[n][2 + e];
        }
      const float r0 = 1.f / fmaxf(quad_sum(l0), kTiny), r1 = 1.f / fmaxf(quad_sum(l1), kTiny);
      uint32_t pa[KT][4];
      to_a<NT>(sc, pa);
      float o[4][4] = {};
      strip_pv<KT>(pa, sv, lane, o);
      // the strip's q rows are read: its output takes their place
      __syncwarp();
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        *reinterpret_cast<uint32_t*>(tiles + swz(16 * s + grp, n) + 2 * q2) =
            pack_bf16(o[n][0] * r0, o[n][1] * r0);
        *reinterpret_cast<uint32_t*>(tiles + swz(16 * s + grp + 8, n) + 2 * q2) =
            pack_bf16(o[n][2] * r1, o[n][3] * r1);
      }
    }
    __syncwarp();
    for (int idx = lane; idx < 4 * F; idx += 32) {
      const int f = idx >> 2, c = idx & 3;
      *reinterpret_cast<uint4*>(out + ((b * F + f) * HW + x) * hd + g * D + c * 8) =
          *reinterpret_cast<const uint4*>(tiles + swz(f, c));
    }
  }
}

// Shared memory of one backward warp: q, k, v, do tiles; a [16][32] staging
// tile; its [F, F] fp32 sums of ds.
__host__ __device__ constexpr int bwd_warp_bytes(int KT, int F) {
  return (4 * 16 * KT * kTileRow + 16 * kTileRow + F * F * 4 + 127) / 128 * 128;
}

// NT, KT as in the forward. The dk and dv sums of a pixel stay in registers
// over its strips; at F > 48 (KT = 4) both would not fit beside the strip's
// scores, so the strips run twice per pixel, for dq, dbias and dk, then for
// dv. (Bounds: one block of eight warps per SM.)
template <int NT>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
headpacked_bwd_mma_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                          const bf16* __restrict__ cos_t, const bf16* __restrict__ sin_t,
                          const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
                          float* __restrict__ partial, int F, long long HW, int heads,
                          int chunks) {
  constexpr int KT = (NT + 1) / 2, FP = 16 * KT, TB = FP * kTileRow;
  constexpr int kPasses = KT == 4 ? 2 : 1;
  extern __shared__ __align__(128) char tc_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  const Work wk = block_work(heads, chunks, HW, warp, warps);
  const long long b = wk.b;
  const int g = wk.g, hd = heads * D;
  char* tab = tc_smem;
  float* sbias = reinterpret_cast<float*>(tab + 2 * F * kTabRow);
  char* warp0 = tc_smem + head_bytes(F);
  char* tiles = warp0 + warp * bwd_warp_bytes(KT, F);
  char* stage = tiles + 4 * TB;                                  // [16][32] bf16, swizzled
  float* sdb = reinterpret_cast<float*>(stage + 16 * kTileRow);  // [F][F]
  const uint32_t sq = smem_u32(tiles), sk = sq + TB, sv = sk + TB, sdo = sv + TB;
  for (int e = lane; e < F * F; e += 32) sdb[e] = 0.f;
  load_head(cos_t, sin_t, bias, b, g, F, heads, tab, sbias);

  const long long qstride = 3LL * hd, rs = HW * qstride;
  const int grp = lane >> 2, q2 = 2 * (lane & 3);
  // rotary adjoint of a column pair of part `part`, dx cos - rot(dx) sin,
  // rounded to bf16 first for dk and dv
  auto adjoint = [&](int part, bool round_first) {
    return [=](int row, int col, float a, float c) -> uint32_t {
      if (row >= F) return 0u;
      if (round_first) {
        a = rnd<bf16>(a);
        c = rnd<bf16>(c);
      }
      const char* t = tab + row * kTabRow + part * kTileRow + col * 2;
      const float2 cv = unpack_bf16(*reinterpret_cast<const uint32_t*>(t));
      const float2 sv = unpack_bf16(*reinterpret_cast<const uint32_t*>(t + F * kTabRow));
      return pack_bf16(__fsub_rn(__fmul_rn(a, cv.x), __fmul_rn(-c, sv.x)),
                       __fsub_rn(__fmul_rn(c, cv.y), __fmul_rn(a, sv.y)));
    };
  };

#pragma unroll 1
  for (long long x = wk.x0; x < wk.x1; ++x) {
    __syncwarp();  // the previous pixel's tiles are no longer read
    load_unit<4>(qkv, dout, b, x, g, F, FP, HW, hd, tiles, lane);
    rotate_unit<4>(tab, F, FP, tiles, lane);
    // row f of part `part` of this unit's dqkv: dst + f * rs + part * hd
    bf16* dst = dqkv + ((b * F) * HW + x) * qstride + g * D;
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass) {
      const bool first = pass == 0;  // dq, dbias and dk; dv too in one pass
      float dk[KT][4][4] = {}, dv[kPasses == 1 ? KT : 1][4][4] = {};
#pragma unroll 1
      for (int s = 0; s < KT; ++s) {
        float pr[NT][4], ds[NT][4];
        strip_abT<NT>(sq, sk, s, lane, pr);
        float m0, m1;
        bias_max<NT>(pr, sbias, s, F, lane, m0, m1);
        float l0 = 0.f, l1 = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            pr[n][e] = __expf(pr[n][e] - m0);
            pr[n][2 + e] = __expf(pr[n][2 + e] - m1);
            l0 += rnd<bf16>(pr[n][e]);
            l1 += rnd<bf16>(pr[n][2 + e]);
          }
        const float r0 = 1.f / fmaxf(quad_sum(l0), kTiny);
        const float r1 = 1.f / fmaxf(quad_sum(l1), kTiny);
        strip_abT<NT>(sdo, sv, s, lane, ds);  // dp
        float c0 = 0.f, c1 = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            pr[n][e] *= r0;
            pr[n][2 + e] *= r1;
            c0 += rnd<bf16>(pr[n][e] * ds[n][e]);
            c1 += rnd<bf16>(pr[n][2 + e] * ds[n][2 + e]);
          }
        c0 = quad_sum(c0);
        c1 = quad_sum(c1);
        const int i0 = 16 * s + grp, i1 = i0 + 8;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            ds[n][e] = pr[n][e] * (ds[n][e] - c0);
            ds[n][2 + e] = pr[n][2 + e] * (ds[n][2 + e] - c1);
            const int j = 8 * n + q2 + e;
            if (first && j < F) {
              if (i0 < F) sdb[i0 * F + j] += ds[n][e];
              if (i1 < F) sdb[i1 * F + j] += ds[n][2 + e];
            }
          }
        // round(ds) and round(prob) as A fragments: dq = ds k, dk += ds^T q,
        // dv += prob^T do
        uint32_t da[KT][4], pa[KT][4];
        to_a<NT>(ds, da);
        to_a<NT>(pr, pa);
        if constexpr (kPasses == 1) {
          strip_cT_v<KT>(da, sq, s, lane, dk);
          strip_cT_v<KT>(pa, sdo, s, lane, dv);
        } else {
          strip_cT_v<KT>(first ? da : pa, first ? sq : sdo, s, lane, dk);
        }
        if (first) {
          float dq[4][4] = {};
          strip_pv<KT>(da, sk, lane, dq);
          store_tile(dq, adjoint(0, false), dst, rs, 16 * s, F, stage, lane);
        }
      }
      // dk, or in the second pass dv (in dk's registers)
      const int part = first ? 1 : 2;
#pragma unroll
      for (int a = 0; a < KT; ++a) {
        store_tile(dk[a], adjoint(part, true), dst + part * hd, rs, 16 * a, F, stage, lane);
        if constexpr (kPasses == 1)
          store_tile(dv[a], adjoint(2, true), dst + 2 * hd, rs, 16 * a, F, stage, lane);
      }
    }
  }
  if (partial != nullptr) {
    // the warps' sums, added in warp order
    __syncthreads();
    float* dst = partial + ((b * heads + g) * chunks + wk.chunk) * ((long long)F * F);
    const int wb = bwd_warp_bytes(KT, F) / 4;
    const float* w0 = reinterpret_cast<const float*>(warp0 + 4 * TB + 16 * kTileRow);
    for (int e = threadIdx.x; e < F * F; e += blockDim.x) {
      float acc = 0.f;
      for (int w = 0; w < warps; ++w) acc += w0[w * wb + e];
      dst[e] = acc;
    }
  }
}

bool bad_shape(int B, int F, int HW, int heads, int chunks) {
  return B < 1 || F < 1 || F > 64 || HW < 1 || heads < 1 || chunks < 1 || chunks > HW;
}

// Warps of a block: at most 8, at most one per pixel of the block, as many
// as fit beside the head's tables.
int block_warps(int HW, int chunks, int F, int warp_bytes, int max_warps) {
  const int ppb = (HW + chunks - 1) / chunks;
  return std::max(1, std::min({max_warps, ppb, (kMaxSmem - head_bytes(F)) / warp_bytes}));
}

template <int NT>
cudaError_t launch_fwd_mma(const bf16* qkv, const float* bias, const bf16* cos_t, const bf16* sin_t,
                           bf16* out, int B, int F, int HW, int heads, int chunks,
                           cudaStream_t st) {
  const int warp_bytes = 3 * 16 * ((NT + 1) / 2) * kTileRow;
  const int w = block_warps(HW, chunks, F, warp_bytes, kMaxWarps);
  const int smem = head_bytes(F) + w * warp_bytes;
  auto kernel = headpacked_fwd_mma_kernel<NT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)((long long)B * heads * chunks), w * 32, smem, st>>>(
      qkv, bias, cos_t, sin_t, out, F, HW, heads, chunks);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_bwd_mma(const bf16* qkv, const float* bias, const bf16* cos_t, const bf16* sin_t,
                           const bf16* dout, bf16* dqkv, float* partial, int B, int F, int HW,
                           int heads, int chunks, cudaStream_t st) {
  const int warp_bytes = bwd_warp_bytes((NT + 1) / 2, F);
  const int w = block_warps(HW, chunks, F, warp_bytes, kMaxWarps);
  const int smem = head_bytes(F) + w * warp_bytes;
  auto kernel = headpacked_bwd_mma_kernel<NT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)((long long)B * heads * chunks), w * 32, smem, st>>>(
      qkv, bias, cos_t, sin_t, dout, dqkv, partial, F, HW, heads, chunks);
  return cudaGetLastError();
}

// A bf16 call runs one block per (batch, head, chunk of pixels); the fp32
// forward ignores `chunks`.
template <typename T>
int launch_fwd(const void* qkv, const void* bias, const void* cos_t, const void* sin_t, void* out,
               int B, int F, int HW, int heads, int chunks, void* stream) {
  if (bad_shape(B, F, HW, heads, chunks)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same_v<T, bf16>) {
    auto q = static_cast<const bf16*>(qkv);
    auto bi = static_cast<const float*>(bias);
    auto c = static_cast<const bf16*>(cos_t);
    auto s = static_cast<const bf16*>(sin_t);
    auto o = static_cast<bf16*>(out);
    switch ((F + 7) / 8) {
      case 1: return launch_fwd_mma<1>(q, bi, c, s, o, B, F, HW, heads, chunks, st);
      case 2: return launch_fwd_mma<2>(q, bi, c, s, o, B, F, HW, heads, chunks, st);
      case 3: return launch_fwd_mma<3>(q, bi, c, s, o, B, F, HW, heads, chunks, st);
      case 4: return launch_fwd_mma<4>(q, bi, c, s, o, B, F, HW, heads, chunks, st);
      case 5: return launch_fwd_mma<5>(q, bi, c, s, o, B, F, HW, heads, chunks, st);
      case 6: return launch_fwd_mma<6>(q, bi, c, s, o, B, F, HW, heads, chunks, st);
      case 7: return launch_fwd_mma<7>(q, bi, c, s, o, B, F, HW, heads, chunks, st);
      default: return launch_fwd_mma<8>(q, bi, c, s, o, B, F, HW, heads, chunks, st);
    }
  } else {
    const size_t smem = sizeof(float) * 3 * F * LD;
    auto kernel = headpacked_fwd_kernel<T>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const long long units = (long long)B * HW * heads;
    kernel<<<(unsigned)units, kWarps * 32, smem, st>>>(
        static_cast<const T*>(qkv), static_cast<const float*>(bias), static_cast<const T*>(cos_t),
        static_cast<const T*>(sin_t), static_cast<T*>(out), F, HW, heads);
    return cudaGetLastError();
  }
}

// `partial` holds B*heads*chunks*F*F floats, or is null when dbias is not
// wanted (then `dbias` is not written either). A block (both types) owns
// ceil(HW / chunks) pixels of one (batch, head).
template <typename T>
int launch_bwd(const void* qkv, const void* bias, const void* cos_t, const void* sin_t,
               const void* dout, void* dqkv, void* partial, void* dbias, int B, int F, int HW,
               int heads, int chunks, void* stream) {
  if (bad_shape(B, F, HW, heads, chunks)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if constexpr (std::is_same_v<T, bf16>) {
    auto q = static_cast<const bf16*>(qkv);
    auto bi = static_cast<const float*>(bias);
    auto c = static_cast<const bf16*>(cos_t);
    auto s = static_cast<const bf16*>(sin_t);
    auto d = static_cast<const bf16*>(dout);
    auto dq = static_cast<bf16*>(dqkv);
    auto pt = static_cast<float*>(partial);
    switch ((F + 7) / 8) {
#define LFDM_BWD_CASE(NT) \
  case NT: err = launch_bwd_mma<NT>(q, bi, c, s, d, dq, pt, B, F, HW, heads, chunks, st); break;
      LFDM_BWD_CASE(1) LFDM_BWD_CASE(2) LFDM_BWD_CASE(3) LFDM_BWD_CASE(4)
      LFDM_BWD_CASE(5) LFDM_BWD_CASE(6) LFDM_BWD_CASE(7)
      default: err = launch_bwd_mma<8>(q, bi, c, s, d, dq, pt, B, F, HW, heads, chunks, st);
#undef LFDM_BWD_CASE
    }
  } else {
    const int px = (HW + chunks - 1) / chunks;
    const size_t smem = sizeof(float) * (4 * F * LD + 2 * F * (F + 1) + F * F);
    auto kernel = headpacked_bwd_kernel<T>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const long long jobs = (long long)B * chunks * heads;
    kernel<<<(unsigned)jobs, kWarps * 32, smem, st>>>(
        static_cast<const T*>(qkv), static_cast<const float*>(bias), static_cast<const T*>(cos_t),
        static_cast<const T*>(sin_t), static_cast<const T*>(dout), static_cast<T*>(dqkv),
        static_cast<float*>(partial), F, HW, heads, px, chunks);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || partial == nullptr) return err;
  const long long total = (long long)B * F * heads * F;
  headpacked_dbias_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(dbias), total, F, heads, chunks);
  return cudaGetLastError();
}

}  // namespace
}  // namespace lfdm

#define LFDM_HEADPACKED_EXPORTS(SUFFIX, TYPE)                                                      \
  extern "C" int launch_headpacked_fwd_##SUFFIX(const void* qkv, const void* bias,                \
                                                const void* cos_t, const void* sin_t, void* out,  \
                                                int B, int F, int HW, int heads, int chunks,      \
                                                void* stream) {                                   \
    return lfdm::launch_fwd<TYPE>(qkv, bias, cos_t, sin_t, out, B, F, HW, heads, chunks, stream); \
  }                                                                                                \
  extern "C" int launch_headpacked_bwd_##SUFFIX(                                                   \
      const void* qkv, const void* bias, const void* cos_t, const void* sin_t, const void* dout,  \
      void* dqkv, void* partial, void* dbias, int B, int F, int HW, int heads, int chunks,        \
      void* stream) {                                                                              \
    return lfdm::launch_bwd<TYPE>(qkv, bias, cos_t, sin_t, dout, dqkv, partial, dbias, B, F, HW,  \
                                  heads, chunks, stream);                                          \
  }

LFDM_HEADPACKED_EXPORTS(f32, float)
LFDM_HEADPACKED_EXPORTS(bf16, __nv_bfloat16)
