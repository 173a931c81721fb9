// Warp-level tensor-core helpers for the port's kernels (sm_80 and later
// instructions, built here for sm_90a): bf16 mma.sync with fp32 sums,
// ldmatrix fragment loads from shared memory, 16-byte cp.async copies,
// loads from a cluster's distributed shared memory, the swizzled layouts of
// bf16 tiles that keep ldmatrix free of bank conflicts ([rows][32]: swz;
// wider rows: swzw), and the in-place LayerNorm of such a tile that the two
// fused layers share.
//
// Fragment layout of mma.sync.m16n8k16 (lane = 4 * grp + quad):
//   A (16x16, row-major): a[0] = (row grp,   k 2q..2q+1), a[1] = (row grp+8, k 2q..),
//                         a[2] = (row grp,   k 8+2q..),   a[3] = (row grp+8, k 8+2q..)
//   B (16x8, "col"):      b[0] = (k 2q..2q+1, col grp),   b[1] = (k 8+2q.., col grp)
//   C (16x8, fp32):       c[0..1] = (row grp, cols 2q, 2q+1), c[2..3] = (row grp+8, same cols)
// Two C tiles side by side (16 columns) are, packed to bf16, the A fragment
// of the next product over those 16 columns: {c0[0..1], c0[2..3], c1[0..1], c1[2..3]}.
//
// The strip helpers at the end (strip_abT, bias_max, to_a, strip_pv) are the
// attention steps of one warp on one (pixel, head) unit of F <= 64 frames and
// d = 32 channels: scores, bias and row max, the probabilities as A
// fragments, and their product with V. packed_attention.cu uses them;
// headpacked_attention.cu keeps its own copies of the same code.
#pragma once

#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>

namespace lfdm {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// (lo, hi) rounded to bf16 (nearest even), lo in the low half: one operand
// register of mma.sync
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four 8x8 b16 matrices; lanes 8m..8m+7 give the row addresses of matrix m,
// r[m] receives its fragment (lane: row grp, columns 2q, 2q+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same with each matrix transposed: lane gets (M[2q][grp], M[2q+1][grp]).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += A * B, m16n8k16, bf16 operands, fp32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 8x8 b16 matrix whose fragment (lane: row grp, columns 2q, 2q+1) this
// lane holds, transposed across the warp: turns two C tiles of a product
// into an A fragment of the product with the transpose.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

// 16 bytes global -> shared, cached in L2 only; completes at cp_async_wait_all
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

// 4 bytes global -> shared (cached in L1 and L2); completes at cp_async_wait_all
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// waits until at most N committed groups are still in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The shared-memory address `addr` of this block as seen in block `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// loads from the distributed shared memory of a cluster (addresses from map_rank)
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ float ld_cluster_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint4 ld_cluster_u4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// the two bf16 halves of an operand register, low half first
__device__ __forceinline__ float2 bf2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Byte offset of 16-byte chunk c (channels 8c..8c+7) of row r in a [rows][32]
// bf16 tile of 64-byte rows. The chunk index is XORed with (r / 2) % 4, so
// the eight rows one ldmatrix matrix reads fall on eight different groups of
// four banks.
__device__ __forceinline__ int swz(int r, int c) { return r * 64 + ((c ^ ((r >> 1) & 3)) << 4); }

// Byte offset of 16-byte chunk c of row r in a bf16 tile of `rb`-byte rows:
// the chunk index is XORed with r & m, m + 1 the largest power of two up to 8
// that divides the rb / 16 chunks of a row (swz_mask), so the XOR stays in
// the row. With rows of a multiple of 128 bytes (m = 7) the eight rows one
// ldmatrix matrix reads fall on eight different groups of banks; narrower
// rows share some banks.
__device__ __forceinline__ int swzw(int r, int c, int rb, int m) {
  return r * rb + ((c ^ (r & m)) << 4);
}

__device__ __forceinline__ int swz_mask(int chunks) { return min(8, chunks & -chunks) - 1; }

// LayerNorm in place of `rows` rows of a bf16 tile swizzled by swzw (C
// channels, 2C-byte rows, mask m); row r of the norm is tile row row_of(r).
// lpr lanes per row (a power of two, for the XOR sums), each on 16-byte
// chunks of 8 channels; fp32 statistics with var = E[x^2] - mean^2, gamma
// (fp32, shared memory), the result rounded to bf16. Every warp of the block
// takes rows; no barrier.
template <typename RowOf>
__device__ __forceinline__ void layer_norm_tile(char* sx, const float* sgamma, int rows, int C,
                                                int m, float eps, RowOf row_of) {
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int RB = 2 * C;
  int lpr = 32;
  while (lpr > C / 8) lpr >>= 1;
  const int sub = lane / lpr, sl = lane % lpr;
  for (int r0 = warp * (32 / lpr); r0 < rows; r0 += warps * (32 / lpr)) {
    const int r = r0 + sub;
    const bool ok = r < rows;
    const int row = ok ? row_of(r) : 0;
    float sum = 0.f, ss = 0.f;
    for (int c = sl; c < C / 8; c += lpr) {
      if (!ok) break;
      const uint4 v = *reinterpret_cast<const uint4*>(sx + swzw(row, c, RB, m));
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f2 = bf2(w[e]);
        sum += f2.x + f2.y;
        ss += f2.x * f2.x + f2.y * f2.y;
      }
    }
    for (int o = lpr / 2; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    const float mean = sum / C;
    const float rstd = rsqrtf(ss / C - mean * mean + eps);
    for (int c = sl; c < C / 8; c += lpr) {
      if (!ok) break;
      uint4* at = reinterpret_cast<uint4*>(sx + swzw(row, c, RB, m));
      const uint4 v = *at;
      uint32_t w[4] = {v.x, v.y, v.z, v.w};
      const float4 ga = *reinterpret_cast<const float4*>(sgamma + 8 * c);
      const float4 gb = *reinterpret_cast<const float4*>(sgamma + 8 * c + 4);
      const float gm[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f2 = bf2(w[e]);
        w[e] = pack_bf16((f2.x - mean) * rstd * gm[2 * e], (f2.y - mean) * rstd * gm[2 * e + 1]);
      }
      *at = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// max and sum over the four lanes of a quad (the lanes that hold one C-fragment row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// acc = rows 16s..16s+15 of tile ta times the first 8 NT rows of tile tb,
// transposed, over the 32 channels (swizzled [rows][32] bf16 tiles at
// shared-memory addresses ta, tb): a [16, 8 NT] strip of scores.
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

// Adds the bias (sbias, [F, F] fp32 in shared memory) to the strip's scores,
// sets pad keys (j >= F) to -inf, and returns the maxima of the lane's two
// rows (pad query rows take a zero bias).
template <int NT>
__device__ __forceinline__ void bias_max(float (&acc)[NT][4], const float* sbias, int s, int F,
                                         int lane, float& m0, float& m1) {
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

// o += P tv over the 16 KT rows of tile tv (keys), P given as A fragments
// per 16 keys; o holds the strip's [16, 32] result as four C tiles.
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

}  // namespace lfdm
