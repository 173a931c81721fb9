// Warp-level tensor-core helpers for the port's kernels (sm_80 and later
// instructions, built here for sm_90a): bf16 mma.sync with fp32 sums,
// ldmatrix fragment loads from shared memory, 16-byte cp.async copies, and
// the swizzled layout of a [rows][32] bf16 tile that keeps ldmatrix free of
// bank conflicts.
//
// Fragment layout of mma.sync.m16n8k16 (lane = 4 * grp + quad):
//   A (16x16, row-major): a[0] = (row grp,   k 2q..2q+1), a[1] = (row grp+8, k 2q..),
//                         a[2] = (row grp,   k 8+2q..),   a[3] = (row grp+8, k 8+2q..)
//   B (16x8, "col"):      b[0] = (k 2q..2q+1, col grp),   b[1] = (k 8+2q.., col grp)
//   C (16x8, fp32):       c[0..1] = (row grp, cols 2q, 2q+1), c[2..3] = (row grp+8, same cols)
// Two C tiles side by side (16 columns) are, packed to bf16, the A fragment
// of the next product over those 16 columns: {c0[0..1], c0[2..3], c1[0..1], c1[2..3]}.
#pragma once

#include <cuda_bf16.h>

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Byte offset of 16-byte chunk c (channels 8c..8c+7) of row r in a [rows][32]
// bf16 tile of 64-byte rows. The chunk index is XORed with (r / 2) % 4, so
// the eight rows one ldmatrix matrix reads fall on eight different groups of
// four banks.
__device__ __forceinline__ int swz(int r, int c) { return r * 64 + ((c ^ ((r >> 1) & 3)) << 4); }

}  // namespace lfdm
