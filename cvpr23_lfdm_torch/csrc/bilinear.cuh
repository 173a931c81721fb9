// The per-pixel core of the port's bilinear warps (torch grid_sample
// semantics: align_corners=False, zeros padding, grid (x, y) in [-1, 1]).
//
// A warp kernel works out, once per output pixel, where its four corners lie
// inside one [H, W, C] source image and how much each weighs; the threads
// that then stream the pixel's C channels read these instead of redoing the
// coordinate arithmetic per channel. Offsets are 32-bit element offsets
// inside one image (the wrappers refuse an image of more than 2^31 - 1
// elements); the image's base pointer stays 64-bit in the kernel.
//
// Every step rounds as the plain version (ops/warp.py::grid_sample) does on
// the card, one fp32 operation at a time (no FMA contraction): the
// unnormalised coordinate ((g + 1) * size - 1) * 0.5, the weights wy * wx,
// and, in accumulate(), each corner's value * weight added in the order
// (x0, y0), (x0+1, y0), (x0, y0+1), (x0+1, y0+1). A corner outside the image
// weighs zero and points at the clamped pixel, as the plain version gathers.
// A bf16 image is read as it is stored and each value widened to fp32
// exactly; the weights and sums are fp32 as above, and the caller rounds the
// sum to bf16 once, as the plain version's final cast does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace lfdm {

struct Corners {
  int4 off;    // element offsets of the four corners inside one image
  float4 w;    // their weights; 0 for a corner outside the image
};

__device__ __forceinline__ float unnormalize(float g, int size) {
  return __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(g, 1.f), (float)size), 1.f), 0.5f);
}

// The corners of the sample at grid point (gx, gy) in an [H, W, C] image.
__device__ __forceinline__ Corners bilinear_corners(float gx, float gy, int H, int W, int C) {
  const float ix = unnormalize(gx, W), iy = unnormalize(gy, H);
  const float x0 = floorf(ix), y0 = floorf(iy);
  const float wx1 = __fsub_rn(ix, x0), wy1 = __fsub_rn(iy, y0);
  const float wx[2] = {__fsub_rn(1.f, wx1), wx1}, wy[2] = {__fsub_rn(1.f, wy1), wy1};
  int off[4];
  float w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int dx = k & 1, dy = k >> 1;
    const float xx = x0 + dx, yy = y0 + dy;
    const bool inside = xx >= 0.f && xx <= W - 1 && yy >= 0.f && yy <= H - 1;  // false for NaN
    // fmaxf returns the other operand for NaN; float -> int conversion saturates
    const int xi = (int)fminf(fmaxf(xx, 0.f), (float)(W - 1));
    const int yi = (int)fminf(fmaxf(yy, 0.f), (float)(H - 1));
    off[k] = (yi * W + xi) * C;
    w[k] = inside ? __fmul_rn(wy[dy], wx[dx]) : 0.f;
  }
  return {make_int4(off[0], off[1], off[2], off[3]), make_float4(w[0], w[1], w[2], w[3])};
}

// The sample of one channel (or four, for float4) at offset `c` past each
// corner, in fp32.
__device__ __forceinline__ float accumulate(const float* __restrict__ img, const Corners& s, int c) {
  float acc = __fmul_rn(__ldg(img + s.off.x + c), s.w.x);
  acc = __fadd_rn(acc, __fmul_rn(__ldg(img + s.off.y + c), s.w.y));
  acc = __fadd_rn(acc, __fmul_rn(__ldg(img + s.off.z + c), s.w.z));
  return __fadd_rn(acc, __fmul_rn(__ldg(img + s.off.w + c), s.w.w));
}

__device__ __forceinline__ float4 accumulate(const float4* __restrict__ img, const Corners& s,
                                             int c) {
  // offsets are in floats; a float4 image has C % 4 == 0, so they divide by 4
  const float4 v[4] = {__ldg(img + (s.off.x >> 2) + c), __ldg(img + (s.off.y >> 2) + c),
                       __ldg(img + (s.off.z >> 2) + c), __ldg(img + (s.off.w >> 2) + c)};
  const float w[4] = {s.w.x, s.w.y, s.w.z, s.w.w};
  float4 acc = make_float4(__fmul_rn(v[0].x, w[0]), __fmul_rn(v[0].y, w[0]),
                           __fmul_rn(v[0].z, w[0]), __fmul_rn(v[0].w, w[0]));
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    acc.x = __fadd_rn(acc.x, __fmul_rn(v[k].x, w[k]));
    acc.y = __fadd_rn(acc.y, __fmul_rn(v[k].y, w[k]));
    acc.z = __fadd_rn(acc.z, __fmul_rn(v[k].z, w[k]));
    acc.w = __fadd_rn(acc.w, __fmul_rn(v[k].w, w[k]));
  }
  return acc;
}

// Eight bf16 channels moved as one 16-byte unit, and their fp32 sample
struct alignas(16) Bf16x8 {
  uint4 u;
};
struct Float8 {
  float v[8];
};

__device__ __forceinline__ float accumulate(const __nv_bfloat16* __restrict__ img, const Corners& s,
                                            int c) {
  float acc = __fmul_rn(__bfloat162float(__ldg(img + s.off.x + c)), s.w.x);
  acc = __fadd_rn(acc, __fmul_rn(__bfloat162float(__ldg(img + s.off.y + c)), s.w.y));
  acc = __fadd_rn(acc, __fmul_rn(__bfloat162float(__ldg(img + s.off.z + c)), s.w.z));
  return __fadd_rn(acc, __fmul_rn(__bfloat162float(__ldg(img + s.off.w + c)), s.w.w));
}

__device__ __forceinline__ Float8 accumulate(const Bf16x8* __restrict__ img, const Corners& s,
                                             int c) {
  // offsets are in elements; a Bf16x8 image has C % 8 == 0, so they divide by 8
  const int off[4] = {s.off.x >> 3, s.off.y >> 3, s.off.z >> 3, s.off.w >> 3};
  const float w[4] = {s.w.x, s.w.y, s.w.z, s.w.w};
  Float8 acc;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(img + off[k] + c));
    const uint32_t word[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      // bf16 -> fp32 is exact: the 16 bits become the high half
      const uint32_t bits = i % 2 == 0 ? word[i / 2] << 16 : word[i / 2] & 0xffff0000u;
      const float p = __fmul_rn(__uint_as_float(bits), w[k]);
      acc.v[i] = k == 0 ? p : __fadd_rn(acc.v[i], p);
    }
  }
  return acc;
}

}  // namespace lfdm
