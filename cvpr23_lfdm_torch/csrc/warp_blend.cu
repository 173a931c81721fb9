// Bilinear backward warp of B sources at B grids, fused with a blend:
//   warped[b, y, x, c] = sum over the 4 corners of image[b, :, :, c] around
//                        the sample point of grid[b, y, x] = (gx, gy) in [-1, 1]
//   blend 0 (none):      out = warped
//   blend 1 (occlusion): out = warped * occ[b, y, x]
//   blend 2 (previous):  out = warped * occ + prev * (1 - occ)
// with torch grid_sample semantics: align_corners=False, zeros padding.
// Everything is fp32, as the TPU wrappers cast their arguments.
//
// Replaces the Pallas TPU kernels cvpr23_lfdm_tpu/ops/warp_pallas.py::
// warp_onehot (_kernel: the sample as a dense one-hot [HW, HW] matrix
// product, which caps H*W at 1024) and warp_gather (_gather_kernel: the same
// function by lane gather). On Hopper both are this one kernel, with no size
// cap. The plain version is ops/warp.py::warp_blend_plain.
//
// Bound on the H100: bytes (image, grid, occ and prev read once, out written
// once: 0.851 ms at [320, 128, 128, 67]). The four corner reads of an output
// come from L1/L2, since neighbouring outputs share corners.
//
// Design: a block of 256 threads owns a tile of consecutive output pixels of
// one image (32 to 256 of them, about 32 KB of output: tile_pixels). First
// one thread per pixel works out the pixel's corners (bilinear.cuh: 32-bit
// offsets inside the image, weights, zero for a corner outside it) into
// shared memory. Then the block streams the tile's contiguous pixels x C
// outputs with a stride of 256: each thread tracks its
// (pixel, channel) by increments, with one division when it starts, reads
// the pixel's corners from shared memory, and writes coalesced outputs; no
// thread idles at an odd C. Where C % 4 == 0 and image, prev and out are
// 16-byte aligned, the stream is in float4 (16 bytes a thread). The blend is
// the epilogue. Every product and sum rounds as the plain version's
// (no FMA contraction), so the kernel gives its values.

#include <cstdint>

#include "bilinear.cuh"
#include "common.cuh"

namespace lfdm {
namespace {

constexpr int kMaxTile = 256;  // output pixels of a tile, at most

// Pixels of a tile: about 32 KB of output (8192 floats), a power of two in
// [32, kMaxTile]. On the H100, at the three decode scales, tiles of 256
// pixels took 1.25-2x as long (PERF.md, kernel table notes).
int tile_pixels(int C) {
  int t = kMaxTile;
  while (t > 32 && (long long)t * C > 8192) t /= 2;
  return t;
}

__device__ __forceinline__ float blend1(float acc, int mode, float o, float p) {
  if (mode == 1) return __fmul_rn(acc, o);
  return __fadd_rn(__fmul_rn(acc, o), __fmul_rn(p, __fsub_rn(1.f, o)));
}

template <int BLEND>
__device__ __forceinline__ float blend(float acc, float o, const float* prev, long long e) {
  return BLEND == 0 ? acc : blend1(acc, BLEND, o, BLEND == 2 ? prev[e] : 0.f);
}

template <int BLEND>
__device__ __forceinline__ float4 blend(float4 acc, float o, const float4* prev, long long e) {
  if (BLEND == 0) return acc;
  const float4 p = BLEND == 2 ? prev[e] : make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(blend1(acc.x, BLEND, o, p.x), blend1(acc.y, BLEND, o, p.y),
                     blend1(acc.z, BLEND, o, p.z), blend1(acc.w, BLEND, o, p.w));
}

// V = float (any C) or float4 (C % 4 == 0, 16-byte aligned); CV = C in V units.
template <int BLEND, typename V>
__global__ void __launch_bounds__(kThreads)
warp_blend_kernel(const V* __restrict__ image, const float* __restrict__ grid,
                  const float* __restrict__ occ, const V* __restrict__ prev, V* __restrict__ out,
                  long long B, int H, int W, int C, int CV, int tile) {
  __shared__ Corners corners[kMaxTile];
  __shared__ float socc[kMaxTile];
  const int hw = H * W;
  const int p0 = blockIdx.x * tile;  // the tile's first pixel in its image
  const int np = min(tile, hw - p0);
  const int n = np * CV;
  // a thread's (pixel, channel) steps by (dp, dc) for each kThreads outputs
  const int dp = kThreads / CV, dc = kThreads - dp * CV;
  const int pix_start = threadIdx.x / CV, c_start = threadIdx.x - pix_start * CV;
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    const long long first = b * hw + p0;  // the tile's first pixel over all images
    __syncthreads();                      // the previous image's corners are read
    for (int t = threadIdx.x; t < np; t += kThreads) {
      const long long p = first + t;
      corners[t] = bilinear_corners(grid[2 * p], grid[2 * p + 1], H, W, C);
      if (BLEND != 0) socc[t] = occ[p];
    }
    __syncthreads();
    const V* img = image + b * hw * (long long)CV;
    V* dst = out + first * CV;
    const V* pv = prev + first * CV;
    int pix = pix_start, c = c_start;
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const V acc = accumulate(img, corners[pix], c);
      dst[e] = blend<BLEND>(acc, BLEND != 0 ? socc[pix] : 0.f, pv, e);
      pix += dp;
      c += dc;
      if (c >= CV) {
        c -= CV;
        ++pix;
      }
    }
  }
}

template <typename V>
void launch_typed(const void* image, const void* grid, const void* occ, const void* prev,
                  void* out, long long B, int H, int W, int C, int blend, cudaStream_t st) {
  const int CV = C / (int)(sizeof(V) / sizeof(float)), tile = tile_pixels(C);
  const dim3 blocks((unsigned)((H * W + tile - 1) / tile), (unsigned)(B < 65535 ? B : 65535));
  auto im = static_cast<const V*>(image);
  auto g = static_cast<const float*>(grid), oc = static_cast<const float*>(occ);
  auto pv = static_cast<const V*>(prev);
  auto o = static_cast<V*>(out);
  if (blend == 0)
    warp_blend_kernel<0, V><<<blocks, kThreads, 0, st>>>(im, g, oc, pv, o, B, H, W, C, CV, tile);
  else if (blend == 1)
    warp_blend_kernel<1, V><<<blocks, kThreads, 0, st>>>(im, g, oc, pv, o, B, H, W, C, CV, tile);
  else
    warp_blend_kernel<2, V><<<blocks, kThreads, 0, st>>>(im, g, oc, pv, o, B, H, W, C, CV, tile);
}

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
}  // namespace lfdm

extern "C" int launch_warp_blend_f32(const void* image, const void* grid, const void* occ,
                                     const void* prev, void* out, long long B, long long H,
                                     long long W, long long C, int blend, void* stream) {
  using namespace lfdm;
  if (B < 1 || H < 1 || W < 1 || C < 1 || blend < 0 || blend > 2 ||
      (blend >= 1 && occ == nullptr) || (blend == 2 && prev == nullptr))
    return cudaErrorInvalidValue;
  if (H * W * C > 2147483647LL) return cudaErrorInvalidValue;  // 32-bit offsets in an image
  auto st = static_cast<cudaStream_t>(stream);
  if (C % 4 == 0 && aligned16(image) && aligned16(prev) && aligned16(out))
    launch_typed<float4>(image, grid, occ, prev, out, B, (int)H, (int)W, (int)C, blend, st);
  else
    launch_typed<float>(image, grid, occ, prev, out, B, (int)H, (int)W, (int)C, blend, st);
  return cudaGetLastError();
}
