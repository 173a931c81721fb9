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
// once). One thread per output element, channels fastest, so neighbouring
// threads read neighbouring channels of one corner and write neighbouring
// outputs; the corners are summed in the TPU kernels' order ((x0, y0),
// (x0+1, y0), (x0, y0+1), (x0+1, y0+1)), and the blend is the epilogue.

#include "common.cuh"

namespace lfdm {
namespace {

template <int BLEND>
__global__ void __launch_bounds__(kThreads)
warp_blend_kernel(const float* __restrict__ image, const float* __restrict__ grid,
                  const float* __restrict__ occ, const float* __restrict__ prev,
                  float* __restrict__ out, long long total, int H, int W, int C) {
  const long long hw = (long long)H * W;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(idx % C);
    const long long p = idx / C;  // (b * H + y) * W + x
    const long long b = p / hw;
    const float ix = ((grid[2 * p] + 1.f) * W - 1.f) * 0.5f;
    const float iy = ((grid[2 * p + 1] + 1.f) * H - 1.f) * 0.5f;
    const float x0 = floorf(ix), y0 = floorf(iy);
    const float wx1 = ix - x0, wy1 = iy - y0;
    const float wx[2] = {1.f - wx1, wx1}, wy[2] = {1.f - wy1, wy1};
    const float* s = image + b * hw * C + c;
    float acc = 0.f;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float yy = y0 + dy;
      if (!(yy >= 0.f && yy <= H - 1)) continue;  // also skips NaN
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const float xx = x0 + dx;
        if (!(xx >= 0.f && xx <= W - 1)) continue;
        acc += (wx[dx] * wy[dy]) * s[((long long)yy * W + (long long)xx) * C];
      }
    }
    if (BLEND == 1) acc = acc * occ[p];
    if (BLEND == 2) {
      const float o = occ[p];
      acc = acc * o + prev[idx] * (1.f - o);
    }
    out[idx] = acc;
  }
}

}  // namespace
}  // namespace lfdm

extern "C" int launch_warp_blend_f32(const void* image, const void* grid, const void* occ,
                                     const void* prev, void* out, long long B, long long H,
                                     long long W, long long C, int blend, void* stream) {
  using namespace lfdm;
  if (B < 1 || H < 1 || W < 1 || C < 1 || blend < 0 || blend > 2 ||
      (blend >= 1 && occ == nullptr) || (blend == 2 && prev == nullptr))
    return cudaErrorInvalidValue;
  const long long total = B * H * W * C;
  const long long blocks = (total + kThreads - 1) / kThreads;
  const unsigned grid_x = (unsigned)(blocks < (1LL << 20) ? blocks : (1LL << 20));
  auto st = static_cast<cudaStream_t>(stream);
  auto im = static_cast<const float*>(image), g = static_cast<const float*>(grid);
  auto oc = static_cast<const float*>(occ), pv = static_cast<const float*>(prev);
  auto o = static_cast<float*>(out);
  if (blend == 0)
    warp_blend_kernel<0><<<grid_x, kThreads, 0, st>>>(im, g, oc, pv, o, total, (int)H, (int)W, (int)C);
  else if (blend == 1)
    warp_blend_kernel<1><<<grid_x, kThreads, 0, st>>>(im, g, oc, pv, o, total, (int)H, (int)W, (int)C);
  else
    warp_blend_kernel<2><<<grid_x, kThreads, 0, st>>>(im, g, oc, pv, o, total, (int)H, (int)W, (int)C);
  return cudaGetLastError();
}
