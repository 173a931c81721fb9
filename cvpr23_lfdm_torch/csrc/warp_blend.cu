// Bilinear backward warps on one core: out[i, y, x, c] = sum over the 4
// corners of image[i / frames, :, :, c] around the sample point of
// grid[i, y, x] = (gx, gy) in [-1, 1], with torch grid_sample semantics
// (align_corners=False, zeros padding), for output images i < images:
//   - the fused warp + blend (frames = 1, fp32, everything cast to fp32 as
//     the TPU wrappers cast their arguments):
//       blend 0 (none):      out = warped
//       blend 1 (occlusion): out = warped * occ[i, y, x]
//       blend 2 (previous):  out = warped * occ + prev * (1 - occ)
//     Replaces the Pallas TPU kernels cvpr23_lfdm_tpu/ops/warp_pallas.py::
//     warp_onehot (_kernel: the sample as a dense one-hot [HW, HW] matrix
//     product, which caps H*W at 1024) and warp_gather (_gather_kernel: the
//     same function by lane gather): on Hopper both are this one kernel, with
//     no size cap. Plain version: ops/warp.py::warp_blend_plain.
//   - the decode warp of one source per video at F per-frame grids (frames =
//     F, blend none, fp32 or bf16 in and out: fp32 weights and sums, the sum
//     rounded once to the source's dtype), over the whole frame or over a
//     band of Ho of the source's Hs rows (a rank's band of a `space` mesh:
//     its grid still addresses the whole source). Replaces warp_pallas.py::
//     warp_video_tiled (_tiled_kernel, window geometry _tiled_geometry) and
//     its fit-checked dispatcher warp_video: no windows, tiles or fit check,
//     exact for every flow. Plain version: ops/warp.py::warp_video_plain.
//
// Bound on the H100: bytes (image, grid, occ and prev read once, out written
// once: 0.851 ms at [320, 128, 128, 67] fp32; the decode warp's output
// dominates its bytes, and the shared source stays in L2). The four corner
// reads of an output come from L1/L2, since neighbouring outputs share
// corners.
//
// Design: the source image is [Hs, W, C] and an output image [Ho, W, C] (Ho
// == Hs but in the decode warp's band mode): the corners are found in the
// source's extent and the tiles cut the output's pixels. A block of 256
// threads owns a tile of consecutive output pixels of one image (32 to 256 of them, about 32 KB of output: tile_pixels).
// First one thread per pixel works out the pixel's corners (bilinear.cuh:
// 32-bit offsets inside the source image, weights, zero for a corner outside
// it) into shared memory. Then the block streams the tile's contiguous
// pixels x C outputs with a stride of 256 units: each thread tracks its
// (pixel, channel) by increments, with one division when it starts, reads
// the pixel's corners from shared memory, and writes coalesced outputs; no
// thread idles at an odd C. A unit is 16 bytes (float4, or eight bf16
// channels) where C fills whole units and image, prev and out are 16-byte
// aligned, else one element. The blend is the epilogue. Every product and
// sum rounds as the plain version's (no FMA contraction), so the kernel
// gives its values bit for bit.

#include <cstdint>
#include <type_traits>

#include "bilinear.cuh"
#include "common.cuh"
#include "mma.cuh"

namespace lfdm {
namespace {

constexpr int kMaxTile = 256;  // output pixels of a tile, at most

// Pixels of a tile: about 32 KB of output (8192 fp32 or 16384 bf16 elements),
// a power of two in [32, kMaxTile]. On the H100, at the three decode scales,
// fp32 tiles of 256 pixels took longer, and bf16 tiles of 8 KB or 16 KB took
// longer than 32 KB ones (PERF.md §6, the warp+blend and decode-warp findings).
int tile_pixels(int C, int esz) {
  int t = kMaxTile;
  while (t > 32 && (long long)t * C * esz > 32768) t /= 2;
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

// elements of one unit V
template <typename V> struct Elems { static constexpr int value = 1; };
template <> struct Elems<float4> { static constexpr int value = 4; };
template <> struct Elems<Bf16x8> { static constexpr int value = 8; };

__device__ __forceinline__ void put(float* d, float a) { *d = a; }
__device__ __forceinline__ void put(float4* d, float4 a) { *d = a; }
__device__ __forceinline__ void put(__nv_bfloat16* d, float a) { *d = __float2bfloat16(a); }
__device__ __forceinline__ void put(Bf16x8* d, const Float8& a) {
  const float* v = a.v;
  d->u = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                    pack_bf16(v[6], v[7]));
}

// V = the unit a thread streams: float, float4 (C % 4 == 0, 16-byte aligned),
// __nv_bfloat16, or Bf16x8 (C % 8 == 0, aligned); CV = C in V units. A blend
// (BLEND > 0) takes fp32 units.
template <int BLEND, typename V>
__global__ void __launch_bounds__(kThreads)
warp_blend_kernel(const V* __restrict__ image, const float* __restrict__ grid,
                  const float* __restrict__ occ, const V* __restrict__ prev, V* __restrict__ out,
                  long long images, int frames, int Hs, int Ho, int W, int C, int CV, int tile) {
  __shared__ Corners corners[kMaxTile];
  __shared__ float socc[kMaxTile];
  const int hw = Ho * W;  // output pixels of an image
  const long long src_image = (long long)Hs * W * CV;  // V units of a source image
  const int p0 = blockIdx.x * tile;  // the tile's first pixel in its image
  const int np = min(tile, hw - p0);
  const int n = np * CV;
  // a thread's (pixel, channel) steps by (dp, dc) for each kThreads outputs
  const int dp = kThreads / CV, dc = kThreads - dp * CV;
  const int pix_start = threadIdx.x / CV, c_start = threadIdx.x - pix_start * CV;
  for (long long i = blockIdx.y; i < images; i += gridDim.y) {
    const long long first = i * hw + p0;  // the tile's first pixel over all output images
    __syncthreads();                      // the previous image's corners are read
    for (int t = threadIdx.x; t < np; t += kThreads) {
      const long long p = first + t;
      corners[t] = bilinear_corners(grid[2 * p], grid[2 * p + 1], Hs, W, C);
      if (BLEND != 0) socc[t] = occ[p];
    }
    __syncthreads();
    const V* img = image + (i / frames) * src_image;
    V* dst = out + first * CV;
    const V* pv = prev + first * CV;
    int pix = pix_start, c = c_start;
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const auto acc = accumulate(img, corners[pix], c);
      if constexpr (BLEND == 0) put(dst + e, acc);
      else dst[e] = blend<BLEND>(acc, socc[pix], pv, e);
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
                  void* out, long long images, int frames, int Hs, int Ho, int W, int C, int blend,
                  cudaStream_t st) {
  const int CV = C / Elems<V>::value, tile = tile_pixels(C, sizeof(V) / Elems<V>::value);
  const dim3 blocks((unsigned)((Ho * W + tile - 1) / tile),
                    (unsigned)(images < 65535 ? images : 65535));
  auto im = static_cast<const V*>(image);
  auto g = static_cast<const float*>(grid), oc = static_cast<const float*>(occ);
  auto pv = static_cast<const V*>(prev);
  auto o = static_cast<V*>(out);
  if constexpr (std::is_same<V, float>::value || std::is_same<V, float4>::value) {
    if (blend == 1) {
      warp_blend_kernel<1, V><<<blocks, kThreads, 0, st>>>(im, g, oc, pv, o, images, frames, Hs, Ho,
                                                           W, C, CV, tile);
      return;
    }
    if (blend == 2) {
      warp_blend_kernel<2, V><<<blocks, kThreads, 0, st>>>(im, g, oc, pv, o, images, frames, Hs, Ho,
                                                           W, C, CV, tile);
      return;
    }
  }
  warp_blend_kernel<0, V><<<blocks, kThreads, 0, st>>>(im, g, oc, pv, o, images, frames, Hs, Ho, W,
                                                       C, CV, tile);
}

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// One image of H*W*C elements at most 2^31 - 1: 32-bit offsets inside it.
bool sizes_ok(long long images, long long H, long long W, long long C) {
  return images >= 1 && H >= 1 && W >= 1 && C >= 1 && H * W * C <= 2147483647LL;
}

}  // namespace
}  // namespace lfdm

extern "C" int launch_warp_blend_f32(const void* image, const void* grid, const void* occ,
                                     const void* prev, void* out, long long B, long long H,
                                     long long W, long long C, int blend, void* stream) {
  using namespace lfdm;
  if (!sizes_ok(B, H, W, C) || blend < 0 || blend > 2 || (blend >= 1 && occ == nullptr) ||
      (blend == 2 && prev == nullptr))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int h = (int)H, w = (int)W, c = (int)C;  // one image: output rows = source rows
  if (C % 4 == 0 && aligned16(image) && aligned16(prev) && aligned16(out))
    launch_typed<float4>(image, grid, occ, prev, out, B, 1, h, h, w, c, blend, st);
  else
    launch_typed<float>(image, grid, occ, prev, out, B, 1, h, h, w, c, blend, st);
  return cudaGetLastError();
}

// The decode warp: src [B, Hs, W, C] at grid [B, F, Ho, W, 2] -> out [B, F, Ho, W, C]
// in the source's dtype (bf16 != 0: bf16, else fp32); Ho <= Hs, and the grid
// addresses the whole source.
extern "C" int launch_warp_video(int bf16, const void* src, const void* grid, void* out,
                                 long long B, long long F, long long Hs, long long Ho, long long W,
                                 long long C, void* stream) {
  using namespace lfdm;
  if (!sizes_ok(B * F, Hs, W, C) || Ho < 1 || Ho > Hs) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const bool aligned = aligned16(src) && aligned16(out);
  const int hs = (int)Hs, ho = (int)Ho, w = (int)W, c = (int)C;
  if (bf16 && C % 8 == 0 && aligned)
    launch_typed<Bf16x8>(src, grid, nullptr, nullptr, out, B * F, (int)F, hs, ho, w, c, 0, st);
  else if (bf16)
    launch_typed<__nv_bfloat16>(src, grid, nullptr, nullptr, out, B * F, (int)F, hs, ho, w, c, 0, st);
  else if (C % 4 == 0 && aligned)
    launch_typed<float4>(src, grid, nullptr, nullptr, out, B * F, (int)F, hs, ho, w, c, 0, st);
  else
    launch_typed<float>(src, grid, nullptr, nullptr, out, B * F, (int)F, hs, ho, w, c, 0, st);
  return cudaGetLastError();
}
