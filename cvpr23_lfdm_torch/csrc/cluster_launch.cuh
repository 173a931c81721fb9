// Host side of a thread-block-cluster launch, shared by the fused layers'
// bf16 kernels: cudaLaunchKernelEx with the cluster dimension as a launch
// attribute, after the dynamic shared memory is allowed. Whether the card can
// place such a cluster (cudaOccupancyMaxActiveClusters) is asked once per
// configuration (kernel, threads, shared memory, cluster shape), not on every
// call; a cluster that cannot be placed returns cudaErrorLaunchOutOfResources.
#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <set>
#include <tuple>

namespace lfdm {

inline bool cluster_placed(const void* kernel, int threads, int smem, dim3 cluster, bool add) {
  static std::mutex mu;
  static std::set<std::tuple<const void*, int, int, unsigned, unsigned, unsigned>> placed;
  const auto key = std::make_tuple(kernel, threads, smem, cluster.x, cluster.y, cluster.z);
  std::lock_guard<std::mutex> lock(mu);
  if (add) placed.insert(key);
  return placed.count(key) > 0;
}

template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid, dim3 cluster, int threads,
                           int smem, cudaStream_t st, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster.x;
  attr[0].val.clusterDim.y = cluster.y;
  attr[0].val.clusterDim.z = cluster.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const void* key = reinterpret_cast<const void*>(kernel);
  if (!cluster_placed(key, threads, smem, cluster, false)) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorLaunchOutOfResources;  // the cluster cannot be placed
    cluster_placed(key, threads, smem, cluster, true);
  }
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace lfdm
