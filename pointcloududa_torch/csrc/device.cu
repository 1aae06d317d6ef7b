// What the card gives any kernel, asked through two kernels that do nothing.
//
//  * The launch floor: what one launch costs when it computes nothing. The
//    Chamfer kernels' bounds (bytes and operations over the whole card) lie
//    far below it, so the smoke test prints it beside them.
//  * Clusters at once: how many thread-block clusters of a given size the
//    card runs at the same time when every block takes a whole SM (1024
//    threads and all the shared memory a block may have). The kernels that
//    share an item among a cluster (fps.cu, the one-launch forward of
//    chamfer.cu) size their cluster from this one number, so that a batch
//    never waits for a second wave. The probe kernel is never launched.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

__global__ void whole_sm_kernel() {}

}  // namespace

extern "C" {

int pcuda_empty_launch(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}

// Outside any stream capture: clusters of `cluster` blocks, one block to an
// SM, that the current device runs at once.
int pcuda_max_active_clusters(int cluster, int* clusters) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(whole_sm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(cluster);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(cluster));
  config.blockDim = dim3(1024);
  config.dynamicSmemBytes = static_cast<size_t>(optin);
  config.attrs = &attr;
  config.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, whole_sm_kernel, &config));
}

}  // extern "C"
