// Empty kernels: the launch floor of one small kernel on the card, the
// yardstick beside the small eigensolvers' and the pose LM's times
// (chip_smoke.py phases 17 (b) and 18, tools/eig_study.py,
// tools/pose_lm_study.py). Not part of the port: nothing calls them on a
// system path. Built like the port's kernels (nvcc, plain C, ctypes):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC \
//        -o libempty.so tools/empty_kernel.cu

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

__global__ void empty_cluster_kernel() {}

// Each block of a cluster writes its rank to its shared memory, and after
// a cluster barrier reads the next rank's through distributed shared
// memory: out[b] = (rank of block b + 1) % the cluster's size
// (tools/capture_probe.py).
__global__ void cluster_probe_kernel(int* out) {
  __shared__ int mine;
  unsigned rank, size;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(size));
  if (threadIdx.x == 0) mine = (int)rank;
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
  if (threadIdx.x == 0) {
    unsigned local = (unsigned)__cvta_generic_to_shared(&mine), remote;
    int v;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(remote) : "r"(local), "r"((rank + 1) % size));
    asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(remote) : "memory");
    out[blockIdx.x] = v;
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// One launch of `kernel` as one cluster of `cluster` blocks of `threads`.
template <typename... A>
int launch_cluster(void (*kernel)(A...), int cluster, int threads, void* stream, A... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster);
  config.blockDim = dim3(threads);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&config, kernel, args...);
}

}  // namespace

extern "C" {

// Allows the cluster kernels a cluster past the portable 8; call once
// before any launch or capture. Returns the CUDA error code.
int empty_init() {
  cudaError_t err = cudaFuncSetAttribute(empty_cluster_kernel,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cluster_probe_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return (int)err;
}

// One launch of `threads` threads in one block on `stream`; returns
// cudaGetLastError().
int empty_launch(int threads, void* stream) {
  empty_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

// One launch of one thread-block cluster of `cluster` blocks of `threads`
// threads on `stream` (a pose LM launch's shape, as pose_lm_attributes
// reports it); returns the CUDA error code.
int empty_cluster_launch(int cluster, int threads, void* stream) {
  return launch_cluster(empty_cluster_kernel, cluster, threads, stream);
}

// One launch of cluster_probe_kernel (one cluster of `cluster` blocks of
// 32 threads) into out (`cluster` ints) on `stream`; returns the CUDA
// error code.
int cluster_probe_launch(int* out, int cluster, void* stream) {
  return launch_cluster(cluster_probe_kernel, cluster, 32, stream, out);
}

}  // extern "C"
