// An empty kernel: the launch floor of one small kernel on the card, the
// yardstick beside the small eigensolvers' times (chip_smoke.py phase 17
// (b), tools/eig_study.py). Not part of the port: nothing calls it on a
// system path. Built like the port's kernels (nvcc, plain C, ctypes):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC \
//        -o libempty.so tools/empty_kernel.cu

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// One launch of `threads` threads in one block on `stream`; returns
// cudaGetLastError().
int empty_launch(int threads, void* stream) {
  empty_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
