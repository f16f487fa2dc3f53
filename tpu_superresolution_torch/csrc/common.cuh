// Helpers shared by the hand-written Hopper kernels of the port.
//
// Every kernel here is compiled with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -c
// one source per nvcc process, and the objects are linked into one shared
// library with a plain C interface (kernels/_lib.py).
// Each extern "C" entry point launches on the stream it is given and
// returns cudaGetLastError() as an int; the Python wrapper raises when it
// is not 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

static inline bool aligned_to(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes)) == 0;
}
