// Shared device helpers of the repro_torch kernels.
//
// Block reductions here are deterministic: a fixed shuffle tree inside
// each warp, then every thread sums the per-warp partials in warp
// order. The same inputs give the same bits on every run.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

// cudaGetErrorString for the ctypes wrappers' error messages.
REPRO_EXPORT const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace {
__global__ void repro_empty_kernel() {}
}  // namespace

// One launch of an empty kernel on `stream`, through the same ctypes
// path as a library's kernels: the floor of a one-launch op. Returns the
// launch's cudaError_t.
REPRO_EXPORT int repro_empty_launch(void* stream) {
  repro_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum of `v` over the block, returned in every thread. `scratch` holds
// at least 32 floats of shared memory. The leading barrier lets the
// caller chain reductions on one scratch buffer.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < n_warps; ++w) t += scratch[w];
  return t;
}

// Max of `v` over the block, returned in every thread (see block_sum).
__device__ __forceinline__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float t = -INFINITY;
  for (int w = 0; w < n_warps; ++w) t = fmaxf(t, scratch[w]);
  return t;
}
