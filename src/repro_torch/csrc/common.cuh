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

// ---- launch configurations ------------------------------------------
//
// A launcher computes the instantiation it launches and its grid, block
// and dynamic shared memory from the shapes, into a LaunchConfig, by one
// helper a kernel family; it launches from that record, and its
// library's `*_launch_attrs` export reports the same record with CUDA's
// attributes of the instantiation (`launch_attributes`), so the launch
// and the report cannot drift apart.
struct LaunchConfig {
  const void* fn;    // the kernel instantiation
  const char* name;  // its name, as the source spells it
  long long grid;    // blocks
  int block;         // threads a block
  long long smem;    // dynamic shared memory a block, in bytes
};

// The card's per-block shared-memory limit with the opt-in above 48 KB,
// or -1 with the CUDA error left for cudaGetLastError.
inline long long smem_optin_limit(int device) {
  int limit = 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return limit;
}

// Opt the instantiation in to its dynamic shared memory above 48 KB;
// cudaErrorInvalidValue when its static and dynamic shared memory
// together exceed the card's per-block limit.
inline cudaError_t prepare_launch(const LaunchConfig& c) {
  if (c.smem <= 48 * 1024) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const long long limit = smem_optin_limit(device);
  if (limit < 0) return cudaGetLastError();
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, c.fn);
  if (err != cudaSuccess) return err;
  if (c.smem + static_cast<long long>(attr.sharedSizeBytes) > limit)
    return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(c.fn,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(c.smem));
}

// The fields `launch_attributes` writes, in order.
enum LaunchAttr {
  kAttrGrid, kAttrBlock, kAttrDynSmem, kAttrStaticSmem, kAttrRegs,
  kAttrLocalBytes, kAttrMaxThreads, kAttrBlocksPerSm, kAttrSmemLimit,
  kAttrAccepted, kAttrCount
};

// `c` with CUDA's attributes of its instantiation into out[kAttrCount]:
// the launch (grid, block, dynamic shared memory), cudaFuncGetAttributes
// (static shared memory, registers a thread, local bytes a thread — the
// spills —, the most threads a block), resident blocks an SM from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor at that block and
// dynamic shared memory (0 when the launch does not fit), the card's
// opt-in limit, and whether `accepted` and `prepare_launch` let the
// launcher launch it. The name goes into `name` (at most `cap` bytes
// with the terminator). Returns the cudaError_t of the queries.
inline int launch_attributes(const LaunchConfig& c, bool accepted,
                             long long* out, char* name, int cap) {
  int i = 0;
  for (; i + 1 < cap && c.name[i]; ++i) name[i] = c.name[i];
  if (cap > 0) name[i] = '\0';
  out[kAttrGrid] = c.grid;
  out[kAttrBlock] = c.block;
  out[kAttrDynSmem] = c.smem;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[kAttrSmemLimit] = smem_optin_limit(device);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, c.fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[kAttrStaticSmem] = static_cast<long long>(attr.sharedSizeBytes);
  out[kAttrRegs] = attr.numRegs;
  out[kAttrLocalBytes] = static_cast<long long>(attr.localSizeBytes);
  out[kAttrMaxThreads] = attr.maxThreadsPerBlock;
  const bool fits = accepted && prepare_launch(c) == cudaSuccess;
  out[kAttrAccepted] = fits ? 1 : 0;
  int blocks = 0;
  if (fits) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, c.fn, c.block, static_cast<size_t>(c.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaGetLastError();  // a refused prepare leaves no error behind
  out[kAttrBlocksPerSm] = blocks;
  return 0;
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
