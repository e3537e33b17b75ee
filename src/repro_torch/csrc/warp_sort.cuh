// The one warp's bitonic sort of 64-bit keys, shared by the serving tick
// (tick_kernel.cuh) and the single-update delta statistics
// (delta_stats.cu).
//
// A key is (node id << 32 | endpoint index), so ascending order is by
// node id and, within one id, by endpoint index: the stable order of the
// 2k endpoints. Up to kRegKeys keys sit in registers, KPL a lane, and
// sort with compare-exchanges inside a lane and 64-bit `__shfl_xor_sync`
// across lanes; above that the warp sorts its own slice of shared memory,
// one `__syncwarp` a stage. Either sort takes a power-of-two length
// (`sort_length`), padded with kNoKey, which sorts last.
#pragma once

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNoKey = ~0ull;   // sorts after every real key
constexpr int kRegKeys = 256;                  // keys sorted in registers

// The bitonic length for 2k keys: a power of two, at least 2 a lane.
__host__ __device__ __forceinline__ int sort_length(int k) {
  int n = 64;
  while (n < 2 * k) n <<= 1;
  return n;
}

// Keys a lane holds in registers for a sort of `sort_n` keys, or 0 for
// the shared-memory sort.
__host__ __device__ __forceinline__ int lane_keys(int sort_n) {
  return sort_n <= kRegKeys ? sort_n / 32 : 0;
}

__device__ __forceinline__ unsigned long long umin64(unsigned long long a,
                                                     unsigned long long b) {
  return a < b ? a : b;
}

__device__ __forceinline__ unsigned long long umax64(unsigned long long a,
                                                     unsigned long long b) {
  return a < b ? b : a;
}

// Bitonic sort of 32·KPL keys held KPL a lane, lane L holding positions
// L·KPL .. L·KPL + KPL − 1: strides below KPL compare inside a lane,
// the others across lanes with one 64-bit shuffle a key.
template <int KPL>
__device__ __forceinline__ void warp_sort(unsigned long long (&key)[KPL],
                                          int lane) {
  constexpr int N = 32 * KPL;
#pragma unroll
  for (int size = 2; size <= N; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= KPL) {
        const int lx = stride / KPL;
        const bool asc = ((lane * KPL) & size) == 0;
        const bool keep_min = asc == ((lane & lx) == 0);
#pragma unroll
        for (int r = 0; r < KPL; ++r) {
          const unsigned long long o = __shfl_xor_sync(kFull, key[r], lx);
          key[r] = keep_min ? umin64(key[r], o) : umax64(key[r], o);
        }
      } else {
#pragma unroll
        for (int r = 0; r < KPL; ++r) {
          if (r & stride) continue;
          const bool asc = ((lane * KPL + r) & size) == 0;
          const unsigned long long a = key[r], b = key[r | stride];
          if ((a > b) == asc) {
            key[r] = b;
            key[r | stride] = a;
          }
        }
      }
    }
  }
}

// Bitonic sort of the warp's n keys in shared memory (n a power of two),
// one `__syncwarp` a stage.
__device__ __forceinline__ void warp_sort_shared(unsigned long long* key,
                                                 int n, int lane) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < (n >> 1); t += 32) {
        const int lo = 2 * stride * (t / stride) + t % stride;
        const int hi = lo + stride;
        const unsigned long long a = key[lo], b = key[hi];
        if ((a > b) == ((lo & size) == 0)) {
          key[lo] = b;
          key[hi] = a;
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace
