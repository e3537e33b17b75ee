// Fused Lemma-1 statistics of a dense W in one pass over device memory.
//
// Replaces the TPU kernel `vnge_q_stats_pallas`
// (src/repro/kernels/vnge_q/kernel.py:56, body `_kernel` :28). For an
// (n, n) float32 W with row sums s it returns
//
//   [S = Σ_i s_i, Σ_i s_i², Σ_E w² = ½ Σ_ij W_ij², s_max = max_i s_i]
//
// Design. On the TPU every grid step accumulates into one shared (4,)
// output block, sound only because the TPU grid runs in order. Blocks
// on Hopper run in no order, so this is two launches:
//
//   1. one block per stripe of kRowsPerBlock rows; each warp reads a
//      row with neighbouring lanes on neighbouring columns (four loads
//      in flight a lane), reduces its sum and sum of squares with
//      shuffles, and keeps the stripe's [S, Σs², Σw², s_max] in
//      registers; the block reduces them in a fixed order and writes
//      one (4,) partial;
//   2. one block reduces the partials in a fixed order.
//
// No atomics, so the result repeats bit for bit. The ragged edge is
// masked by the loop bounds: W is not padded to a block multiple.
//
// What bounds it on the H100: n² · 4 bytes read once, at 3.35 TB/s
// (8192² → 0.080 ms); about 3 flops a byte, far below the card's
// balance point. At the training probe's n = 40 (6.4 KB) a launch is
// latency-bound: a few µs for two launches.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 16;

__global__ void __launch_bounds__(kThreads)
vnge_q_partial_kernel(const float* __restrict__ w,
                      float* __restrict__ partial, int n) {
  __shared__ float scratch[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRowsPerBlock;
  float s_tot = 0.f, s2 = 0.f, w2 = 0.f, s_max = -INFINITY;
  for (int r = warp; r < kRowsPerBlock && row0 + r < n; r += kWarps) {
    const float* wr = w + (row0 + r) * static_cast<long long>(n);
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    float q0 = 0.f, q1 = 0.f, q2 = 0.f, q3 = 0.f;
    int c = lane;
    for (; c + 96 < n; c += 128) {
      const float x0 = wr[c], x1 = wr[c + 32], x2 = wr[c + 64],
                  x3 = wr[c + 96];
      a0 += x0; a1 += x1; a2 += x2; a3 += x3;
      q0 += x0 * x0; q1 += x1 * x1; q2 += x2 * x2; q3 += x3 * x3;
    }
    for (; c < n; c += 32) {
      const float x = wr[c];
      a0 += x;
      q0 += x * x;
    }
    const float s = warp_sum((a0 + a1) + (a2 + a3));
    const float q = warp_sum((q0 + q1) + (q2 + q3));
    s_tot += s;
    s2 += s * s;
    w2 += q;
    s_max = fmaxf(s_max, s);
  }
  // every lane of a warp holds its warp's values: count lane 0 only
  const bool lead = lane == 0;
  s_tot = block_sum(lead ? s_tot : 0.f, scratch);
  s2 = block_sum(lead ? s2 : 0.f, scratch);
  w2 = block_sum(lead ? w2 : 0.f, scratch);
  s_max = block_max(s_max, scratch);
  if (threadIdx.x == 0) {
    float* out = partial + 4LL * blockIdx.x;
    out[0] = s_tot;
    out[1] = s2;
    out[2] = w2;
    out[3] = s_max;
  }
}

__global__ void __launch_bounds__(kThreads)
vnge_q_reduce_kernel(const float* __restrict__ partial, int blocks,
                     float* __restrict__ out) {
  __shared__ float scratch[32];
  float s_tot = 0.f, s2 = 0.f, w2 = 0.f, s_max = -INFINITY;
  for (int b = threadIdx.x; b < blocks; b += blockDim.x) {
    s_tot += partial[4 * b + 0];
    s2 += partial[4 * b + 1];
    w2 += partial[4 * b + 2];
    s_max = fmaxf(s_max, partial[4 * b + 3]);
  }
  s_tot = block_sum(s_tot, scratch);
  s2 = block_sum(s2, scratch);
  w2 = block_sum(w2, scratch);
  s_max = block_max(s_max, scratch);
  if (threadIdx.x == 0) {
    out[0] = s_tot;
    out[1] = s2;
    out[2] = 0.5f * w2;
    out[3] = s_max;
  }
}

int partial_blocks(int n) { return (n + kRowsPerBlock - 1) / kRowsPerBlock; }

}  // namespace

// Rows of the (blocks, 4) partial buffer the wrapper allocates.
REPRO_EXPORT int vnge_q_partial_blocks(int n) { return partial_blocks(n); }

// Both passes on `stream`; returns the first launch error (0 on success).
REPRO_EXPORT int vnge_q_stats_launch(const float* w, float* partial,
                                     float* out, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = n > 0 ? partial_blocks(n) : 0;
  if (blocks > 0) {
    vnge_q_partial_kernel<<<blocks, kThreads, 0, s>>>(w, partial, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  vnge_q_reduce_kernel<<<1, kThreads, 0, s>>>(partial, blocks, out);
  return static_cast<int>(cudaGetLastError());
}
