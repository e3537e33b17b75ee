// Fused Lemma-1 statistics of a dense W in one launch.
//
// Replaces the TPU kernel `vnge_q_stats_pallas`
// (src/repro/kernels/vnge_q/kernel.py:56, body `_kernel` :28). For an
// (n, n) float32 W with row sums s it returns
//
//   [S = Σ_i s_i, Σ_i s_i², Σ_E w² = ½ Σ_ij W_ij², s_max = max_i s_i]
//
// Design. On the TPU every grid step accumulates into one shared (4,)
// output block, sound only because the TPU grid runs in order. Blocks
// on Hopper run in no order, so each block reduces a stripe of rows to a
// (4,) partial, and the last block to finish reduces the partials, in
// one launch:
//
//   - each warp reads one row with neighbouring lanes on neighbouring
//     columns, four loads in flight a lane, and reduces its sum and sum
//     of squares with shuffles; the block reduces its warps' [S, Σs²,
//     Σw², s_max] in a fixed order;
//   - n ≤ kOneBlockN (the training probe's 40 × 40 routing graph): one
//     block of 32 warps takes every row (at most 4 a warp) and writes
//     the result, no partials;
//   - above, one block of 8 warps a stripe of 8 rows, one row a warp,
//     writes its partial, `__threadfence`s and counts itself done with
//     one `atomicAdd` on a device counter; the block that counts last
//     reduces the partials in index order (thread t sums partials t,
//     t + 256, ..., then the fixed block tree) and resets the counter to
//     0 for the next launch on the stream. No atomic touches a value, so
//     the result repeats bit for bit whichever block finishes last.
//
// One row a warp matters: with two rows a warp (16 a block), as the
// two-launch form it replaces had, the blocks' wait on the counter made
// the 8192² call slower than that form on the H100; with one row a warp
// it is faster.
//
// The ragged edge is masked by the loop bounds: W is not padded. The
// wrapper keeps the partials and the counter as a workspace of its own
// stream, so two streams never share a counter.
//
// What bounds it on the H100: n² · 4 bytes read once, at 3.35 TB/s
// (8192² → 0.080 ms); about 3 flops a byte, far below the card's
// balance point. At n = 40 (6.4 KB) a launch is latency-bound.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;          // a block of the stripe grid
constexpr int kRowsPerBlock = kThreads / 32;  // one row a warp
constexpr int kOneBlockN = 128;        // at or below: one block, no partials
constexpr int kOneBlockThreads = 1024; // that block: 32 warps, ≤ 4 rows each

int grid_blocks(int n) {
  return n <= kOneBlockN ? 1 : (n + kRowsPerBlock - 1) / kRowsPerBlock;
}

// kOneBlock: one block of kOneBlockThreads takes all n rows and writes
// the result. Otherwise a block of kThreads takes kRowsPerBlock rows.
template <bool kOneBlock>
__global__ void __launch_bounds__(kOneBlock ? kOneBlockThreads : kThreads)
vnge_q_kernel(const float* __restrict__ w, float* __restrict__ partial,
              unsigned* __restrict__ counter, float* __restrict__ out,
              int n) {
  constexpr int kWarps = (kOneBlock ? kOneBlockThreads : kThreads) / 32;
  __shared__ float scratch[32];
  __shared__ bool last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = kOneBlock ? n : kRowsPerBlock;
  const long long row0 =
      kOneBlock ? 0 : static_cast<long long>(blockIdx.x) * kRowsPerBlock;
  float s_tot = 0.f, s2 = 0.f, w2 = 0.f, s_max = -INFINITY;
  for (int r = warp; r < rows && row0 + r < n; r += kWarps) {
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
  if constexpr (kOneBlock) {
    if (threadIdx.x == 0) {
      out[0] = s_tot;
      out[1] = s2;
      out[2] = 0.5f * w2;
      out[3] = s_max;
    }
    return;
  }
  if (threadIdx.x == 0) {
    float* p = partial + 4LL * blockIdx.x;
    p[0] = s_tot;
    p[1] = s2;
    p[2] = w2;
    p[3] = s_max;
    __threadfence();  // the partial is visible before the count
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();  // every other block's partial is read after its count
  s_tot = 0.f, s2 = 0.f, w2 = 0.f, s_max = -INFINITY;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x);
       b += blockDim.x) {
    s_tot += __ldcg(partial + 4 * b + 0);
    s2 += __ldcg(partial + 4 * b + 1);
    w2 += __ldcg(partial + 4 * b + 2);
    s_max = fmaxf(s_max, __ldcg(partial + 4 * b + 3));
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
    *counter = 0u;  // ready for the next launch on this stream
  }
}

// One block of kOneBlockThreads for n at or below kOneBlockN, otherwise a
// block of kThreads a stripe of kRowsPerBlock rows.
LaunchConfig vnge_q_config(int n) {
  const int blocks = grid_blocks(n);
  if (blocks == 1)
    return {reinterpret_cast<const void*>(vnge_q_kernel<true>),
            "vnge_q_kernel<true>", 1, kOneBlockThreads, 0};
  return {reinterpret_cast<const void*>(vnge_q_kernel<false>),
          "vnge_q_kernel<false>", blocks, kThreads, 0};
}

}  // namespace

// Partials (rows of 4 floats) a launch for n needs in its workspace; 1
// where one block takes all of W (it writes none).
REPRO_EXPORT int vnge_q_blocks(int n) { return grid_blocks(n); }

// One launch on `stream`: `partial` holds vnge_q_blocks(n) rows of 4
// floats and `counter` one unsigned that is 0 before the launch (the
// launch leaves it 0). Returns the launch's cudaError_t (0 on success).
REPRO_EXPORT int vnge_q_stats_launch(const float* w, float* partial,
                                     unsigned* counter, float* out, int n,
                                     void* stream) {
  const LaunchConfig c = vnge_q_config(n);
  void* args[] = {&w, &partial, &counter, &out, &n};
  const cudaError_t launched = cudaLaunchKernel(
      c.fn, dim3(static_cast<unsigned>(c.grid)), dim3(c.block), args, 0,
      static_cast<cudaStream_t>(stream));
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

// The launch `vnge_q_stats_launch` makes for an (n, n) W (which 0,
// a = n), with CUDA's attributes of its instantiation
// (`launch_attributes`: out[kAttrCount], the name into `name`). Returns
// the cudaError_t of the queries.
REPRO_EXPORT int vnge_q_launch_attrs(int which, long long a, long long b,
                                     long long c, long long* out, char* name,
                                     int cap) {
  (void)b;
  (void)c;
  if (which != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_attributes(vnge_q_config(static_cast<int>(a)), true, out,
                           name, cap);
}
