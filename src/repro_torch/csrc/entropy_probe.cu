// Attention-graph VNGE statistics without writing A = softmax(logits).
//
// Replaces the two TPU kernels of `attention_graph_stats_pallas`
// (src/repro/kernels/entropy_probe/kernel.py:76):
//
//   row stats   (`_row_stats_kernel`, :35): per row of the (BH, S, S)
//               logits, its max m and exp-sum d = Σ exp(x − m);
//   graph stats (`_graph_stats_kernel`, :42): per head, the column sums
//               of A, Σ A², Σ A∘Aᵀ and diag(A), with Σ diag² beside
//               them, A_ij = exp(x_ij − m_i) / d_i rebuilt on chip.
//
// The wrapper (kernels/entropy_probe/ops.py) closes the algebra into
// the Lemma-1 statistics of W = (A + Aᵀ)/2 with a zero diagonal.
//
// Design. On the TPU the colsum block stays resident across the
// sequential row-tile sweep and the scalars accumulate across the whole
// grid; blocks on Hopper run in no order, so neither carries over.
//
//   row stats:   one warp per row, an online max / exp-sum over its
//                columns in one read, lanes on neighbouring columns,
//                combined across the warp with shuffles;
//   graph stats: one block per (head, unordered tile pair I ≤ J) of
//                kTile × kTile tiles. It loads T[I,J] and T[J,I] once,
//                rebuilds both A tiles in shared memory from the row
//                normalizers, and takes ΣA² over both, 2·Σ A_ij A_ji
//                over i ∈ I, j ∈ J (the diagonal tile once), the
//                column sums of each tile and, on I = J, diag(A). Each
//                logits tile is read once — the TPU kernel reads every
//                tile twice. Column-sum and scalar partials go to
//                buffers; a second launch, one block per head, reduces
//                them in a fixed order. No atomics: results repeat bit
//                for bit.
//
// Masked logits (-1e30 under the causal mask) give exp(−1e30 − m) = 0
// exactly, and a row always keeps its diagonal. A ragged S (not a
// multiple of kTile) is masked inside the kernel: out-of-range elements
// are A = 0 and are never written.
//
// What bounds it on the H100: the logits, BH · S² · 4 bytes, read once
// per kernel (the normalizers and outputs are O(BH · S)); at the
// training probe's (BH, S) = (192, 128) that is 12.6 MB, 3.8 µs, so a
// launch there is latency-bound.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowWarps = kThreads / 32;
constexpr int kTile = 64;
constexpr int kPitch = kTile + 1;  // conflict-free transposed reads

__device__ __forceinline__ void online_merge(float& m, float& d, float om,
                                             float od) {
  const float mx = fmaxf(m, om);
  const float a = m == -INFINITY ? 0.f : d * expf(m - mx);
  const float b = om == -INFINITY ? 0.f : od * expf(om - mx);
  m = mx;
  d = a + b;
}

__global__ void __launch_bounds__(kThreads)
row_stats_kernel(const float* __restrict__ logits,
                 float* __restrict__ rowmax, float* __restrict__ denom,
                 long long rows, int s) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* x = logits + row * s;
  float m = -INFINITY, d = 0.f;
  for (int c = lane; c < s; c += 32) {
    const float v = x[c];
    if (v > m) {
      d = d * expf(m - v) + 1.f;
      m = v;
    } else {
      d += expf(v - m);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, o);
    const float od = __shfl_xor_sync(0xffffffffu, d, o);
    online_merge(m, d, om, od);
  }
  if (lane == 0) {
    rowmax[row] = m;
    denom[row] = d;
  }
}

// Load the (kTile, kTile) tile of rows r0.., columns c0.. of one head's
// logits into `a` as A = exp(x − m_row) / d_row (0 outside S).
__device__ __forceinline__ void load_a_tile(
    const float* __restrict__ head, const float* __restrict__ rm,
    const float* __restrict__ dn, int r0, int c0, int s,
    float (*a)[kPitch]) {
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int r = e / kTile, c = e % kTile;
    const int i = r0 + r, j = c0 + c;
    float v = 0.f;
    if (i < s && j < s)
      v = expf(head[static_cast<long long>(i) * s + j] - rm[i]) / dn[i];
    a[r][c] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
graph_tile_kernel(const float* __restrict__ logits,
                  const float* __restrict__ rowmax,
                  const float* __restrict__ denom, int s, int nt,
                  int n_pairs, float* __restrict__ part_col,
                  float* __restrict__ part_scal, float* __restrict__ diag) {
  __shared__ float a1[kTile][kPitch];
  __shared__ float a2[kTile][kPitch];
  __shared__ float scratch[32];
  const long long bh = blockIdx.x / n_pairs;
  int p = static_cast<int>(blockIdx.x % n_pairs);
  int ti = 0;  // pair p → (ti, tj), ti ≤ tj, row-major over the triangle
  while (p >= nt - ti) {
    p -= nt - ti;
    ++ti;
  }
  const int tj = ti + p;
  const bool on_diag = ti == tj;
  const float* head = logits + bh * s * static_cast<long long>(s);
  const float* rm = rowmax + bh * s;
  const float* dn = denom + bh * s;
  const int r0 = ti * kTile, c0 = tj * kTile;

  load_a_tile(head, rm, dn, r0, c0, s, a1);              // A[I, J]
  if (!on_diag) load_a_tile(head, rm, dn, c0, r0, s, a2);  // A[J, I]
  __syncthreads();

  float sq = 0.f, cross = 0.f;
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int r = e / kTile, c = e % kTile;
    const float x = a1[r][c];
    sq += x * x;
    if (on_diag) {
      cross += x * a1[c][r];
    } else {
      const float y = a2[r][c];
      sq += y * y;
      cross += x * a2[c][r];
    }
  }
  sq = block_sum(sq, scratch);
  cross = block_sum(cross, scratch);
  if (threadIdx.x == 0) {
    float* ps = part_scal + 2LL * blockIdx.x;  // (bh, pair) row-major
    ps[0] = sq;
    ps[1] = on_diag ? cross : 2.f * cross;
  }
  // column sums: A[I, J] feeds row tile I at columns J, A[J, I] row
  // tile J at columns I; each (row tile, column) entry has one writer
  float* col = part_col + bh * static_cast<long long>(nt) * s;
  const int c = threadIdx.x % kTile;
  const int which = threadIdx.x / kTile;
  if (which == 0 && c0 + c < s) {
    float t = 0.f;
    for (int r = 0; r < kTile; ++r) t += a1[r][c];
    col[static_cast<long long>(ti) * s + c0 + c] = t;
    if (on_diag) diag[bh * s + c0 + c] = a1[c][c];
  } else if (which == 1 && !on_diag && r0 + c < s) {
    float t = 0.f;
    for (int r = 0; r < kTile; ++r) t += a2[r][c];
    col[static_cast<long long>(tj) * s + r0 + c] = t;
  }
}

__global__ void __launch_bounds__(kThreads)
graph_reduce_kernel(const float* __restrict__ part_col,
                    const float* __restrict__ part_scal,
                    const float* __restrict__ diag, int s, int nt,
                    int n_pairs, float* __restrict__ scal,
                    float* __restrict__ colsum) {
  __shared__ float scratch[32];
  const long long bh = blockIdx.x;
  const float* col = part_col + bh * static_cast<long long>(nt) * s;
  const float* dg = diag + bh * s;
  float d2 = 0.f;
  for (int j = threadIdx.x; j < s; j += blockDim.x) {
    float t = 0.f;
    for (int r = 0; r < nt; ++r) t += col[static_cast<long long>(r) * s + j];
    colsum[bh * s + j] = t;
    d2 += dg[j] * dg[j];
  }
  const float* ps = part_scal + 2 * bh * n_pairs;
  float sq = 0.f, cross = 0.f;
  for (int q = threadIdx.x; q < n_pairs; q += blockDim.x) {
    sq += ps[2 * q];
    cross += ps[2 * q + 1];
  }
  sq = block_sum(sq, scratch);
  cross = block_sum(cross, scratch);
  d2 = block_sum(d2, scratch);
  if (threadIdx.x == 0) {
    scal[3 * bh + 0] = sq;
    scal[3 * bh + 1] = cross;
    scal[3 * bh + 2] = d2;
  }
}

int tiles(int s) { return (s + kTile - 1) / kTile; }

}  // namespace

// Tiles along S and unordered tile pairs: the wrapper sizes the
// (BH, tiles, S) column and (BH, pairs, 2) scalar partial buffers.
REPRO_EXPORT int entropy_probe_tiles(int s) { return tiles(s); }
REPRO_EXPORT int entropy_probe_pairs(int s) {
  return tiles(s) * (tiles(s) + 1) / 2;
}

// Row max and exp-sum of each of `rows` rows of length s.
REPRO_EXPORT int row_stats_launch(const float* logits, float* rowmax,
                                  float* denom, long long rows, int s,
                                  void* stream) {
  if (rows <= 0) return 0;
  const long long blocks = (rows + kRowWarps - 1) / kRowWarps;
  row_stats_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      logits, rowmax, denom, rows, s);
  return static_cast<int>(cudaGetLastError());
}

// The tile pass and the per-head reduction; returns the first launch
// error (0 on success).
REPRO_EXPORT int graph_stats_launch(const float* logits,
                                    const float* rowmax, const float* denom,
                                    int bh, int s, float* part_col,
                                    float* part_scal, float* scal,
                                    float* colsum, float* diag,
                                    void* stream) {
  if (bh <= 0 || s <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nt = tiles(s), n_pairs = nt * (nt + 1) / 2;
  const long long blocks = static_cast<long long>(bh) * n_pairs;
  graph_tile_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      logits, rowmax, denom, s, nt, n_pairs, part_col, part_scal, diag);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  graph_reduce_kernel<<<bh, kThreads, 0, st>>>(part_col, part_scal, diag, s,
                                               nt, n_pairs, scal, colsum);
  return static_cast<int>(cudaGetLastError());
}
