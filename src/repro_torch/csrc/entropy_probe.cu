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
// Here the graph-stats launch also closes the algebra (the plain
// closing is `stats_from_parts`, kernels/entropy_probe/ref.py; the
// reference's `ops.py:25-33`) and writes each head's Lemma-1 statistics
// of W = (A + Aᵀ)/2 with a zero diagonal, [S_tot, Σs², Σ_E w², s_max].
// Each op is one launch; nothing but its output is allocated a call.
//
// Design. On the TPU the colsum block stays resident across the
// sequential row-tile sweep and the scalars accumulate across the whole
// grid; blocks on Hopper run in no order, so neither carries over.
//
//   row stats:   one warp a row; up to S = 1024 a lane keeps its ≤ 32
//                values in registers (128-bit loads where S % 4 == 0):
//                the max by shuffles, then one exp each and the sum,
//                no branch per element. Longer rows go in chunks of
//                1024 merged online. Both outputs are one (2, rows)
//                buffer.
//   graph stats: one block per (head, two consecutive unordered tile
//                pairs I ≤ J) of kTile × kTile tiles; each logits tile
//                is read once (the TPU kernel reads every tile twice). A
//                thread holds 4 rows × 4 neighbouring columns of a
//                tile: A built with one reciprocal of each row's
//                exp-sum, ΣA² and its columns' sums kept in registers
//                while the tile is built. The partner tile A[J, I]
//                (A[I, I] on the diagonal) goes to shared memory first,
//                then A[I, J] stays in registers, so one tile is live a
//                thread (40 registers, 6 blocks an SM); the only
//                transposed read is the cross term Σ A_ij A_ji, and a
//                warp's 8 × 4 thread layout makes both the row-major
//                store and the transposed read free of bank conflicts
//                at pitch 65. Column sums: shuffles, then 4 row groups
//                through shared memory. Partials go to a workspace; the
//                last block of each head to finish (an integer arrival
//                counter per head, reset to 0 by that block) sums the
//                head's partials in index order and closes the algebra.
//                No float atomics: results repeat bit for bit.
//
// exp is the MUFU's (`__expf`): its relative error (a few 1e-7 near the
// row max, where A is large) is far inside the probe's rtol 5e-4.
// Masked logits (-1e30 under the causal mask) give exp(−1e30 − m) = 0
// exactly, and a row always keeps its diagonal. A ragged S is masked in
// the kernel: elements outside S load as −∞, so A = 0 there, and are
// never written.
//
// What bounds it on the H100: the logits, BH · S² · 4 bytes, read once
// per kernel (the row stats and outputs are O(BH · S)); at the training
// probe's (BH, S) = (192, 128) that is 12.6 MB, 3.8 µs, so a call there
// is bound by its launch and host work; at (192, 1024), 805 MB, 0.24 ms.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowWarps = kThreads / 32;
constexpr int kMaxRowVec = 8;  // float4s a lane holds: rows up to 1024
constexpr int kTile = 64;
constexpr int kPitch = kTile + 1;
constexpr int kRowStride = kThreads / 16;  // rows between a thread's
constexpr int kRowsPer = kTile / kRowStride;  // rows a thread holds
constexpr int kGroups = kThreads / 64;        // row groups of a tile
// Tile pairs a graph-stats block takes, and the blocks an SM must hold
// (at most 40 registers a thread). More resident blocks, not more loads
// in flight a thread, keep the logits streaming: on the H100 a block
// with both tiles of a pair in registers (about 100 registers, 2 blocks
// an SM) was far slower at (BH, S) = (192, 1024). Two pairs a block
// spread the per-block tail (block sums, the count) over two pairs;
// four left the last wave half empty at (48, 1000).
constexpr int kPairsPerBlock = 2;
constexpr int kGraphMinBlocks = 6;

// ---- row stats ------------------------------------------------------

// V float4s (4·V values) a lane: 128·V columns a chunk.
template <int V, bool kVec>
__global__ void __launch_bounds__(kThreads)
row_stats_kernel(const float* __restrict__ logits, float* __restrict__ out,
                 long long rows, int s) {
  constexpr int kChunk = 128 * V;
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp: one row a warp
  const float* x = logits + row * s;
  float m = -INFINITY, d = 0.f;
  for (int c0 = 0; c0 < s; c0 += kChunk) {
    float v[4 * V];
    if constexpr (kVec) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int c = c0 + 4 * (lane + 32 * k);
        float4 t = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
        if (c < s) t = __ldg(reinterpret_cast<const float4*>(x + c));
        v[4 * k] = t.x;
        v[4 * k + 1] = t.y;
        v[4 * k + 2] = t.z;
        v[4 * k + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4 * V; ++k) {
        const int c = c0 + lane + 32 * k;
        v[k] = c < s ? __ldg(x + c) : -INFINITY;
      }
    }
    float cm = v[0];
#pragma unroll
    for (int k = 1; k < 4 * V; ++k) cm = fmaxf(cm, v[k]);
    const float mx = fmaxf(m, warp_max(cm));
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < 4 * V; ++k) t += __expf(v[k] - mx);
    // the first chunk: m = −∞ and d = 0, so d stays 0 before the add
    d = d * __expf(m - mx) + warp_sum(t);
    m = mx;
  }
  if (lane == 0) {
    out[row] = m;
    out[rows + row] = d;
  }
}

// The float4s a lane holds for rows of length s: the least power of two
// that covers s, up to kMaxRowVec (longer rows take several chunks).
int row_vec(int s) {
  int v = 1;
  while (v < kMaxRowVec && 128 * v < s) v *= 2;
  return v;
}

// One warp a row, kRowWarps rows a block, the instantiation for the row
// length (`row_vec`) and whether the rows load as float4 (`vec_ok`).
template <bool kVec>
LaunchConfig row_config_vec(long long rows, int s) {
  LaunchConfig c{nullptr, nullptr, (rows + kRowWarps - 1) / kRowWarps,
                 kThreads, 0};
  switch (row_vec(s)) {
    case 1:
      c.fn = reinterpret_cast<const void*>(row_stats_kernel<1, kVec>);
      c.name = kVec ? "row_stats_kernel<1, true>"
                    : "row_stats_kernel<1, false>";
      break;
    case 2:
      c.fn = reinterpret_cast<const void*>(row_stats_kernel<2, kVec>);
      c.name = kVec ? "row_stats_kernel<2, true>"
                    : "row_stats_kernel<2, false>";
      break;
    case 4:
      c.fn = reinterpret_cast<const void*>(row_stats_kernel<4, kVec>);
      c.name = kVec ? "row_stats_kernel<4, true>"
                    : "row_stats_kernel<4, false>";
      break;
    default:
      c.fn = reinterpret_cast<const void*>(row_stats_kernel<kMaxRowVec, kVec>);
      c.name = kVec ? "row_stats_kernel<8, true>"
                    : "row_stats_kernel<8, false>";
  }
  return c;
}

LaunchConfig row_config(long long rows, int s, bool vec) {
  return vec ? row_config_vec<true>(rows, s) : row_config_vec<false>(rows, s);
}

// ---- graph stats ----------------------------------------------------

__host__ __device__ inline int tiles(int s) {
  return (s + kTile - 1) / kTile;
}
__host__ __device__ inline int pairs(int s) {
  return tiles(s) * (tiles(s) + 1) / 2;
}

// A thread's place in a tile: columns 4·col4 .. 4·col4 + 3 of rows
// rsub + kRowStride·p, p < kRowsPer. A warp covers 4 rows × 32 columns
// (lane & 7 on the columns), so its loads are 128-byte rows.
struct TileLane {
  int col4, rsub;
  __device__ TileLane()
      : col4((threadIdx.x & 7) + 8 * ((threadIdx.x >> 5) & 1)),
        rsub(((threadIdx.x & 31) >> 3) + 4 * (threadIdx.x >> 6)) {}
};

// The thread's kRowsPer × 4 logits of the tile at rows r0.., columns
// c0..; −∞ outside S.
template <bool kVec>
__device__ __forceinline__ void load_tile(const float* __restrict__ head,
                                          int s, int r0, int c0,
                                          const TileLane& t,
                                          float (&x)[kRowsPer][4]) {
  const int c = c0 + 4 * t.col4;
#pragma unroll
  for (int p = 0; p < kRowsPer; ++p) {
    const int i = r0 + t.rsub + kRowStride * p;
    const float* src = head + static_cast<long long>(i) * s + c;
    if constexpr (kVec) {
      float4 v = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      if (i < s && c < s) v = __ldg(reinterpret_cast<const float4*>(src));
      x[p][0] = v.x;
      x[p][1] = v.y;
      x[p][2] = v.z;
      x[p][3] = v.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        x[p][q] = i < s && c + q < s ? __ldg(src + q) : -INFINITY;
    }
  }
}

// x ← A = exp(x − m_row) · (1 / d_row) in place; adds Σ A² to `sq` and
// each column's sum over the thread's rows to `cs`. Rows outside S get
// m = 0 and 1/d = 0 (their x is −∞ already).
__device__ __forceinline__ void build_tile(const float* __restrict__ rm,
                                           const float* __restrict__ dn,
                                           int s, int r0, const TileLane& t,
                                           float (&x)[kRowsPer][4],
                                           float& sq, float (&cs)[4]) {
#pragma unroll
  for (int p = 0; p < kRowsPer; ++p) {
    const int i = r0 + t.rsub + kRowStride * p;
    const float m = i < s ? __ldg(rm + i) : 0.f;
    const float inv = i < s ? 1.f / __ldg(dn + i) : 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float a = __expf(x[p][q] - m) * inv;
      x[p][q] = a;
      sq += a * a;
      cs[q] += a;
    }
  }
}

// Sum the threads of each column: lanes l, l^8, l^16, l^24 by shuffles,
// then the row groups' sums go to `red`.
__device__ __forceinline__ void column_sums(float (&cs)[4],
                                            float (*red)[kTile],
                                            const TileLane& t) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    cs[q] += __shfl_xor_sync(0xffffffffu, cs[q], 8);
    cs[q] += __shfl_xor_sync(0xffffffffu, cs[q], 16);
  }
  if ((threadIdx.x & 31) < 8) {
#pragma unroll
    for (int q = 0; q < 4; ++q) red[threadIdx.x >> 6][4 * t.col4 + q] = cs[q];
  }
}

// Sums of v[0..K) over the block, and the max of v[K], in every thread,
// with two barriers for all of them (fixed order: a shuffle tree in
// each warp, then the warps in order). `scratch` holds (K + 1) floats
// for each of the block's kThreads / 32 warps; the leading barrier lets
// the caller reuse it.
template <int K>
__device__ __forceinline__ void block_reduce(float (&v)[K + 1],
                                             float* scratch) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  v[K] = warp_max(v[K]);
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k <= K; ++k) scratch[k * kWarps + warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += scratch[k * kWarps + w];
    v[k] = s;
  }
  float m = -INFINITY;
  for (int w = 0; w < kWarps; ++w) m = fmaxf(m, scratch[K * kWarps + w]);
  v[K] = m;
}

// Blocks of a head: each takes kPairsPerBlock consecutive tile pairs
// of the triangle in row-major order (the last one fewer).
__host__ __device__ inline int blocks_per_head(int n_pairs) {
  return (n_pairs + kPairsPerBlock - 1) / kPairsPerBlock;
}

// Floats of one head's workspace: nt column-sum rows of S (row tile r,
// column j), diag(A) (S), and [ΣA², ΣA∘Aᵀ] of each of its blocks.
__host__ __device__ inline long long head_floats(int s) {
  return static_cast<long long>(tiles(s) + 1) * s +
         2LL * blocks_per_head(pairs(s));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kGraphMinBlocks)
graph_stats_kernel(const float* __restrict__ logits,
                   const float* __restrict__ rowmax,
                   const float* __restrict__ denom, int s, int nt,
                   int n_pairs, float* __restrict__ work,
                   unsigned* __restrict__ counter, float* __restrict__ out) {
  __shared__ float tile[kTile][kPitch];
  __shared__ float red[2][kGroups][kTile];
  __shared__ float scratch[6 * kThreads / 32];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int n_blocks = blocks_per_head(n_pairs);
  const long long bh = blockIdx.x / n_blocks;
  const int blk = static_cast<int>(blockIdx.x % n_blocks);
  const int first = blk * kPairsPerBlock;
  const int end = min(first + kPairsPerBlock, n_pairs);
  int ti = 0, p = first;  // first pair → (ti, tj), ti ≤ tj, row-major
  while (p >= nt - ti) {
    p -= nt - ti;
    ++ti;
  }
  int tj = ti + p;
  const float* head = logits + bh * s * static_cast<long long>(s);
  const float* rm = rowmax + bh * s;
  const float* dn = denom + bh * s;
  float* col = work + bh * head_floats(s);  // (nt, S) column partials
  float* diag = col + static_cast<long long>(nt) * s;
  float* scal = diag + s;  // [ΣA², ΣA∘Aᵀ] of each of the head's blocks
  const TileLane t;
  float sq = 0.f, cross = 0.f;
  for (int pair = first; pair < end; ++pair) {
    const bool on_diag = ti == tj;
    const int r0 = ti * kTile, c0 = tj * kTile;
    // the partner tile A[J, I] (A[I, I] on the diagonal) first, into
    // shared memory row-major; then A[I, J], kept in registers
    float a[kRowsPer][4], cs[4] = {0.f, 0.f, 0.f, 0.f};
    load_tile<kVec>(head, s, c0, r0, t, a);
    build_tile(rm, dn, s, c0, t, a, sq, cs);
#pragma unroll
    for (int pp = 0; pp < kRowsPer; ++pp)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        tile[t.rsub + kRowStride * pp][4 * t.col4 + q] = a[pp][q];
    column_sums(cs, red[on_diag ? 0 : 1], t);
    if (!on_diag) {
#pragma unroll
      for (int q = 0; q < 4; ++q) cs[q] = 0.f;
      load_tile<kVec>(head, s, r0, c0, t, a);
      build_tile(rm, dn, s, r0, t, a, sq, cs);
      column_sums(cs, red[0], t);
    }
    __syncthreads();
    float x = 0.f;  // Σ A[I,J]_rc · A[J,I]_cr
#pragma unroll
    for (int pp = 0; pp < kRowsPer; ++pp) {
      const int r = t.rsub + kRowStride * pp;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = 4 * t.col4 + q;
        x += a[pp][q] * tile[c][r];
        if (on_diag && c == r && r0 + r < s) diag[r0 + r] = a[pp][q];
      }
    }
    cross += on_diag ? x : 2.f * x;
    // A[I, J] feeds row tile I at columns J, A[J, I] row tile J at
    // columns I: each (row tile, column) entry has one writer
    const int which = tid / kTile, k = tid % kTile;
    const int cbase = which == 0 ? c0 : r0;
    if (which < (on_diag ? 1 : 2) && cbase + k < s) {
      float v = 0.f;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) v += red[which][g][k];
      col[static_cast<long long>(which == 0 ? ti : tj) * s + cbase + k] = v;
    }
    __syncthreads();  // `tile` and `red` are free for the next pair
    if (++tj == nt) tj = ++ti;
  }
  float part[3] = {sq, cross, 0.f};
  block_reduce<2>(part, scratch);
  if (tid == 0) {
    scal[2 * blk] = part[0];
    scal[2 * blk + 1] = part[1];
  }
  __syncthreads();
  if (tid == 0) {
    // cumulative after the barrier: the block's partials are visible
    // before its count (the pattern of cooperative groups' grid sync)
    __threadfence();
    last = atomicAdd(counter + bh, 1u) == n_blocks - 1u;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();  // the head's other partials are read after its count

  // the closing (`stats_from_parts`): with every row of A summing to 1,
  // s_j = ((1 − diag_j) + (colsum_j − diag_j)) / 2 and
  // Σ_E w² = ¼(ΣA² − Σdiag²) + ¼(ΣA∘Aᵀ − Σdiag²)
  // v = [S_tot, Σs², Σdiag², ΣA², ΣA∘Aᵀ; s_max]
  float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, -INFINITY};
  for (int j = tid; j < s; j += kThreads) {
    float c = 0.f;
    for (int r = 0; r < nt; ++r)
      c += __ldcg(col + static_cast<long long>(r) * s + j);
    const float d = __ldcg(diag + j);
    const float sj = 0.5f * ((1.f - d) + (c - d));
    v[0] += sj;
    v[1] += sj * sj;
    v[2] += d * d;
    v[5] = fmaxf(v[5], sj);
  }
  for (int b = tid; b < n_blocks; b += kThreads) {
    v[3] += __ldcg(scal + 2 * b);
    v[4] += __ldcg(scal + 2 * b + 1);
  }
  block_reduce<5>(v, scratch);
  if (tid == 0) {
    float* o = out + 4 * bh;
    o[0] = v[0];
    o[1] = v[1];
    o[2] = 0.25f * (v[3] - v[2]) + 0.25f * (v[4] - v[2]);
    o[3] = v[5];
    counter[bh] = 0u;  // ready for the next launch on this stream
  }
}

bool vec_ok(const float* logits, int s) {
  return s % 4 == 0 && reinterpret_cast<uintptr_t>(logits) % 16 == 0;
}

// kPairsPerBlock tile pairs a block, blocks_per_head blocks a head, and
// whether the tiles load as float4 (`vec_ok`).
LaunchConfig graph_config(int bh, int s, bool vec) {
  const long long blocks =
      static_cast<long long>(bh) * blocks_per_head(pairs(s));
  if (vec)
    return {reinterpret_cast<const void*>(graph_stats_kernel<true>),
            "graph_stats_kernel<true>", blocks, kThreads, 0};
  return {reinterpret_cast<const void*>(graph_stats_kernel<false>),
          "graph_stats_kernel<false>", blocks, kThreads, 0};
}

}  // namespace

// Floats of workspace one head needs at row length s (the column
// partials, diag(A) and its blocks' scalars).
REPRO_EXPORT long long entropy_probe_workspace(int s) {
  return head_floats(s);
}

// Row max and exp-sum of each of `rows` rows of length s into `out`,
// (2, rows): maxes, then exp-sums. Returns the launch's cudaError_t.
REPRO_EXPORT int row_stats_launch(const float* logits, float* out,
                                  long long rows, int s, void* stream) {
  if (rows <= 0 || s <= 0) return 0;
  const LaunchConfig c = row_config(rows, s, vec_ok(logits, s));
  void* args[] = {&logits, &out, &rows, &s};
  const cudaError_t launched = cudaLaunchKernel(
      c.fn, dim3(static_cast<unsigned>(c.grid)), dim3(c.block), args, 0,
      static_cast<cudaStream_t>(stream));
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

// One launch from the logits and row stats to the closed (bh, 4)
// statistics. `work` holds bh · entropy_probe_workspace(s) floats and
// `counter` bh unsigneds that are 0 before the launch (the launch
// leaves them 0). Returns the launch's cudaError_t.
REPRO_EXPORT int graph_stats_launch(const float* logits, const float* rowmax,
                                    const float* denom, float* work,
                                    unsigned* counter, float* out, int bh,
                                    int s, void* stream) {
  if (bh <= 0 || s <= 0) return 0;
  int nt = tiles(s), n_pairs = pairs(s);
  const LaunchConfig c = graph_config(bh, s, vec_ok(logits, s));
  void* args[] = {&logits, &rowmax, &denom, &s, &nt, &n_pairs, &work,
                  &counter, &out};
  const cudaError_t launched = cudaLaunchKernel(
      c.fn, dim3(static_cast<unsigned>(c.grid)), dim3(c.block), args, 0,
      static_cast<cudaStream_t>(stream));
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

// The launch `row_stats_launch` (which 0: a = rows, b = s) or
// `graph_stats_launch` (which 1: a = bh, b = s) makes, with c = 1 for
// float4 loads (s a multiple of 4 on 16-byte aligned logits, as PyTorch
// allocates them) and 0 for scalar loads, with CUDA's attributes of its
// instantiation (`launch_attributes`: out[kAttrCount], the name into
// `name`). Returns the cudaError_t of the queries.
REPRO_EXPORT int entropy_probe_launch_attrs(int which, long long a,
                                            long long b, long long c,
                                            long long* out, char* name,
                                            int cap) {
  const int s = static_cast<int>(b);
  if (which == 0)
    return launch_attributes(row_config(a, s, c != 0), true, out, name, cap);
  if (which == 1)
    return launch_attributes(graph_config(static_cast<int>(a), s, c != 0),
                             true, out, name, cap);
  return static_cast<int>(cudaErrorInvalidValue);
}
