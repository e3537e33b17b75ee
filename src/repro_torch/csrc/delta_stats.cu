// Fused Theorem-2 delta statistics of one update, from the gated delta.
//
// Replaces the TPU kernel `delta_stats_sorted_pallas`
// (src/repro/kernels/delta_stats/kernel.py:77, body `_kernel` :36) and
// the XLA preparation the JAX package runs before it (the endpoint
// concatenation, the sentinel, the argsort and the strength gather of
// `prepare_sorted_delta`). For each row (one stream) it returns
//
//   [ΔS, ΔQ, max_ΔV(s_i + Δs_i), |ΔV|]
//
//   ΔS = 2 Σ_ΔE Δw
//   ΔQ = Σ_ΔV (2 s_i Δs_i + Δs_i²) + Σ_ΔE (4 w Δw + 2 Δw²)
//
// from the k lanes (senders, receivers, Δw, w_old, mask) of the gated
// delta and the (n,) strength row, with Δw masked (Δw·mask). An endpoint
// counts toward ΔV when its lane's mask is positive and its id lies in
// [0, n); the max is -inf when none does.
//
// Design. The TPU kernel contracts a (2k, 2k) same-node matrix on the
// MXU because the TPU sorts and scatters badly; the TPU kernel's own note
// names the GPU form, a sort and a segmented reduce. Here both are one
// launch, one warp a stream and up to 8 streams a block, as the tick
// (tick_kernel.cuh), with `__syncwarp` and shuffles only:
//
//   - Edges in chunks of 32, one a lane (coalesced loads): Δw·mask, the
//     edge sums, and the two endpoint keys (node id << 32 | endpoint
//     index); a masked lane or an id outside [0, n) gets the sentinel id
//     n, which sorts after every valid key.
//   - The keys are sorted by warp_sort.cuh's bitonic network, the one the
//     tick uses: in registers up to 256 keys (k ≤ 128, the serving size),
//     in the warp's slice of shared memory above. The order is (id,
//     endpoint index), the stable order of the JAX package's argsort.
//   - A segment head (the first key of its id) sums its segment's Δw in
//     endpoint order, by one lane, and gathers its own strength from the
//     row: the row is never read beyond the touched nodes.
//   - The sums are kept in float64 (products, segment sums and the warp
//     reduction) and rounded to float32 once at the end: ΔS and ΔQ can
//     cancel (terms of tens summing to near 0), where two float32
//     summation orders differ by more than 1e-5; in float64 the result
//     agrees with the plain version evaluated in float64 to float32
//     rounding. The five scalars are reduced with warp shuffles in a fixed
//     xor tree, so every lane ends with the same bits and two launches
//     agree.
//
// Shared memory a stream: the sort keys (8 B each, a power of two ≥ 2k)
// and the k masked Δw. Up to k = kMaxFusedK = 8192 (16,384 keys, 160 KB
// with a block of one stream) it fits the 227 KB a block can have; 2¹⁵
// keys would not. Above that the wrapper takes the sorted-form route:
// torch's stable argsort (`prepare_sorted_delta`) and
// `delta_stats_sorted_kernel` below, one 512-thread block a row over the
// sorted endpoints read from device memory, which has no size ceiling.
//
// What bounds it on the H100: a stream moves k·20 bytes of delta, 4 bytes
// a touched node and 16 bytes out, and does O(k log² k) compares; at the
// path's single stream (k = 128) that is 3–4 KB, so one launch is bound
// by its latency and the wrapper's host work, not by bytes. The design's
// aim is the one launch: no torch op before it.
#include "warp_sort.cuh"

namespace {

constexpr int kMaxStreams = 8;                 // warps (streams) a block
constexpr long long kBlockSmemTarget = 96 * 1024;
constexpr int kMaxFusedK = 8192;               // 2k keys in shared memory
constexpr int kSortedThreads = 512;            // the sorted-form route

__device__ __forceinline__ double warp_sum_f64(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ double warp_max_f64(double v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmax(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Shared memory of one stream (one warp's slice): the sort keys and the
// (k,) masked Δw; and how many streams share a block (as many as fit in
// kBlockSmemTarget, at most 8, at least 1).
struct DeltaLayout {
  int sort_n;
  long long stream_bytes;
  int streams;

  __host__ __device__ explicit DeltaLayout(int k) : sort_n(sort_length(k)) {
    stream_bytes = (8ll * sort_n + 4ll * k + 15) & ~15ll;
    const long long fit = kBlockSmemTarget / stream_bytes;
    streams = fit < 1 ? 1 : (fit > kMaxStreams ? kMaxStreams : int(fit));
  }

  __host__ __device__ long long bytes() const {
    return streams * stream_bytes;
  }
};

template <int KPL>
__global__ void __launch_bounds__(32 * kMaxStreams)
delta_stats_kernel(const int* __restrict__ senders,
                   const int* __restrict__ receivers,
                   const float* __restrict__ dw,
                   const float* __restrict__ w_old,
                   const float* __restrict__ mask,
                   const float* __restrict__ strengths,
                   float* __restrict__ out, int rows, int n, int k) {
  extern __shared__ unsigned long long smem[];
  const DeltaLayout lay(k);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = static_cast<long long>(blockIdx.x) * lay.streams +
                        warp;
  if (row >= rows) return;  // a whole warp: no block barrier waits on it
  const int sort_n = lay.sort_n;
  unsigned long long* s_key = smem + warp * (lay.stream_bytes / 8);  // [N]
  float* s_val = reinterpret_cast<float*>(s_key + sort_n);   // [k] Δw·mask
  const long long dl = row * k;
  const float* str_row = strengths + row * n;
  const unsigned long long sentinel =
      static_cast<unsigned long long>(static_cast<unsigned>(n)) << 32;

  // -- edges, 32 a chunk: Δw·mask, the edge sums, the endpoint keys -----
  double edge = 0.0, dsum = 0.0;
  int n_valid = 0;
  auto lane_edge = [&](int i, unsigned long long& key_s,
                       unsigned long long& key_r) {
    const int e = 32 * i + lane;
    bool ok_s = false, ok_r = false;
    key_s = key_r = kNoKey;
    if (e < k) {
      const float m = mask[dl + e];
      const float d = dw[dl + e] * m;
      const double dd = d, wo = w_old[dl + e];
      const int s = senders[dl + e], r = receivers[dl + e];
      edge += 4.0 * wo * dd + 2.0 * dd * dd;
      dsum += dd;
      s_val[e] = d;
      ok_s = m > 0.f && s >= 0 && s < n;
      ok_r = m > 0.f && r >= 0 && r < n;
      key_s = (ok_s ? static_cast<unsigned long long>(
                          static_cast<unsigned>(s)) << 32
                    : sentinel) | static_cast<unsigned>(e);
      key_r = (ok_r ? static_cast<unsigned long long>(
                          static_cast<unsigned>(r)) << 32
                    : sentinel) | static_cast<unsigned>(k + e);
    }
    n_valid += __popc(__ballot_sync(kFull, ok_s)) +
               __popc(__ballot_sync(kFull, ok_r));
  };

  if constexpr (KPL > 0) {
    unsigned long long key[KPL];
#pragma unroll
    for (int i = 0; i < KPL / 2; ++i) lane_edge(i, key[2 * i], key[2 * i + 1]);
    if (n_valid > 0) {
      warp_sort<KPL>(key, lane);
#pragma unroll
      for (int r = 0; r < KPL; ++r) s_key[lane * KPL + r] = key[r];
    }
  } else {
    for (int i = 0; i < (k + 31) / 32; ++i) {
      unsigned long long a, b;
      lane_edge(i, a, b);
      const int e = 32 * i + lane;
      if (e < k) {
        s_key[2 * e] = a;
        s_key[2 * e + 1] = b;
      }
    }
    if (n_valid > 0) {
      for (int p = 2 * k + lane; p < sort_n; p += 32) s_key[p] = kNoKey;
      __syncwarp();
      warp_sort_shared(s_key, sort_n, lane);
    }
  }
  __syncwarp();

  // -- segment heads: Δs in endpoint order, the strength, the node sums --
  // The valid keys sort first (ids below the sentinel n), n_valid of them.
  double node = 0.0, mx = -INFINITY;
  int cnt = 0;
  for (int base = 0; base < n_valid; base += 32) {
    const int p = base + lane;
    if (p >= n_valid) continue;
    const unsigned id = static_cast<unsigned>(s_key[p] >> 32);
    if (p > 0 && static_cast<unsigned>(s_key[p - 1] >> 32) == id) continue;
    double ds = 0.0;
    for (int q = p; q < n_valid; ++q) {
      const unsigned long long kq = s_key[q];
      if (static_cast<unsigned>(kq >> 32) != id) break;
      const int e = static_cast<int>(kq & 0xffffffffu);
      ds += s_val[e < k ? e : e - k];
    }
    const double s = str_row[id];
    node += 2.0 * s * ds + ds * ds;
    mx = fmax(mx, s + ds);
    ++cnt;
  }
  edge = warp_sum_f64(edge);
  dsum = warp_sum_f64(dsum);
  node = warp_sum_f64(node);
  mx = warp_max_f64(mx);
  cnt = __reduce_add_sync(kFull, cnt);
  if (lane == 0) {
    out[row * 4 + 0] = static_cast<float>(2.0 * dsum);
    out[row * 4 + 1] = static_cast<float>(node + edge);
    out[row * 4 + 2] = static_cast<float>(mx);
    out[row * 4 + 3] = static_cast<float>(cnt);
  }
}

// The instantiation for a layout: keys in registers (2, 4 or 8 a lane)
// or the shared-memory sort; one warp a stream, lay.streams streams a
// block, and the layout's dynamic shared memory.
LaunchConfig delta_config(long long rows, int k) {
  const DeltaLayout lay(k);
  LaunchConfig c{nullptr, nullptr, (rows + lay.streams - 1) / lay.streams,
                 32 * lay.streams, lay.bytes()};
  switch (lane_keys(lay.sort_n)) {
    case 2:
      c.fn = reinterpret_cast<const void*>(delta_stats_kernel<2>);
      c.name = "delta_stats_kernel<2>";
      break;
    case 4:
      c.fn = reinterpret_cast<const void*>(delta_stats_kernel<4>);
      c.name = "delta_stats_kernel<4>";
      break;
    case 8:
      c.fn = reinterpret_cast<const void*>(delta_stats_kernel<8>);
      c.name = "delta_stats_kernel<8>";
      break;
    default:
      c.fn = reinterpret_cast<const void*>(delta_stats_kernel<0>);
      c.name = "delta_stats_kernel<0>";
  }
  return c;
}

// The sorted-form route for k above kMaxFusedK: the 2k endpoint ids
// sorted ascending (masked slots carry the sentinel id n and sort last),
// their masked Δw, gathered strengths and validity, plus the k per-edge
// masked Δw and w_old. A segment head's thread walks forward over its
// segment; the scalars use the fixed-order block reductions of
// common.cuh. One block a row.
__global__ void __launch_bounds__(kSortedThreads)
delta_stats_sorted_kernel(const int* __restrict__ sorted_nodes,
                          const float* __restrict__ sorted_vals,
                          const float* __restrict__ sorted_strengths,
                          const float* __restrict__ endpoint_valid,
                          const float* __restrict__ dw,
                          const float* __restrict__ w_old,
                          float* __restrict__ out, int two_k, int k) {
  __shared__ float scratch[32];
  const long long row = blockIdx.x;
  const int* sn = sorted_nodes + row * two_k;
  const float* sv = sorted_vals + row * two_k;
  const float* ss = sorted_strengths + row * two_k;
  const float* ev = endpoint_valid + row * two_k;

  float node = 0.f, mx = -INFINITY, cnt = 0.f;
  for (int p = threadIdx.x; p < two_k; p += blockDim.x) {
    const int id = sn[p];
    if (ev[p] > 0.f && (p == 0 || sn[p - 1] != id)) {
      float ds = 0.f;
      for (int q = p; q < two_k && sn[q] == id; ++q) ds += sv[q];
      const float s = ss[p];
      node += 2.f * s * ds + ds * ds;
      mx = fmaxf(mx, s + ds);
      cnt += 1.f;
    }
  }
  float edge = 0.f, dsum = 0.f;
  for (int e = threadIdx.x; e < k; e += blockDim.x) {
    const float d = dw[row * k + e];
    edge += 4.f * w_old[row * k + e] * d + 2.f * d * d;
    dsum += d;
  }
  node = block_sum(node, scratch);
  edge = block_sum(edge, scratch);
  dsum = block_sum(dsum, scratch);
  cnt = block_sum(cnt, scratch);
  mx = block_max(mx, scratch);
  if (threadIdx.x == 0) {
    out[row * 4 + 0] = 2.f * dsum;
    out[row * 4 + 1] = node + edge;
    out[row * 4 + 2] = mx;
    out[row * 4 + 3] = cnt;
  }
}

// The sorted-form route's launch: one block of kSortedThreads a row.
LaunchConfig sorted_config(long long rows) {
  return {reinterpret_cast<const void*>(delta_stats_sorted_kernel),
          "delta_stats_sorted_kernel", rows, kSortedThreads, 0};
}

}  // namespace

// The largest k `delta_stats_launch` takes; above it the wrapper takes
// the sorted-form route.
REPRO_EXPORT int delta_stats_max_k() { return kMaxFusedK; }

// Launch one warp per stream row on `stream`, from the gated delta;
// returns the launch's cudaError_t (0 on success), cudaErrorInvalidValue
// for k outside [1, kMaxFusedK].
REPRO_EXPORT int delta_stats_launch(const int* senders, const int* receivers,
                                    const float* dw, const float* w_old,
                                    const float* mask, const float* strengths,
                                    float* out, int rows, int n, int k,
                                    void* stream) {
  if (rows <= 0) return 0;
  if (k < 1 || k > kMaxFusedK)
    return static_cast<int>(cudaErrorInvalidValue);
  const LaunchConfig c = delta_config(rows, k);
  const cudaError_t err = prepare_launch(c);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&senders, &receivers, &dw, &w_old, &mask, &strengths,
                  &out, &rows, &n, &k};
  const cudaError_t launched = cudaLaunchKernel(
      c.fn, dim3(static_cast<unsigned>(c.grid)), dim3(c.block), args,
      static_cast<size_t>(c.smem), static_cast<cudaStream_t>(stream));
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

// The sorted-form route over `rows` independent streams on `stream`;
// returns the launch's cudaError_t (0 on success).
REPRO_EXPORT int delta_stats_sorted_launch(
    const int* sorted_nodes, const float* sorted_vals,
    const float* sorted_strengths, const float* endpoint_valid,
    const float* dw, const float* w_old, float* out, int rows, int two_k,
    int k, void* stream) {
  if (rows <= 0) return 0;
  const LaunchConfig c = sorted_config(rows);
  void* args[] = {&sorted_nodes, &sorted_vals, &sorted_strengths,
                  &endpoint_valid, &dw, &w_old, &out, &two_k, &k};
  const cudaError_t launched = cudaLaunchKernel(
      c.fn, dim3(static_cast<unsigned>(c.grid)), dim3(c.block), args, 0,
      static_cast<cudaStream_t>(stream));
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

// The launch `delta_stats_launch` (which 0: a = rows, b = k) or
// `delta_stats_sorted_launch` (which 1: a = rows) makes, with CUDA's
// attributes of its instantiation (`launch_attributes`: out[kAttrCount],
// the name into `name`); the one-launch route accepts k in
// [1, kMaxFusedK] only. Returns the cudaError_t of the queries, or
// cudaErrorInvalidValue for another `which`.
REPRO_EXPORT int delta_stats_launch_attrs(int which, long long a,
                                          long long b, long long c,
                                          long long* out, char* name,
                                          int cap) {
  (void)c;
  if (which == 0) {
    // a k above the route's range is reported at its own layout, refused
    const int k = b < 1 ? 1 : static_cast<int>(b);
    return launch_attributes(delta_config(a, k), b >= 1 && b <= kMaxFusedK,
                             out, name, cap);
  }
  if (which == 1) return launch_attributes(sorted_config(a), true, out, name,
                                           cap);
  return static_cast<int>(cudaErrorInvalidValue);
}
