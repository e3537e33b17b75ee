// Fused Theorem-2 delta statistics over the sorted-endpoint form.
//
// Replaces the TPU kernel `delta_stats_sorted_pallas`
// (src/repro/kernels/delta_stats/kernel.py:77, body `_kernel` :36).
// For each row (one stream) it returns
//
//   [ΔS, ΔQ, max_ΔV(s_i + Δs_i), |ΔV|]
//
//   ΔS = 2 Σ_ΔE Δw
//   ΔQ = Σ_ΔV (2 s_i Δs_i + Δs_i²) + Σ_ΔE (4 w Δw + 2 Δw²)
//
// from the 2k endpoint ids sorted ascending (masked slots carry the
// sentinel id n and sort last), their masked Δw, their gathered
// strengths and validity, plus the k per-edge masked Δw and w_old.
// The max is -inf when every lane is masked.
//
// Design. The TPU kernel builds a (2k, 2k) same-node matrix and
// contracts it on the MXU because the TPU scatters badly. Here the
// endpoints are already sorted (the wrapper sorts them with torch.sort,
// as the JAX package argsorts them in XLA before its kernel), so a
// segment head is an endpoint whose id differs from its predecessor,
// and its thread walks forward over the segment to sum Δs_i: O(2k)
// work, no (2k, 2k) temporary, and no size ceiling — every array is
// read from device memory once, so any k the delta can have fits.
// One block of 512 threads per row; the scalar sums use the fixed-order
// block reduction of common.cuh, so results repeat bit for bit.
//
// What bounds it on the H100: a single stream moves 2k·16 + k·8 bytes
// and does O(2k) flops, so one launch is latency-bound (a few µs);
// the batched serving path uses stream_tick.cu instead.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
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

}  // namespace

// Launch over `rows` independent streams on `stream`; returns the
// launch's cudaError_t (0 on success).
REPRO_EXPORT int delta_stats_sorted_launch(
    const int* sorted_nodes, const float* sorted_vals,
    const float* sorted_strengths, const float* endpoint_valid,
    const float* dw, const float* w_old, float* out, int rows, int two_k,
    int k, void* stream) {
  if (rows <= 0) return 0;
  delta_stats_sorted_kernel<<<rows, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      sorted_nodes, sorted_vals, sorted_strengths, endpoint_valid, dw,
      w_old, out, two_k, k);
  return static_cast<int>(cudaGetLastError());
}
