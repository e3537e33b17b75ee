// One whole Algorithm-2 serving tick per stream: the fused JSdist tick
// over the dense n_pad node axis.
//
// Replaces the TPU kernels `stream_tick_pallas` and
// `stream_tick_pallas_stacked` (src/repro/kernels/stream_tick/kernel.py
// :193 and :242, body `_kernel` :66); the stacked (S, B) form is the
// same kernel over S·B rows. The kernel body, its design, its
// shared-memory layout (`TickLayout`) and what bounds it are in
// tick_kernel.cuh, shared with the sparse tick; this file instantiates
// it without the edge store.
#include "tick_kernel.cuh"

// Dynamic shared memory one block (up to 8 streams) needs for k edge
// lanes and j node slots (`TickLayout`; it grows with k only).
REPRO_EXPORT long long stream_tick_smem_bytes(int k, int j) {
  return TickLayout(k).bytes();
}

// The card's per-block shared-memory limit (with the opt-in above 48 KB),
// or -1 with the CUDA error left for cudaGetLastError.
REPRO_EXPORT long long stream_tick_smem_limit(int device) {
  return smem_optin_limit(device);
}

// The launch `stream_tick_launch` makes for `rows` streams, k edge lanes,
// j node slots and `which` warps a stream (0 reads as 1), with CUDA's
// attributes of its instantiation (`launch_attributes`: out[kAttrCount],
// the name into `name`); j does not change the launch (shared memory
// grows with k only). Returns the cudaError_t of the queries.
REPRO_EXPORT int stream_tick_launch_attrs(int which, long long rows,
                                          long long k, long long j,
                                          long long* out, char* name, int cap) {
  (void)j;
  const int warps = which > 1 ? which : 1;
  const int kk = static_cast<int>(k);
  return launch_attributes(tick_config<false>(rows, kk, warps),
                           k >= 0 && tick_warps_ok<false>(kk, warps), out,
                           name, cap);
}

// Resident blocks per SM, warps per block (streams at one warp a stream;
// the same block at every W) and registers per thread of the launch for
// k edge lanes and j node slots, into out[0..2]; returns the cudaError_t
// (0 on success).
REPRO_EXPORT int stream_tick_residency(int k, int j, int* out) {
  return tick_residency<false>(k, j, out);
}

// Launch `warps` warps (1, 2, 4 or 8) per stream row on `stream`; returns
// the launch's cudaError_t (0 on success), cudaErrorInvalidValue when the
// layout for (k, j) exceeds the card's shared memory per block or the
// warps do not divide the block's.
REPRO_EXPORT int stream_tick_launch(
    const float* q, const float* s_total, const float* s_max,
    const float* strengths, const float* node_mask, const int* senders,
    const int* receivers, const float* dw, const float* w_old,
    const float* emask, const int* nid, const float* nflag, float* dist,
    float* q_out, float* s_out, float* smax_out, float* str_out,
    float* mask_out, int rows, int n, int k, int j, int exact_smax,
    int warps, void* stream) {
  return launch_tick<false>(q, s_total, s_max, strengths, node_mask, senders,
                            receivers, dw, w_old, emask, nid, nflag, dist,
                            q_out, s_out, smax_out, str_out, mask_out,
                            EdgeStore{nullptr, nullptr, nullptr, 0}, rows, n,
                            k, j, exact_smax, warps, stream);
}
