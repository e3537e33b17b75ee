// One whole Algorithm-2 serving tick per sparse stream: the fused JSdist
// tick over the n_slots slot axis, plus the (m_pad,) edge-store scatter.
//
// Replaces the TPU kernels `sparse_tick_pallas` and
// `sparse_tick_pallas_stacked` (src/repro/kernels/sparse_tick/kernel.py
// :195 and :251, body `_kernel` :54); the stacked (S, B) form is the
// same kernel over S·B rows. It is the dense tick's body over the slot
// axis (tick_kernel.cuh, instantiated with the edge store): where the
// Pallas kernel scatters into the store through a (k, m_pad) one-hot,
// each lane that passes the gate stores max(w_old + Δw, 0) at its slot
// with one plain store, since slots are unique within a tick; a warp
// owns a stream and copies or zeroes its store row as float4 where the
// row is 16-byte aligned. Shared memory grows with k only; n_slots and
// m_pad have no ceiling.
//
// What bounds it on the H100: device memory, as for the dense tick, plus
// the store: read the (n_slots,) strength and mask rows and the delta
// with its slots; write the changed strength and mask elements and the
// k store slots in place, or both rows and the (m_pad,) store out of
// place.
#include "tick_kernel.cuh"

// Dynamic shared memory one block (up to 8 streams) needs for k edge
// lanes and j node slots (`TickLayout`, the dense tick's layout; it
// grows with k only).
REPRO_EXPORT long long sparse_tick_smem_bytes(int k, int j) {
  return TickLayout(k).bytes();
}

// The card's per-block shared-memory limit (with the opt-in above 48 KB),
// or -1 with the CUDA error left for cudaGetLastError.
REPRO_EXPORT long long sparse_tick_smem_limit(int device) {
  return smem_optin_limit(device);
}

// The launch `sparse_tick_launch` makes for `rows` streams, k edge lanes and
// j node slots, with CUDA's attributes of its instantiation
// (`launch_attributes`: out[kAttrCount], the name into `name`). `which`
// is 0, the one kernel family here; j does not change the launch
// (shared memory grows with k only). Returns the cudaError_t of the
// queries.
REPRO_EXPORT int sparse_tick_launch_attrs(int which, long long rows,
                                          long long k, long long j,
                                          long long* out, char* name, int cap) {
  (void)which;
  (void)j;
  return launch_attributes(tick_config<true>(rows, static_cast<int>(k), 1),
                           k >= 0, out, name, cap);
}

// Resident blocks per SM, streams (warps) per block and registers per
// thread of the launch for k edge lanes and j node slots, into out[0..2];
// returns the cudaError_t (0 on success).
REPRO_EXPORT int sparse_tick_residency(int k, int j, int* out) {
  return tick_residency<true>(k, j, out);
}

// Launch one warp per stream row on `stream`; returns the launch's
// cudaError_t (0 on success), cudaErrorInvalidValue when the layout for
// (k, j) exceeds the card's shared memory per block. `ew_out` may be
// `edge_weights` (in place), as `str_out` may be `strengths`.
REPRO_EXPORT int sparse_tick_launch(
    const float* q, const float* s_total, const float* s_max,
    const float* strengths, const float* node_mask,
    const float* edge_weights, const int* senders, const int* receivers,
    const float* dw, const float* w_old, const float* emask,
    const int* edge_slots, const int* nid, const float* nflag, float* dist,
    float* q_out, float* s_out, float* smax_out, float* str_out,
    float* mask_out, float* ew_out, int rows, int n, int m, int k, int j,
    int exact_smax, void* stream) {
  return launch_tick<true>(q, s_total, s_max, strengths, node_mask, senders,
                           receivers, dw, w_old, emask, nid, nflag, dist,
                           q_out, s_out, smax_out, str_out, mask_out,
                           EdgeStore{edge_weights, edge_slots, ew_out, m},
                           rows, n, k, j, exact_smax, 1, stream);
}
