// The one body of the serving-tick kernels: one whole Algorithm-2 tick
// per stream row, over the dense node axis (`stream_tick.cu`) or over
// the sparse slot axis with the edge-store scatter (`sparse_tick.cu`).
//
// For each stream row it computes, in order:
//
//   1. the join/leave node-mask update: joins before the edge changes,
//      leaves after them;
//   2. edge gating by the post-join mask (both endpoints live and inside
//      [0, n)), and the gather of the endpoint strengths;
//   3. per-node Δs segment sums over the 2k endpoints, and the Theorem-2
//      ΔS / ΔQ / max(s + Δs) of both updates of a tick, ΔG/2 for the
//      averaged graph Ḡ and ΔG for G';
//   4. Q' / S' / s_max' with the empty-graph snap, the strength
//      carry-forward, H̃, and dist = sqrt(max(H̃(Ḡ) − ½(H̃(G) + H̃(G')), 0));
//   5. with kEdgeStore (the sparse tick), the (m,) edge store: each lane
//      that passed the gate of step 2 writes max(w_old + Δw, 0) at its
//      slot (the sentinel 2³¹−1 and any slot outside [0, m) write
//      nothing), and an emptying delta (S' ≤ 0) zeroes the whole row.
//
// The node axis is n = n_pad on the dense path and n = n_slots on the
// sparse one; nothing else about the tick changes with it.
//
// Design. The Pallas kernels build a (2k, n) one-hot, (2k, 2k) partner
// and same-endpoint matrices and, for the store, a (k, m) one-hot,
// because the TPU gathers on the MXU and scatters badly. Here one block
// of 256 threads owns one stream:
//
//   - the 2k endpoint ids, gates, strengths and masked Δw, and the j node
//     slots, sit in shared memory; endpoint strengths and mask values are
//     gathered straight from the stream's row in device memory;
//   - the valid endpoints are sorted by (node id, endpoint index) with a
//     bitonic sort in shared memory; a segment head is the first entry of
//     its id, and its thread sums the segment's Δw in endpoint order:
//     deterministic, no atomics on values. (Finding heads by scanning
//     all earlier endpoints instead costs O(k²) dependent shared-memory
//     loads per stream and is slower than the plain version; PERF.md.)
//   - the heads go into a small open-addressing table in shared memory
//     (node id → head), sized by 2k and never by n;
//   - the scalars are reduced in a fixed order (common.cuh), and every
//     thread then evaluates the Theorem-2 updates from the same totals;
//   - the (n,) strength and mask rows are streamed once: each element is
//     read, looked up in the head table, and given its final value
//     (str + Δs)·mask_after, or 0 on an empty snap; the exact s_max of
//     both updates is reduced over the final values in the same pass;
//   - the edge store is a plain indexed store: slots are unique within a
//     tick among the lanes that write (the SlotMap contract), so thread t
//     stores lane t's weight and no two threads meet.
//
// The rows are never staged in shared memory, so n and m have no
// shared-memory ceiling; shared memory grows with k and j only.
// `TickLayout` below is the one home of the shared-memory layout: the
// kernel carves its arrays from it, and `launch_tick` sizes the launch
// from it and refuses (cudaErrorInvalidValue) a layout above the card's
// per-block opt-in limit, which the `*_smem_bytes` / `*_smem_limit`
// exports let the wrappers check by name first.
//
// In place. The wrapper may pass the output rows as the input rows (the
// PyTorch counterpart of JAX's donation). Every gather from the input
// rows completes before the first write (the barriers after steps 2 and
// 3), and in step 6 each thread reads an element before it writes the
// same element; the scalars are read by every thread before the block's
// last barrier and written by thread 0 after it. In place, step 6 writes
// only the elements whose value changes (the touched nodes, the join and
// leave slots, or the whole row on an empty snap); out of place it
// writes every element. The edge store is never read in place: the
// lanes carry their old weights. Out of place its row is copied first
// and the lane stores land only after the block's last barrier, so a
// copy never overwrites a store; in place only the lanes' slots are
// written, or the whole row is zeroed on an empty snap.
//
// What bounds it on the H100: device memory. Per stream the tick must
// read the (n,) strength and mask rows (8·n bytes) and the delta
// (k·20 + j·8 bytes, plus k·4 for the edge slots), and write the rows
// (8·n bytes, and 4·m for the store) out of place or only their changed
// elements in place (plus k store slots); the arithmetic is
// O(k log² k + n·j) compares and O(k + n) flops, far below the card's
// compute peak.
#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned hash_slot(int id, int hmask) {
  return (static_cast<unsigned>(id) * 2654435761u) & static_cast<unsigned>(hmask);
}

__device__ __forceinline__ int table_find(const int* keys, const int* vals,
                                          int hmask, int id) {
  for (unsigned s = hash_slot(id, hmask);; s = (s + 1) & hmask) {
    const int key = keys[s];
    if (key == id) return vals[s];
    if (key == -1) return -1;
  }
}

// eq. (2) from the carried scalars, H̃ = 0 on an empty graph.
__device__ __forceinline__ float h_tilde(float q, float s, float s_max) {
  const float c = s > 0.f ? 1.f / s : 0.f;
  const float arg = fmaxf(2.f * c * s_max, 1e-30f);
  return s > 0.f ? -q * logf(arg) : 0.f;
}

struct Update {
  float q, s;
  bool empty;
};

// Theorem 2 for one scaled delta (f = 0.5 for ΔG/2, 1 for ΔG).
__device__ __forceinline__ Update theorem2(float q0, float s0, float c0,
                                           float d_s, float dq,
                                           float abs_moved) {
  const float s_raw = s0 + d_s;
  const bool empty = s_raw <= 1e-6f * abs_moved;
  float denom = 1.f + c0 * d_s;
  denom = fabsf(denom) > 1e-30f ? denom : 1e-30f;
  const float c_new = s_raw > 0.f ? 1.f / s_raw : 0.f;
  float q_new = (q0 - 1.f) / (denom * denom) - c_new * c_new * dq + 1.f;
  return {empty ? 1.f : q_new, empty ? 0.f : s_raw, empty};
}

// Shared memory of one block: the 8-byte sort keys first, then 4-byte
// words — six (2k,) endpoint arrays, two (j,) node-slot arrays, the
// two-array head table and a 32-float reduction scratch.
struct TickLayout {
  int two_k, j, sort_n, table_size;

  __host__ __device__ TickLayout(int k, int j_)
      : two_k(2 * k), j(j_), sort_n(2), table_size(32) {
    while (sort_n < two_k) sort_n <<= 1;          // bitonic sort length
    while (table_size < 2 * two_k) table_size <<= 1;  // load factor <= 1/2
  }

  __host__ __device__ long long bytes() const {
    return 8ll * sort_n + 4ll * (6 * two_k + 2 * j + 2 * table_size + 32);
  }
};

// The edge store of the sparse tick: the (rows, m) store in and out and
// the (rows, k) slot of each lane. Unused (null, m = 0) on the dense one.
struct EdgeStore {
  const float* in;
  const int* slot;
  float* out;
  int m;
};

template <bool kEdgeStore>
__global__ void __launch_bounds__(kThreads)
tick_kernel(const float* q, const float* s_total, const float* s_max,
            const float* strengths, const float* node_mask,
            const int* __restrict__ senders,
            const int* __restrict__ receivers,
            const float* __restrict__ dw,
            const float* __restrict__ w_old,
            const float* __restrict__ emask,
            const int* __restrict__ nid,
            const float* __restrict__ nflag,
            float* dist, float* q_out, float* s_out, float* smax_out,
            float* str_out, float* mask_out, EdgeStore store, int n, int k,
            int j, int exact_smax) {
  extern __shared__ unsigned long long smem[];
  const TickLayout lay(k, j);
  const int two_k = lay.two_k, sort_n = lay.sort_n;
  const int table_size = lay.table_size, hmask = table_size - 1;
  const bool in_place = str_out == strengths;
  const long long row = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;

  unsigned long long* s_sort = smem;          // [N]  sort keys, N = sort_n
  int* s_id = reinterpret_cast<int*>(s_sort + sort_n);  // [2k] endpoint ids
  int* s_nid = s_id + two_k;                  // [j]  node-slot ids
  int* s_key = s_nid + j;                     // [T]  head table keys
  int* s_head = s_key + table_size;           // [T]  head table values
  float* s_str = reinterpret_cast<float*>(s_head + table_size);  // [2k]
  float* s_gate = s_str + two_k;              // [2k] post-join mask at id
  float* s_valid = s_gate + two_k;            // [2k] edge validity
  float* s_val = s_valid + two_k;             // [2k] Δw · validity
  float* s_ds = s_val + two_k;                // [2k] Δs at segment heads
  float* s_flag = s_ds + two_k;               // [j]  node-slot flags
  float* scratch = s_flag + j;                // [32] reduction scratch

  const float* str_row = strengths + row * n;
  const float* mask_row = node_mask + row * n;
  const float q0 = q[row], s0 = s_total[row], smax0 = s_max[row];

  // -- 1. endpoint ids and node slots into shared memory ---------------
  for (int t = tid; t < j; t += nt) {
    s_nid[t] = nid[row * j + t];
    s_flag[t] = nflag[row * j + t];
  }
  for (int t = tid; t < table_size; t += nt) s_key[t] = -1;
  for (int e = tid; e < two_k; e += nt)
    s_id[e] = e < k ? senders[row * k + e] : receivers[row * k + e - k];
  __syncthreads();

  // -- 2. gate by the post-join mask; gather endpoint strengths ---------
  for (int e = tid; e < two_k; e += nt) {
    const int id = s_id[e];
    float gate = 0.f, s = 0.f;
    if (id >= 0 && id < n) {
      float join = 0.f;
      for (int t = 0; t < j; ++t)
        if (s_nid[t] == id && s_flag[t] > 0.f) join = 1.f;
      gate = fmaxf(mask_row[id], join);
      s = str_row[id];
    }
    s_gate[e] = gate;
    s_str[e] = s;
  }
  __syncthreads();

  // -- 3. edge validity: the edge mask and both endpoints' gates --------
  for (int e = tid; e < two_k; e += nt) {
    const int ek = e < k ? e : e - k;
    const int partner = e < k ? e + k : e - k;
    const float v = emask[row * k + ek] * s_gate[e] * s_gate[partner];
    s_valid[e] = v;
    s_val[e] = dw[row * k + ek] * v;
  }
  __syncthreads();

  // -- 4. sort the valid endpoints by (node id, endpoint index) ---------
  // A bitonic sort in shared memory: log2(N)·(log2(N)+1)/2 barriers for
  // N = sort_n, every pair compared by one thread. Invalid endpoints
  // carry the largest key and sort last.
  for (int t = tid; t < sort_n; t += nt) {
    s_sort[t] = t < two_k && s_valid[t] > 0.f
        ? (static_cast<unsigned long long>(static_cast<unsigned>(s_id[t]))
           << 32) | static_cast<unsigned>(t)
        : ~0ull;
  }
  __syncthreads();
  for (int size = 2; size <= sort_n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < (sort_n >> 1); t += nt) {
        const int lo = 2 * stride * (t / stride) + t % stride;
        const int hi = lo + stride;
        const unsigned long long a = s_sort[lo], b = s_sort[hi];
        if ((a > b) == ((lo & size) == 0)) {
          s_sort[lo] = b;
          s_sort[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  // -- 5. segment heads, Δs, and the partial sums of both updates -------
  // A head is the first sorted entry of its node id (its smallest
  // endpoint index); its thread sums the segment's Δw in endpoint order,
  // so the result is the same on every run.
  float node_f = 0.f, node_h = 0.f, mx_f = -INFINITY, mx_h = -INFINITY;
  for (int p = tid; p < two_k; p += nt) {
    const unsigned long long key = s_sort[p];
    const unsigned long long id_bits = key >> 32;
    if (key == ~0ull || (p > 0 && (s_sort[p - 1] >> 32) == id_bits))
      continue;
    const int id = static_cast<int>(id_bits);
    const int e = static_cast<int>(key & 0xffffffffu);
    float ds = 0.f;
    for (int q = p; q < two_k && (s_sort[q] >> 32) == id_bits; ++q)
      ds += s_val[static_cast<int>(s_sort[q] & 0xffffffffu)];
    s_ds[e] = ds;
    for (unsigned slot = hash_slot(id, hmask);; slot = (slot + 1) & hmask) {
      if (atomicCAS(&s_key[slot], -1, id) == -1) {
        s_head[slot] = e;
        break;
      }
    }
    const float s = s_str[e], hds = 0.5f * ds;
    node_f += 2.f * s * ds + ds * ds;
    node_h += 2.f * s * hds + hds * hds;
    mx_f = fmaxf(mx_f, s + ds);
    mx_h = fmaxf(mx_h, s + hds);
  }
  float edge_f = 0.f, edge_h = 0.f, dsum = 0.f, abs_sum = 0.f;
  for (int e = tid; e < k; e += nt) {
    const float val = s_val[e], hval = 0.5f * val;
    const float wo = w_old[row * k + e];
    edge_f += 4.f * wo * val + 2.f * val * val;
    edge_h += 4.f * wo * hval + 2.f * hval * hval;
    dsum += val;
    abs_sum += fabsf(val);
  }
  node_f = block_sum(node_f, scratch);
  node_h = block_sum(node_h, scratch);
  edge_f = block_sum(edge_f, scratch);
  edge_h = block_sum(edge_h, scratch);
  dsum = block_sum(dsum, scratch);
  abs_sum = block_sum(abs_sum, scratch);
  mx_f = block_max(mx_f, scratch);
  mx_h = block_max(mx_h, scratch);

  // Every thread evaluates both updates from the same totals.
  const float c0 = s0 > 0.f ? 1.f / s0 : 0.f;
  const float d_s = 2.f * dsum, abs_moved = 2.f * abs_sum;
  const Update upd_half = theorem2(q0, s0, c0, 0.5f * d_s,
                                   node_h + edge_h, 0.5f * abs_moved);
  const Update upd_full = theorem2(q0, s0, c0, d_s, node_f + edge_f,
                                   abs_moved);

  // -- 6. stream the row once: final strengths and mask ----------------
  float rmax_f = -INFINITY, rmax_h = -INFINITY;
  for (int i = tid; i < n; i += nt) {
    const float s = str_row[i], m = mask_row[i];
    float join = 0.f, leave = 0.f;
    for (int t = 0; t < j; ++t) {
      if (s_nid[t] == i) {
        if (s_flag[t] > 0.f) join = 1.f;
        if (s_flag[t] < 0.f) leave = 1.f;
      }
    }
    const float m_joined = fmaxf(m, join);
    const float m_after = m_joined * (1.f - leave);
    const int h = table_find(s_key, s_head, hmask, i);
    const float ds = h >= 0 ? s_ds[h] : 0.f;
    const float v_full = upd_full.empty ? 0.f : (s + ds) * m_after;
    const float v_half = upd_half.empty ? 0.f : (s + 0.5f * ds) * m_joined;
    rmax_f = fmaxf(rmax_f, v_full);
    rmax_h = fmaxf(rmax_h, v_half);
    if (!in_place || v_full != s) str_out[row * n + i] = v_full;
    if (!in_place || m_after != m) mask_out[row * n + i] = m_after;
  }

  // -- 7a. the edge store's row: copied out of place, zeroed on a snap --
  const bool store_snap = !(upd_full.s > 0.f);
  if constexpr (kEdgeStore) {
    const float* ew_row = store.in + row * store.m;
    float* ewo_row = store.out + row * store.m;
    if (store_snap) {
      for (int i = tid; i < store.m; i += nt) ewo_row[i] = 0.f;
    } else if (store.out != store.in) {
      for (int i = tid; i < store.m; i += nt) ewo_row[i] = ew_row[i];
    }
  }

  float smax_f, smax_h;
  if (exact_smax) {
    smax_f = block_max(rmax_f, scratch);
    smax_h = block_max(rmax_h, scratch);
  } else {
    smax_f = upd_full.empty ? 0.f : smax0 + fmaxf(0.f, mx_f - smax0);
    smax_h = upd_half.empty ? 0.f : smax0 + fmaxf(0.f, mx_h - smax0);
  }
  // Thread 0 writes the scalars only after every thread has read them;
  // the lane stores land only after the row copy.
  __syncthreads();
  if constexpr (kEdgeStore) {
    // -- 7b. each gated lane stores its new weight at its slot ----------
    if (!store_snap) {
      float* ewo_row = store.out + row * store.m;
      for (int t = tid; t < k; t += nt) {
        if (s_valid[t] > 0.f) {
          const int slot = store.slot[row * k + t];
          if (slot >= 0 && slot < store.m)
            ewo_row[slot] = fmaxf(w_old[row * k + t] + dw[row * k + t], 0.f);
        }
      }
    }
  }
  if (tid == 0) {
    const float h_pre = h_tilde(q0, s0, smax0);
    const float h_half = h_tilde(upd_half.q, upd_half.s, smax_h);
    const float h_full = h_tilde(upd_full.q, upd_full.s, smax_f);
    const float div = h_half - 0.5f * (h_pre + h_full);
    dist[row] = sqrtf(fmaxf(div, 0.f));
    q_out[row] = upd_full.q;
    s_out[row] = upd_full.s;
    smax_out[row] = smax_f;
  }
}

// The card's per-block shared-memory limit (with the opt-in above 48 KB),
// or -1 with the CUDA error left for cudaGetLastError.
long long tick_smem_limit(int device) {
  int limit = 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return limit;
}

// Launch one block per stream row on `stream`; returns the launch's
// cudaError_t (0 on success), cudaErrorInvalidValue when the layout for
// (k, j) exceeds the card's shared memory per block.
template <bool kEdgeStore>
int launch_tick(const float* q, const float* s_total, const float* s_max,
                const float* strengths, const float* node_mask,
                const int* senders, const int* receivers, const float* dw,
                const float* w_old, const float* emask, const int* nid,
                const float* nflag, float* dist, float* q_out, float* s_out,
                float* smax_out, float* str_out, float* mask_out,
                EdgeStore store, int rows, int n, int k, int j,
                int exact_smax, void* stream) {
  if (rows <= 0) return 0;
  const long long smem = TickLayout(k, j).bytes();
  if (smem > 48 * 1024) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long limit = tick_smem_limit(device);
    if (limit < 0) return static_cast<int>(cudaGetLastError());
    if (smem > limit) return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(tick_kernel<kEdgeStore>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  tick_kernel<kEdgeStore><<<rows, kThreads, static_cast<size_t>(smem),
                            static_cast<cudaStream_t>(stream)>>>(
      q, s_total, s_max, strengths, node_mask, senders, receivers, dw, w_old,
      emask, nid, nflag, dist, q_out, s_out, smax_out, str_out, mask_out,
      store, n, k, j, exact_smax);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
