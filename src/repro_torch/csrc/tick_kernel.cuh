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
// because the TPU gathers on the MXU and scatters badly. Here W warps own
// one stream (W = 1, 2, 4 or 8; always 1 with the edge store), and a
// block of up to 8 warps holds up to 8/W streams. A stream's work is a
// prologue, a chain of dependent steps with little data (about 11 KB at
// the serving size), then one pass over its (n,) rows. With W = 1 a warp
// synchronises with `__syncwarp` and shuffles only: no block barrier, so
// a stream never waits on another. With W > 1 the stream's first warp
// runs the prologue (steps 1–3: node slots, gates, sort, segment heads,
// the eight sums and both updates) and publishes the count of sorted keys
// and both updates in the stream's second slice (`Published`); the W
// warps meet at one barrier (`__syncthreads` when they are the whole
// block, else their group's named barrier over W·32 threads); then each
// warp streams a contiguous 1/W of the row in whole row steps, merging
// from the first sorted head whose id falls in its slice (a binary search
// of the ≤ 2k keys) through its own 32-float scratch. With the exact
// s_max the W partial maxima meet in shared memory after a second
// barrier, and the first warp writes the scalars. The sums stay in one
// warp's fixed xor tree, every row element comes from the same formula
// and s_max is a max, so every W gives the same bits.
//
// W comes from the launch's shape alone (`warps_per_stream` in
// kernels/stream_tick/ops.py): 1 when the rows fill the card's resident
// warps C (blocks an SM × SMs × warps a block: 4 × 132 × 8 = 4,224 on the
// H100 at the serving layouts), else the largest W with rows · W ≤ C that
// still leaves each warp a whole row step (32 · kRowSteps elements).
//
//   - Edges in chunks of 32, one a lane (coalesced loads): the two
//     endpoints' gates (the mask gathered from the row, joins from the
//     node slots broadcast by shuffles), the edge's validity and Δw, its
//     part of the edge sums, and two sort keys (node id << 32 | endpoint
//     index), the largest key for an invalid endpoint.
//   - The keys are sorted by the warp's bitonic network (warp_sort.cuh,
//     shared with delta_stats.cu). Up to 256 keys (k ≤ 128, the serving
//     size) they stay in registers, up to 8 a lane: compare-exchanges
//     inside a lane and `__shfl_xor_sync` across lanes. Above that the
//     warp sorts its slice of shared memory. Either way the order is
//     (node id, endpoint index) and the sorted keys land in the slice.
//   - A segment head (the first key of its id) sums its segment's Δw in
//     endpoint order, by one lane, and keeps the sum in its key's low
//     word; the node sums of both updates follow from it.
//   - The eight scalar reductions are warp shuffles in a fixed xor tree:
//     every lane ends with the same bits, and two launches agree.
//   - The (n,) strength and mask rows are streamed once, 32 elements a
//     step, four steps of loads in flight. The j node slots sit in
//     registers (slot t in lane t; more than 32 are read again from the
//     delta), and a step's join and leave bits are two `__reduce_or_sync`.
//     A step's Δs come from merging it against the sorted heads: a
//     pointer walks the keys, and the heads whose ids fall in the step
//     pass their Δs through a 32-float scratch. The exact s_max of both
//     updates is reduced over the final values in the same pass.
//   - A stream whose every endpoint is gated off (every lane masked, or
//     all on dead nodes) skips the sort and the Δs work; it still streams
//     the row for the exact s_max, the joins and leaves, and the copy out
//     of place.
//   - The edge store is a plain indexed store: slots are unique within a
//     tick among the lanes that write (the SlotMap contract), so lane t
//     stores its edges' weights and no two lanes meet.
//
// The rows are never staged in shared memory, so n and m have no
// shared-memory ceiling; shared memory grows with k only (keys, Δw,
// validity bits, scratch; about 2.6 KB a stream at k = 128). `TickLayout`
// below is the one home of the shared-memory layout: the kernel carves
// each warp's slice from it, and `tick_config` sizes the launch from it
// (the instantiation, warps and streams a block, bytes a block, the same
// at every W) for `launch_tick`,
// which refuses (cudaErrorInvalidValue) a layout above the card's
// per-block opt-in limit, which the `*_smem_bytes` / `*_smem_limit`
// exports let the wrappers check by name first. The `*_launch_attrs`
// exports report `tick_config`'s launch with CUDA's attributes of the
// instantiation (registers, spills, shared memory, blocks an SM), and
// `tick_residency` the resident blocks and warps per SM and the
// registers a thread.
//
// In place. The wrapper may pass the output rows as the input rows (the
// PyTorch counterpart of JAX's donation). Every gather from the input
// rows (steps 1–3) completes before the `__syncwarp` (W = 1) or the
// stream's barrier (W > 1) that precedes the row pass, and in the row
// pass each lane reads an element before it writes the same element (the
// W warps' slices of the row are disjoint); every warp reads the scalars
// before that barrier, and lane 0 of the first warp writes them after it
// and after its warp's last `__syncwarp`. In place, the row pass writes
// only the elements whose value changes (the touched nodes, the join and
// leave slots, or the whole row on an empty snap); out of place it
// writes every element.
// The edge store is never read in place: the lanes carry their old
// weights. Out of place its row is copied first and the lane stores land
// only after a `__syncwarp`, so a copy never overwrites a store; in
// place only the lanes' slots are written, or the whole row is zeroed on
// an empty snap.
//
// What bounds it on the H100: device memory. Per stream the tick must
// read the (n,) strength and mask rows (8·n bytes) and the delta
// (k·20 + j·8 bytes, plus k·4 for the edge slots), and write the rows
// (8·n bytes, and 4·m for the store) out of place or only their changed
// elements in place (plus k store slots); the arithmetic is
// O(k log² k + n) compares and O(k + n) flops, far below the card's
// compute peak. A stream's chain of dependent steps, not its bytes, set
// the time of a block-per-stream design (6 streams resident on an SM, each
// waiting on about 60 block barriers); this design's aim is enough
// streams in flight (32 on an SM at the serving size) for the chains to
// overlap. The row pass is bound by the loads in flight: a warp keeps
// kRowSteps steps of both rows in flight, 4 × 2 × 32 × 4 B = 1 KB, and
// at a loaded latency of about 1 µs the card's 3.35 TB/s needs some
// 3–4 MB in flight. 524,288 streams keep 32 warps resident on every SM
// (4,224 warps, about 4.2 MB, 80–83 % of the bandwidth); 512 long rows
// at W = 1 keep 512 warps (about 0.5 MB, 15 %), and at W = 8 4,096
// warps (about 4 MB) in 512 blocks, all resident in one wave.
#pragma once

#include "warp_sort.cuh"

namespace {

constexpr int kMaxStreams = 8;                 // warps (slices) a block
constexpr int kThreads = 32 * kMaxStreams;
constexpr long long kBlockSmemTarget = 96 * 1024;
constexpr int kRowSteps = 4;                   // row steps of loads in flight

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

// Shared memory of one warp (its slice): the sort keys, the (k,) masked
// Δw, one validity word per 32 edges and a 32-float scratch (the node
// slots take none); and how many warps share a block, each a stream at
// W = 1. A block takes as many slices as fit in kBlockSmemTarget (at
// most 8, at least 1), so the largest layouts still put two blocks on an
// SM. At W > 1 only a stream's first slice holds keys, Δw and validity;
// every warp keeps its own scratch, and the second slice's keys hold the
// `Published` record.
struct TickLayout {
  int sort_n, words;
  long long stream_bytes;
  int streams;

  __host__ __device__ explicit TickLayout(int k) : sort_n(sort_length(k)) {
    words = (k + 31) / 32;
    stream_bytes = (8ll * sort_n + 4ll * k + 4ll * words + 4ll * 32 + 15) &
                   ~15ll;
    const long long fit = kBlockSmemTarget / stream_bytes;
    streams = fit < 1 ? 1 : (fit > kMaxStreams ? kMaxStreams : int(fit));
  }

  // Dynamic shared memory of one block.
  __host__ __device__ long long bytes() const {
    return streams * stream_bytes;
  }
  // Keys a lane holds in registers, or 0 for the shared-memory sort.
  __host__ __device__ int keys_per_lane() const {
    return lane_keys(sort_n);
  }
};

// What a stream's first warp hands its other warps at W > 1 (before the
// first barrier: the count of sorted keys and both updates), and where
// each warp leaves its row maxima (before the second). It lies in the
// key area of the stream's second slice, at least 64 keys long.
struct Published {
  int n_valid;
  Update half, full;
  float rmax[2 * kMaxStreams];
};
static_assert(sizeof(Published) <= 8 * 64, "Published outgrows a slice");

// The barrier of one stream's W warps: the block's when they are the
// whole block, else the named barrier of their group (barrier 0 is the
// block's) over W·32 threads.
__device__ __forceinline__ void stream_sync(int group, int warps,
                                            bool whole_block) {
  if (whole_block)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(32 * warps)
                 : "memory");
}

// The edge store of the sparse tick: the (rows, m) store in and out and
// the (rows, k) slot of each lane. Unused (null, m = 0) on the dense one.
struct EdgeStore {
  const float* in;
  const int* slot;
  float* out;
  int m;
};

// The join and leave bits of the 32 node ids [c, c + 32): bit i is set
// when a node slot with id c + i has a positive (join) or negative
// (leave) flag. Slots 0–31 come from the registers (lane t holds slot
// t); any others are read from the delta.
__device__ __forceinline__ void slot_bits(int c, int my_nid, float my_flag,
                                          const int* nid_row,
                                          const float* nflag_row, int j,
                                          int lane, unsigned& join,
                                          unsigned& leave) {
  unsigned off = static_cast<unsigned>(my_nid) - static_cast<unsigned>(c);
  bool in = lane < j && off < 32u;
  join = __reduce_or_sync(kFull, in && my_flag > 0.f ? 1u << off : 0u);
  leave = __reduce_or_sync(kFull, in && my_flag < 0.f ? 1u << off : 0u);
  for (int g = 32; g < j; g += 32) {
    const int t = g + lane;
    const int id = t < j ? nid_row[t] : -1;
    const float f = t < j ? nflag_row[t] : 0.f;
    off = static_cast<unsigned>(id) - static_cast<unsigned>(c);
    in = t < j && off < 32u;
    join |= __reduce_or_sync(kFull, in && f > 0.f ? 1u << off : 0u);
    leave |= __reduce_or_sync(kFull, in && f < 0.f ? 1u << off : 0u);
  }
}

// Whether nodes `a` and `b` join in this delta (a slot with the id and a
// positive flag), for one edge a lane; slots broadcast from the
// registers (0–31) or read from the delta.
__device__ __forceinline__ void joins(int a, int b, int my_nid,
                                      float my_flag, const int* nid_row,
                                      const float* nflag_row, int j,
                                      bool& ja, bool& jb) {
  ja = jb = false;
  const int head = j < 32 ? j : 32;
  for (int t = 0; t < head; ++t) {
    const int sid = __shfl_sync(kFull, my_nid, t);
    const bool on = __shfl_sync(kFull, my_flag, t) > 0.f;
    ja |= on && sid == a;
    jb |= on && sid == b;
  }
  for (int t = 32; t < j; ++t) {
    const bool on = nflag_row[t] > 0.f;
    ja |= on && nid_row[t] == a;
    jb |= on && nid_row[t] == b;
  }
}

// Per-stream partial sums of the edge lanes and of the segment heads.
struct Sums {
  float node_f = 0.f, node_h = 0.f, edge_f = 0.f, edge_h = 0.f;
  float dsum = 0.f, abs_sum = 0.f, mx_f = -INFINITY, mx_h = -INFINITY;
};

// kSplit: the instantiation for W > 1 warps a stream (`warps`); without
// it W is 1 and `warps` is not read, so the one-warp kernel carries none
// of the split's registers, spills or named barriers.
template <bool kEdgeStore, int KPL, bool kSplit = false>
__global__ void __launch_bounds__(kThreads, 4)
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
            float* str_out, float* mask_out, EdgeStore store, int rows,
            int n, int k, int j, int exact_smax, int warps) {
  extern __shared__ unsigned long long smem[];
  const TickLayout lay(k);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  static_assert(!(kEdgeStore && kSplit), "the sparse tick is not split");
  // W warps a stream, consecutive in the block; the first (part 0) runs
  // the prologue
  const int wps = kSplit ? warps : 1;
  const int part = warp & (wps - 1), group = warp / wps;
  const int per_block = lay.streams / wps;
  const long long row = static_cast<long long>(blockIdx.x) * per_block +
                        group;
  if (row >= rows) return;  // a whole stream: no barrier waits on it
  const int sort_n = lay.sort_n, words = lay.words;
  const long long slice = lay.stream_bytes / 8;
  unsigned long long* s_key = smem + (warp - part) * slice;  // [N]
  float* s_val = reinterpret_cast<float*>(s_key + sort_n);   // [k] Δw·valid
  unsigned* s_vbits = reinterpret_cast<unsigned*>(s_val + k);  // [words]
  float* s_scratch = reinterpret_cast<float*>(s_vbits + words) +
                     2 * slice * part;  // [32], the warp's own
  Published* pub = reinterpret_cast<Published*>(s_key + slice);  // W > 1
  const bool whole_block = per_block == 1;
  const bool in_place = str_out == strengths;

  const float* str_row = strengths + row * n;
  const float* mask_row = node_mask + row * n;
  const int* nid_row = nid + row * j;
  const float* nflag_row = nflag + row * j;
  const float q0 = q[row], s0 = s_total[row], smax0 = s_max[row];

  // -- node slots 0–31 in registers; whether any slot is active --------
  int my_nid = -1;
  float my_flag = 0.f;
  if (lane < j) {
    my_nid = nid_row[lane];
    my_flag = nflag_row[lane];
  }
  bool any_join = __any_sync(kFull, my_flag > 0.f);
  bool any_slot = __any_sync(kFull, my_flag != 0.f);
  for (int g = 32; g < j; g += 32) {
    const float f = g + lane < j ? nflag_row[g + lane] : 0.f;
    any_join |= __any_sync(kFull, f > 0.f);
    any_slot |= __any_sync(kFull, f != 0.f);
  }

  // -- edges, 32 a chunk: gates, validity, Δw, edge sums, sort keys ----
  const long long dl = row * k;
  int n_valid = 0;
  float mx_f = -INFINITY, mx_h = -INFINITY;
  Update upd_half{}, upd_full{};
  if (part == 0) {
    Sums acc;
    auto edge = [&](int i, unsigned long long& key_s,
                    unsigned long long& key_r) {
      const int ek = 32 * i + lane;
      float val = 0.f, valid = 0.f;
      int s = -1, r = -1;
      if (ek < k) {
        s = senders[dl + ek];
        r = receivers[dl + ek];
      }
      bool js = false, jr = false;
      if (any_join)
        joins(s, r, my_nid, my_flag, nid_row, nflag_row, j, js, jr);
      if (ek < k) {
        // a masked lane gathers nothing: its validity is 0 whatever the gates
        const float em = emask[dl + ek];
        const bool gather = em != 0.f;
        const float g_s = gather && s >= 0 && s < n
                              ? fmaxf(mask_row[s], js ? 1.f : 0.f) : 0.f;
        const float g_r = gather && r >= 0 && r < n
                              ? fmaxf(mask_row[r], jr ? 1.f : 0.f) : 0.f;
        valid = em * g_s * g_r;
        val = dw[dl + ek] * valid;
        const float hval = 0.5f * val, wo = w_old[dl + ek];
        acc.edge_f += 4.f * wo * val + 2.f * val * val;
        acc.edge_h += 4.f * wo * hval + 2.f * hval * hval;
        acc.dsum += val;
        acc.abs_sum += fabsf(val);
        s_val[ek] = val;
      }
      const bool ok = valid > 0.f;
      const unsigned vb = __ballot_sync(kFull, ok);
      if (lane == 0 && i < words) s_vbits[i] = vb;
      n_valid += 2 * __popc(vb);
      key_s = ok ? (static_cast<unsigned long long>(static_cast<unsigned>(s))
                    << 32) | static_cast<unsigned>(ek)
                 : kNoKey;
      key_r = ok ? (static_cast<unsigned long long>(static_cast<unsigned>(r))
                    << 32) | static_cast<unsigned>(k + ek)
                 : kNoKey;
    };

    if constexpr (KPL > 0) {
      unsigned long long key[KPL];
#pragma unroll
      for (int i = 0; i < KPL / 2; ++i) edge(i, key[2 * i], key[2 * i + 1]);
      if (n_valid > 0) {
        warp_sort<KPL>(key, lane);
#pragma unroll
        for (int r = 0; r < KPL; ++r) s_key[lane * KPL + r] = key[r];
      }
    } else {
      for (int i = 0; i < words; ++i) {
        unsigned long long a, b;
        edge(i, a, b);
        const int ek = 32 * i + lane;
        if (ek < k) {
          s_key[2 * ek] = a;
          s_key[2 * ek + 1] = b;
        }
      }
      if (n_valid > 0) {
        for (int p = 2 * k + lane; p < sort_n; p += 32) s_key[p] = kNoKey;
        __syncwarp();
        warp_sort_shared(s_key, sort_n, lane);
      }
    }
    __syncwarp();

    // -- segment heads: Δs in endpoint order, the node sums ---------------
    // A head is the first sorted key of its id (its smallest endpoint
    // index); its lane sums the segment's Δw in endpoint order and keeps
    // the sum in the key's low word (only the high word, the id, is read
    // by the other lanes).
    for (int base = 0; base < n_valid; base += 32) {
      const int p = base + lane;
      if (p >= n_valid) continue;
      const unsigned long long key = s_key[p];
      const unsigned id = static_cast<unsigned>(key >> 32);
      if (p > 0 && static_cast<unsigned>(s_key[p - 1] >> 32) == id) continue;
      float ds = 0.f;
      for (int q = p; q < n_valid; ++q) {
        const unsigned long long kq = s_key[q];
        if (static_cast<unsigned>(kq >> 32) != id) break;
        const int e = static_cast<int>(kq & 0xffffffffu);
        ds += s_val[e < k ? e : e - k];
      }
      reinterpret_cast<unsigned*>(s_key + p)[0] = __float_as_uint(ds);
      const float s = str_row[id], hds = 0.5f * ds;
      acc.node_f += 2.f * s * ds + ds * ds;
      acc.node_h += 2.f * s * hds + hds * hds;
      acc.mx_f = fmaxf(acc.mx_f, s + ds);
      acc.mx_h = fmaxf(acc.mx_h, s + hds);
    }
    const float node_f = warp_sum(acc.node_f), node_h = warp_sum(acc.node_h);
    const float edge_f = warp_sum(acc.edge_f), edge_h = warp_sum(acc.edge_h);
    const float dsum = warp_sum(acc.dsum), abs_sum = warp_sum(acc.abs_sum);
    mx_f = warp_max(acc.mx_f);
    mx_h = warp_max(acc.mx_h);

    // Every lane evaluates both updates from the same totals.
    const float c0 = s0 > 0.f ? 1.f / s0 : 0.f;
    const float d_s = 2.f * dsum, abs_moved = 2.f * abs_sum;
    upd_half = theorem2(q0, s0, c0, 0.5f * d_s, node_h + edge_h,
                        0.5f * abs_moved);
    upd_full = theorem2(q0, s0, c0, d_s, node_f + edge_f, abs_moved);
  }
  // every gather and head sum of the stream before the first write
  if (wps > 1) {
    if (part == 0 && lane == 0) {
      pub->n_valid = n_valid;
      pub->half = upd_half;
      pub->full = upd_full;
    }
    stream_sync(group, wps, whole_block);
    if (part != 0) {
      n_valid = pub->n_valid;
      upd_half = pub->half;
      upd_full = pub->full;
    }
  } else {
    __syncwarp();
  }

  // -- stream the warp's slice [lo, hi) of the row once: final strengths
  //    and mask; whole row steps, the last slice ragged ----------------
  int lo = 0, hi = n;
  if (wps > 1) {
    constexpr int step = 32 * kRowSteps;
    const int span = ((n + wps - 1) / wps + step - 1) / step * step;
    lo = min(n, part * span);
    hi = min(n, lo + span);
  }
  float rmax_f = -INFINITY, rmax_h = -INFINITY;
  int ptr = 0;  // the first sorted key not yet merged
  if (lo > 0) {  // the first key whose id lies in the slice (a head)
    for (int len = n_valid; len > 0;) {
      const int half = len >> 1;
      if (static_cast<unsigned>(s_key[ptr + half] >> 32) <
          static_cast<unsigned>(lo)) {
        ptr += half + 1;
        len -= half + 1;
      } else {
        len = half;
      }
    }
  }
  unsigned next_id = ptr < n_valid
                         ? static_cast<unsigned>(s_key[ptr] >> 32)
                         : 0xffffffffu;
  for (int first = lo; first < hi; first += 32 * kRowSteps) {
    float sv[kRowSteps], mv[kRowSteps];
#pragma unroll
    for (int u = 0; u < kRowSteps; ++u) {
      const int i = first + 32 * u + lane;
      sv[u] = i < hi ? str_row[i] : 0.f;
      mv[u] = i < hi ? mask_row[i] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kRowSteps; ++u) {
      const int c = first + 32 * u;
      if (c >= hi) break;
      const int i = c + lane;
      unsigned jbits = 0u, lbits = 0u;
      if (any_slot)
        slot_bits(c, my_nid, my_flag, nid_row, nflag_row, j, lane, jbits,
                  lbits);
      float ds = 0.f;
      while (next_id < static_cast<unsigned>(c + 32)) {
        const int p = ptr + lane;
        const unsigned long long key = p < n_valid ? s_key[p] : kNoKey;
        const unsigned id = static_cast<unsigned>(key >> 32);
        const bool in = p < n_valid && id < static_cast<unsigned>(c + 32);
        const bool head =
            in && (p == 0 || static_cast<unsigned>(s_key[p - 1] >> 32) != id);
        if (head) s_scratch[id - c] = __uint_as_float(
            static_cast<unsigned>(key & 0xffffffffu));
        const unsigned present =
            __reduce_or_sync(kFull, head ? 1u << (id - c) : 0u);
        ptr += __popc(__ballot_sync(kFull, in));
        __syncwarp();
        if ((present >> lane) & 1u) ds = s_scratch[lane];
        next_id = ptr < n_valid ? static_cast<unsigned>(s_key[ptr] >> 32)
                                : 0xffffffffu;
        __syncwarp();
      }
      const float s = sv[u], m = mv[u];
      const float join = static_cast<float>((jbits >> lane) & 1u);
      const float leave = static_cast<float>((lbits >> lane) & 1u);
      const float m_joined = fmaxf(m, join);
      const float m_after = m_joined * (1.f - leave);
      const float v_full = upd_full.empty ? 0.f : (s + ds) * m_after;
      const float v_half = upd_half.empty ? 0.f
                                          : (s + 0.5f * ds) * m_joined;
      if (i < hi) {
        rmax_f = fmaxf(rmax_f, v_full);
        rmax_h = fmaxf(rmax_h, v_half);
        if (!in_place || v_full != s) str_out[row * n + i] = v_full;
        if (!in_place || m_after != m) mask_out[row * n + i] = m_after;
      }
    }
  }

  // -- the edge store's row: copied out of place, zeroed on a snap; then
  //    each gated lane stores its new weight at its slot ----------------
  const bool store_snap = !(upd_full.s > 0.f);
  if constexpr (kEdgeStore) {
    const float* ew_row = store.in + row * store.m;
    float* ewo_row = store.out + row * store.m;
    const bool vec = (store.m & 3) == 0 &&
        ((reinterpret_cast<size_t>(ew_row) |
          reinterpret_cast<size_t>(ewo_row)) & 15) == 0;
    if (store_snap || store.out != store.in) {
      if (vec) {
        const float4* src = reinterpret_cast<const float4*>(ew_row);
        float4* dst = reinterpret_cast<float4*>(ewo_row);
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int i = lane; i < (store.m >> 2); i += 32)
          dst[i] = store_snap ? zero : src[i];
      } else {
        for (int i = lane; i < store.m; i += 32)
          ewo_row[i] = store_snap ? 0.f : ew_row[i];
      }
    }
    __syncwarp();  // the lane stores land after the copy
    if (!store_snap) {
      for (int i = 0; i < words; ++i) {
        const int ek = 32 * i + lane;
        if (ek < k && ((s_vbits[i] >> lane) & 1u)) {
          const int slot = store.slot[dl + ek];
          if (slot >= 0 && slot < store.m)
            ewo_row[slot] = fmaxf(w_old[dl + ek] + dw[dl + ek], 0.f);
        }
      }
    }
  }

  float smax_f, smax_h;
  if (exact_smax) {
    smax_f = warp_max(rmax_f);
    smax_h = warp_max(rmax_h);
    if (wps > 1) {  // the maxima of the stream's W slices
      if (lane == 0) {
        pub->rmax[2 * part] = smax_f;
        pub->rmax[2 * part + 1] = smax_h;
      }
      stream_sync(group, wps, whole_block);
      for (int w = 0; w < wps; ++w) {
        smax_f = fmaxf(smax_f, pub->rmax[2 * w]);
        smax_h = fmaxf(smax_h, pub->rmax[2 * w + 1]);
      }
    }
  } else {
    smax_f = upd_full.empty ? 0.f : smax0 + fmaxf(0.f, mx_f - smax0);
    smax_h = upd_half.empty ? 0.f : smax0 + fmaxf(0.f, mx_h - smax0);
  }
  if (part != 0) return;
  __syncwarp();  // every lane has read the scalars
  if (lane == 0) {
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

// Whether a stream may take `warps` warps at the layout for k: 1 always;
// 2, 4 or 8 on the dense tick where they divide the block's warps.
template <bool kEdgeStore>
bool tick_warps_ok(int k, int warps) {
  if (warps == 1) return true;
  if (kEdgeStore || (warps != 2 && warps != 4 && warps != 8)) return false;
  return TickLayout(k).streams % warps == 0;
}

// The instantiations' names as the source spells them: the dense tick,
// the sparse tick and the split dense tick, by keys a lane 0, 2, 4, 8.
constexpr const char* kTickNames[3][4] = {
    {"tick_kernel<false, 0>", "tick_kernel<false, 2>",
     "tick_kernel<false, 4>", "tick_kernel<false, 8>"},
    {"tick_kernel<true, 0>", "tick_kernel<true, 2>", "tick_kernel<true, 4>",
     "tick_kernel<true, 8>"},
    {"tick_kernel<false, 0, true>", "tick_kernel<false, 2, true>",
     "tick_kernel<false, 4, true>", "tick_kernel<false, 8, true>"}};

template <bool kEdgeStore, bool kSplit>
void tick_instantiation(int keys_per_lane, LaunchConfig& c) {
  const char* const* names = kTickNames[kSplit ? 2 : kEdgeStore ? 1 : 0];
  switch (keys_per_lane) {
    case 2:
      c.fn = reinterpret_cast<const void*>(tick_kernel<kEdgeStore, 2, kSplit>);
      c.name = names[1];
      break;
    case 4:
      c.fn = reinterpret_cast<const void*>(tick_kernel<kEdgeStore, 4, kSplit>);
      c.name = names[2];
      break;
    case 8:
      c.fn = reinterpret_cast<const void*>(tick_kernel<kEdgeStore, 8, kSplit>);
      c.name = names[3];
      break;
    default:
      c.fn = reinterpret_cast<const void*>(tick_kernel<kEdgeStore, 0, kSplit>);
      c.name = names[0];
  }
}

// The instantiation for a layout: keys in registers (2, 4 or 8 a lane)
// or the shared-memory sort, split or not; `warps` warps a stream (1
// where `tick_warps_ok` refuses it), lay.streams warps and
// lay.streams / warps streams a block, and the layout's dynamic shared
// memory, whatever the warps.
template <bool kEdgeStore>
LaunchConfig tick_config(long long rows, int k, int warps) {
  const TickLayout lay(k);
  const bool split = warps > 1 && tick_warps_ok<kEdgeStore>(k, warps);
  const int per_block = lay.streams / (split ? warps : 1);
  LaunchConfig c{nullptr, nullptr, (rows + per_block - 1) / per_block,
                 32 * lay.streams, lay.bytes()};
  if constexpr (kEdgeStore)
    tick_instantiation<true, false>(lay.keys_per_lane(), c);
  else if (split)
    tick_instantiation<false, true>(lay.keys_per_lane(), c);
  else
    tick_instantiation<false, false>(lay.keys_per_lane(), c);
  return c;
}

// Resident blocks per SM (from cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// streams per block and registers per thread of the launch for (k, j),
// into out[0..2]; returns the cudaError_t.
template <bool kEdgeStore>
int tick_residency(int k, int j, int* out) {
  long long attrs[kAttrCount];
  char name[32];
  const int err = launch_attributes(tick_config<kEdgeStore>(1, k, 1), true,
                                    attrs, name, sizeof(name));
  if (err != 0) return err;
  if (!attrs[kAttrAccepted]) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = static_cast<int>(attrs[kAttrBlocksPerSm]);
  out[1] = TickLayout(k).streams;
  out[2] = static_cast<int>(attrs[kAttrRegs]);
  return 0;
}

// Launch `warps` warps per stream row, lay.streams / warps rows a block,
// on `stream`; returns the launch's cudaError_t (0 on success),
// cudaErrorInvalidValue when the layout for (k, j) exceeds the card's
// shared memory per block or `tick_warps_ok` refuses the warps.
template <bool kEdgeStore>
int launch_tick(const float* q, const float* s_total, const float* s_max,
                const float* strengths, const float* node_mask,
                const int* senders, const int* receivers, const float* dw,
                const float* w_old, const float* emask, const int* nid,
                const float* nflag, float* dist, float* q_out, float* s_out,
                float* smax_out, float* str_out, float* mask_out,
                EdgeStore store, int rows, int n, int k, int j,
                int exact_smax, int warps, void* stream) {
  if (!tick_warps_ok<kEdgeStore>(k, warps))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0) return 0;
  const LaunchConfig c = tick_config<kEdgeStore>(rows, k, warps);
  const cudaError_t err = prepare_launch(c);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&q, &s_total, &s_max, &strengths, &node_mask, &senders,
                  &receivers, &dw, &w_old, &emask, &nid, &nflag, &dist,
                  &q_out, &s_out, &smax_out, &str_out, &mask_out, &store,
                  &rows, &n, &k, &j, &exact_smax, &warps};
  const cudaError_t launched = cudaLaunchKernel(
      c.fn, dim3(static_cast<unsigned>(c.grid)), dim3(c.block), args,
      static_cast<size_t>(c.smem), static_cast<cudaStream_t>(stream));
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
