// Block-sparse matrix-vector product y = W x on the ELL-of-blocks
// layout, the matvec of the λ_max power iteration behind FINGER-Ĥ.
//
// Replaces the TPU kernel `bsr_matvec_pallas`
// (src/repro/kernels/bsr_spmv/kernel.py:37, body `_kernel` :24). W is
//
//   values  (n_rb, max_bpr, b, b) float32, the dense blocks of each row
//           stripe in slot order (padding slots all zero, col 0);
//   col_ids (n_rb, max_bpr) int32, each slot's column-block index;
//   counts  (n_rb,) int32, the real slots of each stripe: slots
//           0 .. counts − 1 hold its blocks, the rest is padding;
//
// and x, y are (n_rb·b,) float32. `order` (n_rb,) int32 is the launch
// order of the stripes, a permutation (the wrapper gives them by
// descending count).
//
// Design. The TPU kernel keeps all of x in VMEM and issues one MXU dot
// per (b, b) block in a sequential loop over every slot. Neither carries
// over: at the paper's n = 2^18, x is 1 MB (over shared memory, but well
// inside the 50 MB L2), and a matrix-vector product has no tensor-core
// use. Here
//
//   - each stripe reads only its real slots: the loop stops at its
//     count, so the kernel moves the real blocks' bytes and never the
//     padding (on a graph of uneven stripes, half the stored bytes or
//     less);
//   - one block of 256 threads (8 warps) per row stripe; block i takes
//     stripe order[i], so the longest stripes start first and the short
//     ones fill the card's tail (the stripes hold 9–45 real slots on the
//     offline graphs); the order changes which SM runs a stripe, never
//     how the stripe sums;
//   - each warp owns b/8 rows of the stripe; a row's b values are read
//     as float4 by b/4 neighbouring lanes (b = 128: one warp, one
//     coalesced 512 B read; b = 64: a half warp, two rows per read),
//     streamed past the caches (`__ldcs`) since each block is read once;
//   - each lane reads its four x values of the slot's column block
//     through the read-only path: x stays in L2 and L1 across the
//     stripes that share it, with no barrier per slot;
//   - per slot the warp issues the loads of all its rows together
//     before any use (b/8 · 16 B a lane in flight), then each lane adds
//     its four products to a per-row register partial in slot order;
//   - after the last real slot each row's lanes reduce their partials
//     with shuffles in a fixed tree and one lane stores y.
//
// A padding slot would add exact zeros, so stopping at the count gives
// the same y, bit for bit, as summing every slot. No atomics and no
// shared memory: the same inputs give the same bits on every run.
//
// What bounds it on the H100: the bytes of the real blocks
// (4 · Σ counts · b²), their col_ids, the counts and order, x and y at
// 3.35 TB/s; 2 flops per 4-byte value, far below the card's balance
// point. At the offline phase's n = 2^18 (about 16 real blocks a
// stripe) that is 2.2 GB: 0.65 ms.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int B>
__global__ void __launch_bounds__(kThreads)
bsr_matvec_kernel(const float* __restrict__ values,
                  const int* __restrict__ col_ids,
                  const int* __restrict__ counts,
                  const int* __restrict__ order,
                  const float* __restrict__ x, float* __restrict__ y,
                  int max_bpr) {
  constexpr int kLanesPerRow = B / 4;                // float4 lanes a row
  constexpr int kRowsPerRead = 32 / kLanesPerRow;    // rows a warp read
  constexpr int kRowsPerWarp = B / kWarps;
  constexpr int kReads = kRowsPerWarp / kRowsPerRead;
  static_assert(kRowsPerWarp % kRowsPerRead == 0, "block size");

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad = lane % kLanesPerRow;  // columns 4·quad .. 4·quad + 3
  const int row0 = warp * kRowsPerWarp + lane / kLanesPerRow;
  const long long stripe = __ldg(order + blockIdx.x);
  const int count = __ldg(counts + stripe);
  const int* cols = col_ids + stripe * max_bpr;
  const float4* blocks = reinterpret_cast<const float4*>(values) +
                         stripe * max_bpr * (B * B / 4);

  float acc[kReads];
#pragma unroll
  for (int r = 0; r < kReads; ++r) acc[r] = 0.f;

  for (int k = 0; k < count; ++k) {
    const float4* blk = blocks + static_cast<long long>(k) * (B * B / 4);
    float4 v[kReads];
#pragma unroll
    for (int r = 0; r < kReads; ++r)
      v[r] = __ldcs(blk + (row0 + r * kRowsPerRead) * (B / 4) + quad);
    const long long col = __ldg(cols + k);
    const float4 xv =
        __ldg(reinterpret_cast<const float4*>(x + col * B) + quad);
#pragma unroll
    for (int r = 0; r < kReads; ++r)
      acc[r] += ((v[r].x * xv.x + v[r].y * xv.y) + v[r].z * xv.z) +
                v[r].w * xv.w;
  }

#pragma unroll
  for (int r = 0; r < kReads; ++r) {
    float s = acc[r];
    // xor offsets below kLanesPerRow stay inside the row's lane group
#pragma unroll
    for (int o = kLanesPerRow / 2; o > 0; o >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, o);
    if (quad == 0) y[stripe * B + row0 + r * kRowsPerRead] = s;
  }
}

// One block of kThreads a stripe of b rows, for b = 128 or 64; a null
// instantiation for any other b.
LaunchConfig bsr_config(long long n_rb, int b) {
  if (b == 128)
    return {reinterpret_cast<const void*>(bsr_matvec_kernel<128>),
            "bsr_matvec_kernel<128>", n_rb, kThreads, 0};
  if (b == 64)
    return {reinterpret_cast<const void*>(bsr_matvec_kernel<64>),
            "bsr_matvec_kernel<64>", n_rb, kThreads, 0};
  return {nullptr, "", n_rb, kThreads, 0};
}

}  // namespace

// y = W x on `stream` for b = 64 or 128, stripes launched in `order`;
// returns the launch error (0 on success), cudaErrorInvalidValue for any
// other b.
REPRO_EXPORT int bsr_matvec_launch(const float* values, const int* col_ids,
                                   const int* counts, const int* order,
                                   const float* x, float* y, int n_rb,
                                   int max_bpr, int b, void* stream) {
  if (n_rb <= 0) return 0;
  const LaunchConfig c = bsr_config(n_rb, b);
  if (c.fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&values, &col_ids, &counts, &order, &x, &y, &max_bpr};
  const cudaError_t launched = cudaLaunchKernel(
      c.fn, dim3(static_cast<unsigned>(c.grid)), dim3(c.block), args, 0,
      static_cast<cudaStream_t>(stream));
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

// The launch `bsr_matvec_launch` makes for n_rb stripes of b rows (which
// 0, a = n_rb, b = b), with CUDA's attributes of its instantiation
// (`launch_attributes`: out[kAttrCount], the name into `name`). Returns
// the cudaError_t of the queries, cudaErrorInvalidValue for a b it does
// not take.
REPRO_EXPORT int bsr_spmv_launch_attrs(int which, long long a, long long b,
                                       long long c, long long* out,
                                       char* name, int cap) {
  (void)c;
  const LaunchConfig cfg = bsr_config(a, static_cast<int>(b));
  if (which != 0 || cfg.fn == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_attributes(cfg, true, out, name, cap);
}
