// Quantized multi-leaf histogram (K4): per-(slot, feature, bin) integer
// sums of the int8 gradient lattice (gq, hq, w), dequantized to f32.
//
// Replaces the TPU kernel `lightgbm_tpu/ops/pallas_hist.py:
// _hist_kernel_multi_i8` (K4, driven by `_run_kernel_multi_i8`) together
// with the dequantize of its wrapper `pallas_histogram_multi_quantized_rows`.
// Contract: for bins [F, N] (u8, or u16 past 256 bins), the lattice pw3
// [3, N] int8, leaf_id [N] i32, slots [S <= 42] i32 and scales [2] f32
// (s_g, s_h), acc[s, f, b, c] is the int32 sum of pw3[c, r] over the rows r
// with leaf_id[r] == slots[s] and bins[f, r] == b, and out[s, f, b, c] is
// float(acc) * s_g (c = 0), float(acc) * s_h (c = 1) or float(acc) (c = 2,
// the count).  The contract is bitwise: the sums are integers, so the
// order of adds cannot change them, and the dequantize is one conversion
// and one multiply in IEEE f32, as the plain version's (`ops/hist_kernel_q.py
// histogram_multi_quantized_plain`).
//
// The TPU kernel's one-hot int8 matmul on the matrix unit works around a
// core with no atomics and is not carried over.  Here, four launches:
//   * the first stage (hist_q_common.cuh): each slot's rows listed in row
//     order from one read of the leaf ids, with their lattice words; then
//     one int32 partial histogram per (piece of a slot's list, slot,
//     feature), one warp a feature adding its rows with shared-memory
//     integer atomics;
//   * hist_q_reduce_kernel: each cell's pieces summed and dequantized into
//     `out`.
// No device-memory atomic and no memset of an accumulator.
//
// What bounds it on the H100: the bytes.  A call must read every row's
// leaf id and the bins and three lattice bytes of the rows in the slots,
// and write the histogram: at N = 2M rows and F = 28 u8, one slot holding
// every row, about 70 MB, 21 us at 3.35 TB/s; at a leaf of 1% of the rows
// 8.6 MB.  The first stage reads no bins or lattice of rows outside the
// slots and loops over the listed rows, not over N; the row list, the
// lattice words and the partials are its overhead.  Left for later:
// packing gq and hq into one atomic (within the reference's PACKED_TILE
// bound); s8 tensor-core MMA on a one-hot.

#include "hist_q_common.cuh"

namespace {

// The second stage: out[i] = the dequantized sum of cell i's pieces.
__global__ void __launch_bounds__(kReduceThreads)
hist_q_reduce_kernel(const int* __restrict__ work, int chunks,
                     long long total, long long per_slot,
                     const int* __restrict__ slots,
                     const int* __restrict__ slot_start,
                     const float* __restrict__ scales,
                     float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kReduceThreads +
                      threadIdx.x;
  if (i >= total) return;
  const int s = static_cast<int>(i / per_slot);
  const int pieces = slot_rows(slots, slot_start, s, chunks).pieces;
  out[i] = dequant_cell(sum_q_chunks(work, pieces, total, i),
                        static_cast<int>(i % 3), scales);
}

}  // namespace

// bins [F, N] (bin_bytes 1: u8, 2: u16), pw3 [3, N] int8, leaf_id [N] i32,
// slots [S] i32 (S <= 42); Fg and chunks the launch plan of
// `ops/hist_kernel_q.py launch_plan_q` (q_args_ok); rowbuf the row scratch
// (2N + S * ceil(N / 8192) + S + 1 i32); ticket one i32, 0 between
// launches; work [chunks, S, F, MB, 3] int32 scratch; scales [2] f32 (s_g,
// s_h); out [S, F, MB, 3] f32.  Returns the cudaError_t of the launches.
extern "C" int lgbt_histogram_q(const void* bins, int bin_bytes,
                                const int8_t* pw3, const int* leaf_id,
                                const int* slots, int N, int F, int S,
                                int MB, int Fg, int chunks, int* rowbuf,
                                int* ticket, int* work, const float* scales,
                                float* out, cudaStream_t stream) {
  if (!q_args_ok(N, F, S, MB, bin_bytes, Fg, chunks))
    return cudaErrorInvalidValue;
  cudaError_t e = launch_q_first_stage(bins, bin_bytes, pw3, leaf_id, slots,
                                       N, F, S, MB, Fg, chunks, rowbuf,
                                       ticket, work, stream);
  if (e != cudaSuccess) return e;
  const long long per_slot = static_cast<long long>(F) * MB * 3;
  const long long total = S * per_slot;
  const long long blocks = (total + kReduceThreads - 1) / kReduceThreads;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  hist_q_reduce_kernel<<<static_cast<unsigned>(blocks), kReduceThreads, 0,
                         stream>>>(work, chunks, total, per_slot, slots,
                                   slot_start_of(rowbuf, N, S), scales, out);
  return static_cast<int>(cudaGetLastError());
}

// ---- The carry: K4's first stage over one shard of rows at a time ----
//
// The shard-streamed grower folds shard after shard into int32 cells
// carried on the device: each shard runs K4's first stage over its own
// rows (row lists, lattice words, int32 partials, with the shard's own
// launch plan) and adds its pieces' sums to the carried cells; the carry
// is dequantized once, after the last shard.  Integer sums do not depend
// on the order or the cut into shards and pieces, so the finalized carry
// is lgbt_histogram_q's over all N rows bit for bit (int32 stays exact
// while the carried sums do, the wrapper's MAX_ROWS_Q over all N).

namespace {

// carry[i] += cell i's sum over the shard's pieces of its slot.
__global__ void __launch_bounds__(kReduceThreads)
carry_q_add_kernel(const int* __restrict__ work, int chunks,
                   long long total, long long per_slot,
                   const int* __restrict__ slots,
                   const int* __restrict__ slot_start,
                   int* __restrict__ carry) {
  const long long i = static_cast<long long>(blockIdx.x) * kReduceThreads +
                      threadIdx.x;
  if (i >= total) return;
  const int s = static_cast<int>(i / per_slot);
  const int pieces = slot_rows(slots, slot_start, s, chunks).pieces;
  carry[i] += sum_q_chunks(work, pieces, total, i);
}

__global__ void __launch_bounds__(kReduceThreads)
carry_q_dequant_kernel(const int* __restrict__ carry, long long total,
                       const float* __restrict__ scales,
                       float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kReduceThreads +
                      threadIdx.x;
  if (i >= total) return;
  out[i] = dequant_cell(carry[i], static_cast<int>(i % 3), scales);
}

}  // namespace

// One shard's fold: bins [F, n], pw3 [3, n] int8 and leaf_id [n] i32 are
// the shard's rows; slots [S] i32; Fg and chunks the shard's launch plan
// (`launch_plan_q(n, F, S, MB)`); rowbuf, ticket and work as
// lgbt_histogram_q's over n rows; carry [S, F, MB, 3] int32, added to.
extern "C" int lgbt_histogram_carry_q(const void* bins, int bin_bytes,
                                      const int8_t* pw3, const int* leaf_id,
                                      const int* slots, int n, int F, int S,
                                      int MB, int Fg, int chunks,
                                      int* rowbuf, int* ticket, int* work,
                                      int* carry, cudaStream_t stream) {
  if (!q_args_ok(n, F, S, MB, bin_bytes, Fg, chunks))
    return cudaErrorInvalidValue;
  cudaError_t e = launch_q_first_stage(bins, bin_bytes, pw3, leaf_id, slots,
                                       n, F, S, MB, Fg, chunks, rowbuf,
                                       ticket, work, stream);
  if (e != cudaSuccess) return e;
  const long long per_slot = static_cast<long long>(F) * MB * 3;
  const long long total = S * per_slot;
  const long long blocks = (total + kReduceThreads - 1) / kReduceThreads;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  carry_q_add_kernel<<<static_cast<unsigned>(blocks), kReduceThreads, 0,
                       stream>>>(work, chunks, total, per_slot, slots,
                                 slot_start_of(rowbuf, n, S), carry);
  return static_cast<int>(cudaGetLastError());
}

// The carried histogram: out [S, F, MB, 3] f32, each int32 cell of carry
// dequantized as K4 does (dequant_cell: round to f32, times s_g or s_h).
extern "C" int lgbt_histogram_carry_q_finalize(const int* carry,
                                               long long total,
                                               const float* scales,
                                               float* out,
                                               cudaStream_t stream) {
  if (total <= 0) return cudaErrorInvalidValue;
  const long long blocks = (total + kReduceThreads - 1) / kReduceThreads;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  carry_q_dequant_kernel<<<static_cast<unsigned>(blocks), kReduceThreads, 0,
                           stream>>>(carry, total, scales, out);
  return static_cast<int>(cudaGetLastError());
}
