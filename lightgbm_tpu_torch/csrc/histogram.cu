// Multi-leaf histogram: per-(slot, feature, bin) sums of (g*w, h*w, w).
//
// Replaces the TPU kernel `lightgbm_tpu/ops/pallas_hist.py:
// _hist_kernel_multi` (K1, driven by `_run_kernel_multi`).  Contract: for
// bins [F, N] (u8, or u16 past 256 bins), payload [N, 3] f32, leaf_id [N]
// i32 and slots [S] i32, out[s, f, b, c] is the sum of payload[r, c] over
// the rows r with leaf_id[r] == slots[s] and bins[f, r] == b.  The kernel
// decides itself which rows count; a slot that matches no row gives zeros.
// The TPU kernel's 3-term bf16 split of the payload and its one-hot matmul
// work around a matrix unit with no atomics and are not carried over: the
// sums here are plain f32 adds.
//
// Run-to-run reproducibility is part of the contract (streaming and
// distributed training compare models byte for byte), so no float atomic
// whose order can vary is used, in global or in shared memory.  The first
// stage (hist_common.cuh, shared with the fused kernel K2 in
// fused_split.cu, so its histogram is this one's) lists each slot's rows
// in row order from one read of the leaf ids, then builds one partial
// histogram per (chunk, slot, feature) from a piece of that list, with one
// warp the only writer of each (slot, feature) histogram and the sums of
// the lanes holding one bin added in lane order; hist_reduce_kernel
// (hist_common.cuh, K2's too) sums each cell's chunk partials in index
// order (`sum_chunks`).
// hist_common.cuh's header states the order of every add; it is fixed by
// the inputs and the chunk count, so two launches on the same inputs give
// the same bits, and `ops/hist_kernel.py histogram_multi_ordered` gives
// them on the CPU.  The kernels only add, so FMA contraction cannot change
// a bit and -fmad stays at its default.
//
// What bounds it on the H100: the bytes.  A call reads every row's leaf
// id and the bins and payload of the rows in the slots, and writes the
// histogram: at N = 2M rows and F = 28 u8, one slot holding every row,
// about 88 MB, 26 us at 3.35 TB/s; at a leaf of 1% of the rows 8.7 MB.
// The first stage reads no bins or payload of rows outside the slots and
// loops over the listed rows, not over N; the row list and the chunk
// partials are its overhead.
//
// Bins >= MB are skipped (out of contract; the plain version would raise).

#include "hist_common.cuh"

// bins [F, N] (bin_bytes 1: u8, 2: u16), payload [N, 3] f32, leaf_id [N]
// i32, slots [S] i32; Fg and chunks the launch plan of `ops/
// hist_kernel.py launch_plan` (partial_args_ok); rowbuf the row scratch
// (N + S * ceil(N / 8192) + S + 1 i32); ticket one i32, 0 between
// launches; work [chunks, S, F, MB, 3] f32 scratch; out [S, F, MB, 3]
// f32.  Returns the cudaError_t of the
// launches.
extern "C" int lgbt_histogram(const void* bins, int bin_bytes,
                              const float* payload, const int* leaf_id,
                              const int* slots, int N, int F, int S, int MB,
                              int Fg, int chunks, int* rowbuf, int* ticket,
                              float* work, float* out, cudaStream_t stream) {
  if (!partial_args_ok(N, F, S, MB, bin_bytes, Fg, chunks))
    return cudaErrorInvalidValue;
  cudaError_t e = launch_first_stage(bins, bin_bytes, payload, leaf_id,
                                     slots, N, F, S, MB, Fg, chunks, rowbuf,
                                     ticket, work, stream);
  if (e != cudaSuccess) return e;
  return static_cast<int>(launch_reduce(work, chunks, N, S, F, MB, slots,
                                        rowbuf, out, stream));
}
