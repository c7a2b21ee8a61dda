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
// whose order can vary is used, in global or in shared memory:
//   * grid (feature, chunk of rows, slot), 8 warps a block; each warp owns a
//     fixed sub-range of the chunk's rows and a private [MB][3] histogram
//     in shared memory;
//   * per 32 rows, lanes holding the same bin (rows outside the slot hold
//     none) are grouped with __match_any_sync; the group's lowest lane sums
//     the group's values in lane order from a per-warp staging buffer and
//     adds the sum to the warp's histogram, so no two lanes touch one cell;
//   * the block sums its warps' histograms in warp order and writes one
//     partial per chunk to the workspace [chunks, S, F, MB, 3]; a second
//     kernel sums the chunks in index order.
// The first stage lives in hist_common.cuh: the fused kernel K2
// (fused_split.cu) runs the same code, so its histogram is this one's.
// Every add happens in an order fixed by the inputs' shapes, so two
// launches on the same inputs give the same bits.  The kernel only adds,
// so FMA contraction cannot change a bit and -fmad stays at its default.
//
// What bounds it on the H100: the bytes.  Each call reads every row's bin,
// leaf id and (for rows in the slot) payload: at N = 2M rows and F = 28
// about 88 MB, 26 us at 3.35 TB/s.  Blocks of one chunk run for all
// features side by side (feature is the fastest grid axis), so the leaf
// ids and payload a chunk's blocks share come from L2 after the first
// read.  The group loop is serial in the group's size, so a feature whose
// rows crowd into few bins costs more issue slots.  Left for later: row
// partitions that skip rows outside the leaf, wider loads, wgmma/TMA.
//
// Bins >= MB are skipped (out of contract; the plain version would raise).

#include "hist_common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
hist_reduce_kernel(const float* __restrict__ work, int chunks,
                   long long total, float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= total) return;
  float acc = work[i];
  for (int c = 1; c < chunks; ++c) acc += work[c * total + i];
  out[i] = acc;
}

}  // namespace

// bins [F, N] (bin_bytes 1: u8, 2: u16), payload [N, 3] f32, leaf_id [N]
// i32, slots [S] i32; work [chunks, S, F, MB, 3] f32 scratch; out
// [S, F, MB, 3] f32.  rows_per_chunk is a multiple of 256 and chunks =
// ceil(N / rows_per_chunk).  Returns the cudaError_t of the launches.
extern "C" int lgbt_histogram(const void* bins, int bin_bytes,
                              const float* payload, const int* leaf_id,
                              const int* slots, int N, int F, int S, int MB,
                              int rows_per_chunk, int chunks, float* work,
                              float* out, cudaStream_t stream) {
  if (!partial_args_ok(N, F, S, MB, rows_per_chunk, chunks))
    return cudaErrorInvalidValue;
  cudaError_t e = launch_partial(bins, bin_bytes, payload, leaf_id, slots, N,
                                 F, S, MB, rows_per_chunk, chunks, work,
                                 stream);
  if (e != cudaSuccess) return e;
  const long long total = static_cast<long long>(S) * F * MB * 3;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  hist_reduce_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      work, chunks, total, out);
  return static_cast<int>(cudaGetLastError());
}
