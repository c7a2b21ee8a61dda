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
// core with no atomics and is not carried over.  Here (hist_q_common.cuh):
//   * grid (feature, chunk of rows, group of slots); a block keeps its
//     group's [MB][3] int32 histograms in shared memory and reads each row's
//     bin and leaf id once for all the group's slots;
//   * a row of a slot adds its sign-extended lattice values with
//     shared-memory integer atomicAdd; the block then adds its non-zero
//     cells to the device accumulator with integer atomicAdd;
//   * a second kernel dequantizes the accumulator into `out`.
//
// What bounds it on the H100: the bytes.  A launch reads every row's bin
// and leaf id and, for rows in the slots, three lattice bytes: at N = 2M
// rows and F = 28 (u8) about 70 MB, 21 us at 3.35 TB/s.  Blocks of one
// chunk run for all features side by side (feature is the fastest grid
// axis), so the leaf ids and lattice bytes they share come from L2 after
// the first read.  Rows crowding into few bins serialise their atomics on
// those cells.  Left for later: row lists per leaf, so that a small leaf
// does not read all N rows; packing gq and hq into one atomic (the
// reference's PACKED_TILE borrow bound); s8 tensor-core MMA on the one-hot.

#include "hist_q_common.cuh"

namespace {

__global__ void __launch_bounds__(256)
hist_q_dequant_kernel(const int* __restrict__ acc, long long total,
                      const float* __restrict__ scales,
                      float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= total) return;
  out[i] = dequant_cell(acc[i], static_cast<int>(i % 3), scales);
}

}  // namespace

// bins [F, N] (bin_bytes 1: u8, 2: u16), pw3 [3, N] int8, leaf_id [N] i32,
// slots [S] i32 (S <= 42, in groups of G a block); acc [S, F, MB, 3] int32
// scratch (zeroed here); scales [2] f32 (s_g, s_h); out [S, F, MB, 3] f32.
// rows_per_chunk is a multiple of 512 and chunks = ceil(N / rows_per_chunk).
// Returns the cudaError_t of the launches.
extern "C" int lgbt_histogram_q(const void* bins, int bin_bytes,
                                const int8_t* pw3, const int* leaf_id,
                                const int* slots, int N, int F, int S,
                                int MB, int G, int rows_per_chunk,
                                int chunks, int* acc, const float* scales,
                                float* out, cudaStream_t stream) {
  if (!q_args_ok(N, F, S, MB, G, rows_per_chunk, chunks))
    return cudaErrorInvalidValue;
  cudaError_t e = launch_q_partial(bins, bin_bytes, pw3, leaf_id, slots, N,
                                   F, S, MB, G, rows_per_chunk, chunks, acc,
                                   stream);
  if (e != cudaSuccess) return e;
  const long long total = static_cast<long long>(S) * F * MB * 3;
  const long long blocks = (total + 255) / 256;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  hist_q_dequant_kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      acc, total, scales, out);
  return static_cast<int>(cudaGetLastError());
}
