// The accumulation stage of the quantized multi-leaf histogram, shared by
// the K4 kernel (`histogram_q.cu`) and the fused quantized histogram+split
// kernel K5 (`fused_split.cu`), so that K5's histogram is K4's bit for bit.
//
// The stage is three launches (`launch_q_first_stage`), the design of the
// f32 stage of K1 and K2 (hist_common.cuh) with integer cells:
//   1. row_count_kernel<42> (hist_common.cuh), grid (8192-row blocks):
//      each row's leaf id is read once and compared with the S <= 42
//      slots (the first equal slot wins; a repeated slot reads its first
//      occurrence's rows); counts per (slot, block), their exclusive
//      prefix by the last block, each slot's start.
//   2. row_list_kernel<42, lattice>, same grid: every slot's rows in row
//      order, one slot after the other, and beside each listed row its
//      three int8 lattice values (gq, hq, w) packed into one word, read
//      from pw3 [3, N] for the rows in the slots only.
//   3. hist_q_partial_kernel, grid (slot x group of features, chunk), 8
//      warps a block, up to four blocks an SM: a slot's L listed rows are
//      cut into P = min(chunks, max(1, L / 256)) pieces, chunk c < P takes
//      piece c; warp w adds feature w of the block's group over the whole
//      piece, 32 listed rows (a batch) at a time, its loads running ahead
//      in registers (the row indices 2D batches ahead, the bins and
//      lattice words D ahead).  Each lane adds its row's sign-extended
//      gq, hq and w (when not zero) to the bin's int32 cells in shared
//      memory with plain integer atomicAdd.  The block writes its [Fg, MB,
//      3] int32 histograms to the workspace [chunks, S, F, MB, 3].
// The second stage sums a cell's pieces (`sum_q_chunks`) and dequantizes
// it (`dequant_cell`): K4's hist_q_reduce_kernel (`histogram_q.cu`), or
// K5's dequant_scan_kernel before its scan (`fused_split.cu`).
//
// Integer addition is associative, so neither the order of the shared-
// memory atomics nor the cut into pieces can change a bit: two launches
// give the same sums, and the same as any plain integer sum.  No
// device-memory atomic and no memset: each piece's partial is written
// whole, and only the pieces a slot has are read back.  int32 is exact
// while |sum| < 2^31: with the lattice's |gq|, hq <= 15 and w <= 1, up to
// 143M rows (the wrapper refuses more).  Bins >= MB are skipped.
//
// What bounds it: bytes.  A launch must read every row's leaf id, and
// the bins and three lattice bytes of the rows in the slots, and write
// the histograms: at the 2M x 28 u8 root 70 MB, 21 us at 3.35 TB/s; at a
// leaf of 1% of the rows 8.6 MB.  What the design does about it: the
// leaf ids are read once for all slots and features; the histogram
// kernel's trip count follows the rows in the slots, not N, and it reads
// the bins of listed rows only and the lattice as one coalesced word a
// listed row.  What it pays: the row list and lattice words (written and
// read once a feature, from L1 or L2 after the first), one int32 partial
// per (piece, slot, feature) written and read back, and the shared-memory
// atomics of rows that share a bin.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_common.cuh"

namespace {

constexpr int kQMaxSlots = 42;      // MULTI_CHUNK_Q, slots a launch

// Shared memory of one hist_q_partial_kernel block: the [Fg][MB][3]
// int32 histograms.  `ops/hist_kernel_q.py q_smem_bytes` repeats it.
__host__ __device__ inline long long q_partial_smem_bytes(int Fg, int MB) {
  return static_cast<long long>(Fg) * MB * 12;
}

// The listed rows' lattice words: after the row list's slot_start.
__host__ __device__ inline unsigned* lattice_list_of(int* rowbuf, int N,
                                                     int S) {
  return reinterpret_cast<unsigned*>(slot_start_of(rowbuf, N, S) + S + 1);
}

// One lane's row: bin v (kNoBin or >= MB: none) and lattice word pw.
__device__ __forceinline__ void add_q(int* h, unsigned v, unsigned pw,
                                      int MB) {
  if (v >= static_cast<unsigned>(MB)) return;
  const int g = static_cast<signed char>(pw & 0xFFu);
  const int hs = static_cast<signed char>((pw >> 8) & 0xFFu);
  const int w = static_cast<signed char>((pw >> 16) & 0xFFu);
  int* c = h + 3 * v;
  if (g) atomicAdd(c, g);
  if (hs) atomicAdd(c + 1, hs);
  if (w) atomicAdd(c + 2, w);
}

// 3. The int32 histograms of one (slot, group of features) over one piece
// of the slot's listed rows.
template <typename BinT>
__global__ void __launch_bounds__(kThreads, 4)
hist_q_partial_kernel(const BinT* __restrict__ bins,
                      const unsigned* __restrict__ lat,
                      const int* __restrict__ list,
                      const int* __restrict__ slot_start,
                      const int* __restrict__ slots, int N, int F, int S,
                      int MB, int Fg, int* __restrict__ work) {
  extern __shared__ int hist_q[];      // [fn][MB][3]
  const int nfg = (F + Fg - 1) / Fg;
  const int s = blockIdx.x / nfg;
  const int f0 = (blockIdx.x % nfg) * Fg;
  const int fn = min(Fg, F - f0);
  const int chunk = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const SlotRows x = slot_rows(slots, slot_start, s, gridDim.y);
  if (chunk >= x.pieces) return;       // the slot has fewer pieces
  const long long p0 = x.start + x.len * chunk / x.pieces;
  const long long p1 = x.start + x.len * (chunk + 1) / x.pieces;
  const int nbatch = static_cast<int>((p1 - p0 + 31) / 32);
  const int cells = MB * 3;

  for (int i = threadIdx.x; i < fn * cells; i += kThreads) hist_q[i] = 0;
  __syncthreads();

  if (warp < fn) {                     // warp w adds feature f0 + w
    const BinT* frow = bins + static_cast<size_t>(f0 + warp) * N;
    int* h = hist_q + warp * cells;
    auto entry = [&](int b) { return p0 + 32LL * b + lane; };
    auto row_of = [&](int b) {         // lane's listed row of batch b
      const long long e = entry(b);
      return e < p1 ? __ldg(list + e) : -1;
    };
    unsigned v[kAhead], pw[kAhead];
    int ahead[kAhead];                 // rows of batch b + kAhead
    auto fetch = [&](int u, int b, int row) {
      v[u] = row >= 0 ? static_cast<unsigned>(__ldg(frow + row)) : kNoBin;
      pw[u] = row >= 0 ? __ldg(lat + entry(b)) : 0u;
    };
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      fetch(u, u, row_of(u));
      ahead[u] = row_of(u + kAhead);
    }
    for (int b0 = 0; b0 < nbatch; b0 += kAhead) {
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        add_q(h, v[u], pw[u], MB);     // past the piece: kNoBin, skipped
        fetch(u, b0 + u + kAhead, ahead[u]);
        ahead[u] = row_of(b0 + u + 2 * kAhead);
      }
    }
  }
  __syncthreads();

  int* dst = work + (static_cast<size_t>(chunk) * S + s) *
                        static_cast<size_t>(F) * cells +
             static_cast<size_t>(f0) * cells;
  for (int i = threadIdx.x; i < fn * cells; i += kThreads) dst[i] = hist_q[i];
}

// The launch plan both entry points validate alike (`ops/hist_kernel_q.py
// launch_plan_q` makes it): 1 <= S <= 42 slots, F features in groups of Fg
// (at most one a warp), 1 to 65535 chunks, and the block's shared memory
// within the 227 KB an H100 block can have.
inline bool q_args_ok(int N, int F, int S, int MB, int bin_bytes, int Fg,
                      int chunks) {
  if (N <= 0 || F <= 0 || S <= 0 || S > kQMaxSlots || MB <= 0) return false;
  if (bin_bytes != 1 && bin_bytes != 2) return false;
  if (Fg < 1 || Fg > F || Fg > kWarps) return false;
  if (chunks < 1 || chunks > 65535) return false;
  return q_partial_smem_bytes(Fg, MB) <= kSmemMax;
}

template <typename BinT>
cudaError_t launch_q_partial_t(const void* bins, const unsigned* lat,
                               const int* list, const int* slot_start,
                               const int* slots, int N, int F, int S, int MB,
                               int Fg, int chunks, int* work,
                               cudaStream_t stream) {
  auto kernel = hist_q_partial_kernel<BinT>;
  const int smem = static_cast<int>(q_partial_smem_bytes(Fg, MB));
  static bool opted_in = false;        // the 227 KB opt-in, once
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  kernel<<<dim3(S * ((F + Fg - 1) / Fg), chunks), kThreads, smem,
           stream>>>(static_cast<const BinT*>(bins), lat, list, slot_start,
                     slots, N, F, S, MB, Fg, work);
  return cudaGetLastError();
}

// The whole first stage, after q_args_ok: the row list and the listed
// rows' lattice words in rowbuf (N + S * list_blocks(N) + S + 1 + N ints),
// then the int32 partials in work [chunks, S, F, MB, 3].  ticket as
// launch_row_lists's.
inline cudaError_t launch_q_first_stage(const void* bins, int bin_bytes,
                                        const int8_t* pw3,
                                        const int* leaf_id, const int* slots,
                                        int N, int F, int S, int MB, int Fg,
                                        int chunks, int* rowbuf, int* ticket,
                                        int* work, cudaStream_t stream) {
  unsigned* lat = lattice_list_of(rowbuf, N, S);
  cudaError_t e = launch_row_lists<kQMaxSlots, true>(
      leaf_id, slots, N, S, rowbuf, ticket, pw3, lat, stream);
  if (e != cudaSuccess) return e;
  const int* slot_start = slot_start_of(rowbuf, N, S);
  if (bin_bytes == 1)
    return launch_q_partial_t<uint8_t>(bins, lat, rowbuf, slot_start, slots,
                                       N, F, S, MB, Fg, chunks, work, stream);
  return launch_q_partial_t<uint16_t>(bins, lat, rowbuf, slot_start, slots,
                                      N, F, S, MB, Fg, chunks, work, stream);
}

// Cell i's int32 sum over the first `pieces` partials of work [chunks,
// total], their loads issued kReduceUnroll at a time.  Any order gives
// the same integer.
__device__ __forceinline__ int sum_q_chunks(const int* __restrict__ work,
                                            int pieces, long long total,
                                            long long i) {
  int acc = work[i];
  int c = 1;
  for (; c + kReduceUnroll <= pieces; c += kReduceUnroll) {
    int v[kReduceUnroll];
#pragma unroll
    for (int u = 0; u < kReduceUnroll; ++u) v[u] = work[(c + u) * total + i];
#pragma unroll
    for (int u = 0; u < kReduceUnroll; ++u) acc += v[u];
  }
  for (; c < pieces; ++c) acc += work[c * total + i];
  return acc;
}

// One cell's dequantized value: the int32 sum converted to f32 (round to
// nearest), times s_g (channel 0) or s_h (channel 1); the count unscaled.
// __fmul_rn is never contracted, whatever -fmad says.
__device__ __forceinline__ float dequant_cell(int v, int ch,
                                              const float* scales) {
  const float x = __int2float_rn(v);
  return ch < 2 ? __fmul_rn(x, __ldg(scales + ch)) : x;
}

}  // namespace
