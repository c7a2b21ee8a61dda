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

// ---- The carry: one shard's rows added to int32 cells, one launch ----
//
// The shard-streamed grower folds shard after shard into int32 cells
// carried on the device, and dequantizes them once, after the last shard.
// Integer adds are exact in any order, so neither the cut into shards and
// tiles nor the order of the atomics below can change a bit: the finalized
// carry is lgbt_histogram_q's over all N rows bit for bit, and two runs
// give the same bits (int32 stays exact while the carried sums do, the
// wrapper's MAX_ROWS_Q over all N).  K4's row list exists only to give
// its f32 twin an order; the integer carry needs none, so a shard is one
// launch with no row list and no workspace:
//   carry_q_kernel, grid (tile of rows x group of slots x group of
//   features), a cluster of C blocks of one (slot group, feature group)
//   over consecutive tiles.  A block reads its tile's leaf ids straight
//   (every row's, four rows a thread in flight), and for each row in one
//   of its slots (each slot matched on its own, as K4's plain version)
//   the three lattice bytes and the bins of its features, adding gq, hq
//   and w (when not zero) into the slot's int32 cells [Sb, Fg, MB, 3] in
//   shared memory with shared-memory integer atomics, as K4 does.  Then
//   the cluster sums its blocks' cells over distributed shared memory,
//   each block a C-th of the cells, and adds the nonzero sums to the
//   carried cells [S, F, MB, 3] with global integer atomics (red.add).
//   C = 1 (`launch_plan_carry_q`: a single tile) adds a block's cells
//   alone.
// The bins of rows outside the slots are not read (one leaf id decides);
// a 32-byte sector holds 32 rows' u8 bins, so the skipped ones save
// little.
//
// What bounds it: the bytes.  Every leaf id of the shard, the bins and
// three lattice bytes of its rows in the slots, the carried cells read
// and written once (2 * S * F * MB * 12 B).  What it pays beyond them:
// the leaf ids and lattice bytes read again by each feature group (from
// L2), and the tiles' cells summed: C blocks' over distributed shared
// memory, then one global atomic a nonzero cell per cluster.

#include <cooperative_groups.h>

namespace {

constexpr int kQTileUnroll = 4;       // rows of a thread in flight

// The cells of a (slot group, feature group) over one tile of rows, then
// their cluster sum added to carry.
template <typename BinT>
__global__ void __launch_bounds__(kThreads)
carry_q_kernel(const BinT* __restrict__ bins, const int8_t* __restrict__ pw3,
               const int* __restrict__ leaf_id,
               const int* __restrict__ slots, int n, int F, int S, int MB,
               int Sb, int Fg, int tiles, int tile_rows, int cluster,
               int* __restrict__ carry) {
  extern __shared__ int cells_q[];     // [Sb][Fg][MB][3], then slots [Sb]
  int* slot_s = cells_q + static_cast<size_t>(Sb) * Fg * MB * 3;
  const int nfg = (F + Fg - 1) / Fg;
  const int t = blockIdx.x % tiles;
  const int combo = blockIdx.x / tiles;
  const int s0 = (combo / nfg) * Sb, sn = min(Sb, S - s0);
  const int f0 = (combo % nfg) * Fg, fn = min(Fg, F - f0);
  const int per_slot = fn * MB * 3;
  const int ncells = sn * per_slot;
  for (int i = threadIdx.x; i < ncells; i += kThreads) cells_q[i] = 0;
  if (threadIdx.x < sn) slot_s[threadIdx.x] = __ldg(slots + s0 + threadIdx.x);
  __syncthreads();

  const long long lo = static_cast<long long>(t) * tile_rows;
  const long long hi = min(static_cast<long long>(n), lo + tile_rows);
  for (long long r0 = lo + threadIdx.x; r0 < hi;
       r0 += kQTileUnroll * kThreads) {
    int lid[kQTileUnroll];
#pragma unroll
    for (int u = 0; u < kQTileUnroll; ++u) {
      const long long r = r0 + u * kThreads;
      lid[u] = r < hi ? __ldg(leaf_id + r) : 0;
    }
#pragma unroll
    for (int u = 0; u < kQTileUnroll; ++u) {
      const long long r = r0 + u * kThreads;
      unsigned long long m = 0;        // the slots of the row
      if (r < hi)
        for (int k = 0; k < sn; ++k)
          if (slot_s[k] == lid[u]) m |= 1ULL << k;
      if (!m) continue;
      const int g = __ldg(pw3 + r);
      const int hq = __ldg(pw3 + n + r);
      const int w = __ldg(pw3 + 2LL * n + r);
      for (int f = 0; f < fn; ++f) {
        const unsigned b = __ldg(bins + static_cast<size_t>(f0 + f) * n + r);
        if (b >= static_cast<unsigned>(MB)) continue;
        for (unsigned long long mm = m; mm; mm &= mm - 1) {
          int* c = cells_q + (__ffsll(static_cast<long long>(mm)) - 1) *
                                 per_slot + (f * MB + b) * 3;
          if (g) atomicAdd(c, g);
          if (hq) atomicAdd(c + 1, hq);
          if (w) atomicAdd(c + 2, w);
        }
      }
    }
  }

  // the cluster's sum of each cell, a C-th of the cells a block
  namespace cg = cooperative_groups;
  int q = 0;
  if (cluster > 1) {
    cg::this_cluster().sync();
    q = static_cast<int>(cg::this_cluster().block_rank());
  } else {
    __syncthreads();
  }
  const int share = (ncells + cluster - 1) / cluster;
  const int a = q * share, z = min(ncells, a + share);
  const int mb3 = MB * 3;
  for (int i = a + threadIdx.x; i < z; i += kThreads) {
    int sum = 0;
    if (cluster > 1) {
      for (int o = 0; o < cluster; ++o)
        sum += *cg::this_cluster().map_shared_rank(cells_q + i, o);
    } else {
      sum = cells_q[i];
    }
    if (sum) {
      const int k = i / per_slot, rem = i - k * per_slot;
      const int fl = rem / mb3;
      atomicAdd(carry + (static_cast<size_t>(s0 + k) * F + f0 + fl) * mb3 +
                    (rem - fl * mb3), sum);
    }
  }
  if (cluster > 1) cg::this_cluster().sync();   // keep the cells for the
}                                               // cluster's other blocks

// Shared memory of one carry_q_kernel block, all of it dynamic: the
// int32 cells [Sb, Fg, MB, 3] and the block's slots.
// `ops/hist_kernel_q.py carry_q_smem_bytes` repeats it.
inline long long carry_q_smem_bytes(int Sb, int Fg, int MB) {
  return static_cast<long long>(Sb) * Fg * MB * 12 + 4LL * Sb;
}

// The launch plan the entry validates (`ops/hist_kernel_q.py
// launch_plan_carry_q` makes it): 1 <= S <= 42 slots in groups of Sb, F
// features in groups of Fg, tiles of tile_rows covering n, a multiple of
// the cluster (1, 2, 4 or 8), and the block's cells within 227 KB.
inline bool carry_q_args_ok(int n, int F, int S, int MB, int bin_bytes,
                            int Sb, int Fg, int tiles, int tile_rows,
                            int cluster) {
  if (n <= 0 || F <= 0 || S <= 0 || S > kQMaxSlots || MB <= 0) return false;
  if (bin_bytes != 1 && bin_bytes != 2) return false;
  if (Sb < 1 || Sb > S || Fg < 1 || Fg > F) return false;
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8)
    return false;
  if (tiles < 1 || tile_rows < 1 || tiles % cluster != 0) return false;
  if (static_cast<long long>(tiles) * tile_rows < n) return false;
  const long long combos = static_cast<long long>((S + Sb - 1) / Sb) *
                           ((F + Fg - 1) / Fg);
  if (combos * tiles > 0x7FFFFFFFLL) return false;
  return carry_q_smem_bytes(Sb, Fg, MB) <= kSmemMax;
}

template <typename BinT>
cudaError_t launch_carry_q_t(const void* bins, const int8_t* pw3,
                             const int* leaf_id, const int* slots, int n,
                             int F, int S, int MB, int Sb, int Fg, int tiles,
                             int tile_rows, int cluster, int* carry,
                             cudaStream_t stream) {
  auto kernel = carry_q_kernel<BinT>;
  static bool opted_in = false;        // the 227 KB opt-in, once, less
  if (!opted_in) {                     // any static shared memory
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemMax - static_cast<int>(fa.sharedSizeBytes));
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const long long combos = static_cast<long long>((S + Sb - 1) / Sb) *
                           ((F + Fg - 1) / Fg);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(combos * tiles));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(carry_q_smem_bytes(Sb, Fg, MB));
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const BinT*>(bins),
                            pw3, leaf_id, slots, n, F, S, MB, Sb, Fg, tiles,
                            tile_rows, cluster, carry);
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

// One shard's fold: bins [F, n] (bin_bytes 1 or 2), pw3 [3, n] int8 and
// leaf_id [n] i32 are the shard's rows; slots [S] i32 (S <= 42); Sb, Fg,
// tiles, tile_rows and cluster the shard's launch plan
// (`launch_plan_carry_q(n, F, S, MB)`); carry [S, F, MB, 3] int32, added
// to.  One launch.  Returns its cudaError_t.
extern "C" int lgbt_histogram_carry_q(const void* bins, int bin_bytes,
                                      const int8_t* pw3, const int* leaf_id,
                                      const int* slots, int n, int F, int S,
                                      int MB, int Sb, int Fg, int tiles,
                                      int tile_rows, int cluster, int* carry,
                                      cudaStream_t stream) {
  if (!carry_q_args_ok(n, F, S, MB, bin_bytes, Sb, Fg, tiles, tile_rows,
                       cluster))
    return cudaErrorInvalidValue;
  cudaError_t e =
      bin_bytes == 1
          ? launch_carry_q_t<uint8_t>(bins, pw3, leaf_id, slots, n, F, S, MB,
                                      Sb, Fg, tiles, tile_rows, cluster,
                                      carry, stream)
          : launch_carry_q_t<uint16_t>(bins, pw3, leaf_id, slots, n, F, S,
                                       MB, Sb, Fg, tiles, tile_rows, cluster,
                                       carry, stream);
  if (e != cudaSuccess) return e;
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
