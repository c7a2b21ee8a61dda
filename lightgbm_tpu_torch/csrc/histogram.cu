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


// ---- The carry: K1's order over one shard of rows at a time ----
//
// The shard-streamed grower folds shard after shard into a histogram
// carried on the device, and the data learner's ring sends it from rank to
// rank; once the last shard is folded, the histogram is lgbt_histogram's
// over all N rows bit for bit.  K1's order of adds (hist_common.cuh)
// depends on each slot's whole list: its L rows cut into P = min(chunks,
// max(1, L / 256)) pieces, each piece into batches of 32 counted from the
// piece's first row, the pieces' partials summed in index order from the
// first (`sum_chunks`, a left fold).  So the caller gives each slot's L
// (`lengths`) before the first shard, with K1's chunk count for all N
// rows.  Shards come in row order, so a slot's ranks are folded in
// increasing order: at a shard boundary the pieces before the open one
// are complete and those after it untouched.  Folding each completed
// piece into a running prefix, in index order, gives sum_chunks's bits,
// and the carry holds only what crosses a boundary:
//   prefix   [S, F, MB, 3]  the completed pieces' left fold (the first
//                           piece's partial copied, then + each next);
//                           after the last shard, the histogram;
//   open     [S, F, MB, 3]  the open piece's partial (its full batches);
//   rank     [2, S]         the slot's rows folded so far;
//   pend_*   the rows of the slot's open batch (fewer than 32, all in the
//            open piece): bins [2, S, F, 32] i32, payload [2, S, 32, 3];
//   parity   [1]            which half of rank and pend_* the next shard
//            writes (it reads the other); the list kernel flips it, so
//            the state is these tensors alone (a hop of the data
//            learner's ring moves them as they are).
// Two launches a shard:
//   1. carry_list_kernel, grid (2048-row blocks), one pass: each row's
//      leaf id read once and compared with the slots (the first equal
//      wins); each 2048-row block's rows of each slot ranked in row
//      order (warp ballots), its offset in the slot's list taken by a
//      decoupled look-back over the blocks (a block's number is an
//      atomic ticket, so every block it waits on is running), the
//      slot's rows written to list[k * n + offset]: every slot's rows
//      of the shard in row order, without a second pass over the leaf
//      ids.  The last block to finish flips the parity, writes each
//      slot's new rank and lays out the fold's blocks: first[s], the
//      first grid row of slot s, each slot taking one row a piece its
//      ranks [R0, R1) reach (one, to move its open batch, if the shard
//      has none of its rows; none once every row is folded).
//   2. carry_fold_kernel, grid (feature, the slots' pieces): block (f, y)
//      takes piece j = y - first[s] of slot s.  Its partial starts from
//      the open piece's (the first piece, begun in an earlier shard) or
//      from +0.0.  Warps 1-7 take the piece's batches in rounds (warp w
//      batch 7r + w - 1), loads running ahead (row indices 2D rounds
//      ahead, bins and payload D ahead; lanes before R0 read the pending
//      rows); each groups its lanes by bin and sums each group in lane
//      order from +0.0 (K1's add_batch sums).  Warp 0 adds the round's
//      batch sums to the cells in batch order while the others compute
//      the next round (two buffers), so the cells see K1's adds in K1's
//      order while a shard that reaches few pieces of a large slot is
//      not left to one warp a piece walking its batches alone.  A batch
//      the shard leaves open is not added but written to the out
//      pending rows.  Then the fold, in piece order: a complete piece
//      goes into the prefix (the first piece copied), the open one into
//      `open`.  A block alone on its (slot, feature) folds its own
//      partial; otherwise each writes its partial to a per-launch
//      scratch and the last to finish (a ticket per (slot, feature))
//      folds them all in index order.
// Every ticket and look-back word is back at 0 when a launch ends (the
// last block to finish clears them), so launches on one stream may share
// them and launches that overlap may not.
//
// What bounds it: the bytes, as K1's (each leaf id once; bins and payload
// of the shard's rows in the slots; the carried state read and written
// once: 2 * 2 * S * F * MB * 12 B).  What it pays beyond them: the row
// list (written once, read once a feature), the payload read once a
// feature (from L2), the scratch partials of a shard that completes
// pieces, the look-back's serial chain of 2048-row blocks, and the
// ordered adds, one warp's chain of 7 batches a round.

namespace {

constexpr unsigned long long kLookAgg = 1ULL << 62;    // the block's own
constexpr unsigned long long kLookIncl = 2ULL << 62;   // with its prefix
constexpr unsigned long long kLookState = 3ULL << 62;

// Piece c's first rank among a slot's L rows cut into P pieces.
__device__ __forceinline__ long long piece_start(long long L, int P, int c) {
  return L * c / P;
}

// The piece of rank r < L: the last c with piece_start(c) <= r.
__device__ __forceinline__ int piece_of(long long L, int P, long long r) {
  int c = static_cast<int>(r * P / L);
  while (c + 1 < P && piece_start(L, P, c + 1) <= r) ++c;
  while (c > 0 && piece_start(L, P, c) > r) --c;
  return c;
}

__device__ __forceinline__ int pieces_of(long long L, int chunks) {
  return static_cast<int>(
      min(static_cast<long long>(chunks), max(1LL, L / kMinPiece)));
}

// The first equal slot of slot s (a repeated slot reads its rows).
__device__ __forceinline__ int first_equal(const int* slots, int s) {
  for (int k = 0; k < s; ++k)
    if (__ldg(slots + k) == __ldg(slots + s)) return k;
  return s;
}

// The list kernel's blocks: 8 warps, 8 rows a thread, 2048 rows a block
// (a quarter of K1's, so that a shard of a few ten thousand rows still
// spreads over a dozen SMs).
constexpr int kCarryListWarps = 8;
constexpr int kCarryListThreads = kCarryListWarps * 32;
constexpr int kCarryListRows = kListRounds * kCarryListThreads;

__host__ __device__ inline int carry_list_blocks(int n) {
  return (n + kCarryListRows - 1) / kCarryListRows;
}

// 1. list[k * n + e]: the shard's rows of slot k in row order; slot_len[k]
// their count; then the new parity, ranks and the fold's rows first[S +
// 1] (at most `height`).  look [S * gridDim.x] u64 and sync[0]
// (tickets), sync[1] (finished blocks) are 0 at the start and left 0.
__global__ void __launch_bounds__(kCarryListThreads)
carry_list_kernel(const int* __restrict__ leaf_id,
                  const int* __restrict__ slots, int n, int S, int chunks,
                  int height, const int* __restrict__ lengths, int* rank,
                  int* parity, int* __restrict__ list,
                  int* __restrict__ slot_len, int* __restrict__ first,
                  unsigned long long* look, int* sync) {
  constexpr int kPerSlot = kListRounds * kCarryListWarps;  // (round, warp)
  __shared__ int slot_s[kMaxSlots];
  __shared__ int cnt_s[kMaxSlots * kPerSlot];
  __shared__ int base_s[kMaxSlots];
  __shared__ int vb_s;
  __shared__ bool last_s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nb = gridDim.x;
  if (threadIdx.x == 0) vb_s = atomicAdd(sync, 1);
  if (threadIdx.x < S) slot_s[threadIdx.x] = __ldg(slots + threadIdx.x);
  __syncthreads();
  const int vb = vb_s;                 // this block's rows, by ticket
  const long long base = static_cast<long long>(vb) * kCarryListRows;
  int ks[kListRounds], rk[kListRounds];
#pragma unroll
  for (int j = 0; j < kListRounds; ++j) {   // every round's load in flight
    const long long r = base + j * kCarryListThreads + threadIdx.x;
    ks[j] = r < n ? __ldg(leaf_id + r) : 0;
  }
#pragma unroll
  for (int j = 0; j < kListRounds; ++j) {
    const long long r = base + j * kCarryListThreads + threadIdx.x;
    ks[j] = r < n ? slot_of(ks[j], slot_s, S) : -1;
    rk[j] = 0;
  }
  for (int k = 0; k < S; ++k) {        // one ballot a slot and round
#pragma unroll
    for (int j = 0; j < kListRounds; ++j) {
      const unsigned same = __ballot_sync(kFull, ks[j] == k);
      if (ks[j] == k) rk[j] = __popc(same & ((1u << lane) - 1u));
      if (lane == 0) cnt_s[k * kPerSlot + j * kCarryListWarps + warp] =
                         __popc(same);
    }
  }
  __syncthreads();
  for (int k = warp; k < S; k += kCarryListWarps) {   // the block's prefix
    int* c = cnt_s + k * kPerSlot;     // over (round, warp), 2 a lane
    constexpr int kPer = kPerSlot / 32;
    int v[kPer], sum = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      v[q] = c[lane * kPer + q];
      sum += v[q];
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += t;
    }
    int run = incl - sum;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      c[lane * kPer + q] = run;
      run += v[q];
    }
    if (lane == 31) base_s[k] = incl;  // the block's rows of slot k
  }
  __syncthreads();
  if (threadIdx.x < S) {               // the look-back, a thread a slot
    const int k = threadIdx.x;
    const int own = base_s[k];
    unsigned long long* w = look + static_cast<size_t>(k) * nb;
    int before = 0;
    if (vb > 0) {
      atomicExch(w + vb, kLookAgg | static_cast<unsigned>(own));
      for (int j = vb - 1; j >= 0;) {
        const unsigned long long x =
            *reinterpret_cast<volatile unsigned long long*>(w + j);
        const unsigned long long st = x & kLookState;
        if (st == 0) continue;         // block j has not counted yet
        before += static_cast<int>(static_cast<unsigned>(x));
        if (st == kLookIncl) break;
        --j;
      }
    }
    atomicExch(w + vb, kLookIncl | static_cast<unsigned>(before + own));
    base_s[k] = before;
    if (vb == nb - 1) slot_len[k] = before + own;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kListRounds; ++j)
    if (ks[j] >= 0) {
      const int k = ks[j];
      list[static_cast<size_t>(k) * n + base_s[k] +
           cnt_s[k * kPerSlot + j * kCarryListWarps + warp] + rk[j]] =
          static_cast<int>(base + j * kCarryListThreads + threadIdx.x);
    }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last_s = atomicAdd(sync + 1, 1) == nb - 1;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();                     // the last block: the fold's layout
  const int out = 1 - *parity;         // the half this shard writes
  if (threadIdx.x < S) {               // a thread a slot: its grid rows
    const int s = threadIdx.x;
    const int kc = first_equal(slots, s);
    const long long len = static_cast<long long>(static_cast<unsigned>(
        *reinterpret_cast<volatile unsigned long long*>(
            look + static_cast<size_t>(kc) * nb + nb - 1)));
    const long long R0 = rank[(1 - out) * S + s], R1 = R0 + len;
    const long long L = __ldg(lengths + s);
    rank[out * S + s] = static_cast<int>(R1);
    int parts = 0;
    if (R0 < L && len == 0) {
      parts = 1;                       // only its open batch moves
    } else if (R0 < L) {
      const int P = pieces_of(L, chunks);
      parts = piece_of(L, P, min(R1, L) - 1) - piece_of(L, P, R0) + 1;
    }
    base_s[s] = parts;
  }
  __syncthreads();                     // the counts read, then cleared
  if (threadIdx.x == 0) {
    int y = 0;
    for (int s = 0; s < S; ++s) {
      first[s] = y;
      y = min(height, y + base_s[s]);
    }
    first[S] = y;
    *parity = out;
    sync[0] = 0;
    sync[1] = 0;
  }
  for (int i = threadIdx.x; i < S * nb; i += kCarryListThreads)
    look[i] = 0ULL;
}

// Shared memory of one carry_fold_kernel block: the feature's cells [MB,
// 3] f32, each warp's lane buffer of 96 words (g, h, w) and two round
// buffers of each computing warp's batch sums [2][7][128] words.
// `ops/hist_kernel.py carry_smem_bytes` repeats it.
constexpr int kComputeWarps = kWarps - 1;
__host__ __device__ inline long long carry_smem_bytes(int MB) {
  return 12LL * MB + kWarps * 96 * 4 + 2 * kComputeWarps * 128 * 4;
}

// 2. The fold of one (feature, piece of a slot) of the shard.
template <typename BinT>
__device__ __forceinline__ void carry_fold_block(
    const BinT* __restrict__ bins, const float* __restrict__ payload,
    const int* __restrict__ list, const int* __restrict__ slot_len,
    const int* __restrict__ first, const int* __restrict__ slots, int n,
    int F, int S, int MB, int chunks, const int* __restrict__ lengths,
    const int* __restrict__ rank, int* pend_bin, float* pend_pay, int out,
    float* prefix, float* open, float* scratch, int* tickets) {
  extern __shared__ __align__(16) unsigned char smem_c[];
  float* lanes = reinterpret_cast<float*>(smem_c);     // [kWarps][96]
  float* recs = lanes + kWarps * 96;                   // [2][7][128]
  float* cells = recs + 2 * kComputeWarps * 128;       // [MB][3]
  int* ticket_s = reinterpret_cast<int*>(lanes);       // once adds end

  const int fe = blockIdx.x;
  const int y = blockIdx.y;
  if (y >= __ldg(first + S)) return;
  int s = 0;
  while (__ldg(first + s + 1) <= y) ++s;
  const int j = y - __ldg(first + s);
  const int npart = __ldg(first + s + 1) - __ldg(first + s);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kc = first_equal(slots, s);
  const long long len = __ldg(slot_len + kc);
  const int in = 1 - out;
  const long long R0 = __ldg(rank + in * S + s), R1 = R0 + len;
  const long long L = __ldg(lengths + s);
  const size_t pb_half = static_cast<size_t>(S) * F * 32;
  const int* pbi = pend_bin + in * pb_half;
  int* pbo = pend_bin + out * pb_half;
  const float* ppi = pend_pay + static_cast<size_t>(in) * S * 96;
  float* ppo = pend_pay + static_cast<size_t>(out) * S * 96;
  const size_t pbr = (static_cast<size_t>(s) * F + fe) * 32 + lane;
  const size_t ppr = (static_cast<size_t>(s) * 32 + lane) * 3;
  if (len == 0) {                      // no row here: the open batch's
    if (warp == 0) {                   // rows move to the out half
      pbo[pbr] = pbi[pbr];
      if (fe == 0) {
        ppo[ppr] = ppi[ppr];
        ppo[ppr + 1] = ppi[ppr + 1];
        ppo[ppr + 2] = ppi[ppr + 2];
      }
    }
    return;
  }
  const int P = pieces_of(L, chunks);
  const int ca = piece_of(L, P, R0);
  const int c = ca + j;
  const long long B0 = piece_start(L, P, c), B1 = piece_start(L, P, c + 1);
  const bool cont = j == 0 && R0 > B0;     // begun in an earlier shard
  const long long va = cont ? R0 - (R0 - B0) % 32 : B0;
  const long long vb = min(B1, R1);
  const bool complete = vb == B1;
  const bool open_last = !complete && (vb - B0) % 32 != 0;
  const int nbatch = static_cast<int>((vb - va + 31) / 32);
  const int nfull = open_last ? nbatch - 1 : nbatch;
  const int cells_n = MB * 3;
  const size_t cell0 = (static_cast<size_t>(s) * F + fe) * cells_n;

  for (int i = threadIdx.x; i < cells_n; i += kThreads)
    cells[i] = cont ? open[cell0 + i] : 0.f;   // the open piece's partial

  const BinT* frow = bins + static_cast<size_t>(fe) * n;
  const int* lst = list + static_cast<size_t>(kc) * n;
  const int cw = warp - 1;             // the computing warp, -1: warp 0
  float* st = lanes + warp * 96;
  auto row_of = [&](int k) {           // lane's row of round k: -1 none,
    const long long p = va + 32LL * (kComputeWarps * k + cw) + lane;
    if (cw < 0 || p >= vb) return -1;  // -2 a pending row
    if (p < R0) return -2;
    return __ldg(lst + (p - R0));
  };
  unsigned v[kAhead];
  float g[kAhead], hs[kAhead], w[kAhead];
  int ahead[kAhead];                   // rows of round k + kAhead
  auto fetch = [&](int u, int row) {
    if (row >= 0) {
      v[u] = __ldg(frow + row);
      const float* p = payload + 3LL * row;
      g[u] = __ldg(p);
      hs[u] = __ldg(p + 1);
      w[u] = __ldg(p + 2);
    } else if (row == -2) {
      v[u] = static_cast<unsigned>(pbi[pbr]);
      g[u] = ppi[ppr];
      hs[u] = ppi[ppr + 1];
      w[u] = ppi[ppr + 2];
    } else {
      v[u] = kNoBin;
      g[u] = hs[u] = w[u] = 0.f;
    }
  };
  const int rounds = (nbatch + kComputeWarps - 1) / kComputeWarps;
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    fetch(u, row_of(u));
    ahead[u] = row_of(u + kAhead);
  }
  __syncthreads();                     // the cells' first values
  for (int k0 = 0; k0 < rounds; k0 += kAhead) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int k = k0 + u;
      if (k < rounds) {                // the same for the whole block
        float* rec = recs + ((k & 1) * kComputeWarps) * 128;
        if (cw >= 0) {                 // this warp's batch of round k
          const int b = kComputeWarps * k + cw;
          unsigned bin = kNoBin;       // the lane's sums for the cells
          float sg = 0.f, sh = 0.f, sw = 0.f;
          if (b < nfull) {
            st[lane] = g[u];
            st[32 + lane] = hs[u];
            st[64 + lane] = w[u];
            const unsigned group = __match_any_sync(kFull, v[u]);
            __syncwarp();
            if (v[u] < static_cast<unsigned>(MB) &&
                __ffs(group) - 1 == lane) {   // the bin's owner
              bin = v[u];
              if (group == (1u << lane)) {
                sg += g[u];
                sh += hs[u];
                sw += w[u];
              } else {
                for (unsigned gm = group; gm; gm &= gm - 1) {  // lanes
                  const int l = __ffs(gm) - 1;                 // in order
                  sg += st[l];
                  sh += st[32 + l];
                  sw += st[64 + l];
                }
              }
            }
            __syncwarp();
          } else if (b < nbatch && va + 32LL * b + lane < vb) {
            pbo[pbr] = static_cast<int>(v[u]);   // the open batch
            if (fe == 0) {
              ppo[ppr] = g[u];
              ppo[ppr + 1] = hs[u];
              ppo[ppr + 2] = w[u];
            }
          }
          float* mine = rec + cw * 128;
          mine[lane] = sg;
          mine[32 + lane] = sh;
          mine[64 + lane] = sw;
          reinterpret_cast<unsigned*>(mine + 96)[lane] = bin;
        }
        __syncthreads();               // round k's sums are in `rec`
        if (cw < 0) {                  // warp 0: their adds, in order,
          for (int q = 0; q < kComputeWarps; ++q) {   // while the others
            const float* sq = rec + q * 128;          // compute round k+1
            const unsigned x =
                reinterpret_cast<const unsigned*>(sq + 96)[lane];
            if (x < static_cast<unsigned>(MB)) {
              float* cell = cells + 3 * x;
              cell[0] += sq[lane];
              cell[1] += sq[32 + lane];
              cell[2] += sq[64 + lane];
            }
            __syncwarp();
          }
        }
      }
      fetch(u, ahead[u]);              // round k + kAhead
      ahead[u] = row_of(k + 2 * kAhead);
    }
  }
  __syncthreads();

  if (npart == 1) {                    // alone: fold its own partial
    for (int i = threadIdx.x; i < cells_n; i += kThreads) {
      const size_t o = cell0 + i;
      if (!complete) open[o] = cells[i];
      else prefix[o] = c == 0 ? cells[i] : prefix[o] + cells[i];
    }
    return;
  }
  const size_t row0 = static_cast<size_t>(fe) * cells_n;
  const size_t stride = static_cast<size_t>(F) * cells_n;
  for (int i = threadIdx.x; i < cells_n; i += kThreads)
    scratch[y * stride + row0 + i] = cells[i];
  __threadfence();
  __syncthreads();
  const int t = s * F + fe;
  if (threadIdx.x == 0) *ticket_s = atomicAdd(tickets + t, 1);
  __syncthreads();
  if (*ticket_s != npart - 1) return;
  __threadfence();                     // the last: fold in piece order
  const int y0 = __ldg(first + s);
  for (int i = threadIdx.x; i < cells_n; i += kThreads) {
    const size_t o = cell0 + i;
    float acc = prefix[o];
    for (int q = 0; q < npart; ++q) {
      const float x = __ldcg(scratch + (y0 + q) * stride + row0 + i);
      if (R1 >= piece_start(L, P, ca + q + 1))
        acc = ca + q == 0 ? x : acc + x;
      else
        open[o] = x;                   // the last piece, left open
    }
    prefix[o] = acc;
  }
  if (threadIdx.x == 0) tickets[t] = 0;
}

// tickets: one a (slot, feature), 0 at the start and left 0.  No static
// shared memory: the block's ticket reuses a lane buffer, so all of it
// is dynamic.
template <typename BinT>
__global__ void __launch_bounds__(kThreads)
carry_fold_kernel(const BinT* __restrict__ bins,
                  const float* __restrict__ payload,
                  const int* __restrict__ list,
                  const int* __restrict__ slot_len,
                  const int* __restrict__ first,
                  const int* __restrict__ slots, int n, int F, int S,
                  int MB, int chunks, const int* __restrict__ lengths,
                  const int* __restrict__ rank, int* pend_bin,
                  float* pend_pay, const int* parity, float* prefix,
                  float* open, float* scratch, int* tickets) {
  carry_fold_block<BinT>(bins, payload, list, slot_len, first, slots, n, F,
                         S, MB, chunks, lengths, rank, pend_bin, pend_pay,
                         __ldg(parity), prefix, open, scratch, tickets);
}

// The carry's launch: 1 <= S <= 14 slots, F features, the fold's grid (F,
// height) within CUDA's limits, a block's shared memory within 227 KB.
inline bool carry_args_ok(int n, int F, int S, int MB, int bin_bytes,
                          int chunks, int height) {
  if (n <= 0 || F <= 0 || S <= 0 || S > kMaxSlots || MB <= 0) return false;
  if (bin_bytes != 1 && bin_bytes != 2) return false;
  if (chunks < 1 || height < 1 || height > 65535) return false;
  return carry_smem_bytes(MB) <= kSmemMax;
}

template <typename BinT>
cudaError_t launch_carry_fold_t(const void* bins, const float* payload,
                                const int* list, const int* slot_len,
                                const int* first, const int* slots, int n,
                                int F, int S, int MB, int chunks, int height,
                                const int* lengths, const int* rank,
                                int* pend_bin, float* pend_pay,
                                const int* parity, float* prefix,
                                float* open, float* scratch, int* tickets,
                                cudaStream_t stream) {
  auto kernel = carry_fold_kernel<BinT>;
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
  kernel<<<dim3(F, height), kThreads,
           static_cast<int>(carry_smem_bytes(MB)), stream>>>(
      static_cast<const BinT*>(bins), payload, list, slot_len, first, slots,
      n, F, S, MB, chunks, lengths, rank, pend_bin, pend_pay, parity, prefix,
      open, scratch, tickets);
  return cudaGetLastError();
}

}  // namespace

// One shard's fold: bins [F, n] (bin_bytes 1 or 2), payload [n, 3] f32
// and leaf_id [n] i32 are the shard's rows, the next in row order; slots
// [S] i32; chunks K1's for all N rows (`launch_plan(N, F, S, MB)`);
// height the fold's grid rows, at least the pieces the shard's rows of
// every slot can reach (`ops/hist_kernel.py carry_height`); scratch the
// per-launch scratch (`carry_scratch_ints`: the list [S * n] i32, the
// counts [S], the fold's rows [S + 1], the partials [height, F, MB, 3]
// f32 from an even offset); sync the stream's words (`carry_sync_ints`:
// the look-back [S * ceil(n / 2048)] u64, the list's ticket and finished
// blocks, a ticket a (slot, feature)), 0 between launches; lengths [S]
// i32; the state: rank [2, S] i32, pend_bin [2, S, F, 32] i32, pend_pay
// [2, S, 32, 3] f32, parity [1] i32, prefix and open [S, F, MB, 3] f32.
// Returns the cudaError_t of the launches.
extern "C" int lgbt_histogram_carry(const void* bins, int bin_bytes,
                                    const float* payload, const int* leaf_id,
                                    const int* slots, int n, int F, int S,
                                    int MB, int chunks, int height,
                                    int* scratch, int* sync,
                                    const int* lengths, int* rank,
                                    int* pend_bin, float* pend_pay,
                                    int* parity, float* prefix, float* open,
                                    cudaStream_t stream) {
  if (!carry_args_ok(n, F, S, MB, bin_bytes, chunks, height))
    return cudaErrorInvalidValue;
  const int nb = carry_list_blocks(n);
  int* list = scratch;
  int* slot_len = scratch + static_cast<size_t>(S) * n;
  int* first = slot_len + S;
  float* partials = reinterpret_cast<float*>(
      scratch + ((static_cast<size_t>(S) * n + 2 * S + 2) & ~size_t{1}));
  unsigned long long* look = reinterpret_cast<unsigned long long*>(sync);
  int* words = sync + 2 * static_cast<size_t>(S) * nb;
  carry_list_kernel<<<nb, kCarryListThreads, 0, stream>>>(
      leaf_id, slots, n, S, chunks, height, lengths, rank, parity, list,
      slot_len, first, look, words);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = bin_bytes == 1
          ? launch_carry_fold_t<uint8_t>(
                bins, payload, list, slot_len, first, slots, n, F, S, MB,
                chunks, height, lengths, rank, pend_bin, pend_pay, parity,
                prefix, open, partials, words + 2, stream)
          : launch_carry_fold_t<uint16_t>(
                bins, payload, list, slot_len, first, slots, n, F, S, MB,
                chunks, height, lengths, rank, pend_bin, pend_pay, parity,
                prefix, open, partials, words + 2, stream);
  return static_cast<int>(e);
}
