// The first stage of the multi-leaf f32 histogram, shared by the K1 kernel
// (`histogram.cu`) and the fused histogram+split kernel K2
// (`fused_split.cu`), so that K2's histogram is K1's bit for bit; and the
// sum of the chunk partials that both second stages use.
//
// The stage is three launches (`launch_first_stage`):
//   1. row_count_kernel, grid (8192-row blocks): each row's leaf id is read
//      once and compared with the S <= 14 slots (the first equal slot
//      wins); the block counts its rows of each slot.  The last block to
//      finish takes the exclusive prefix of the counts over (slot, block)
//      in that order, and each slot's start.
//   2. row_list_kernel, same grid: the row list, every slot's rows in row
//      order, one slot after the other (a row's place is its slot's and
//      block's offset plus its rank in the block, from warp ballots and
//      popc).
//   Kernels 1 and 2 (`launch_row_lists`) take the slot cap as a template
//   parameter: K1 and K2 launch the 14-slot instance, the quantized K4 and
//   K5 (hist_q_common.cuh) the 42-slot one, which also lists each row's
//   int8 lattice as one word.
//   3. hist_partial_kernel, grid (slot x group of features, chunk), 8 warps
//      a block, up to four blocks an SM.  A slot's L listed rows (a
//      repeated slot reads its first occurrence's) are cut into P =
//      min(chunks, max(1, L / 256)) pieces; chunk c < P takes the piece
//      [c * L / P, (c + 1) * L / P), the other chunks' blocks exit.  Warp w
//      of the block adds feature w of its group over the whole piece, 32
//      listed rows (a batch) at a time.  Its loads run ahead in registers:
//      the row indices of the batch 2D ahead, the bins and payload of the
//      batch D ahead (D = kAhead), so no add waits on a dependent global
//      load.  In a batch the lanes of one bin OR their lane bits into the
//      cell's group word (a shared-memory integer atomic); the group's
//      lowest lane owns it, sums the group's (g, h, w) in lane order from
//      +0.0 (from a per-warp staging buffer), adds the sums to the cell
//      and clears the word.  A (slot, feature) histogram has one
//      writing warp and no float atomic is used.  The block writes its
//      histograms to the workspace [chunks, S, F, MB, 3].
// The second stage, hist_reduce_kernel (`launch_reduce`, K1's and K2's),
// sums a cell's pieces in index order with `sum_chunks`.
//
// The fixed order of every add, for a cell (slot s, feature f, bin b):
// within each piece, the cell starts at +0.0 and adds, batch by batch
// (the piece's rows in row order, cut into batches of 32 from the piece's
// first row), the batch's rows with bin b summed in row order from +0.0;
// then the pieces' partials are summed in index order.  It depends only on
// the slot's rows and the chunk count, so two launches on the same inputs
// give the same bits, and `ops/hist_kernel.py histogram_multi_ordered`
// repeats it on the CPU.  Bins >= MB are skipped (their row still takes
// its place in a batch).  The kernels only add, so FMA contraction cannot
// change a bit.
//
// What bounds it: bytes.  A launch must read every row's leaf id (it
// cannot know which rows are in the slots otherwise) and the bins and
// payload of the rows in the slots, and write the histograms: at the
// 2M x 28 u8 root 88 MB, 26 us at 3.35 TB/s; at a leaf of 1% of the rows
// 8.7 MB.  What the design does about it: the leaf ids are read once (and
// again from L2) for all slots and features; the histogram kernel touches
// the bins and payload of listed rows only, its trip count follows the
// rows in the slots, not N, and its loads run D batches ahead of the
// adds.  What it pays: the row list (written and read once), the payload
// read once per feature (from L1 or L2 after the first), one partial per
// (chunk, slot, feature) written and read back by the second stage, three
// launches, and adds whose chain (group word, owner, cell) is
// latency-bound, hidden by up to 32 warps an SM.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSlots = 14;        // MULTI_CHUNK, slots a launch
constexpr int kListWarps = 32;       // kernels 1 and 2: 1024 threads,
constexpr int kListThreads = kListWarps * 32;
constexpr int kListRounds = 8;       // 8 rows a thread,
constexpr int kListRows = kListRounds * kListThreads;   // 8192 a block
constexpr int kAhead = 4;            // batches the loads run ahead
constexpr int kMinPiece = 256;       // rows a piece holds at least
constexpr unsigned kNoBin = 0xFFFFFFFFu;
constexpr int kSmemMax = 227 * 1024;
constexpr int kReduceUnroll = 16;    // chunk partials loaded together
constexpr unsigned kFull = 0xFFFFFFFFu;

// Blocks of the row-list kernels over N rows.
__host__ __device__ inline int list_blocks(int N) {
  return (N + kListRows - 1) / kListRows;
}

// Shared memory of one hist_partial_kernel block: the [Fg][MB] histograms
// of 16-byte cells (g, h, w and the group word) and each warp's staging
// buffer of 96 floats.  `ops/hist_kernel.py smem_bytes` repeats it.
__host__ __device__ inline long long partial_smem_bytes(int Fg, int MB) {
  return static_cast<long long>(Fg) * MB * 16 + kWarps * 96 * 4;
}

// Index of leaf id v among the slots (the first equal one), or -1.
__device__ __forceinline__ int slot_of(int v, const int* slot_s, int S) {
  for (int k = 0; k < S; ++k)
    if (v == slot_s[k]) return k;
  return -1;
}

// Slot s's list: its first entry and length (a repeated slot: its first
// occurrence's), and the pieces the list is cut into: as many as fit
// kMinPiece rows each, at least 1 and at most `chunks`.
struct SlotRows {
  long long start, len;
  int pieces;
};

__device__ __forceinline__ SlotRows slot_rows(const int* slots,
                                              const int* slot_start, int s,
                                              int chunks) {
  int kc = s;
  for (int k = 0; k < s; ++k)
    if (__ldg(slots + k) == __ldg(slots + s)) { kc = k; break; }
  SlotRows x;
  x.start = __ldg(slot_start + kc);
  x.len = __ldg(slot_start + kc + 1) - x.start;
  x.pieces = static_cast<int>(
      min(static_cast<long long>(chunks),
          max(1LL, x.len / kMinPiece)));
  return x;
}

// slot_start within the row scratch (see launch_first_stage).
__host__ __device__ inline int* slot_start_of(int* rowbuf, int N, int S) {
  return rowbuf + N + static_cast<long long>(S) * list_blocks(N);
}

// The exclusive prefix of counts [E] in place, in index order, by one
// block of kListThreads; slot_start[k] = counts[k * nb] (k < S),
// slot_start[S] the total.
__device__ __forceinline__ void scan_counts(int* counts, int E, int nb,
                                            int S, int* slot_start) {
  __shared__ int warp_s[kListWarps];
  __shared__ int total_s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per = (E + kListThreads - 1) / kListThreads;
  const int a = min(static_cast<int>(threadIdx.x) * per, E);
  const int z = min(a + per, E);
  int sum = 0;
  for (int q = a; q < z; ++q) sum += __ldcg(counts + q);
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_s[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int t = warp_s[lane];
    int wi = t;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, wi, d);
      if (lane >= d) wi += v;
    }
    warp_s[lane] = wi - t;
    if (lane == 31) total_s = wi;
  }
  __syncthreads();
  int run = warp_s[warp] + incl - sum;
  for (int q = a; q < z; ++q) {
    const int c = __ldcg(counts + q);
    counts[q] = run;
    run += c;
  }
  __syncthreads();
  if (threadIdx.x < S) slot_start[threadIdx.x] = counts[threadIdx.x * nb];
  if (threadIdx.x == S) slot_start[S] = total_s;
}

// 1+2. counts[k * nb + block]: the block's rows of slot k; the last block
// to finish (by the ticket, which it sets back to 0) turns the counts into
// their exclusive prefix over (slot, block) and fills slot_start.  kSlots
// is the launch's slot cap: 14 for K1 and K2, 42 for K4 and K5
// (hist_q_common.cuh).
template <int kSlots>
__global__ void __launch_bounds__(kListThreads)
row_count_kernel(const int* __restrict__ leaf_id,
                 const int* __restrict__ slots, int N, int S,
                 int* __restrict__ counts, int* __restrict__ slot_start,
                 int* __restrict__ ticket) {
  __shared__ int slot_s[kSlots];
  __shared__ int cnt_s[kSlots * kListWarps];
  __shared__ bool last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x < S) slot_s[threadIdx.x] = __ldg(slots + threadIdx.x);
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * kListRows;
  int v[kListRounds];                  // every round's load in flight
#pragma unroll
  for (int j = 0; j < kListRounds; ++j) {
    const long long r = base + j * kListThreads + threadIdx.x;
    v[j] = r < N ? __ldg(leaf_id + r) : 0;
  }
#pragma unroll
  for (int j = 0; j < kListRounds; ++j) {
    const long long r = base + j * kListThreads + threadIdx.x;
    v[j] = r < N ? slot_of(v[j], slot_s, S) : -1;
  }
  for (int k = 0; k < S; ++k) {        // one ballot a slot and round
    int c = 0;
#pragma unroll
    for (int j = 0; j < kListRounds; ++j)
      c += __popc(__ballot_sync(kFull, v[j] == k));
    if (lane == 0) cnt_s[k * kListWarps + warp] = c;
  }
  __syncthreads();
  if (threadIdx.x < S) {
    int t = 0;
    for (int w = 0; w < kListWarps; ++w)
      t += cnt_s[threadIdx.x * kListWarps + w];
    counts[threadIdx.x * gridDim.x + blockIdx.x] = t;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(ticket, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  scan_counts(counts, S * gridDim.x, gridDim.x, S, slot_start);
  if (threadIdx.x == 0) *ticket = 0;
}

// The lattice word of a listed row (K4 and K5): its three int8 lattice
// values gq, hq and w in bytes 0, 1 and 2.
__device__ __forceinline__ unsigned pack_lattice(const int8_t* pw3,
                                                 long long N, long long r) {
  return static_cast<unsigned>(static_cast<uint8_t>(__ldg(pw3 + r))) |
         static_cast<unsigned>(static_cast<uint8_t>(__ldg(pw3 + N + r)))
             << 8 |
         static_cast<unsigned>(static_cast<uint8_t>(__ldg(pw3 + 2 * N + r)))
             << 16;
}

// 2. list[offset(k, block) + rank] = row, for every row of slot k; with
// kLattice (K4 and K5) also lat[offset(k, block) + rank] = the row's
// lattice word from pw3 [3, N] int8, read for the rows in the slots only.
template <int kSlots, bool kLattice>
__global__ void __launch_bounds__(kListThreads)
row_list_kernel(const int* __restrict__ leaf_id,
                const int* __restrict__ slots, int N, int S,
                const int* __restrict__ offsets, int* __restrict__ list,
                const int8_t* __restrict__ pw3, unsigned* __restrict__ lat) {
  constexpr int kPerSlot = kListRounds * kListWarps;   // (round, warp)
  __shared__ int slot_s[kSlots];
  __shared__ int cnt_s[kSlots * kPerSlot];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x < S) slot_s[threadIdx.x] = __ldg(slots + threadIdx.x);
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * kListRows;
  int ks[kListRounds], rk[kListRounds];
  unsigned lw[kListRounds];
#pragma unroll
  for (int j = 0; j < kListRounds; ++j) {   // every round's load in flight
    const long long r = base + j * kListThreads + threadIdx.x;
    ks[j] = r < N ? __ldg(leaf_id + r) : 0;
  }
#pragma unroll
  for (int j = 0; j < kListRounds; ++j) {
    const long long r = base + j * kListThreads + threadIdx.x;
    ks[j] = r < N ? slot_of(ks[j], slot_s, S) : -1;
    rk[j] = 0;
    // the lattice loads of listed rows, in flight during the ranks
    lw[j] = (kLattice && ks[j] >= 0) ? pack_lattice(pw3, N, r) : 0u;
  }
  for (int k = 0; k < S; ++k) {        // one ballot a slot and round
#pragma unroll
    for (int j = 0; j < kListRounds; ++j) {
      const unsigned same = __ballot_sync(kFull, ks[j] == k);
      if (ks[j] == k) rk[j] = __popc(same & ((1u << lane) - 1u));
      if (lane == 0) cnt_s[k * kPerSlot + j * kListWarps + warp] =
                         __popc(same);
    }
  }
  __syncthreads();
  for (int k = warp; k < S; k += kListWarps) {   // warp w: slots w, w + 32
    int* c = cnt_s + k * kPerSlot;     // slot k's prefix over (round,
    constexpr int kPer = kPerSlot / 32;   // warp), 8 entries a lane
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
    int run = __ldg(offsets + k * gridDim.x + blockIdx.x) + incl - sum;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      c[lane * kPer + q] = run;
      run += v[q];
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kListRounds; ++j)
    if (ks[j] >= 0) {
      const int e = cnt_s[ks[j] * kPerSlot + j * kListWarps + warp] + rk[j];
      list[e] = static_cast<int>(base + j * kListThreads + threadIdx.x);
      if (kLattice) lat[e] = lw[j];
    }
}

// Kernels 1 and 2 for up to kSlots slots: the row list in rowbuf (N +
// S * list_blocks(N) + S + 1 ints: the list, the counts turned offsets,
// slot_start); with kLattice also each listed row's lattice word in lat
// [N].  ticket: one int, 0 between launches (row_count_kernel's last block
// sets it back), so launches that share it must not overlap.
template <int kSlots, bool kLattice>
cudaError_t launch_row_lists(const int* leaf_id, const int* slots, int N,
                             int S, int* rowbuf, int* ticket,
                             const int8_t* pw3, unsigned* lat,
                             cudaStream_t stream) {
  int* counts = rowbuf + N;
  const int nb = list_blocks(N);
  row_count_kernel<kSlots><<<nb, kListThreads, 0, stream>>>(
      leaf_id, slots, N, S, counts, slot_start_of(rowbuf, N, S), ticket);
  row_list_kernel<kSlots, kLattice><<<nb, kListThreads, 0, stream>>>(
      leaf_id, slots, N, S, counts, rowbuf, pw3, lat);
  return cudaGetLastError();
}

// One batch of a warp's adds: lane's bin v (kNoBin: none) and values
// (g, hs, w) into the feature's histogram h.
__device__ __forceinline__ void add_batch(float4* h, float* st, int lane,
                                          unsigned v, float g, float hs,
                                          float w, int MB) {
  st[lane] = g;
  st[32 + lane] = hs;
  st[64 + lane] = w;
  float4* c = v < static_cast<unsigned>(MB) ? h + v : nullptr;
  // the lanes of one bin OR their bits into the cell's group word; the
  // group's lowest lane owns it
  if (c) atomicOr(reinterpret_cast<unsigned*>(c) + 3, 1u << lane);
  __syncwarp();
  float4 cell = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c) cell = *c;
  if (c && __ffs(__float_as_uint(cell.w)) - 1 == lane) {
    const unsigned group = __float_as_uint(cell.w);
    float sg = 0.f, sh = 0.f, sw = 0.f;
    if (group == (1u << lane)) {
      sg += g;
      sh += hs;
      sw += w;
    } else {
      for (unsigned gm = group; gm; gm &= gm - 1) {      // lanes in order
        const int l = __ffs(gm) - 1;
        sg += st[l];
        sh += st[32 + l];
        sw += st[64 + l];
      }
    }
    cell.x += sg;
    cell.y += sh;
    cell.z += sw;
    cell.w = 0.f;                                    // the group word
    *c = cell;
  }
  __syncwarp();
}

// 3. The histograms of one (slot, group of features) over one piece of the
// slot's listed rows.
template <typename BinT>
__global__ void __launch_bounds__(kThreads, 4)
hist_partial_kernel(const BinT* __restrict__ bins,
                    const float* __restrict__ payload,
                    const int* __restrict__ list,
                    const int* __restrict__ slot_start,
                    const int* __restrict__ slots, int N, int F, int S,
                    int MB, int Fg, float* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem_h[];
  float4* hist = reinterpret_cast<float4*>(smem_h);
  float* stage = reinterpret_cast<float*>(
      smem_h + static_cast<long long>(Fg) * MB * 16);

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

  for (int i = threadIdx.x; i < fn * MB; i += kThreads)
    hist[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  if (warp < fn) {                     // warp w adds feature f0 + w
    const BinT* frow = bins + static_cast<size_t>(f0 + warp) * N;
    float4* h = hist + warp * MB;
    float* st = stage + warp * 96;
    auto row_of = [&](int b) {         // lane's listed row of batch b
      const long long e = p0 + 32LL * b + lane;
      return e < p1 ? __ldg(list + e) : -1;
    };
    unsigned v[kAhead];
    float g[kAhead], hs[kAhead], w[kAhead];
    int ahead[kAhead];                 // rows of batch b + kAhead
    auto fetch = [&](int u, int row) {
      if (row >= 0) {
        v[u] = __ldg(frow + row);
        const float* p = payload + 3LL * row;
        g[u] = __ldg(p);
        hs[u] = __ldg(p + 1);
        w[u] = __ldg(p + 2);
      } else {
        v[u] = kNoBin;
        g[u] = hs[u] = w[u] = 0.f;
      }
    };
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      fetch(u, row_of(u));
      ahead[u] = row_of(u + kAhead);
    }
    for (int b0 = 0; b0 < nbatch; b0 += kAhead) {
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (b0 + u < nbatch) add_batch(h, st, lane, v[u], g[u], hs[u], w[u],
                                       MB);
        fetch(u, ahead[u]);            // batch b0 + u + kAhead
        ahead[u] = row_of(b0 + u + 2 * kAhead);
      }
    }
  }
  __syncthreads();

  const int cells = MB * 3;
  const float* histf = reinterpret_cast<const float*>(hist);
  for (int i = threadIdx.x; i < fn * cells; i += kThreads) {
    const int fl = i / cells, r = i - fl * cells;
    const int bin = r / 3;
    work[((static_cast<size_t>(chunk) * S + s) * F + f0 + fl) *
             static_cast<size_t>(cells) + r] =
        histf[(static_cast<size_t>(fl) * MB + bin) * 4 + (r - 3 * bin)];
  }
}

// The launch plan both entry points validate alike (`ops/hist_kernel.py
// launch_plan` makes it): 1 <= S <= 14 slots, F features in groups of Fg
// (at most one a warp), 1 to 65535 chunks, and the block's shared memory
// within the 227 KB an H100 block can have.
inline bool partial_args_ok(int N, int F, int S, int MB, int bin_bytes,
                            int Fg, int chunks) {
  if (N <= 0 || F <= 0 || S <= 0 || S > kMaxSlots || MB <= 0) return false;
  if (bin_bytes != 1 && bin_bytes != 2) return false;
  if (Fg < 1 || Fg > F || Fg > kWarps) return false;
  if (chunks < 1 || chunks > 65535) return false;
  return partial_smem_bytes(Fg, MB) <= kSmemMax;
}

template <typename BinT>
cudaError_t launch_partial_t(const void* bins, const float* payload,
                             const int* list, const int* slot_start,
                             const int* slots, int N, int F, int S, int MB,
                             int Fg, int chunks, float* work,
                             cudaStream_t stream) {
  auto kernel = hist_partial_kernel<BinT>;
  const int smem = static_cast<int>(partial_smem_bytes(Fg, MB));
  static bool opted_in = false;        // the 227 KB opt-in, once
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  kernel<<<dim3(S * ((F + Fg - 1) / Fg), chunks), kThreads, smem,
           stream>>>(static_cast<const BinT*>(bins), payload, list,
                     slot_start, slots, N, F, S, MB, Fg, work);
  return cudaGetLastError();
}

// The whole first stage, after partial_args_ok: the row list in rowbuf
// (launch_row_lists), then the partials in work [chunks, S, F, MB, 3].
inline cudaError_t launch_first_stage(const void* bins, int bin_bytes,
                                      const float* payload,
                                      const int* leaf_id, const int* slots,
                                      int N, int F, int S, int MB, int Fg,
                                      int chunks, int* rowbuf, int* ticket,
                                      float* work, cudaStream_t stream) {
  int* list = rowbuf;
  int* slot_start = slot_start_of(rowbuf, N, S);
  cudaError_t e = launch_row_lists<kMaxSlots, false>(
      leaf_id, slots, N, S, rowbuf, ticket, nullptr, nullptr, stream);
  if (e != cudaSuccess) return e;
  if (bin_bytes == 1)
    return launch_partial_t<uint8_t>(bins, payload, list, slot_start, slots,
                                     N, F, S, MB, Fg, chunks, work, stream);
  return launch_partial_t<uint16_t>(bins, payload, list, slot_start, slots,
                                    N, F, S, MB, Fg, chunks, work, stream);
}

// Cell i of the histogram: its chunk partials in work [chunks, total]
// summed in index order, work[0] + work[1] + ..., the loads of
// kReduceUnroll chunks issued together.
__device__ __forceinline__ float sum_chunks(const float* __restrict__ work,
                                            int chunks, long long total,
                                            long long i) {
  float acc = work[i];
  int c = 1;
  for (; c + kReduceUnroll <= chunks; c += kReduceUnroll) {
    float v[kReduceUnroll];
#pragma unroll
    for (int u = 0; u < kReduceUnroll; ++u) v[u] = work[(c + u) * total + i];
#pragma unroll
    for (int u = 0; u < kReduceUnroll; ++u) acc += v[u];
  }
  for (; c < chunks; ++c) acc += work[c * total + i];
  return acc;
}

constexpr int kReduceThreads = 128;

// The second stage's sums: out[i] = sum_chunks over the pieces of cell
// i's slot.
__global__ void __launch_bounds__(kReduceThreads)
hist_reduce_kernel(const float* __restrict__ work, int chunks,
                   long long total, long long per_slot,
                   const int* __restrict__ slots,
                   const int* __restrict__ slot_start,
                   float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kReduceThreads +
                      threadIdx.x;
  if (i >= total) return;
  const int s = static_cast<int>(i / per_slot);
  out[i] = sum_chunks(work, slot_rows(slots, slot_start, s, chunks).pieces,
                      total, i);
}

// out [S, F, MB, 3] from the first stage's work [chunks, S, F, MB, 3] and
// the slots' lists in rowbuf.
inline cudaError_t launch_reduce(const float* work, int chunks, int N,
                                 int S, int F, int MB, const int* slots,
                                 int* rowbuf, float* out,
                                 cudaStream_t stream) {
  const long long per_slot = static_cast<long long>(F) * MB * 3;
  const long long total = S * per_slot;
  const long long blocks = (total + kReduceThreads - 1) / kReduceThreads;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  hist_reduce_kernel<<<static_cast<unsigned>(blocks), kReduceThreads, 0,
                       stream>>>(work, chunks, total, per_slot, slots,
                                 slot_start_of(rowbuf, N, S), out);
  return cudaGetLastError();
}

}  // namespace
