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

// ---- The carry: K1's first stage over one shard of rows at a time ----
//
// The shard-streamed grower folds shard after shard into a histogram
// carried on the device; once the last shard is folded, the histogram is
// lgbt_histogram's over all N rows bit for bit.  K1's order of adds
// (hist_common.cuh) depends on each slot's whole list: its L rows cut
// into P = min(chunks, max(1, L / 256)) pieces, each piece into batches
// of 32 counted from the piece's first row.  So the caller gives each
// slot's L (`lengths`) before the first shard, with K1's chunk count for
// all N rows, and the carry holds what crosses a shard boundary:
//   work     [chunks, S, F, MB, 3]  the pieces' partials, zero at first;
//   rank     [S]                    the slot's rows folded so far;
//   pend_*   the rows of the slot's open batch (fewer than 32, all in the
//            piece holding rank): their bins [S, F, 32] and payload
//            [S, 32, 3].  A shard reads the `in` buffers and writes the
//            `out` ones; the caller swaps them between shards.
// A shard's rows of slot s (the row lists of hist_common.cuh over the
// shard) have the global ranks [R0, R1).  Block (s, group, c) takes the
// ranks of piece c = [B0, B1) that this shard reaches: from the start of
// the open batch (R0 less the pending rows) or from B0, to min(B1, R1);
// lanes before R0 read the pending rows, the others the shard's list.
// It loads the piece's partials into shared memory, adds every complete
// batch with K1's add_batch (so a batch's rows of one bin are summed in
// lane order from +0.0 and that sum added to the cell), and writes them
// back; a batch that the shard leaves open (the piece goes on past R1)
// is not added but written to the `out` pending rows, lane by lane.  A
// block whose piece the shard does not reach exits; one that only moves
// the pending rows (a shard with no row of the slot) copies them.

namespace {

template <typename BinT>
__global__ void __launch_bounds__(kThreads, 4)
carry_partial_kernel(const BinT* __restrict__ bins,
                     const float* __restrict__ payload,
                     const int* __restrict__ list,
                     const int* __restrict__ slot_start,
                     const int* __restrict__ slots, int n, int F, int S,
                     int MB, int Fg, const int* __restrict__ rank,
                     const int* __restrict__ lengths,
                     const int* __restrict__ pend_bin_in,
                     const float* __restrict__ pend_pay_in,
                     int* __restrict__ pend_bin_out,
                     float* __restrict__ pend_pay_out,
                     float* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem_c[];
  float4* hist = reinterpret_cast<float4*>(smem_c);
  float* stage = reinterpret_cast<float*>(
      smem_c + static_cast<long long>(Fg) * MB * 16);

  const int nfg = (F + Fg - 1) / Fg;
  const int s = blockIdx.x / nfg;
  const int f0 = (blockIdx.x % nfg) * Fg;
  const int fn = min(Fg, F - f0);
  const int chunk = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // the shard's rows of slot s: its first occurrence's list, as in K1
  int kc = s;
  for (int k = 0; k < s; ++k)
    if (__ldg(slots + k) == __ldg(slots + s)) { kc = k; break; }
  const long long st0 = __ldg(slot_start + kc);
  const long long len = __ldg(slot_start + kc + 1) - st0;
  const long long L = __ldg(lengths + s);
  const long long R0 = __ldg(rank + s), R1 = R0 + len;
  const int pieces = static_cast<int>(
      min(static_cast<long long>(gridDim.y), max(1LL, L / kMinPiece)));
  if (chunk >= pieces) return;
  const long long B0 = L * chunk / pieces, B1 = L * (chunk + 1) / pieces;
  long long va;
  if (B0 <= R0 && R0 < B1) va = R0 - (R0 - B0) % 32;   // the open batch
  else if (B0 > R0) va = B0;
  else return;                         // the piece was complete before
  const long long vb = min(B1, R1);
  if (vb <= va) return;                // the shard does not reach it
  const bool open_last = vb == R1 && vb < B1 && (vb - B0) % 32 != 0;
  const int nbatch = static_cast<int>((vb - va + 31) / 32);
  const int nfull = open_last ? nbatch - 1 : nbatch;
  const int cells = MB * 3;
  float* dst = work + ((static_cast<size_t>(chunk) * S + s) * F + f0) *
                          static_cast<size_t>(cells);

  if (nfull > 0) {
    for (int i = threadIdx.x; i < fn * MB; i += kThreads) {
      const float* c = dst + 3LL * i;
      hist[i] = make_float4(c[0], c[1], c[2], 0.f);
    }
  }
  __syncthreads();

  if (warp < fn) {                     // warp w adds feature f0 + w
    const int fe = f0 + warp;
    const BinT* frow = bins + static_cast<size_t>(fe) * n;
    float4* h = hist + warp * MB;
    float* stg = stage + warp * 96;
    for (int b = 0; b < nbatch; ++b) {
      const long long p = va + 32LL * b + lane;
      unsigned v = kNoBin;
      float g = 0.f, hs = 0.f, w = 0.f;
      if (p < vb) {
        if (p < R0) {                  // a pending row of the open batch
          const int l = static_cast<int>(p - va);
          v = static_cast<unsigned>(
              pend_bin_in[(static_cast<size_t>(s) * F + fe) * 32 + l]);
          const float* q = pend_pay_in + (static_cast<size_t>(s) * 32 + l) * 3;
          g = q[0];
          hs = q[1];
          w = q[2];
        } else {
          const int row = __ldg(list + st0 + (p - R0));
          v = __ldg(frow + row);
          const float* q = payload + 3LL * row;
          g = __ldg(q);
          hs = __ldg(q + 1);
          w = __ldg(q + 2);
        }
      }
      if (b < nfull) {
        add_batch(h, stg, lane, v, g, hs, w, MB);
      } else if (p < vb) {             // the open batch: carried over
        pend_bin_out[(static_cast<size_t>(s) * F + fe) * 32 + lane] =
            static_cast<int>(v);
        if (fe == 0) {
          float* q = pend_pay_out + (static_cast<size_t>(s) * 32 + lane) * 3;
          q[0] = g;
          q[1] = hs;
          q[2] = w;
        }
      }
    }
  }
  __syncthreads();

  if (nfull > 0) {
    const float* histf = reinterpret_cast<const float*>(hist);
    for (int i = threadIdx.x; i < fn * cells; i += kThreads) {
      const int fl = i / cells, r = i - fl * cells;
      const int bin = r / 3;
      dst[static_cast<size_t>(fl) * cells + r] =
          histf[(static_cast<size_t>(fl) * MB + bin) * 4 + (r - 3 * bin)];
    }
  }
}

// rank[s] += the shard's rows of slot s (its first occurrence's list).
__global__ void carry_advance_kernel(const int* __restrict__ slots,
                                     const int* __restrict__ slot_start,
                                     int S, int* __restrict__ rank) {
  const int s = threadIdx.x;
  if (s >= S) return;
  int kc = s;
  for (int k = 0; k < s; ++k)
    if (slots[k] == slots[s]) { kc = k; break; }
  rank[s] += slot_start[kc + 1] - slot_start[kc];
}

// out[i] = the sum of cell i's pieces in index order (sum_chunks), the
// pieces of its slot's L.
__global__ void __launch_bounds__(kReduceThreads)
carry_reduce_kernel(const float* __restrict__ work, int chunks,
                    long long total, long long per_slot,
                    const int* __restrict__ lengths,
                    float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kReduceThreads +
                      threadIdx.x;
  if (i >= total) return;
  const long long L = __ldg(lengths + i / per_slot);
  const int pieces = static_cast<int>(
      min(static_cast<long long>(chunks), max(1LL, L / kMinPiece)));
  out[i] = sum_chunks(work, pieces, total, i);
}

template <typename BinT>
cudaError_t launch_carry_t(const void* bins, const float* payload,
                           const int* list, const int* slot_start,
                           const int* slots, int n, int F, int S, int MB,
                           int Fg, int chunks, const int* rank,
                           const int* lengths, const int* pbi,
                           const float* ppi, int* pbo, float* ppo,
                           float* work, cudaStream_t stream) {
  auto kernel = carry_partial_kernel<BinT>;
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
                     slot_start, slots, n, F, S, MB, Fg, rank, lengths, pbi,
                     ppi, pbo, ppo, work);
  return cudaGetLastError();
}

}  // namespace

// One shard's fold: bins [F, n] (bin_bytes 1 or 2), payload [n, 3] f32
// and leaf_id [n] i32 are the shard's rows, the next in row order; slots
// [S] i32; Fg and chunks the launch plan of all N rows (`launch_plan(N, F,
// S, MB)`); rowbuf the row scratch of n rows (N + S * ceil(n / 8192) +
// S + 1 i32 with N = n); ticket as lgbt_histogram's; rank [S], lengths
// [S] i32; the pending rows' in and out buffers (bins [S, F, 32] i32,
// payload [S, 32, 3] f32); work [chunks, S, F, MB, 3] f32.
extern "C" int lgbt_histogram_carry(const void* bins, int bin_bytes,
                                    const float* payload, const int* leaf_id,
                                    const int* slots, int n, int F, int S,
                                    int MB, int Fg, int chunks, int* rowbuf,
                                    int* ticket, int* rank,
                                    const int* lengths, const int* pbi,
                                    const float* ppi, int* pbo, float* ppo,
                                    float* work, cudaStream_t stream) {
  if (!partial_args_ok(n, F, S, MB, bin_bytes, Fg, chunks))
    return cudaErrorInvalidValue;
  cudaError_t e = launch_row_lists<kMaxSlots, false>(
      leaf_id, slots, n, S, rowbuf, ticket, nullptr, nullptr, stream);
  if (e != cudaSuccess) return e;
  const int* slot_start = slot_start_of(rowbuf, n, S);
  e = bin_bytes == 1
          ? launch_carry_t<uint8_t>(bins, payload, rowbuf, slot_start, slots,
                                    n, F, S, MB, Fg, chunks, rank, lengths,
                                    pbi, ppi, pbo, ppo, work, stream)
          : launch_carry_t<uint16_t>(bins, payload, rowbuf, slot_start,
                                     slots, n, F, S, MB, Fg, chunks, rank,
                                     lengths, pbi, ppi, pbo, ppo, work,
                                     stream);
  if (e != cudaSuccess) return e;
  carry_advance_kernel<<<1, 32, 0, stream>>>(slots, slot_start, S, rank);
  return static_cast<int>(cudaGetLastError());
}

// The carried histogram: out [S, F, MB, 3] f32 from work [chunks, S, F,
// MB, 3], each cell's pieces (of its slot's lengths[s]) summed in index
// order.
extern "C" int lgbt_histogram_carry_finalize(const float* work, int chunks,
                                             int S, int F, int MB,
                                             const int* slots,
                                             const int* lengths, float* out,
                                             cudaStream_t stream) {
  (void)slots;
  if (S <= 0 || S > kMaxSlots || F <= 0 || MB <= 0 || chunks < 1)
    return cudaErrorInvalidValue;
  const long long per_slot = static_cast<long long>(F) * MB * 3;
  const long long total = S * per_slot;
  const long long blocks = (total + kReduceThreads - 1) / kReduceThreads;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  carry_reduce_kernel<<<static_cast<unsigned>(blocks), kReduceThreads, 0,
                        stream>>>(work, chunks, total, per_slot, lengths,
                                  out);
  return static_cast<int>(cudaGetLastError());
}
