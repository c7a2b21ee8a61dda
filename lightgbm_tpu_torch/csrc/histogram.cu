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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kNone = 0xFFFFFFFFu;

template <typename BinT>
__global__ void __launch_bounds__(kThreads)
hist_partial_kernel(const BinT* __restrict__ bins,
                    const float* __restrict__ payload,
                    const int* __restrict__ leaf_id,
                    const int* __restrict__ slots, int N, int F, int MB,
                    int rows_per_chunk, float* __restrict__ work) {
  extern __shared__ float smem[];
  const int cells = MB * 3;
  float* hist = smem;                               // [kWarps][MB * 3]
  float* stage = smem + kWarps * cells;             // [kWarps][3][32]
  const int f = blockIdx.x;
  const int chunk = blockIdx.y;
  const int s = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < kWarps * cells; i += kThreads) hist[i] = 0.f;
  __syncthreads();

  const int slot = __ldg(slots + s);
  const int rows_per_warp = rows_per_chunk / kWarps;
  const long long chunk_end =
      min(static_cast<long long>(chunk + 1) * rows_per_chunk,
          static_cast<long long>(N));
  const long long w0 = static_cast<long long>(chunk) * rows_per_chunk +
                       static_cast<long long>(warp) * rows_per_warp;
  const long long w1 = min(w0 + rows_per_warp, chunk_end);
  float* wh = hist + warp * cells;
  float* st = stage + warp * 96;
  const BinT* brow = bins + static_cast<size_t>(f) * N;

  for (long long base = w0; base < w1; base += 32) {   // warp-uniform
    const long long r = base + lane;
    unsigned key = kNone;
    float g = 0.f, h = 0.f, w = 0.f;
    if (r < w1 && __ldg(leaf_id + r) == slot) {
      const unsigned b = static_cast<unsigned>(__ldg(brow + r));
      if (b < static_cast<unsigned>(MB)) {
        key = b;
        g = __ldg(payload + 3 * r);
        h = __ldg(payload + 3 * r + 1);
        w = __ldg(payload + 3 * r + 2);
      }
    }
    st[lane] = g;
    st[32 + lane] = h;
    st[64 + lane] = w;
    const unsigned group = __match_any_sync(0xFFFFFFFFu, key);
    __syncwarp();
    if (key != kNone && lane == __ffs(group) - 1) {
      float sg = 0.f, sh = 0.f, sw = 0.f;
      for (unsigned m = group; m; m &= m - 1) {        // lanes in order
        const int l = __ffs(m) - 1;
        sg += st[l];
        sh += st[32 + l];
        sw += st[64 + l];
      }
      wh[3 * key] += sg;
      wh[3 * key + 1] += sh;
      wh[3 * key + 2] += sw;
    }
    __syncwarp();
  }
  __syncthreads();

  float* out = work + ((static_cast<size_t>(chunk) * gridDim.z + s) * F + f) *
                          static_cast<size_t>(cells);
  for (int i = threadIdx.x; i < cells; i += kThreads) {
    float acc = hist[i];
    for (int k = 1; k < kWarps; ++k) acc += hist[k * cells + i];
    out[i] = acc;
  }
}

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

template <typename BinT>
cudaError_t launch_partial(const void* bins, const float* payload,
                           const int* leaf_id, const int* slots, int N, int F,
                           int S, int MB, int rows_per_chunk, int chunks,
                           size_t smem, float* work, cudaStream_t stream) {
  auto kernel = hist_partial_kernel<BinT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(F, chunks, S);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const BinT*>(bins), payload, leaf_id, slots, N, F, MB,
      rows_per_chunk, work);
  return cudaGetLastError();
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
  if (N <= 0 || F <= 0 || S <= 0 || MB <= 0) return cudaErrorInvalidValue;
  if (rows_per_chunk <= 0 || rows_per_chunk % kThreads != 0 ||
      chunks <= 0 || chunks > 65535 || S > 65535)
    return cudaErrorInvalidValue;
  if (static_cast<long long>(rows_per_chunk) * (chunks - 1) >= N ||
      static_cast<long long>(rows_per_chunk) * chunks < N)
    return cudaErrorInvalidValue;
  const size_t smem = (static_cast<size_t>(kWarps) * MB * 3 + kWarps * 96) *
                      sizeof(float);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t e;
  if (bin_bytes == 1) {
    e = launch_partial<uint8_t>(bins, payload, leaf_id, slots, N, F, S, MB,
                                rows_per_chunk, chunks, smem, work, stream);
  } else if (bin_bytes == 2) {
    e = launch_partial<uint16_t>(bins, payload, leaf_id, slots, N, F, S, MB,
                                 rows_per_chunk, chunks, smem, work, stream);
  } else {
    return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  const long long total = static_cast<long long>(S) * F * MB * 3;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  hist_reduce_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      work, chunks, total, out);
  return static_cast<int>(cudaGetLastError());
}
