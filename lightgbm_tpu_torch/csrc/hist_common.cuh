// The first stage of the multi-leaf histogram, shared by the K1 kernel
// (`histogram.cu`) and the fused histogram+split kernel K2
// (`fused_split.cu`), so that K2's histogram is K1's bit for bit.
//
// hist_partial_kernel: grid (feature, chunk of rows, slot), 8 warps a
// block; each warp owns a fixed sub-range of the chunk's rows and a
// private [MB][3] f32 histogram in shared memory.  Per 32 rows, lanes
// holding the same bin (rows outside the slot hold none) are grouped with
// __match_any_sync; the group's lowest lane sums the group's values in
// lane order from a per-warp staging buffer and adds the sum to the warp's
// histogram, so no two lanes touch one cell.  The block sums its warps'
// histograms in warp order and writes one partial per chunk to the
// workspace [chunks, S, F, MB, 3].  The second stage (K1's
// hist_reduce_kernel, K2's reduce-and-scan kernel) sums the chunks of each
// cell in index order.  The kernel only adds, so FMA contraction cannot
// change a bit.  Bins >= MB are skipped.

#pragma once

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

// Shared memory one block of hist_partial_kernel needs at MB bins.
inline size_t partial_smem_bytes(int MB) {
  return (static_cast<size_t>(kWarps) * MB * 3 + kWarps * 96) * sizeof(float);
}

// The launch arguments both entry points validate alike: rows_per_chunk a
// multiple of the block's 256 rows, chunks = ceil(N / rows_per_chunk), and
// the block's shared memory within the 227 KB an H100 block can have.
inline bool partial_args_ok(int N, int F, int S, int MB, int rows_per_chunk,
                            int chunks) {
  if (N <= 0 || F <= 0 || S <= 0 || MB <= 0) return false;
  if (rows_per_chunk <= 0 || rows_per_chunk % kThreads != 0 ||
      chunks <= 0 || chunks > 65535 || S > 65535)
    return false;
  if (static_cast<long long>(rows_per_chunk) * (chunks - 1) >= N ||
      static_cast<long long>(rows_per_chunk) * chunks < N)
    return false;
  return partial_smem_bytes(MB) <= 227 * 1024;
}

template <typename BinT>
cudaError_t launch_partial_t(const void* bins, const float* payload,
                             const int* leaf_id, const int* slots, int N,
                             int F, int S, int MB, int rows_per_chunk,
                             int chunks, float* work, cudaStream_t stream) {
  auto kernel = hist_partial_kernel<BinT>;
  const size_t smem = partial_smem_bytes(MB);
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

// The partial stage for bin_bytes 1 (u8) or 2 (u16).
inline cudaError_t launch_partial(const void* bins, int bin_bytes,
                                  const float* payload, const int* leaf_id,
                                  const int* slots, int N, int F, int S,
                                  int MB, int rows_per_chunk, int chunks,
                                  float* work, cudaStream_t stream) {
  if (bin_bytes == 1)
    return launch_partial_t<uint8_t>(bins, payload, leaf_id, slots, N, F, S,
                                     MB, rows_per_chunk, chunks, work,
                                     stream);
  if (bin_bytes == 2)
    return launch_partial_t<uint16_t>(bins, payload, leaf_id, slots, N, F,
                                      S, MB, rows_per_chunk, chunks, work,
                                      stream);
  return cudaErrorInvalidValue;
}

}  // namespace
