// The accumulation stage of the quantized multi-leaf histogram, shared by
// the K4 kernel (`histogram_q.cu`) and the fused quantized histogram+split
// kernel K5 (`fused_split.cu`), so that K5's histogram is K4's bit for bit.
//
// hist_q_partial_kernel: grid (feature, chunk of rows, group of slots),
// 512 threads a block.  The block keeps one [MB][3] int32 histogram per
// slot of its group in shared memory (the wrapper sizes the group to fit:
// all 42 slots at MB = 256, 129 KB).  Each thread walks the chunk's rows
// with a stride of 512, four rows at a time, loads each row's leaf id, bin
// and lattice values (gq, hq, w; int8, sign-extended), compares the leaf id
// with every slot of the group (each slot matches on its own, as the
// reference kernel's per-slot masks do) and, for a match, adds the values
// to the bin's cells with shared-memory atomicAdd.  The bins and leaf ids
// of a chunk are read once for all the group's slots.
// Then the block adds each non-zero cell to the int32 accumulator
// acc[S, F, MB, 3] in device memory with atomicAdd.  Integer addition is
// associative, so neither the order of the shared-memory atomics nor that
// of the device-memory ones can change a bit: two launches give the same
// sums, and the same as any plain integer sum.  The caller zeroes `acc`.
// int32 is exact while |sum| < 2^31: with the lattice's |gq|, hq <= 15 and
// w <= 1, up to 143M rows (the wrapper refuses more).  Bins >= MB are
// skipped.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQThreads = 512;
constexpr int kQUnroll = 4;         // rows a thread loads at once
constexpr int kQMaxSlots = 42;      // MULTI_CHUNK_Q, slots per launch

template <typename BinT>
__global__ void __launch_bounds__(kQThreads)
hist_q_partial_kernel(const BinT* __restrict__ bins,
                      const int8_t* __restrict__ pw3,
                      const int* __restrict__ leaf_id,
                      const int* __restrict__ slots, int N, int F, int S,
                      int MB, int G, int rows_per_chunk,
                      int* __restrict__ acc) {
  extern __shared__ int smem_q[];
  const int cells = MB * 3;
  const int f = blockIdx.x;
  const int chunk = blockIdx.y;
  const int s0 = blockIdx.z * G;
  const int g_n = min(G, S - s0);
  int* hist = smem_q;                               // [g_n][MB][3]
  int* sl = smem_q + G * cells;                     // [g_n]
  for (int i = threadIdx.x; i < g_n * cells; i += kQThreads) hist[i] = 0;
  for (int i = threadIdx.x; i < g_n; i += kQThreads) sl[i] = slots[s0 + i];
  __syncthreads();

  const long long r0 = static_cast<long long>(chunk) * rows_per_chunk;
  const long long r1 = min(r0 + rows_per_chunk, static_cast<long long>(N));
  const BinT* brow = bins + static_cast<size_t>(f) * N;
  const int8_t* grow = pw3;
  const int8_t* hrow = pw3 + N;
  const int8_t* wrow = pw3 + 2 * static_cast<long long>(N);
  // kQUnroll rows a thread at a time, every load issued before any is
  // used, so that their latencies overlap; a row is read whether or not
  // its leaf is in the group (the bytes of a warp's rows share sectors)
  for (long long base = r0 + threadIdx.x; base < r1;
       base += static_cast<long long>(kQThreads) * kQUnroll) {
    int lid[kQUnroll], b[kQUnroll], gq[kQUnroll], hq[kQUnroll], w[kQUnroll];
#pragma unroll
    for (int u = 0; u < kQUnroll; ++u) {
      const long long r = base + static_cast<long long>(u) * kQThreads;
      const bool in = r < r1;
      lid[u] = in ? __ldg(leaf_id + r) : 0;
      b[u] = in ? static_cast<int>(__ldg(brow + r)) : MB;   // MB: skipped
      gq[u] = in ? __ldg(grow + r) : 0;
      hq[u] = in ? __ldg(hrow + r) : 0;
      w[u] = in ? __ldg(wrow + r) : 0;
    }
#pragma unroll
    for (int u = 0; u < kQUnroll; ++u) {
      if (b[u] >= MB) continue;
      for (int i = 0; i < g_n; ++i) {
        if (lid[u] != sl[i]) continue;
        int* c = hist + (i * MB + b[u]) * 3;
        if (gq[u]) atomicAdd(c, gq[u]);
        if (hq[u]) atomicAdd(c + 1, hq[u]);
        if (w[u]) atomicAdd(c + 2, w[u]);
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < g_n * cells; i += kQThreads) {
    const int v = hist[i];
    if (v) {
      const int k = i / cells;
      atomicAdd(acc + (static_cast<size_t>(s0 + k) * F + f) * cells +
                    (i - k * cells),
                v);
    }
  }
}

// Shared memory one block of hist_q_partial_kernel needs for G slots.
inline size_t q_smem_bytes(int G, int MB) {
  return static_cast<size_t>(G) * (static_cast<size_t>(MB) * 3 + 1) *
         sizeof(int);
}

// The launch arguments both entry points validate alike: 1 <= S <= 42
// slots in groups of G, rows_per_chunk a multiple of the block's 512 rows,
// chunks = ceil(N / rows_per_chunk), and the block's shared memory within
// the 227 KB an H100 block can have.
inline bool q_args_ok(int N, int F, int S, int MB, int G, int rows_per_chunk,
                      int chunks) {
  if (N <= 0 || F <= 0 || S <= 0 || S > kQMaxSlots || MB <= 0) return false;
  if (G <= 0 || G > S) return false;
  if (rows_per_chunk <= 0 || rows_per_chunk % kQThreads != 0 ||
      chunks <= 0 || chunks > 65535)
    return false;
  if (static_cast<long long>(rows_per_chunk) * (chunks - 1) >= N ||
      static_cast<long long>(rows_per_chunk) * chunks < N)
    return false;
  return q_smem_bytes(G, MB) <= 227 * 1024;
}

template <typename BinT>
cudaError_t launch_q_partial_t(const void* bins, const int8_t* pw3,
                               const int* leaf_id, const int* slots, int N,
                               int F, int S, int MB, int G,
                               int rows_per_chunk, int chunks, int* acc,
                               cudaStream_t stream) {
  auto kernel = hist_q_partial_kernel<BinT>;
  const size_t smem = q_smem_bytes(G, MB);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(F, chunks, (S + G - 1) / G);
  kernel<<<grid, kQThreads, smem, stream>>>(
      static_cast<const BinT*>(bins), pw3, leaf_id, slots, N, F, S, MB, G,
      rows_per_chunk, acc);
  return cudaGetLastError();
}

// Zero acc [S, F, MB, 3] int32, then the accumulation stage for bin_bytes 1
// (u8) or 2 (u16).
inline cudaError_t launch_q_partial(const void* bins, int bin_bytes,
                                    const int8_t* pw3, const int* leaf_id,
                                    const int* slots, int N, int F, int S,
                                    int MB, int G, int rows_per_chunk,
                                    int chunks, int* acc,
                                    cudaStream_t stream) {
  if (bin_bytes != 1 && bin_bytes != 2) return cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(
      acc, 0, static_cast<size_t>(S) * F * MB * 3 * sizeof(int), stream);
  if (e != cudaSuccess) return e;
  if (bin_bytes == 1)
    return launch_q_partial_t<uint8_t>(bins, pw3, leaf_id, slots, N, F, S,
                                       MB, G, rows_per_chunk, chunks, acc,
                                       stream);
  return launch_q_partial_t<uint16_t>(bins, pw3, leaf_id, slots, N, F, S, MB,
                                      G, rows_per_chunk, chunks, acc, stream);
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
