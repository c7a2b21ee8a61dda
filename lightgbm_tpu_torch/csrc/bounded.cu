// The bounded sum: int32 partial sums of quantized leaf codes per (tile,
// class), combined into f32 scores under the per-tile scales.  The
// serving runtime's bounded rung (`serve_precision=bounded`).
//
// Not a TPU kernel.  On the TPU it is the XLA scan of
// `lightgbm_tpu/ops/predict.py:567 accumulate_slots_bounded`: each tree's
// int8 / int16 code at its leaf slot is added into the int32 partial of
// (tile_of_tree[t], class of t), which is exact (the quantizer refuses a
// tile whose codes could pass 2^24), and then, per class, the partials are
// combined with the tiles' f32 scales in ascending tile order.  XLA's CPU
// build writes that combine as out_1 = p_0 * s_0 + p_1 * s_1 and
// out_s = out_(s-1) + p_s * s_s, and LLVM contracts it into
//   out_1 = fma(p_0, s_0, round(p_1 * s_1)),  out_s = fma(p_s, s_s, out_(s-1)),
// one f32 rounding a step (a single tile: round(p_0 * s_0)).  This kernel
// does exactly that with __fmul_rn and __fmaf_rn (built with -fmad=false,
// so nothing else is contracted), so its bits are the reference's.
//
// The groups: at refresh the host lists the trees by (class, tile), the
// tiles ascending within a class and inside [0, S) (`ops/predict.py
// bounded_groups`): a CSR of groups, in class order.
//
// Design (the first one was one thread a row walking every tree, a chain of
// three dependent loads a tree: 32 blocks of 4 warps at 4096 rows, one
// thread for a 1-row request).  A block holds R rows and W tree lanes a
// row (`compiler/records.py bounded_plan`): thread i is on row i % R and
// lane i / R, so a warp's lanes sit on neighbouring rows of one tree and
// their slot loads coalesce, and a 1-row request spreads its trees over a
// whole block.  The groups go a chunk at a time, their CSR starts staged
// in shared memory; within a chunk the W lanes of a row split the chunk's
// trees (lane w takes positions w, w + W, ... of the CSR), each thread
// loading the tree, its plan row, the slot and the code of kUnroll trees
// before adding any, so kUnroll chains are in flight.  A thread adds its
// codes into a register partial of the group it is in and, when it
// leaves a group (a binary search of the staged starts finds the next),
// adds that partial into the group's shared int32 cell of its row.
// Integer adds are exact in any order (every partial is below 2^24 in
// magnitude), so the order of the lanes and of the shared-memory adds
// cannot change a bit.  After
// a barrier, one thread a (row, class) combines the chunk's groups of its
// class into its f32 state, stepping over tiles without a group of that
// class with p = 0, as the reference's combine does; after the last
// chunk it steps to tile S - 1 and writes the score.  Only the combine
// rounds, and its order is the fixed one above.
//
// What bounds it on the H100: the dependent loads of a tree (its plan
// row, then the slot, then the code); the bytes are one slot a tree and
// row, the codes, the groups and the scores.
//
// Indices past the tables clamp, as XLA's gathers do in the JAX package.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kUnroll = 4;

__host__ __device__ inline int align16(long long n) {
  return static_cast<int>((n + 15) / 16 * 16);
}

// The combine state v of one (row, class) before tile s, after it: tile 0
// leaves p_0 itself (exact in f32), tile 1 fma(p_0, s_0, round(p_1 s_1)),
// tile s >= 2 fma(p_s, s_s, v).
__device__ __forceinline__ float tile_step(float v, int s, int p,
                                           const float* __restrict__ scales) {
  const float pf = static_cast<float>(p);
  if (s == 0) return pf;
  if (s == 1)
    return __fmaf_rn(v, __ldg(scales), __fmul_rn(pf, __ldg(scales + 1)));
  return __fmaf_rn(pf, __ldg(scales + s), v);
}

__device__ __forceinline__ int clamp_tile(int s, int S) {
  return s < 0 ? 0 : (s >= S ? S - 1 : s);
}

template <class Q>
__global__ void __launch_bounds__(kMaxThreads)
bounded_kernel(const int* __restrict__ slots, int Rs, int B,
               const int* __restrict__ gather_idx,
               const Q* __restrict__ qval, int NL,
               const int* __restrict__ grp_tile,
               const int* __restrict__ grp_start,
               const int* __restrict__ grp_trees,
               const int* __restrict__ cls_start, int K,
               const float* __restrict__ scales, int S, int G, int R,
               int W, int GC, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int part_bytes = align16(static_cast<long long>(GC) * R * 4);
  const int state_bytes = align16(static_cast<long long>(K) * R * 4);
  int* part = reinterpret_cast<int*>(smem);                  // [GC, R]
  float* state = reinterpret_cast<float*>(smem + part_bytes);  // [K, R]
  int* starts = reinterpret_cast<int*>(smem + part_bytes +
                                       state_bytes);         // [GC + 1]
  const int r = threadIdx.x % R;
  const int lane = threadIdx.x / R;
  const int row = blockIdx.x * R + r;
  const bool real = row < B;
  for (int g0 = 0; g0 < G; g0 += GC) {
    const int ng = min(G, g0 + GC) - g0;
    for (int i = threadIdx.x; i < ng * R; i += blockDim.x) part[i] = 0;
    for (int i = threadIdx.x; i <= ng; i += blockDim.x)
      starts[i] = __ldg(grp_start + g0 + i);
    __syncthreads();
    const int j1 = starts[ng];
    int g = 0;   // the group (in this chunk) of the lane's position
    int p = 0;
    for (int j = starts[0] + lane; real && j < j1; j += kUnroll * W) {
      int code[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int ju = j + u * W;
        code[u] = 0;
        if (ju < j1) {
          const int t = __ldg(grp_trees + ju);
          int rr = __ldg(gather_idx + t);
          rr = rr < 0 ? 0 : (rr >= Rs ? Rs - 1 : rr);
          int sl = __ldg(slots + static_cast<size_t>(rr) * B + row);
          sl = sl < 0 ? 0 : (sl >= NL ? NL - 1 : sl);
          code[u] = static_cast<int>(
              __ldg(qval + static_cast<size_t>(t) * NL + sl));
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int ju = j + u * W;
        if (ju >= j1) break;
        if (starts[g + 1] <= ju) {   // left group g: find ju's
          if (p) atomicAdd(part + g * R + r, p);
          p = 0;
          int lo = g + 1, hi = ng;   // starts[lo] <= ju < starts[hi]
          while (hi - lo > 1) {
            const int mid = (lo + hi) >> 1;
            if (starts[mid] <= ju) lo = mid; else hi = mid;
          }
          g = lo;
        }
        p += code[u];
      }
    }
    if (p) atomicAdd(part + g * R + r, p);
    __syncthreads();
    const int g1 = g0 + ng;
    // the combine of this chunk's groups, one thread a (row, class)
    for (int i = threadIdx.x; i < K * R; i += blockDim.x) {
      const int k = i / R;
      const int gs = max(g0, __ldg(cls_start + k));
      const int ge = min(g1, __ldg(cls_start + k + 1));
      if (gs >= ge) continue;
      float v = state[i];
      int s = gs > __ldg(cls_start + k)
                  ? clamp_tile(__ldg(grp_tile + gs - 1), S) + 1 : 0;
      for (int gg = gs; gg < ge; ++gg) {
        const int st = clamp_tile(__ldg(grp_tile + gg), S);
        for (; s < st; ++s) v = tile_step(v, s, 0, scales);
        v = tile_step(v, st, part[(gg - g0) * R + i % R], scales);
        s = st + 1;
      }
      state[i] = v;
    }
    __syncthreads();
  }
  // the tiles after each class's last group, then the score
  for (int i = threadIdx.x; i < K * R; i += blockDim.x) {
    const int k = i / R;
    const int rw = blockIdx.x * R + i % R;
    if (rw >= B) continue;
    const int ge = __ldg(cls_start + k + 1);
    float v = state[i];
    int s = ge > __ldg(cls_start + k)
                ? clamp_tile(__ldg(grp_tile + ge - 1), S) + 1 : 0;
    for (; s < S; ++s) v = tile_step(v, s, 0, scales);
    if (S == 1) v = __fmul_rn(v, __ldg(scales));
    out[static_cast<size_t>(rw) * K + k] = v;
  }
}

template <class Q>
int launch(const int* slots, int Rs, int B, const int* gather_idx,
           const Q* qval, int NL, const int* grp_tile,
           const int* grp_start, const int* grp_trees, const int* cls_start,
           int K, const float* scales, int S, int G, int R, int W, int GC,
           int smem, float* out, cudaStream_t stream) {
  auto kernel = bounded_kernel<Q>;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<(B + R - 1) / R, R * W, smem, stream>>>(
      slots, Rs, B, gather_idx, qval, NL, grp_tile, grp_start, grp_trees,
      cls_start, K, scales, S, G, R, W, GC, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// slots [Rs, B] i32, gather_idx [T] i32, qval [T, NL] i8 (`bits` 8) or i16
// (`bits` 16), the groups (grp_tile [G], grp_start [G + 1], grp_trees [T],
// cls_start [K + 1]: class k's groups are cls_start[k]..cls_start[k + 1],
// tiles ascending), scales [S] f32, out [B, K] f32.  The launch
// (`compiler/records.py bounded_plan`): R rows a block, W lanes a row,
// GC groups a chunk, `smem` the bytes of its layout (`bounded_smem`).
// Returns the cudaError_t of the launch.
extern "C" int lgbt_accumulate_bounded(
    const int* slots, int Rs, int B, const int* gather_idx, const void* qval,
    int bits, int T, int NL, const int* grp_tile, const int* grp_start,
    const int* grp_trees, const int* cls_start, int K, const float* scales,
    int S, int G, int R, int W, int GC, int smem, float* out,
    cudaStream_t stream) {
  if (B <= 0 || K <= 0) return 0;
  if (T <= 0 || Rs <= 0 || NL <= 0 || S <= 0 || G <= 0 || R <= 0 ||
      W <= 0 || GC <= 0 || static_cast<long long>(R) * W > kMaxThreads)
    return cudaErrorInvalidValue;
  const int want = align16(static_cast<long long>(GC) * R * 4) +
                   align16(static_cast<long long>(K) * R * 4) +
                   align16((static_cast<long long>(GC) + 1) * 4);
  if (smem != want || smem > kMaxSmem) return cudaErrorInvalidValue;
  if (bits == 8)
    return launch<int8_t>(slots, Rs, B, gather_idx,
                          static_cast<const int8_t*>(qval), NL, grp_tile,
                          grp_start, grp_trees, cls_start, K, scales, S, G,
                          R, W, GC, smem, out, stream);
  if (bits == 16)
    return launch<int16_t>(slots, Rs, B, gather_idx,
                           static_cast<const int16_t*>(qval), NL, grp_tile,
                           grp_start, grp_trees, cls_start, K, scales, S, G,
                           R, W, GC, smem, out, stream);
  return cudaErrorInvalidValue;
}
