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
// Design: at refresh the host lists the trees by (class, tile), the tiles
// ascending within a class (`ops/predict.py bounded_groups`): a CSR of
// groups.  One thread a row walks, for each class, the tiles 0..S-1; a tile
// with a group of that class sums the group's codes (each tree's slot read
// at its row `gather_idx[t]` of the slots) into the int32 partial, a tile
// without one has partial 0, and the partial is combined at once.  No
// [N, S, K] partial array, no atomics, and the order is fixed.
//
// What bounds it on the H100: reading the [T, N] int32 slots once (lanes
// read neighbouring rows of a slot row, so the loads coalesce); the codes
// and the CSR are small and stay in L1 / L2.
//
// Indices past the tables clamp, as XLA's gathers do in the JAX package.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <class Q>
__global__ void __launch_bounds__(kThreads)
bounded_kernel(const int* __restrict__ slots, int Rs, int B,
               const int* __restrict__ gather_idx,
               const Q* __restrict__ qval, int NL,
               const int* __restrict__ grp_tile,
               const int* __restrict__ grp_start,
               const int* __restrict__ grp_trees,
               const int* __restrict__ cls_start, int K,
               const float* __restrict__ scales, int S,
               float* __restrict__ out) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= B) return;
  for (int k = 0; k < K; ++k) {
    int g = __ldg(cls_start + k);
    const int gend = __ldg(cls_start + k + 1);
    float acc = 0.0f;
    float p0 = 0.0f;
    for (int s = 0; s < S; ++s) {
      int p = 0;
      if (g < gend && __ldg(grp_tile + g) == s) {
        const int j1 = __ldg(grp_start + g + 1);
        for (int j = __ldg(grp_start + g); j < j1; ++j) {
          const int t = __ldg(grp_trees + j);
          int r = __ldg(gather_idx + t);
          r = r < 0 ? 0 : (r >= Rs ? Rs - 1 : r);
          int sl = __ldg(slots + static_cast<size_t>(r) * B + row);
          sl = sl < 0 ? 0 : (sl >= NL ? NL - 1 : sl);
          p += static_cast<int>(__ldg(qval + static_cast<size_t>(t) * NL +
                                      sl));
        }
        ++g;
      }
      const float pf = static_cast<float>(p);
      const float sc = __ldg(scales + s);
      if (s == 0) {
        p0 = pf;
        acc = __fmul_rn(pf, sc);
      } else if (s == 1) {
        acc = __fmaf_rn(p0, __ldg(scales), __fmul_rn(pf, sc));
      } else {
        acc = __fmaf_rn(pf, sc, acc);
      }
    }
    out[static_cast<size_t>(row) * K + k] = acc;
  }
}

template <class Q>
int launch(const int* slots, int Rs, int B, const int* gather_idx,
           const Q* qval, int T, int NL, const int* grp_tile,
           const int* grp_start, const int* grp_trees, const int* cls_start,
           int K, const float* scales, int S, float* out,
           cudaStream_t stream) {
  if (B <= 0 || K <= 0) return 0;
  if (T <= 0 || Rs <= 0 || NL <= 0 || S <= 0) return cudaErrorInvalidValue;
  bounded_kernel<Q><<<(B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      slots, Rs, B, gather_idx, qval, NL, grp_tile, grp_start, grp_trees,
      cls_start, K, scales, S, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// slots [Rs, B] i32, gather_idx [T] i32, qval [T, NL] i8 (`bits` 8) or i16
// (`bits` 16), the groups (grp_tile [G], grp_start [G + 1], grp_trees [T],
// cls_start [K + 1]: class k's groups are cls_start[k]..cls_start[k + 1],
// tiles ascending), scales [S] f32, out [B, K] f32.  Returns the
// cudaError_t of the launch.
extern "C" int lgbt_accumulate_bounded(
    const int* slots, int Rs, int B, const int* gather_idx, const void* qval,
    int bits, int T, int NL, const int* grp_tile, const int* grp_start,
    const int* grp_trees, const int* cls_start, int K, const float* scales,
    int S, float* out, cudaStream_t stream) {
  if (bits == 8)
    return launch<int8_t>(slots, Rs, B, gather_idx,
                          static_cast<const int8_t*>(qval), T, NL, grp_tile,
                          grp_start, grp_trees, cls_start, K, scales, S, out,
                          stream);
  if (bits == 16)
    return launch<int16_t>(slots, Rs, B, gather_idx,
                           static_cast<const int16_t*>(qval), T, NL,
                           grp_tile, grp_start, grp_trees, cls_start, K,
                           scales, S, out, stream);
  return cudaErrorInvalidValue;
}
