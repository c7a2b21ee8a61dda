// Exact f64 sum of pre-routed leaf slots, in boosting order.
//
// Not a TPU kernel: on the TPU, `lightgbm_tpu/ops/predict.py:
// accumulate_slots_exact` is an XLA scan that adds binary64 in software out
// of u32 operations (`_f64_add_bits`), because the TPU has no f64.  The
// H100 has native f64, so one thread per (row, class) walks the trees
// t = 0..T-1 and adds leaf_values[t, slots[gather_idx[t], row]] into its
// accumulator with round-to-nearest-even, starting from +0.0: the same
// values, in the same order, with the same rounding at every step, hence
// the same bits.  A tree reduction, atomics or any reordering would change
// the bits, so the loop stays sequential per thread.  Built with
// -fmad=false, and the add is an explicit __dadd_rn.
//
// What bounds it on the H100: reading the [T, B] slots once (coalesced:
// neighbouring threads read neighbouring rows) and the leaf-value gathers,
// which hit L2 (the table is T*NL*8 bytes).  Left for later: fusing it
// into the traverse kernel so the slots never go to device memory.
//
// Indices past the tables clamp, as XLA's gathers do in the JAX package.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
accumulate_kernel(const int* __restrict__ slots, int R, int B,
                  const int* __restrict__ gather_idx,
                  const double* __restrict__ values, int T, int NL,
                  const int* __restrict__ cls, int K,
                  double* __restrict__ out) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (idx >= static_cast<long long>(B) * K) return;
  const int row = static_cast<int>(idx / K);
  const int k = static_cast<int>(idx - static_cast<long long>(row) * K);
  double acc = 0.0;
  for (int t = 0; t < T; ++t) {
    if (K > 1 && __ldg(cls + t) != k) continue;
    int g = __ldg(gather_idx + t);
    g = g < 0 ? 0 : (g >= R ? R - 1 : g);
    int s = __ldg(slots + static_cast<size_t>(g) * B + row);
    s = s < 0 ? 0 : (s >= NL ? NL - 1 : s);
    acc = __dadd_rn(acc, __ldg(values + static_cast<size_t>(t) * NL + s));
  }
  out[idx] = acc;
}

}  // namespace

// slots [R, B] i32, gather_idx [T] i32, values [T, NL] f64, cls [T] i32 or
// null when K == 1, out [B, K] f64.  Returns the cudaError_t of the launch.
extern "C" int lgbt_accumulate(const int* slots, int R, int B,
                               const int* gather_idx, const double* values,
                               int T, int NL, const int* cls, int K,
                               double* out, cudaStream_t stream) {
  const long long n = static_cast<long long>(B) * K;
  if (n <= 0) return 0;
  if (T > 0 && (R <= 0 || NL <= 0)) return cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  accumulate_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      slots, R, B, gather_idx, values, T, NL, cls, K, out);
  return static_cast<int>(cudaGetLastError());
}
