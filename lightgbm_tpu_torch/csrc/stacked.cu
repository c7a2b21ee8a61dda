// The stacked-plane traversal: the [T, N] int32 leaf slots of every tree
// of the stacked [T, NI] planes (`Booster.export_predict_arrays`) for f32
// rows X [N, F].
//
// Not a TPU kernel.  On the TPU it is the XLA scan of
// `lightgbm_tpu/ops/predict.py:114 _leaf_slots` (a per-row while_loop,
// vmapped, under `:632 predict_leaf_ensemble`'s scan over trees); the
// port had it only as torch ops (`ops/predict.py _leaf_slots`), which make
// about 20 launches and one host sync a tree level.  It is the traversal
// of the serving runtime's device-sum and slot rungs, and of
// `device_predict` for a model outside the compiled plan's 12-bit feature
// and 16-bit palette fields.
//
// Semantics, all in IEEE f32 (built without fast math and with
// -fmad=false): a NaN with missing type != NaN reads 0.0; missing type
// Zero tests |v| <= f32(1e-35); a missing value goes to default_left; a
// categorical node (decision type bit 0) tests the category's bit in its
// bitset of `cat_nwords` words, with the range guard v > -1 and
// v < 32 * nwords (NaN, out of span and v <= -1 go right); a leaf is
// ~node.  A feature id outside [0, F) reads 0.0 and a node id at or past
// NI routes to leaf 0 (the plain version's rules for malformed planes);
// a cursor still inside after NI + 1 steps gives ~cursor, as the plain
// version's step bound does.
//
// Design: one thread a (tree, row); a block holds 256 rows of one tree,
// so a warp's cursors start at the same root and read the same plane
// words while they agree (broadcast loads through the read-only cache).
// Each thread reads its own row of X.  Rows are independent, so a padded
// batch's real rows equal the unpadded batch's.
//
// What bounds it on the H100: the dependent loads of the walk (node word,
// then the feature value, then the child), one chain a thread; the bytes
// are small (the planes and X once, the [T, N] slots out).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
stacked_kernel(const float* __restrict__ X, int N, int F,
               const int* __restrict__ feat, const float* __restrict__ thr,
               const int* __restrict__ dtype, const int* __restrict__ left,
               const int* __restrict__ right,
               const int* __restrict__ cat_words,
               const int* __restrict__ cat_nwords, int T, int NI, int MW,
               int* __restrict__ out) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= N) return;
  const float* x = X + static_cast<size_t>(row) * F;
  for (int t = blockIdx.y; t < T; t += gridDim.y) {
    const size_t base = static_cast<size_t>(t) * NI;
    int nd = 0;
    for (int step = 0; step <= NI && nd >= 0; ++step) {
      if (nd >= NI) {
        nd = -1;
        break;
      }
      const int f = __ldg(feat + base + nd);
      const float fval = (f >= 0 && f < F) ? x[f] : 0.0f;
      const int dt = __ldg(dtype + base + nd);
      const int missing_type = (dt >> 2) & 3;
      const bool default_left = (dt & 2) != 0;
      const bool isnan_v = fval != fval;
      const float fv = (isnan_v && missing_type != 2) ? 0.0f : fval;
      const bool is_missing =
          (missing_type == 1 && fabsf(fv) <= 1e-35f) ||
          (missing_type == 2 && isnan_v);
      bool go_left = is_missing ? default_left
                                : (fv <= __ldg(thr + base + nd));
      if (cat_words != nullptr && (dt & 1)) {
        const float span =
            static_cast<float>(__ldg(cat_nwords + base + nd) * 32);
        const bool ok = !isnan_v && fval > -1.0f && fval < span;
        const int v = ok ? static_cast<int>(fval) : 0;
        int widx = v / 32;
        widx = widx < 0 ? 0 : (widx > MW - 1 ? MW - 1 : widx);
        const unsigned w = static_cast<unsigned>(
            __ldg(cat_words + (base + nd) * MW + widx));
        go_left = ok && ((w >> (v % 32)) & 1u);
      }
      nd = go_left ? __ldg(left + base + nd) : __ldg(right + base + nd);
    }
    out[static_cast<size_t>(t) * N + row] = ~nd;
  }
}

}  // namespace

// X [N, F] f32; feat, dtype, left, right [T, NI] i32; thr [T, NI] f32;
// cat_words [T, NI, MW] i32 and cat_nwords [T, NI] i32, or both null for a
// model without categorical splits; out [T, N] i32.  Returns the
// cudaError_t of the launch.
extern "C" int lgbt_stacked_slots(const float* X, int N, int F,
                                  const int* feat, const float* thr,
                                  const int* dtype, const int* left,
                                  const int* right, const int* cat_words,
                                  const int* cat_nwords, int T, int NI,
                                  int MW, int* out, cudaStream_t stream) {
  if (N <= 0 || T <= 0) return 0;
  if (NI <= 0 || F < 0 || (cat_words != nullptr &&
                           (cat_nwords == nullptr || MW <= 0)))
    return cudaErrorInvalidValue;
  const dim3 grid((N + kThreads - 1) / kThreads,
                  T < kMaxGridY ? T : kMaxGridY);
  stacked_kernel<<<grid, kThreads, 0, stream>>>(X, N, F, feat, thr, dtype,
                                                left, right, cat_words,
                                                cat_nwords, T, NI, MW, out);
  return static_cast<int>(cudaGetLastError());
}
