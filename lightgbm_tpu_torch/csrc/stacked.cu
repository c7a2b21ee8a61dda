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
// The records (`compiler/records.py stacked_records`, built by
// `ops/predict.py with_records` for the callers that launch this kernel):
// one 16-byte record a node, read with one vector load from one sector,
// holding the threshold's bits (or, on a categorical node, its word
// count), both children whole, and the feature id, default_left, the
// missing type and is_cat in one word.  A
// feature id outside [0, 2^28 - 1) is stored as 2^28 - 1, which is at
// or past every row width the entry takes (F <= 2^28 - 1), so it reads
// 0.0 as the out-of-range rule says: the packing encodes that rule and
// drops no case.  The bitset words stay in their [T, NI, MW] plane.
//
// Design (the port's first one was one thread a (tree, row), one tree a
// block, five gathers a visit, each block re-reading its rows of X): a
// block holds R rows and walks a chunk of C trees for them, reading each
// row's values from device memory through L1.  Thread i walks the (tree,
// row) pairs i, i + threads, ..., one at a time: on the H100 two and four
// cursors a thread in lockstep (`forest::walk`'s way) were slower, and
// so were lanes that took their next pair as soon as they reached a leaf,
// and so was staging the block's rows in shared memory at stride F | 1
// (`forest::load_rows`'s way) (PERF.md).  Pair p is row p % R of tree
// p / R, so a warp's lanes sit on neighbouring rows of one tree and
// start at its root together: while they agree they read one record, and
// the slots [T, N] are written coalesced.  The grid's tree chunks
// (`compiler/records.py stacked_plan`) spread a 1-row request's trees
// over the SMs.  Rows are independent, so a padded batch's real rows
// equal the unpadded batch's.
//
// What bounds it on the H100: the instructions and the dependent loads of
// the walk (the record, then the row's value, then the next record), not bytes (the records and X once, the [T, N] slots out).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxGridY = 65535;
constexpr int kFeatOut = (1 << 28) - 1;

// One routing step of a cursor at record r (nd inside [0, NI)): the next
// cursor.
template <bool kCat>
__device__ __forceinline__ int route(const int4 r, float fval,
                                     const int* __restrict__ cat_words,
                                     size_t node, int MW) {
  const int w = r.w;
  const bool default_left = ((w >> 28) & 1) != 0;
  const int missing_type = (w >> 29) & 3;
  const bool isnan_v = fval != fval;
  const float fv = (isnan_v && missing_type != 2) ? 0.0f : fval;
  const bool is_missing = (missing_type == 1 && fabsf(fv) <= 1e-35f) ||
                          (missing_type == 2 && isnan_v);
  bool go_left = is_missing ? default_left : (fv <= __int_as_float(r.x));
  if (kCat && w < 0) {   // is_cat is bit 31: the sign
    // the word count times 32 in int32, wrapping as the plain version's
    const float span = static_cast<float>(
        static_cast<int>(static_cast<unsigned>(r.x) * 32u));
    const bool ok = !isnan_v && fval > -1.0f && fval < span;
    const int v = ok ? static_cast<int>(fval) : 0;   // truncates
    int widx = v / 32;
    widx = widx < 0 ? 0 : (widx > MW - 1 ? MW - 1 : widx);
    const unsigned cw =
        static_cast<unsigned>(__ldg(cat_words + node * MW + widx));
    go_left = ok && ((cw >> (v % 32)) & 1u);
  }
  return go_left ? r.y : r.z;
}

template <bool kCat>
__global__ void __launch_bounds__(kMaxThreads)
stacked_kernel(const float* __restrict__ X, int N, int F,
               const int4* __restrict__ rec,
               const int* __restrict__ cat_words, int T, int NI, int MW,
               int R, int C, int* __restrict__ out) {
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, N - row0);
  for (int t0 = blockIdx.y * C; t0 < T; t0 += gridDim.y * C) {
    const int pairs = nrows * min(C, T - t0);
    for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
      const int r = p % nrows;
      const int t = t0 + p / nrows;
      const size_t base = static_cast<size_t>(t) * NI;
      const float* x = X + static_cast<size_t>(row0 + r) * F;
      int nd = 0;
      for (int step = 0; step <= NI && nd >= 0; ++step) {
        if (nd >= NI) {   // a node id past the planes: leaf 0
          nd = -1;
          break;
        }
        const int4 rc = __ldg(rec + base + nd);
        const int f = rc.w & kFeatOut;
        nd = route<kCat>(rc, f < F ? __ldg(x + f) : 0.0f, cat_words,
                         base + nd, MW);
      }
      out[static_cast<size_t>(t) * N + row0 + r] = ~nd;
    }
  }
}

template <bool kCat>
int launch(const float* X, int N, int F, const int* rec,
           const int* cat_words, int T, int NI, int MW, int R, int C,
           int threads, int* out, cudaStream_t stream) {
  const int chunks = (T + C - 1) / C;
  const dim3 grid((N + R - 1) / R, chunks < kMaxGridY ? chunks : kMaxGridY);
  stacked_kernel<kCat><<<grid, threads, 0, stream>>>(
      X, N, F, reinterpret_cast<const int4*>(rec), cat_words, T, NI, MW, R,
      C, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// X [N, F] f32; rec [T, NI, 4] i32 (the records above); cat_words
// [T, NI, MW] i32, or null for a model without categorical splits; out
// [T, N] i32.  The launch (`compiler/records.py stacked_plan`): R rows a
// block, C trees a block, `threads` a block.  Returns the cudaError_t of
// the launch.
extern "C" int lgbt_stacked_slots(const float* X, int N, int F,
                                  const int* rec, const int* cat_words,
                                  int T, int NI, int MW, int R, int C,
                                  int threads, int* out,
                                  cudaStream_t stream) {
  if (N <= 0 || T <= 0) return 0;
  if (NI <= 0 || F < 0 || F > kFeatOut || R <= 0 || C <= 0 ||
      threads < 32 || threads > kMaxThreads || threads % 32 ||
      (cat_words != nullptr && MW <= 0))
    return cudaErrorInvalidValue;
  if (cat_words != nullptr)
    return launch<true>(X, N, F, rec, cat_words, T, NI, MW, R, C, threads,
                        out, stream);
  return launch<false>(X, N, F, rec, cat_words, T, NI, MW, R, C, threads,
                       out, stream);
}
