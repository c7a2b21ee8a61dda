// Sums of pre-routed leaf slots in boosting order: the standalone exact
// (f64) sum, and its f32 instance, `device_predict`'s sum.
//
// Not a TPU kernel.  The f64 sum: on the TPU,
// `lightgbm_tpu/ops/predict.py: accumulate_slots_exact` is an XLA scan that
// adds binary64 in software out of u32 operations (`_f64_add_bits`),
// because the TPU has no f64.  The H100 has native f64: tree t's value
// leaf_values[t, slots[gather_idx[t], row]] is added into its row's (and
// class's) accumulator with round-to-nearest-even, trees t = 0..T-1 in
// order, from +0.0: the same values, in the same order, with the same
// rounding at every step, hence the same bits.  The serving path no
// longer calls it (the fused `serve.cu` sums in the walk's launch); it
// stays for callers that hold slots (a device-sum rung) and is held
// against its plain version.
//
// The f32 sum: `Booster.predict(device_predict=True)`'s.  On the TPU it
// is the XLA scan of `lightgbm_tpu/ops/predict.py:188
// predict_raw_ensemble` (`:212 predict_raw_ensemble_multi`): an f32
// carry from +0.0, tree by tree in boosting order, each step one f32 add
// of the tree's f32 leaf value (a scatter-add into the tree's class
// column for multiclass).  The same chain here with __fadd_rn gives the
// same bits.  It is the same kernel with a float accumulator and float
// values; it keeps the f64 instance's launch plan and shared-memory
// layout, so half of each value slot goes unused.
//
// Design: the ordered-sum stage of `forest_common.cuh`.  A block owns R
// rows (up to 32, fewer so that a launch has 256 blocks or more); per
// chunk of trees its threads gather the chunk's (tree, row) values, four a
// thread with their loads in flight together, into shared memory as
// [trees, R] (double-buffered, one barrier a chunk), and one thread
// per (row, class) adds them in tree order, carrying its accumulator
// from chunk to chunk.  No atomics and no tree reduction, so the bits do
// not depend on the chunk.  Built with -fmad=false; the adds are explicit
// __dadd_rn / __fadd_rn.
//
// What bounds it on the H100: reading the [T, B] slots once (coalesced:
// neighbouring lanes read neighbouring rows) and the leaf-value gathers,
// which hit L2; the dependent adds (T a row) overlap the next chunk's
// gathers.
//
// Indices past the tables clamp, as XLA's gathers do in the JAX package.

#include <cuda_runtime.h>

#include "forest_common.cuh"

namespace {

constexpr int kMaxThreads = 256;
// pairs a thread gathers at once
constexpr int kGather = 4;

// V: double (the exact sum) or float (device_predict's sum).
template <class V>
__global__ void __launch_bounds__(kMaxThreads)
accumulate_kernel(const int* __restrict__ slots, int Rs, int B,
                  const int* __restrict__ gather_idx,
                  const V* __restrict__ values, int T, int NL,
                  const int* __restrict__ cls, int K, int R, int trees,
                  V* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const forest::Layout l = forest::layout(R, 1, trees, K, 0, 1, false,
                                          false);
  // the f64 layout; a float instance uses the first half of each buffer
  V* vals = reinterpret_cast<V*>(smem + l.vals);
  V* acc = reinterpret_cast<V*>(smem + l.acc);
  const int row0 = blockIdx.x * R;
  for (int i = threadIdx.x; i < R * K; i += blockDim.x) acc[i] = V(0);
  const int nq = (T + trees - 1) / trees;
  const int pairs = trees * R;
  for (int q = 0; q < nq; ++q) {
    const int tb = q * trees;
    const int nb = min(trees, T - tb);
    V* vbuf = vals + (q & 1) * pairs;
    // a thread's pairs are gathered together: the index loads, then the
    // slot loads, then the value loads
    for (int p0 = threadIdx.x; p0 < pairs; p0 += kGather * blockDim.x) {
      int g[kGather], s[kGather];
      bool ok[kGather];
#pragma unroll
      for (int i = 0; i < kGather; ++i) {
        const int p = p0 + i * blockDim.x;
        const int c = p / R;
        ok[i] = p < pairs && c < nb && row0 + p - c * R < B;
        g[i] = ok[i] ? __ldg(gather_idx + tb + c) : 0;
        g[i] = g[i] < 0 ? 0 : (g[i] >= Rs ? Rs - 1 : g[i]);
      }
#pragma unroll
      for (int i = 0; i < kGather; ++i) {
        const int p = p0 + i * blockDim.x;
        const int c = p / R;
        s[i] = ok[i] ? __ldg(slots + static_cast<size_t>(g[i]) * B + row0 +
                             p - c * R)
                     : 0;
        s[i] = s[i] < 0 ? 0 : (s[i] >= NL ? NL - 1 : s[i]);
      }
      V v[kGather];
#pragma unroll
      for (int i = 0; i < kGather; ++i) {
        const int c = (p0 + i * blockDim.x) / R;
        v[i] = ok[i] ? __ldg(values + static_cast<size_t>(tb + c) * NL + s[i])
                     : V(0);
      }
#pragma unroll
      for (int i = 0; i < kGather; ++i)
        if (p0 + i * blockDim.x < pairs) vbuf[p0 + i * blockDim.x] = v[i];
    }
    __syncthreads();
    const forest::LocalValsOf<V> lv{vbuf};
    if (K > 1)
      forest::ordered_sum<true>(acc, lv, cls, 1, 1, trees, tb, T, R, K, 0, R);
    else
      forest::ordered_sum<false>(acc, lv, cls, 1, 1, trees, tb, T, R, 1, 0,
                                 R);
  }
  for (int i = threadIdx.x; i < R * K; i += blockDim.x) {
    const int row = row0 + i / K;
    if (row < B) out[static_cast<size_t>(row) * K + i % K] = acc[i];
  }
}

// Checks the launch, sets the opt-in shared memory and launches; the
// cudaError_t of the launch.
template <class V>
int launch(const int* slots, int Rs, int B, const int* gather_idx,
           const V* values, int T, int NL, const int* cls, int K, int R,
           int trees, int threads, int smem, V* out, cudaStream_t stream) {
  if (B <= 0 || K <= 0) return 0;
  if ((T > 0 && (Rs <= 0 || NL <= 0)) || (K > 1 && cls == nullptr) ||
      R <= 0 || trees <= 0 || threads <= 0 || threads > kMaxThreads ||
      threads % 32 != 0)
    return cudaErrorInvalidValue;
  if (smem != forest::layout(R, 1, trees, K, 0, 1, false, false).total ||
      smem > forest::kMaxSmem)
    return cudaErrorInvalidValue;
  if (smem > forest::kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        accumulate_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
  }
  const long long blocks = (static_cast<long long>(B) + R - 1) / R;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  accumulate_kernel<V><<<static_cast<unsigned>(blocks), threads, smem,
                         stream>>>(slots, Rs, B, gather_idx, values, T, NL,
                                   cls, K, R, trees, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// slots [Rs, B] i32, gather_idx [T] i32, values [T, NL] f64, cls [T] i32 or
// null when K == 1, out [B, K] f64.  The launch (`compiler/records.py
// accumulate_plan`): R rows a block, `trees` trees a chunk, `threads` a
// block, `smem` the bytes of its layout.  Returns the cudaError_t of the
// launch.
extern "C" int lgbt_accumulate(const int* slots, int Rs, int B,
                               const int* gather_idx, const double* values,
                               int T, int NL, const int* cls, int K, int R,
                               int trees, int threads, int smem, double* out,
                               cudaStream_t stream) {
  return launch<double>(slots, Rs, B, gather_idx, values, T, NL, cls, K, R,
                        trees, threads, smem, out, stream);
}

// The f32 sum: as `lgbt_accumulate`, with values [T, NL] f32 and out
// [B, K] f32, at the same launch plan.
extern "C" int lgbt_accumulate_f32(const int* slots, int Rs, int B,
                                   const int* gather_idx, const float* values,
                                   int T, int NL, const int* cls, int K,
                                   int R, int trees, int threads, int smem,
                                   float* out, cudaStream_t stream) {
  return launch<float>(slots, Rs, B, gather_idx, values, T, NL, cls, K, R,
                       trees, threads, smem, out, stream);
}
