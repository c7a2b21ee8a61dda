// Tiled forest traversal to leaf slots: the standalone K6.
//
// Replaces the TPU kernel `lightgbm_tpu/compiler/kernel.py:_traverse_kernel`
// (the Pallas kernel driven by `_traverse_bucket`).  It computes the same
// [tiles * TT, B] int32 leaf slots of one depth bucket, bit for bit:
// routing is `forest::walk` (`forest_common.cuh`), which equals
// `ops/predict.py:_leaf_slots` on the same staged f32 rows, over the JAX
// layout's planes.  The serving path no longer calls it (the fused
// `serve.cu` walks the forest's records and sums in the same launch); it
// stays for callers that need the slots themselves (pred_leaf, a
// device-sum rung) and is held against its plain version.
//
// Design: grid (tile, row block of R rows: up to 64, fewer so that a
// launch has 256 blocks or more); the
// block's rows are copied into shared memory (row stride F|1) when the
// launch plan passes their size (`compiler/records.py traverse_plan`:
// past 48 KB the launch opts in, past 227 KB the rows are read from
// device memory), and its threads walk the tile's (tree, row) pairs,
// neighbouring lanes on neighbouring rows of one tree.  A node is a node
// word and a child word, then its palette entry (code >= P reads +0.0),
// through the read-only cache.
//
// What bounds it on the H100: the node visits, each a chain of dependent
// loads (words, then the palette, then the row), as in the fused kernel;
// the bytes (rows in, slots out, the planes once) are small next to that.
//
// Built without fast math: NaN tests, subnormal inputs and the 1e-35
// compare are IEEE f32.

#include <cuda_runtime.h>

#include "forest_common.cuh"

namespace {

constexpr int kMaxThreads = 256;

// A tree's nodes in the JAX layout: node word, child word, then the
// tile's palette entry (code >= P reads +0.0), through the read-only cache.
struct PlaneSrc {
  const int* tw;            // the tree's node words [NI]
  const int* tk;            // its child words [NI]
  const float* tpal;        // its tile's palette [P]
  const int* catw;          // its bitset words [NI, MW]
  int P, MW;
  __device__ forest::Node node(int, int nd) const {
    const int w = __ldg(tw + nd);
    const int code = w & 0xFFFF;
    return forest::Node{w, __ldg(tk + nd),
                        code < P ? __ldg(tpal + code) : 0.0f};
  }
  __device__ int cat(int, int nd, int widx) const {
    return __ldg(catw + static_cast<size_t>(nd) * MW + widx);
  }
};

template <bool kRowsSmem>
__global__ void __launch_bounds__(kMaxThreads)
traverse_kernel(const float* __restrict__ X, int B, int F, int R,
                const int* __restrict__ words, const int* __restrict__ kids,
                const float* __restrict__ pal, const int* __restrict__ catw,
                int TT, int NI, int P, int MW, int depth,
                int* __restrict__ out) {
  extern __shared__ __align__(16) float xs[];
  const int tile = blockIdx.x;
  const int row0 = blockIdx.y * R;
  const int fp = F | 1;
  if (kRowsSmem) {
    forest::load_rows(xs, X, B, F, row0, R);
    __syncthreads();
  }
  for (int p = threadIdx.x; p < TT * R; p += blockDim.x) {
    const int j = p / R;
    const int r = p - j * R;
    const int row = row0 + r;
    if (row >= B) continue;
    const size_t tree = static_cast<size_t>(tile) * TT + j;
    const PlaneSrc src{words + tree * NI, kids + tree * NI,
                       pal + static_cast<size_t>(tile) * P,
                       catw + tree * NI * MW, P, MW};
    const float* x[1] = {kRowsSmem ? xs + r * fp
                                   : X + static_cast<size_t>(row) * F};
    const int ni[1] = {NI};
    const int steps[1] = {depth};
    int slot[1];
    forest::walk<1>(src, x, F, MW, ni, steps, slot);
    out[tree * B + row] = slot[0];
  }
}

}  // namespace

// X [B, F] f32, words/kids [ntiles, TT, NI] i32, pal [ntiles, P] f32,
// catw [ntiles, TT, NI, MW] i32 or null when MW == 0, out [ntiles*TT, B]
// i32.  R: rows a block; threads a block; `smem` the bytes of a row block
// in shared memory, align16(R * (F | 1) * 4), or 0 to read rows from
// device memory.  Returns the cudaError_t of the launch (0 on success).
extern "C" int lgbt_traverse(const float* X, int B, int F, const int* words,
                             const int* kids, const float* pal,
                             const int* catw, int ntiles, int TT, int NI,
                             int P, int MW, int depth, int R, int threads,
                             int smem, int* out, cudaStream_t stream) {
  if (B <= 0 || ntiles <= 0 || TT <= 0) return 0;
  if (R <= 0 || (B + R - 1) / R > 65535 || threads <= 0 ||
      threads > kMaxThreads || threads % 32 != 0 || NI <= 0 || P <= 0 ||
      (MW > 0 && catw == nullptr))
    return cudaErrorInvalidValue;
  const bool rows_smem = smem > 0;
  if (smem < 0 || smem > forest::kMaxSmem ||
      (rows_smem && smem != forest::align16(R * (F | 1) * 4)))
    return cudaErrorInvalidValue;
  dim3 grid(ntiles, (B + R - 1) / R);
  if (rows_smem) {
    if (smem > forest::kDefaultSmem) {
      cudaError_t e = cudaFuncSetAttribute(
          traverse_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (e != cudaSuccess) return e;
    }
    traverse_kernel<true><<<grid, threads, smem, stream>>>(
        X, B, F, R, words, kids, pal, catw, TT, NI, P, MW, depth, out);
  } else {
    traverse_kernel<false><<<grid, threads, 0, stream>>>(
        X, B, F, R, words, kids, pal, catw, TT, NI, P, MW, depth, out);
  }
  return static_cast<int>(cudaGetLastError());
}
