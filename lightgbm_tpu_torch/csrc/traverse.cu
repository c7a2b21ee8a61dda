// Tiled forest traversal for the compiled serving path.
//
// Replaces the TPU kernel `lightgbm_tpu/compiler/kernel.py:_traverse_kernel`
// (the Pallas kernel driven by `_traverse_bucket`).  It computes the same
// [tiles * TT, B] int32 leaf slots, bit for bit: routing equals
// `ops/predict.py:_leaf_slots` on the same staged f32 rows.
//
// Design (a first, simple kernel):
//   grid (tile, 256-row block), one thread per row.  The block's rows are
//   copied once into shared memory (row stride F|1 words, so that threads
//   reading the same feature hit different banks) when the caller passes
//   their size (`compiler/kernel.py:row_smem_bytes`: past 48 KB the launch
//   opts in to more, past 227 KB, 228 features and up, the caller passes 0
//   and the rows are read from global memory); each thread then walks
//   every tree of its tile for `depth` steps, reading node words, child
//   words, palette entries and bitset words through the read-only cache,
//   and writes ~min(cursor, -1).
//
// What bounds it on the H100: the node visits.  Per visit a thread does
// two dependent global loads (node word, then child word) that hit L1/L2,
// a shared-memory read and a handful of integer and f32 operations; each
// step depends on the previous one, so the kernel is latency-bound per
// thread and relies on many resident warps.  The bytes it must move (rows
// in, slots out, the packed planes once) are small next to that.  Left for
// later: staging a tile's planes in shared memory (cp.async / TMA), the
// tile budget that makes that possible, and more rows per thread to hide
// the load latency.
//
// The TPU kernel gathers with one-hot contractions, so every out-of-range
// index reads zero instead of faulting.  This kernel bounds-checks the same
// four reads and substitutes what the one-hot gives:
//   feature id >= F           -> feature value +0.0
//   palette code >= P         -> threshold +0.0
//   cursor >= NI              -> selects nothing: the next cursor is 0
//   cursor >= 0 after `depth` -> leaf 0
//
// Built without fast math: NaN tests, subnormal inputs and the 1e-35
// compare are IEEE f32.

#include <cuda_runtime.h>

namespace {

constexpr int kRowBlock = 256;
// shared memory a block may use on sm_90 (232,448 bytes), and what a
// launch gets without opting in
constexpr int kMaxSmem = 227 * 1024;
constexpr int kDefaultSmem = 48 * 1024;

__global__ void __launch_bounds__(kRowBlock)
traverse_kernel(const float* __restrict__ X, int B, int F, int br,
                const int* __restrict__ words, const int* __restrict__ kids,
                const float* __restrict__ pal, const int* __restrict__ catw,
                int TT, int NI, int P, int MW, int depth, int use_smem,
                int* __restrict__ out) {
  extern __shared__ float sx[];
  const int tile = blockIdx.x;
  const int r = threadIdx.x;
  const int row = blockIdx.y * br + r;
  const int fp = F | 1;
  const float* x;
  if (use_smem) {
    const float* src = X + static_cast<size_t>(blockIdx.y) * br * F;
    for (int i = r; i < br * F; i += blockDim.x) {
      const int rr = i / F;
      sx[rr * fp + (i - rr * F)] = src[i];
    }
    __syncthreads();
    x = sx + r * fp;
  } else {
    x = X + static_cast<size_t>(row) * F;
  }
  const float* tpal = pal + static_cast<size_t>(tile) * P;
  for (int j = 0; j < TT; ++j) {
    const size_t tree = static_cast<size_t>(tile) * TT + j;
    const int* tw = words + tree * NI;
    const int* tk = kids + tree * NI;
    int nd = 0;
    for (int s = 0; s < depth && nd >= 0; ++s) {
      if (nd >= NI) {            // one-hot over NI slots selects nothing
        nd = 0;
        continue;
      }
      const int w = __ldg(tw + nd);
      const int kd = __ldg(tk + nd);
      const int code = w & 0xFFFF;
      const int feat = (w >> 16) & 0xFFF;
      const bool default_left = ((w >> 28) & 1) != 0;
      const int missing_type = (w >> 29) & 3;
      const float fval = feat < F ? x[feat] : 0.0f;
      const float thr = code < P ? __ldg(tpal + code) : 0.0f;
      const bool isnan_ = fval != fval;
      const float fv = (isnan_ && missing_type != 2) ? 0.0f : fval;
      const bool is_missing = (missing_type == 1 && fabsf(fv) <= 1e-35f) ||
                              (missing_type == 2 && isnan_);
      bool go_left = is_missing ? default_left : (fv <= thr);
      if (MW > 0 && w < 0) {     // is_cat is bit 31: the sign, not w >> 31
        const float span = static_cast<float>(code * 32);
        const bool ok = !isnan_ && fval > -1.0f && fval < span;
        const int v = ok ? static_cast<int>(fval) : 0;   // truncates
        int widx = v / 32;
        widx = widx < 0 ? 0 : (widx > MW - 1 ? MW - 1 : widx);
        const unsigned cw = static_cast<unsigned>(
            __ldg(catw + (tree * NI + nd) * MW + widx));
        go_left = ok && ((cw >> (v & 31)) & 1u);
      }
      // left: arithmetic shift; right: sign extension of the low half
      nd = go_left ? (kd >> 16) : (((kd & 0xFFFF) ^ 0x8000) - 0x8000);
    }
    out[tree * B + row] = ~min(nd, -1);
  }
}

}  // namespace

// X [B, F] f32, words/kids [ntiles, TT, NI] i32, pal [ntiles, P] f32,
// catw [ntiles, TT, NI, MW] i32 or null when MW == 0, out [ntiles*TT, B]
// i32.  B is a multiple of min(B, 256).  `smem` is the bytes of a row
// block, min(B, 256) * (F | 1) * 4, or 0 to read rows from global memory.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int lgbt_traverse(const float* X, int B, int F, const int* words,
                             const int* kids, const float* pal,
                             const int* catw, int ntiles, int TT, int NI,
                             int P, int MW, int depth, int smem, int* out,
                             cudaStream_t stream) {
  if (B <= 0 || ntiles <= 0 || TT <= 0) return 0;
  const int br = B < kRowBlock ? B : kRowBlock;
  if (B % br != 0 || B / br > 65535) return cudaErrorInvalidValue;
  const int use_smem = smem > 0;
  if (smem < 0 || smem > kMaxSmem ||
      (use_smem && smem != br * (F | 1) * static_cast<int>(sizeof(float))))
    return cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        traverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(ntiles, B / br);
  traverse_kernel<<<grid, br, smem, stream>>>(X, B, F, br, words, kids, pal,
                                              catw, TT, NI, P, MW, depth,
                                              use_smem, out);
  return static_cast<int>(cudaGetLastError());
}
