// The serving kernels' two stages, shared by the standalone traverse
// (`traverse.cu`, K6), the standalone exact sum (`accumulate.cu`) and the
// fused entry (`serve.cu`).
//
// The walk stage routes rows through trees, a few cursors a thread in
// lockstep.  A node comes from a source (the JAX layout's node word,
// child word and palette in `traverse.cu`; one 16-byte record in
// `serve.cu`), so the routing below is written once.  It is `ops/predict.py:_leaf_slots` on the same staged
// f32 rows, with the four out-of-range rules of the TPU kernel's one-hot
// gathers (`lightgbm_tpu/compiler/kernel.py:_traverse_kernel`):
//   feature id >= F           -> feature value +0.0
//   palette code >= P         -> threshold +0.0 (the source applies it)
//   cursor >= NI              -> selects nothing: the next cursor is 0
//   cursor >= 0 after `depth` -> leaf 0
// NaN is tested before any substitution, subnormals compare as IEEE f32
// (no -ftz, no fast math) and a categorical value truncates as
// static_cast<int>.
//
// The ordered-sum stage adds a chunk of leaf values, gathered in parallel
// into shared memory as [trees, rows] f64, into one accumulator per
// (row, class), in boosting order, with __dadd_rn from +0.0: the order of
// `ops/predict.py accumulate_slots_exact`, hence its bits at any chunk
// size.  No atomics, no tree reduction, no partial sums merged later.
// Its f32 instances (`serve.cu`'s `lgbt_serve_f32` and `accumulate.cu`'s
// f32 sum, `device_predict`'s) add f32 values with __fadd_rn in the same
// order.

#pragma once

#include <cuda_runtime.h>

namespace forest {

// shared memory a block may use on sm_90 (232,448 bytes), and what a
// launch gets without opting in
constexpr int kMaxSmem = 227 * 1024;
constexpr int kDefaultSmem = 48 * 1024;

__host__ __device__ inline int align16(int n) { return (n + 15) / 16 * 16; }

// One node as the walk reads it.
struct Node {
  int w;      // node word: code, feature, default_left, missing_type, is_cat
  int kd;     // child word: left << 16 | (right & 0xFFFF)
  float thr;  // the decoded threshold
};

// Route N rows through N trees in lockstep (N independent cursors a
// thread, so that their loads are in flight together).  Cursor i starts at
// the root of a tree of ni[i] node slots and walks at most depth[i] steps
// (0: it is not walked); src.node(i, nd) gives node nd of its tree for
// 0 <= nd < ni[i], src.cat(i, nd, widx) its bitset word widx (MW > 0
// only), x[i] its row ([F] f32).  slot[i] gets the leaf slot.
template <int N, class Src>
__device__ __forceinline__ void walk(const Src& src, const float* const* x,
                                     int F, int MW, const int* ni,
                                     const int* depth, int* slot) {
  int nd[N];
  int steps = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    nd[i] = 0;
    steps = max(steps, depth[i]);
  }
  for (int s = 0; s < steps; ++s) {
    bool go[N], in[N];
    bool any = false;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      go[i] = s < depth[i] && nd[i] >= 0;
      in[i] = go[i] && nd[i] < ni[i];   // one-hot over NI slots: else 0
      any |= go[i];
    }
    if (!any) break;
    Node n[N];
    float fval[N];
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (in[i]) n[i] = src.node(i, nd[i]);
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (in[i]) {
        const int feat = (n[i].w >> 16) & 0xFFF;
        fval[i] = feat < F ? x[i][feat] : 0.0f;
      }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (!go[i]) continue;
      if (!in[i]) {
        nd[i] = 0;
        continue;
      }
      const int w = n[i].w;
      const int code = w & 0xFFFF;
      const bool default_left = ((w >> 28) & 1) != 0;
      const int missing_type = (w >> 29) & 3;
      const float fv0 = fval[i];
      const bool isnan_ = fv0 != fv0;
      const float fv = (isnan_ && missing_type != 2) ? 0.0f : fv0;
      const bool is_missing = (missing_type == 1 && fabsf(fv) <= 1e-35f) ||
                              (missing_type == 2 && isnan_);
      bool go_left = is_missing ? default_left : (fv <= n[i].thr);
      if (MW > 0 && w < 0) {   // is_cat is bit 31: the sign, not w >> 31
        const float span = static_cast<float>(code * 32);
        const bool ok = !isnan_ && fv0 > -1.0f && fv0 < span;
        const int v = ok ? static_cast<int>(fv0) : 0;   // truncates
        int widx = v / 32;
        widx = widx < 0 ? 0 : (widx > MW - 1 ? MW - 1 : widx);
        const unsigned cw = static_cast<unsigned>(src.cat(i, nd[i], widx));
        go_left = ok && ((cw >> (v & 31)) & 1u);
      }
      // left: arithmetic shift; right: sign extension of the low half
      const int kd = n[i].kd;
      nd[i] = go_left ? (kd >> 16) : (((kd & 0xFFFF) ^ 0x8000) - 0x8000);
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) slot[i] = ~min(nd[i], -1);
}

// Copy rows [row0, row0 + R) of X [B, F] into xs at row stride F | 1, so
// that threads reading one feature of different rows hit different
// banks; rows past B are left as they are (no thread reads them).
__device__ __forceinline__ void load_rows(float* xs, const float* X, int B,
                                          int F, int row0, int R) {
  const int fp = F | 1;
  const int nrows = min(R, B - row0);
  const float* src = X + static_cast<size_t>(row0) * F;
  for (int i = threadIdx.x; i < nrows * F; i += blockDim.x) {
    const int rr = i / F;
    xs[rr * fp + (i - rr * F)] = src[i];
  }
}

// Shared-memory layout of the value buffers, the accumulators, the
// record buffers and the rows (`compiler/records.py serve_smem_layout`),
// at `vsize` bytes a value (8: f64, 4: f32).
struct Layout {
  int vals, acc, recs, xs, total;
};

__host__ __device__ inline Layout layout(int R, int cluster, int trees,
                                         int K, int F, int ni_max,
                                         bool stage, bool rows_smem,
                                         int vsize = 8) {
  const int rs = (R + cluster - 1) / cluster;
  Layout l;
  l.vals = 0;
  l.acc = l.vals + align16(2 * trees * R * vsize);
  l.recs = l.acc + align16(rs * K * vsize);
  l.xs = l.recs + (stage ? 2 * trees * ni_max * 16 : 0);
  l.total = l.xs + (rows_smem ? align16(R * (F | 1) * 4) : 0);
  return l;
}

// Round-to-nearest-even adds, never contracted: the f64 sum's and the
// f32 sum's.
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}

// The ordered-sum stage.  Chunk trees t0, t0 + 1, ... (< T) were walked
// by `owners` blocks, `per` trees each, block b's values at
// vals.of(b)[c * R + r] for its c-th tree; this block's threads (one per
// (row, class) of rows [r0, r0 + rs) of its R) add them into
// acc[(r - r0) * K + k] in tree order, in V (double or float).  With
// kMulti, tree t adds only into class cls[t * cls_stride]; else K is 1.
// Loads go 16 ahead of the dependent adds.
template <bool kMulti, class V, class Vals>
__device__ __forceinline__ void ordered_sum(V* acc, const Vals& vals,
                                            const int* __restrict__ cls,
                                            int cls_stride, int owners,
                                            int per, int t0, int T, int R,
                                            int K, int r0, int rs) {
  constexpr int kAhead = 16;
  const int n_rows = min(rs, R - r0);
  for (int i = threadIdx.x; i < n_rows * K; i += blockDim.x) {
    const int rr = kMulti ? i / K : i;
    const int k = kMulti ? i - rr * K : 0;
    const int r = r0 + rr;
    V a = acc[i];
    for (int b = 0; b < owners; ++b) {
      const V* v = vals.of(b) + r;
      const int tb = t0 + b * per;
      const int n = min(per, T - tb);
      int c0 = 0;
      for (; c0 + kAhead <= n; c0 += kAhead) {
        V buf[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) buf[u] = v[(c0 + u) * R];
#pragma unroll
        for (int u = 0; u < kAhead; ++u)
          if (!kMulti || __ldg(cls + (tb + c0 + u) * cls_stride) == k)
            a = add_rn(a, buf[u]);
      }
      for (; c0 < n; ++c0)
        if (!kMulti || __ldg(cls + (tb + c0) * cls_stride) == k)
          a = add_rn(a, v[c0 * R]);
    }
    acc[i] = a;
  }
}

// The value buffers of this block alone.
template <class V>
struct LocalValsOf {
  const V* v;
  __device__ const V* of(int) const { return v; }
};
using LocalVals = LocalValsOf<double>;

}  // namespace forest
