// The fused serving kernel: every tree of every depth bucket, then the
// boosting-order sum, in one launch; an f64 instance (serving's exact
// sum) and an f32 instance (`device_predict`'s sum).
//
// Replaces, on the compiled serving path, the TPU kernel
// `lightgbm_tpu/compiler/kernel.py:_traverse_kernel` (one launch per depth
// bucket, slots to device memory) and the XLA scan
// `lightgbm_tpu/ops/predict.py:accumulate_slots_exact` that sums them in
// boosting order in software binary64.  It writes only the [B] or [B, K]
// f64 sums, bit for bit those of the two: the routing is `forest::walk`
// over the forest's records (`compiler/records.py`: one 16-byte record a
// node, the threshold decoded from the tile's palette, the trees in
// boosting order with their tile's padded NI and their bucket's depth),
// the sum `forest::ordered_sum`.
//
// What bounds it on the H100: its floor is the bytes (3.5 MB of rows,
// records and leaf values at 4096 rows on the 500 x 255-leaf model, about
// 1 us), but the node visits hold it far above that: B x (mean leaf
// depth) visits a tree (13M at 4096 rows), each a dependent chain of a
// record load, a row load and a few integer and f32 operations, and at
// deep levels the 32 lanes of a warp load records from up to 32 different
// lines.  What the design does:
//   - the work is (tree, row) pairs, not rows: a block holds R rows in
//     shared memory and its threads walk a chunk of trees for all of them,
//     neighbouring lanes on neighbouring rows of one tree (the top levels
//     then read one record for the whole warp), N cursors a thread in
//     lockstep so that their loads are in flight together;
//   - one 16-byte record load a visit instead of three dependent gathers;
//   - the leaf values of a chunk go to shared memory as [trees, R] (f64
//     or f32), and one thread per (row, class) adds them in boosting
//     order, carrying its accumulator from chunk to chunk: the slots
//     never go to device memory.  One barrier a chunk (the value buffers
//     are double-buffered).
// The launch plan (`compiler/records.py forest_plan`) picks single blocks
// of up to 16 rows, as many blocks as give two an SM, and two cursors a
// thread when it has more than one pair: the fastest of a sweep over
// clusters, rows, cursors and staging on an H100 (PERF.md).  Two more
// branches stay, measured slower and held bitwise: a row block served by
// a thread-block cluster of up to 8 blocks, each walking its share of a
// chunk's trees while the summing threads read the values from the
// cluster's shared memory (DSMEM) in tree order (one more cluster barrier
// at the end, so that no block leaves while another reads its values);
// and a chunk's records copied into shared memory by cp.async,
// double-buffered against the walk of the previous chunk.
//
// The f32 instance, `lgbt_serve_f32`, replaces on `device_predict`'s
// plan route the standalone traverses and the f32 sum of their slots
// (`accumulate.cu`): the JAX package's batch program
// `lightgbm_tpu/ops/predict.py:188 predict_raw_ensemble` (`:212`
// multiclass), an XLA scan whose f32 carry from +0.0 takes one f32 add
// of each tree's f32 leaf value in boosting order, into the tree's class
// column.  The same walk, the same values in the same order with
// __fadd_rn, give its bits; the slots, the bytes that bounded the
// standalone sum, never reach device memory.  Its value buffers and
// accumulators are laid out at 4 bytes a value (`forest::layout`).
//
// Built with -fmad=false, no fast math: the adds are __dadd_rn or
// __fadd_rn, and the routing's compares IEEE f32.  Record, leaf-slot and
// class indices are clamped as the accumulation's gathers clamp.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "forest_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copy the records of trees [tb, tb + n) into buf (n > 0): they lie
// together, in boosting order.
__device__ __forceinline__ void stage_records(int4* buf,
                                              const int4* __restrict__ nodes,
                                              const int4* __restrict__ meta,
                                              int tb, int n) {
  if (n <= 0) return;
  const int first = __ldg(&meta[tb].x);
  const int4 last = __ldg(meta + tb + n - 1);
  const int count = last.x + last.y - first;
  for (int i = threadIdx.x; i < count; i += blockDim.x)
    cp_async16(buf + i, nodes + first + i);
}

// The records of N cursors' trees: in shared memory (staged) or read
// through L1.
template <int N, bool kStage>
struct RecordSrc {
  const int4* tn[N];        // each cursor's tree's first record
  const int* catw;          // [N_nodes, MW], beside the records
  int first[N];             // each tree's first record in `nodes`
  int MW;
  __device__ forest::Node node(int i, int nd) const {
    const int4 v = kStage ? tn[i][nd] : __ldg(tn[i] + nd);
    return forest::Node{v.x, v.y, __int_as_float(v.z)};
  }
  __device__ int cat(int i, int nd, int widx) const {
    return __ldg(catw + (static_cast<size_t>(first[i]) + nd) * MW + widx);
  }
};

// The value buffers of the cluster's blocks, read through DSMEM.
template <class V>
struct ClusterVals {
  V* v;
  __device__ const V* of(int b) const {
    return cg::this_cluster().map_shared_rank(v, b);
  }
};

// V: double (serving's exact sum) or float (device_predict's sum).
template <class V, bool kCluster, bool kStage, int N>
__global__ void __launch_bounds__(kMaxThreads)
serve_kernel(const float* __restrict__ X, int B, int F, int rows_smem,
             const int4* __restrict__ nodes, const int4* __restrict__ meta,
             const int* __restrict__ catw, int MW,
             const V* __restrict__ values, int NL, int T, int K, int R,
             int trees, int ni_max, V* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int owners = kCluster ? static_cast<int>(gridDim.x) : 1;
  const int rank = kCluster ? static_cast<int>(blockIdx.x) : 0;
  const forest::Layout l =
      forest::layout(R, owners, trees, K, F, ni_max, kStage, rows_smem != 0,
                     static_cast<int>(sizeof(V)));
  V* vals = reinterpret_cast<V*>(smem + l.vals);
  V* acc = reinterpret_cast<V*>(smem + l.acc);
  int4* recs = reinterpret_cast<int4*>(smem + l.recs);
  float* xs = reinterpret_cast<float*>(smem + l.xs);
  const int row0 = blockIdx.y * R;
  const int rs = (R + owners - 1) / owners;
  const int r0 = rank * rs;
  const int fp = F | 1;
  const int chunk = trees * owners;
  const int nq = (T + chunk - 1) / chunk;
  const int rec_cap = trees * ni_max;
  const int* cls = &meta[0].w;

  for (int i = threadIdx.x; i < rs * K; i += blockDim.x) acc[i] = V(0);
  if (rows_smem) forest::load_rows(xs, X, B, F, row0, R);
  if (kStage) {
    stage_records(recs, nodes, meta, rank * trees,
                  min(trees, T - rank * trees));
    cp_async_commit();
  }
  for (int q = 0; q < nq; ++q) {
    const int buf = q & 1;
    const int tb = q * chunk + rank * trees;     // this block's first tree
    const int nb = min(trees, T - tb);
    if (kStage) {
      if (q + 1 < nq)
        stage_records(recs + (buf ^ 1) * rec_cap, nodes, meta, tb + chunk,
                      min(trees, T - tb - chunk));
      cp_async_commit();
      cp_async_wait_prev();      // this chunk's copies are done
      __syncthreads();           // everyone's, and the rows
    } else if (rows_smem && q == 0) {
      __syncthreads();
    }
    const int4* rbuf = recs + buf * rec_cap;
    const int rfirst = (kStage && nb > 0) ? __ldg(&meta[tb].x) : 0;
    V* vbuf = vals + buf * trees * R;
    const int pairs = trees * R;
    for (int p0 = threadIdx.x; p0 < pairs; p0 += N * blockDim.x) {
      RecordSrc<N, kStage> src;
      src.catw = catw;
      src.MW = MW;
      const float* x[N];
      int ni[N], depth[N], slot[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int p = p0 + i * blockDim.x;
        const int c = p / R;
        const int r = p - c * R;
        const int row = row0 + r;
        depth[i] = 0;            // not walked
        ni[i] = 1;
        src.first[i] = 0;
        src.tn[i] = nodes;
        x[i] = xs;
        if (p < pairs && c < nb && row < B) {
          const int4 m = __ldg(meta + tb + c);
          src.first[i] = m.x;
          src.tn[i] = kStage ? rbuf + (m.x - rfirst) : nodes + m.x;
          ni[i] = m.y;
          depth[i] = m.z;
          x[i] = rows_smem ? xs + r * fp : X + static_cast<size_t>(row) * F;
        }
      }
      forest::walk<N>(src, x, F, MW, ni, depth, slot);
      V v[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int p = p0 + i * blockDim.x;
        const int c = p / R;
        int s = slot[i];
        s = s < 0 ? 0 : (s >= NL ? NL - 1 : s);
        v[i] = (p < pairs && c < nb && row0 + p - c * R < B)
                   ? __ldg(values + static_cast<size_t>(tb + c) * NL + s)
                   : V(0);
      }
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (p0 + i * blockDim.x < pairs) vbuf[p0 + i * blockDim.x] = v[i];
    }
    if (kCluster) {
      cg::this_cluster().sync();
      const ClusterVals<V> cv{vbuf};
      if (K > 1)
        forest::ordered_sum<true>(acc, cv, cls, 4, owners, trees, q * chunk,
                                  T, R, K, r0, rs);
      else
        forest::ordered_sum<false>(acc, cv, cls, 4, owners, trees,
                                   q * chunk, T, R, 1, r0, rs);
    } else {
      __syncthreads();
      const forest::LocalValsOf<V> lv{vbuf};
      if (K > 1)
        forest::ordered_sum<true>(acc, lv, cls, 4, 1, trees, q * chunk, T,
                                  R, K, 0, R);
      else
        forest::ordered_sum<false>(acc, lv, cls, 4, 1, trees, q * chunk, T,
                                   R, 1, 0, R);
    }
  }
  if (kCluster) cg::this_cluster().sync();   // no block leaves while read
  const int n_rows = min(rs, R - r0);
  for (int i = threadIdx.x; i < n_rows * K; i += blockDim.x) {
    const int row = row0 + r0 + i / K;
    if (row < B) out[static_cast<size_t>(row) * K + i % K] = acc[i];
  }
}

template <class V, bool kCluster, bool kStage, int N>
int launch(const float* X, int B, int F, const int* nodes, const int* meta,
           const int* catw, int MW, const V* values, int NL, int T, int K,
           int R, int cluster, int trees, int threads, int rows_smem,
           int ni_max, int smem, V* out, cudaStream_t stream) {
  auto kernel = serve_kernel<V, kCluster, kStage, N>;
  if (smem > forest::kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (B + R - 1) / R);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (kCluster) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, X, B, F, rows_smem, reinterpret_cast<const int4*>(nodes),
      reinterpret_cast<const int4*>(meta), catw, MW, values, NL, T, K, R,
      trees, ni_max, out);
  if (e != cudaSuccess) return e;
  return static_cast<int>(cudaGetLastError());
}

template <class V, bool kCluster, bool kStage>
int launch_ilp(int ilp, const float* X, int B, int F, const int* nodes,
               const int* meta, const int* catw, int MW, const V* values,
               int NL, int T, int K, int R, int cluster, int trees,
               int threads, int rows_smem, int ni_max, int smem, V* out,
               cudaStream_t stream) {
#define LGBT_ILP(N)                                                         \
  return launch<V, kCluster, kStage, N>(X, B, F, nodes, meta, catw, MW,     \
                                        values, NL, T, K, R, cluster, trees, \
                                        threads, rows_smem, ni_max, smem,   \
                                        out, stream)
  if (ilp == 4) LGBT_ILP(4);
  if (ilp == 2) LGBT_ILP(2);
  LGBT_ILP(1);
#undef LGBT_ILP
}

// Checks a launch of the V instance and dispatches its branch: cluster
// or single blocks, staged or L1 records, `ilp` cursors a thread.  A plan
// no branch takes is refused with cudaErrorInvalidValue.
template <class V>
int serve(const float* X, int B, int F, const int* nodes, const int* meta,
          const int* catw, int MW, const V* values, int NL, int T, int K,
          int R, int cluster, int trees, int threads, int ilp, int stage,
          int rows_smem, int ni_max, int smem, V* out, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (T <= 0 || NL <= 0 || K <= 0 || R <= 0 || trees <= 0 || ni_max <= 0 ||
      F < 0 || (MW > 0 && catw == nullptr) || threads <= 0 ||
      threads > kMaxThreads || threads % 32 != 0 ||
      (ilp != 1 && ilp != 2 && ilp != 4) ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      (B + R - 1) / R > 65535)
    return cudaErrorInvalidValue;
  const forest::Layout l =
      forest::layout(R, cluster, trees, K, F, ni_max, stage != 0,
                     rows_smem != 0, static_cast<int>(sizeof(V)));
  if (smem != l.total || smem > forest::kMaxSmem)
    return cudaErrorInvalidValue;
#define LGBT_SERVE(C, S)                                                    \
  return launch_ilp<V, C, S>(ilp, X, B, F, nodes, meta, catw, MW, values,  \
                             NL, T, K, R, cluster, trees, threads,          \
                             rows_smem, ni_max, smem, out, stream)
  if (cluster > 1 && stage) LGBT_SERVE(true, true);
  if (cluster > 1) LGBT_SERVE(true, false);
  if (stage) LGBT_SERVE(false, true);
  LGBT_SERVE(false, false);
#undef LGBT_SERVE
}

}  // namespace

// X [B, F] f32; nodes [N, 4] i32 and meta [T, 4] i32, the records
// (`compiler/records.py`), catw [N, MW] i32 or null when MW == 0; values
// [T, NL] f64; out [B, K] f64.  The launch (`compiler/records.py
// forest_plan`): R rows a row block, `cluster` blocks a row block (1, 2,
// 4 or 8), `trees` trees a block a chunk, `threads` a block, `ilp`
// cursors a thread walks together (1, 2 or 4), `stage` and `rows_smem`
// as 0/1, `smem` the bytes of its layout at 8 bytes a value.  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int lgbt_serve(const float* X, int B, int F, const int* nodes,
                          const int* meta, const int* catw, int MW,
                          const double* values, int NL, int T, int K, int R,
                          int cluster, int trees, int threads, int ilp,
                          int stage, int rows_smem, int ni_max, int smem,
                          double* out, cudaStream_t stream) {
  return serve<double>(X, B, F, nodes, meta, catw, MW, values, NL, T, K, R,
                       cluster, trees, threads, ilp, stage, rows_smem,
                       ni_max, smem, out, stream);
}

// The f32 instance: `lgbt_serve`'s arguments with values [T, NL] f32, out
// [B, K] f32 and `smem` the layout at 4 bytes a value
// (`forest_plan(..., value_bytes=4)`).
extern "C" int lgbt_serve_f32(const float* X, int B, int F, const int* nodes,
                              const int* meta, const int* catw, int MW,
                              const float* values, int NL, int T, int K,
                              int R, int cluster, int trees, int threads,
                              int ilp, int stage, int rows_smem, int ni_max,
                              int smem, float* out, cudaStream_t stream) {
  return serve<float>(X, B, F, nodes, meta, catw, MW, values, NL, T, K, R,
                      cluster, trees, threads, ilp, stage, rows_smem, ni_max,
                      smem, out, stream);
}
