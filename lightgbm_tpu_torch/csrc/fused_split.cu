// Fused multi-leaf histogram + numerical split scan (K2), its quantized
// twin (K5), and the scan alone over materialised histograms (K3).
//
// Replaces the TPU kernels `lightgbm_tpu/ops/pallas_hist.py:
// _fused_kernel_multi` (K2, driven by `_run_fused_multi`, scan tail
// `_fused_scan_tail`), `_fused_kernel_multi_i8` (K5, driven by
// `_run_fused_multi_i8`) and `_scan_only_kernel` (K3, `pallas_split_scan`).
// The scan is `lightgbm_tpu/ops/split.py fused_numerical_candidates`: for
// each (slot s, feature f) row of an [S, F, MB, 3] f32 histogram
// (g, h, count) and each missing direction (case 0: the NaN bin goes
// right, case 1: it goes left), the first-wins best threshold and its
// candidate row (gain, threshold, left g, left h, left count, 0, 0, 0),
// written to cand [S, 2, F, 8].  The contract is bitwise: the candidates
// equal the port's plain version (`ops/fused_kernel.py split_scan_plain`,
// torch ops in the order of `ops/split.py fused_numerical_candidates`) on
// the same histogram, and K2's histogram is the K1 kernel's.
//
// One scan.  `scan_row` scans one row held in shared memory; K2 and K3 run
// it in the same kernel and K5 in its own, so the candidates are
// interchangeable by construction (the wave grower scans the smaller
// children in K2 and the larger ones, parent minus smaller, in K3).  Every float operation is an
// IEEE f32 add, subtract, multiply or divide in the plain version's order,
// and this library is built with -fmad=false, so none is contracted:
//   * bins >= nb[f] read as +0.0 (the plain version's `where(valid_bin)`);
//   * prefix sums in the order of `ops/reduce.py block_cumsum` (XLA's CPU
//     cumsum): sequential within blocks of 16, the zero-padded block totals
//     prefix-summed the same way (recursing past 16 blocks, MB > 256), then
//     each block's elements plus the previous blocks' total (plus +0.0 in
//     the first block);
//   * gain = (leaf_gain(left) + leaf_gain(right)) - shift with
//     leaf_gain(g, h) = t*t / (h + l2) (0 unless h + l2 > 0),
//     t = sign(g) * max(|g| - l1, 0), right = parent - left, and
//     shift = leaf_gain(parent) + min_gain_to_split;
//   * gates: bin <= nb - 2 - has_nan, min_data and min_hessian on both
//     sides, case 1 only for NaN-missing features (its left adds the NaN
//     bin's sums to every prefix); a gated candidate is -inf;
//   * the argmax follows torch.argmax: the first maximum wins, a NaN beats
//     every number (the first NaN wins), and a row of -inf gives index 0,
//     so its candidate is (-inf, 0, the prefix at bin 0).
//
// K5 = K4's first stage (hist_q_common.cuh: the 42-slot row list with the
// listed rows' lattice words, then hist_q_partial_kernel's int32 partials,
// launched with the same plan) + a dequantize-and-scan stage with grid
// (feature, slot): the block sums its row's pieces (`sum_q_chunks`),
// converts them to f32 and scales g and h exactly as K4's reduce does
// (`dequant_cell`), so K5's histogram is K4's bit for bit; it writes the
// row to `hist`, keeps it in shared memory and scans it with the same
// `scan_row`.
//
// K2 = K1's first stage (hist_common.cuh: the row list and
// hist_partial_kernel, launched with the same plan) + K1's
// hist_reduce_kernel, which writes `hist`, so K2's histogram is K1's bit
// for bit, + K3's scan_kernel over `hist`, so K2's candidates are K3's.
// No float atomics.  K3 has grid (feature, slot) and loads the row from
// `hist`.
//
// What bounds them on the H100: bytes.  K2 reads what K1 reads (every
// row's leaf id, the bins and payload of the rows in the slots: its first
// stage lists those rows and reads only theirs) and writes the histogram
// and the candidates; K5 reads what K4 reads (every row's leaf id, the
// bins and three lattice bytes of the rows in the slots) and writes the
// histogram and the candidates; K3 reads a histogram and writes
// candidates (at 14 slots x 28 features x 255 bins, 1.2 MB in, 25 KB out).  The scan itself
// is a few hundred adds per row on 256 threads, one block per row; the
// block-total levels run on one thread per channel.  Left for later: more
// rows per block, warp-shuffle prefix sums in the same order.

#include "hist_common.cuh"
#include "hist_q_common.cuh"

namespace {

constexpr int kScanThreads = 256;
constexpr int kScanBlock = 16;     // block_cumsum's block (ops/reduce.py)
constexpr int kMaxLevels = 6;      // 16^5 bins and beyond need no more
constexpr int kCandCols = 8;
constexpr int kMissingNan = 2;

struct ScanParams {
  float l1, l2, min_data, min_hess, min_gain;
};

// The prefix-sum levels of an n-element row: level 0 holds the row padded
// to whole blocks of 16, level j + 1 the block totals of level j, up to
// the first level of at most 16 elements, which is not padded.
struct Levels {
  int top;
  int n[kMaxLevels];      // elements of each level
  int off[kMaxLevels];    // offset of each level in a channel's buffer
  int per_chan;           // floats of one channel's buffer
};

__host__ __device__ inline Levels make_levels(int mb) {
  Levels L;
  L.top = 0;
  L.n[0] = mb;
  while (L.n[L.top] > kScanBlock && L.top + 1 < kMaxLevels) {
    L.n[L.top + 1] = (L.n[L.top] + kScanBlock - 1) / kScanBlock;
    ++L.top;
  }
  int o = 0;
  for (int j = 0; j <= L.top; ++j) {
    L.off[j] = o;
    o += (j < L.top) ? kScanBlock * L.n[j + 1] : L.n[j];
  }
  L.per_chan = o;
  return L;
}

inline size_t scan_smem_bytes(int mb) {
  return static_cast<size_t>(3 * make_levels(mb).per_chan) * sizeof(float) +
         2 * kScanThreads * (sizeof(float) + sizeof(int));
}

__device__ __forceinline__ float leaf_gain(float g, float h, float l1,
                                           float l2) {
  // t * t only: the sign of t (torch.sign) cannot change it
  float m = fabsf(g) - l1;
  m = (m < 0.f) ? 0.f : m;                 // clamp_min, NaN stays NaN
  const float sg = (g > 0.f) ? 1.f : ((g < 0.f) ? -1.f : 0.f);
  const float t = sg * m;
  const float denom = h + l2;
  return (denom > 0.f) ? (t * t) / denom : 0.f;
}

// a (at index ia) beats b (at ib) under torch.argmax: NaN first, then the
// larger value, then the lower index
__device__ __forceinline__ bool beats(float a, int ia, float b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

// Scan one (slot, feature) row.  `x` [3][per_chan] holds the row channel
// by channel at level 0, bins >= nb already +0.0, every other float of the
// buffer +0.0; `red_v` / `red_i` are [2][kScanThreads] scratch.  Writes
// the two candidate rows of case 0 and case 1 to cand0 and cand1.
__device__ void scan_row(float* x, float* red_v, int* red_i, int mb, int nb,
                         int missing, const float* parent,
                         const ScanParams p, float* cand0, float* cand1) {
  const Levels L = make_levels(mb);
  const int tid = threadIdx.x;
  const int pc = L.per_chan;
  const bool has_nan = missing == kMissingNan;
  // the NaN bin's sums, read before the prefix sums overwrite the row
  float nanv[3];
  for (int c = 0; c < 3; ++c)
    nanv[c] = (has_nan && nb >= 1 && nb <= mb) ? x[c * pc + nb - 1] : 0.f;
  __syncthreads();

  // ---- prefix sums in block_cumsum's order ----
  for (int j = 0; j < L.top; ++j) {                 // blocks, level by level
    const int blocks = L.n[j + 1];
    for (int t = tid; t < 3 * blocks; t += kScanThreads) {
      const int c = t / blocks, b = t % blocks;
      float* v = x + c * pc + L.off[j] + b * kScanBlock;
      float acc = v[0];
      for (int i = 1; i < kScanBlock; ++i) {
        acc = acc + v[i];
        v[i] = acc;
      }
      x[c * pc + L.off[j + 1] + b] = acc;
    }
    __syncthreads();
  }
  if (tid < 3) {                                     // the top level
    float* v = x + tid * pc + L.off[L.top];
    float acc = v[0];
    for (int i = 1; i < L.n[L.top]; ++i) {
      acc = acc + v[i];
      v[i] = acc;
    }
  }
  __syncthreads();
  for (int j = L.top - 1; j >= 0; --j) {             // add block offsets
    const int len = kScanBlock * L.n[j + 1];
    for (int t = tid; t < 3 * len; t += kScanThreads) {
      const int c = t / len, i = t % len, b = i / kScanBlock;
      const float off = (b == 0) ? 0.f : x[c * pc + L.off[j + 1] + b - 1];
      x[c * pc + L.off[j] + i] = x[c * pc + L.off[j] + i] + off;
    }
    __syncthreads();
  }

  // ---- gains and the first-wins argmax of both cases ----
  const float pg = parent[0], ph = parent[1], pcnt = parent[2];
  const float shift = leaf_gain(pg, ph, p.l1, p.l2) + p.min_gain;
  const int t_max = nb - 2 - (has_nan ? 1 : 0);
  const float neg_inf = __int_as_float(0xff800000);
  float best_v[2] = {neg_inf, neg_inf};
  int best_i[2] = {mb, mb};
  for (int b = tid; b < mb; b += kScanThreads) {
    const float cg = x[b], ch = x[pc + b], cc = x[2 * pc + b];
    for (int cs = 0; cs < 2; ++cs) {
      const float lg = cs ? cg + nanv[0] : cg;
      const float lh = cs ? ch + nanv[1] : ch;
      const float lc = cs ? cc + nanv[2] : cc;
      const float rg = pg - lg, rh = ph - lh, rc = pcnt - lc;
      const float gain = (leaf_gain(lg, lh, p.l1, p.l2) +
                          leaf_gain(rg, rh, p.l1, p.l2)) - shift;
      const bool ok = b <= t_max && (cs == 0 || has_nan) &&
                      lc >= p.min_data && rc >= p.min_data &&
                      lh >= p.min_hess && rh >= p.min_hess;
      const float v = ok ? gain : neg_inf;
      if (beats(v, b, best_v[cs], best_i[cs])) {
        best_v[cs] = v;
        best_i[cs] = b;
      }
    }
  }
  for (int cs = 0; cs < 2; ++cs) {
    red_v[cs * kScanThreads + tid] = best_v[cs];
    red_i[cs * kScanThreads + tid] = best_i[cs];
  }
  __syncthreads();
  for (int half = kScanThreads / 2; half > 0; half >>= 1) {
    if (tid < half) {
      for (int cs = 0; cs < 2; ++cs) {
        const int a = cs * kScanThreads + tid, o = a + half;
        if (beats(red_v[o], red_i[o], red_v[a], red_i[a])) {
          red_v[a] = red_v[o];
          red_i[a] = red_i[o];
        }
      }
    }
    __syncthreads();
  }
  if (tid < 2) {
    const int cs = tid;
    const int b = red_i[cs * kScanThreads];          // < mb: mb >= 1
    float* out = cs ? cand1 : cand0;
    out[0] = red_v[cs * kScanThreads];
    out[1] = static_cast<float>(b);
    out[2] = cs ? x[b] + nanv[0] : x[b];
    out[3] = cs ? x[pc + b] + nanv[1] : x[pc + b];
    out[4] = cs ? x[2 * pc + b] + nanv[2] : x[2 * pc + b];
    out[5] = 0.f;
    out[6] = 0.f;
    out[7] = 0.f;
  }
}

// Zero the block's row buffer: padding and upper levels start at +0.0.
__device__ __forceinline__ void clear_row(float* x, int floats) {
  for (int i = threadIdx.x; i < floats; i += kScanThreads) x[i] = 0.f;
  __syncthreads();
}

// Candidate rows of (s, f) in cand [S, 2, F, 8].
__device__ __forceinline__ float* cand_row(float* cand, int s, int cs,
                                           int f, int F) {
  return cand + ((static_cast<size_t>(s) * 2 + cs) * F + f) * kCandCols;
}

// K3: grid (feature, slot).  Loads the row of hist [S, F, MB, 3] and scans
// it.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const float* __restrict__ hist, int F, int MB,
            const int* __restrict__ feat_nb,
            const int* __restrict__ feat_missing,
            const float* __restrict__ parent, ScanParams p,
            float* __restrict__ cand) {
  extern __shared__ float smem[];
  const Levels L = make_levels(MB);
  float* x = smem;
  float* red_v = smem + 3 * L.per_chan;
  int* red_i = reinterpret_cast<int*>(red_v + 2 * kScanThreads);
  const int f = blockIdx.x, s = blockIdx.y;
  const int nb = __ldg(feat_nb + f);
  clear_row(x, 3 * L.per_chan);
  const long long base = (static_cast<long long>(s) * F + f) * MB * 3;
  for (int i = threadIdx.x; i < MB * 3; i += kScanThreads) {
    const int b = i / 3, ch = i % 3;
    x[ch * L.per_chan + b] = (b < nb) ? hist[base + i] : 0.f;
  }
  __syncthreads();
  scan_row(x, red_v, red_i, MB, nb, __ldg(feat_missing + f), parent + 3 * s,
           p, cand_row(cand, s, 0, f, F), cand_row(cand, s, 1, f, F));
}

// K5's second stage: grid (feature, slot).  Sums the row's pieces of the
// first stage's int32 partials work [chunks, S, F, MB, 3] and dequantizes
// them as K4's reduce does, writes the row to `hist`, and scans it.
__global__ void __launch_bounds__(kScanThreads)
dequant_scan_kernel(const int* __restrict__ work, int chunks, int S, int F,
                    int MB, const int* __restrict__ slots,
                    const int* __restrict__ slot_start,
                    const float* __restrict__ scales,
                    const int* __restrict__ feat_nb,
                    const int* __restrict__ feat_missing,
                    const float* __restrict__ parent, ScanParams p,
                    float* __restrict__ hist, float* __restrict__ cand) {
  extern __shared__ float smem[];
  const Levels L = make_levels(MB);
  float* x = smem;
  float* red_v = smem + 3 * L.per_chan;
  int* red_i = reinterpret_cast<int*>(red_v + 2 * kScanThreads);
  const int f = blockIdx.x, s = blockIdx.y;
  const int nb = __ldg(feat_nb + f);
  const int pieces = slot_rows(slots, slot_start, s, chunks).pieces;
  const long long total = static_cast<long long>(S) * F * MB * 3;
  clear_row(x, 3 * L.per_chan);
  const long long base = (static_cast<long long>(s) * F + f) * MB * 3;
  for (int i = threadIdx.x; i < MB * 3; i += kScanThreads) {
    const int b = i / 3, ch = i % 3;
    const float v = dequant_cell(sum_q_chunks(work, pieces, total, base + i),
                                 ch, scales);
    hist[base + i] = v;
    x[ch * L.per_chan + b] = (b < nb) ? v : 0.f;
  }
  __syncthreads();
  scan_row(x, red_v, red_i, MB, nb, __ldg(feat_missing + f), parent + 3 * s,
           p, cand_row(cand, s, 0, f, F), cand_row(cand, s, 1, f, F));
}

cudaError_t scan_smem_setup(const void* kernel, int MB, size_t* smem) {
  if (make_levels(MB).n[make_levels(MB).top] > kScanBlock)
    return cudaErrorInvalidValue;
  *smem = scan_smem_bytes(MB);
  if (*smem > 227 * 1024) return cudaErrorInvalidValue;
  if (*smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*smem));
  return cudaSuccess;
}

}  // namespace

// K2.  bins [F, N] (bin_bytes 1: u8, 2: u16), payload [N, 3] f32, leaf_id
// [N] i32, slots [S] i32; Fg, chunks, rowbuf, ticket and work [chunks,
// S, F, MB, 3] f32 the first stage's plan and scratch (as lgbt_histogram);
// feat_nb, feat_missing [F] i32; parent [S, 3] f32 (each slot's g, h,
// count sums); hist [S, F, MB, 3] f32 and cand [S, 2, F, 8] f32 out.
// Returns the cudaError_t of the launches.
extern "C" int lgbt_fused_hist_split(
    const void* bins, int bin_bytes, const float* payload,
    const int* leaf_id, const int* slots, int N, int F, int S, int MB,
    int Fg, int chunks, int* rowbuf, int* ticket, float* work,
    const int* feat_nb, const int* feat_missing, const float* parent,
    float l1, float l2, float min_data, float min_hess, float min_gain,
    float* hist, float* cand, cudaStream_t stream) {
  if (!partial_args_ok(N, F, S, MB, bin_bytes, Fg, chunks))
    return cudaErrorInvalidValue;
  size_t smem = 0;
  cudaError_t e = scan_smem_setup(reinterpret_cast<const void*>(scan_kernel),
                                  MB, &smem);
  if (e != cudaSuccess) return e;
  e = launch_first_stage(bins, bin_bytes, payload, leaf_id, slots, N, F, S,
                         MB, Fg, chunks, rowbuf, ticket, work, stream);
  if (e != cudaSuccess) return e;
  e = launch_reduce(work, chunks, N, S, F, MB, slots, rowbuf, hist, stream);
  if (e != cudaSuccess) return e;
  const ScanParams p{l1, l2, min_data, min_hess, min_gain};
  scan_kernel<<<dim3(F, S), kScanThreads, smem, stream>>>(
      hist, F, MB, feat_nb, feat_missing, parent, p, cand);
  return static_cast<int>(cudaGetLastError());
}

// K5.  bins [F, N] (bin_bytes 1: u8, 2: u16), pw3 [3, N] int8, leaf_id
// [N] i32, slots [S] i32 (S <= 42); Fg, chunks, rowbuf, ticket and work
// [chunks, S, F, MB, 3] int32 the first stage's plan and scratch (as
// lgbt_histogram_q); scales [2] f32 (s_g, s_h); feat_nb, feat_missing [F]
// i32; parent [S, 3] f32; hist [S, F, MB, 3] f32 and cand [S, 2, F, 8] f32
// out.  Returns the cudaError_t of the launches.
extern "C" int lgbt_fused_hist_split_q(
    const void* bins, int bin_bytes, const int8_t* pw3, const int* leaf_id,
    const int* slots, int N, int F, int S, int MB, int Fg, int chunks,
    int* rowbuf, int* ticket, int* work, const float* scales,
    const int* feat_nb, const int* feat_missing, const float* parent,
    float l1, float l2, float min_data, float min_hess, float min_gain,
    float* hist, float* cand, cudaStream_t stream) {
  if (!q_args_ok(N, F, S, MB, bin_bytes, Fg, chunks))
    return cudaErrorInvalidValue;
  size_t smem = 0;
  cudaError_t e = scan_smem_setup(
      reinterpret_cast<const void*>(dequant_scan_kernel), MB, &smem);
  if (e != cudaSuccess) return e;
  e = launch_q_first_stage(bins, bin_bytes, pw3, leaf_id, slots, N, F, S, MB,
                           Fg, chunks, rowbuf, ticket, work, stream);
  if (e != cudaSuccess) return e;
  const ScanParams p{l1, l2, min_data, min_hess, min_gain};
  dequant_scan_kernel<<<dim3(F, S), kScanThreads, smem, stream>>>(
      work, chunks, S, F, MB, slots, slot_start_of(rowbuf, N, S), scales,
      feat_nb, feat_missing, parent, p, hist, cand);
  return static_cast<int>(cudaGetLastError());
}

// K3.  hist [S, F, MB, 3] f32, feat_nb, feat_missing [F] i32, parent
// [S, 3] f32; cand [S, 2, F, 8] f32 out.  Returns the cudaError_t of the
// launch.
extern "C" int lgbt_split_scan(const float* hist, int F, int S, int MB,
                               const int* feat_nb, const int* feat_missing,
                               const float* parent, float l1, float l2,
                               float min_data, float min_hess,
                               float min_gain, float* cand,
                               cudaStream_t stream) {
  if (F <= 0 || S <= 0 || MB <= 0 || S > 65535) return cudaErrorInvalidValue;
  size_t smem = 0;
  cudaError_t e = scan_smem_setup(reinterpret_cast<const void*>(scan_kernel),
                                  MB, &smem);
  if (e != cudaSuccess) return e;
  const ScanParams p{l1, l2, min_data, min_hess, min_gain};
  scan_kernel<<<dim3(F, S), kScanThreads, smem, stream>>>(
      hist, F, MB, feat_nb, feat_missing, parent, p, cand);
  return static_cast<int>(cudaGetLastError());
}
