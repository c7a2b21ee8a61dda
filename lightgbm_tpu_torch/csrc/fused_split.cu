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
// One scan.  `scan_block` scans a block's rows held in shared memory; K2
// and K3 run it in the same kernel and K5 in its own, so the candidates
// are interchangeable by construction (the wave grower scans the smaller
// children in K2 and the larger ones, parent minus smaller, in K3).
// Every float operation is an IEEE f32 add, subtract, multiply or divide
// in the plain version's order, and this library is built with
// -fmad=false, so none is contracted:
//   * bins >= nb[f] read as +0.0 (the plain version's `where(valid_bin)`);
//   * prefix sums in the order of `ops/reduce.py block_cumsum` (XLA's CPU
//     cumsum): sequential within blocks of 16, the zero-padded block totals
//     prefix-summed the same way (recursing past 16 blocks, MB > 256), then
//     each block's elements plus the previous blocks' total (plus +0.0 in
//     the first block); every sequential chain starts from XLA's init
//     value, (+0.0 + x0) + x1 ..., except in a row of one bin;
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
// launched with the same plan) + a dequantize-and-scan stage: a block
// sums its rows' pieces, converts them to f32 and scales g and h exactly
// as K4's reduce does (`dequant_cell`), so K5's histogram is K4's bit for
// bit; it writes the rows to `hist`, keeps them in shared memory and
// scans them with the same `scan_block`.
//
// K2 = K1's first stage (hist_common.cuh: the row list and
// hist_partial_kernel, launched with the same plan) + K1's
// hist_reduce_kernel, which writes `hist`, so K2's histogram is K1's bit
// for bit, + K3's scan_kernel over `hist`, so K2's candidates are K3's.
// No float atomics.  K3 loads its rows from `hist`.
//
// What bounds them on the H100: bytes.  K2 reads what K1 reads (every
// row's leaf id, the bins and payload of the rows in the slots: its first
// stage lists those rows and reads only theirs) and writes the histogram
// and the candidates; K5 reads what K4 reads (every row's leaf id, the
// bins and three lattice bytes of the rows in the slots) and writes the
// histogram and the candidates; K3 reads a histogram and writes
// candidates (at 14 slots x 28 features x 255 bins, 1.2 MB in, 25 KB out).
// A scan of a few microseconds is held back by its chain of dependent
// steps, not by either bound, so the design keeps that chain short
// (`scan_block`, shared by the three):
//   * g consecutive rows a block (grid ceil(S * F / g)), g a power of two
//     chosen at launch: one row a block while that leaves fewer than two
//     blocks an SM (the 1 to 14 slots of the wave grower's calls), more
//     rows (up to one a warp) past that;
//   * each thread first loads what it needs of feat_nb, feat_missing and
//     parent, so those loads fly with the row's;
//   * the rows are contiguous in hist: 16-byte loads from the first
//     16-byte boundary (scalar head and tail), kLoadBatch in flight a
//     thread, into shared memory with a pad word after each block of 16
//     bins, so that lanes reading their own blocks hit distinct banks; K5
//     instead sums each cell's pieces, kQCells cells a thread with their
//     loads in flight together, and dequantizes as K4's reduce does;
//   * one warp a row makes the prefix sums: lane b owns blocks b, b + 32,
//     ... and adds each in order (bins >= nb as +0.0), its three channels
//     interleaved; the block totals' prefix (at most 16, the top level)
//     is rebuilt by every lane b for itself, ((+0.0 + t0) + t1) + ... +
//     tb in that order, reading the totals from shared memory: the
//     sequential order, bit for bit, with no serial pass (more than 16
//     blocks, MB > 256: level by level, the same scheme);
//   * the gains: the block's warps split into g groups, one a row, bins
//     t, t + threads of the group, ... (the gains' IEEE divides, with
//     their slow-path branches, are most of the work: spread over every
//     warp, not one); a gated candidate's gain is not computed (it is
//     -inf either way);
//   * the argmax: `beats` is a strict total order, so any pairing tree
//     gives the winner: five __shfl_xor_sync steps a warp, then a row's
//     warps' bests through shared memory and five more; no shuffle
//     follows a branch that only some warps take (nvcc compiles such a
//     shuffle as a slow collective loop);
//   * 16 lanes write the two 8-float candidate rows.
// Nothing is accumulated in device memory: two launches give the same
// bits.

#include <stdint.h>

#include "hist_common.cuh"
#include "hist_q_common.cuh"

namespace {

constexpr int kScanWarps = 8;      // K2's and K3's scan: warps a block
constexpr int kDequantWarps = 16;  // K5's second stage: warps a block
constexpr int kScanBlock = 16;     // block_cumsum's block (ops/reduce.py)
constexpr int kBlockFloats = 3 * kScanBlock;     // a block's 16 bins x 3
constexpr int kBlockStride = kBlockFloats + 1;   // + a pad word: 49 apart
constexpr int kLoadBatch = 4;      // 16-byte loads a thread issues at once
constexpr int kQCells = 2;         // cells a K5 thread sums at once
constexpr int kMaxLevels = 6;      // 16^5 blocks and beyond need no more
constexpr int kCandCols = 8;
constexpr int kMissingNan = 2;

struct ScanParams {
  float l1, l2, min_data, min_hess, min_gain;
};

// The prefix-sum levels of the n block totals of a row: level 0 holds
// the totals padded to whole blocks of 16, level j + 1 the block totals
// of level j, up to the first level of at most 16 elements (the top),
// which is not padded.
struct Levels {
  int top;
  int n[kMaxLevels];      // elements of each level
  int off[kMaxLevels];    // offset of each level in a channel's buffer
  int per_chan;           // floats of one channel's buffer
};

__host__ __device__ inline Levels make_levels(int n0) {
  Levels L;
  L.top = 0;
  L.n[0] = n0;
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

// make_levels(n0).per_chan, in registers.
__host__ __device__ inline int levels_per_chan(int n0) {
  int o = 0;
  for (int n = n0; ; n = (n + kScanBlock - 1) / kScanBlock) {
    if (n <= kScanBlock) return o + n;
    o += kScanBlock * ((n + kScanBlock - 1) / kScanBlock);
  }
}

// Level-0 blocks of a row of mb bins.
__host__ __device__ inline int row_blocks(int mb) {
  return (mb + kScanBlock - 1) / kScanBlock;
}

// One row's shared memory, in floats: the row (row_blocks(mb) blocks of
// kBlockStride floats, float 3 * bin + channel of block b at b *
// kBlockStride + its place in the block), then the totals' levels [3]
// [per_chan], then the NaN bin's 3 sums and (K5) the slot's pieces.
__host__ __device__ inline int row_floats(int mb) {
  const int nb0 = row_blocks(mb);
  return nb0 * kBlockStride + 3 * levels_per_chan(nb0) + 4;
}

// A block's shared memory for g rows of mb bins and `warps` warps: the
// rows, then each warp's best (value, bin) of both cases.
__host__ __device__ inline size_t block_smem_bytes(int g, int mb,
                                                   int warps) {
  return (static_cast<size_t>(g) * row_floats(mb) + 4 * warps) *
         sizeof(float);
}

// Where float i (= 3 * bin + channel) of a row lies in its buffer.
__device__ __forceinline__ int row_at(int i) {
  return (i / kBlockFloats) * kBlockStride + i % kBlockFloats;
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
// larger value, then the lower index.  A strict total order on the pairs
// (+-0 compare equal, so the index decides), so any pairing tree finds
// the same winner.
__device__ __forceinline__ bool beats(float a, int ia, float b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

// The g rows of a block: rows r0 .. r0 + nrows - 1 of S * F (S * F <
// 2^31, scan_setup), each with its buffer; every row's totals' levels
// and its last block's padding +0.0, (K5) its slot's pieces.
struct BlockRows {
  float* smem;
  int r0, nrows, F, mb, nb0, pc, rf;
  __device__ float* row(int k) const { return smem + k * rf; }
  __device__ float* lv(int k) const { return row(k) + nb0 * kBlockStride; }
  __device__ float* nanv(int k) const { return lv(k) + 3 * pc; }
  __device__ int& pieces(int k) const {
    return reinterpret_cast<int*>(nanv(k))[3];
  }
};

// What a thread reads of the scan's inputs, loaded first so that these
// loads and the row's are in flight together: warp w makes row w's prefix
// sums (its nb and missing type), and scans row w / (warps / g) (its nb,
// missing type, slot, feature and parent sums).
struct RowMeta {
  int nb_p, miss_p;                 // the prefix row's
  int s, f, nb, miss;               // the scanned row's
  float pg, ph, pcnt;
};

__device__ RowMeta row_meta(int S, int F, int g,
                            const int* __restrict__ feat_nb,
                            const int* __restrict__ feat_missing,
                            const float* __restrict__ parent) {
  const int warp = threadIdx.x >> 5, wpg = (blockDim.x >> 5) / g;
  const int r0 = static_cast<int>(blockIdx.x) * g, last = S * F - 1;
  RowMeta m;
  const int fp = min(r0 + warp, last) % F;
  m.nb_p = __ldg(feat_nb + fp);
  m.miss_p = __ldg(feat_missing + fp);
  const int r = min(r0 + warp / wpg, last);
  m.s = r / F;
  m.f = r % F;
  m.nb = __ldg(feat_nb + m.f);
  m.miss = __ldg(feat_missing + m.f);
  m.pg = __ldg(parent + 3 * m.s);
  m.ph = __ldg(parent + 3 * m.s + 1);
  m.pcnt = __ldg(parent + 3 * m.s + 2);
  return m;
}

__device__ BlockRows block_rows(int S, int F, int MB, int g,
                                const int* __restrict__ slots = nullptr,
                                const int* __restrict__ slot_start = nullptr,
                                int chunks = 0) {
  extern __shared__ float smem[];
  BlockRows br;
  br.smem = smem;
  br.r0 = static_cast<int>(blockIdx.x) * g;
  br.nrows = min(g, S * F - br.r0);
  br.F = F;
  br.mb = MB;
  br.nb0 = row_blocks(MB);
  br.pc = levels_per_chan(br.nb0);
  br.rf = row_floats(MB);
  if (slots) {
    for (int k = threadIdx.x; k < br.nrows; k += blockDim.x)
      br.pieces(k) =
          slot_rows(slots, slot_start, (br.r0 + k) / F, chunks).pieces;
  }
  const int lvf = 3 * br.pc;
  for (int t = threadIdx.x; t < br.nrows * lvf; t += blockDim.x)
    br.lv(t / lvf)[t % lvf] = 0.f;
  const int n = 3 * MB, pad = kBlockFloats * br.nb0 - n;
  for (int t = threadIdx.x; t < br.nrows * pad; t += blockDim.x)
    br.row(t / pad)[row_at(n + t % pad)] = 0.f;
  if (slots) __syncthreads();             // K5's cells read the pieces
  return br;
}

// K2's and K3's staging: the block's rows are contiguous in hist (src =
// row r0, nrows * 3 * MB floats): 16-byte loads from the first 16-byte
// boundary on, kLoadBatch of them in flight a thread, the scalar head and
// tail; float j goes to row j / (3 MB), place j % (3 MB).
__device__ void stage_hist_rows(const float* __restrict__ src,
                                const BlockRows& br) {
  const int n = 3 * br.mb, total = br.nrows * n;
  const int head = min(total, static_cast<int>(
      ((16u - (reinterpret_cast<uintptr_t>(src) & 15u)) & 15u) >> 2));
  const int nq = (total - head) >> 2;
  auto place = [&](int j, float v) {
    const int k = j / n;
    br.row(k)[row_at(j - k * n)] = v;
  };
  if (threadIdx.x < head) place(threadIdx.x, __ldg(src + threadIdx.x));
  const float4* q = reinterpret_cast<const float4*>(src + head);
  const int step = blockDim.x;
  for (int q0 = threadIdx.x; q0 < nq; q0 += kLoadBatch * step) {
    float4 v[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u)
      if (q0 + u * step < nq) v[u] = __ldg(q + q0 + u * step);
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      if (q0 + u * step < nq) {
        // one division a piece: its 4 floats cross at most one row end
        const int j = head + 4 * (q0 + u * step);
        int k = j / n, i = j - k * n;
        const float w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (i == n) {
            ++k;
            i = 0;
          }
          br.row(k)[row_at(i++)] = w[e];
        }
      }
    }
  }
  for (int j = head + 4 * nq + threadIdx.x; j < total; j += step)
    place(j, __ldg(src + j));
}

// In place, the inclusive prefix of the nt <= 16 elements v[c * pc + 0 ..
// nt - 1] of each channel c: lane b rebuilds the prefix of elements 0..b
// by the sequential chain from +0.0, ((+0.0 + v0) + v1) + ... + vb,
// reading the elements from shared memory (a broadcast to every lane);
// the three channels' chains interleaved.
__device__ void top_prefix(float* v, int pc, int nt, int lane) {
  float p0 = 0.f, p1 = 0.f, p2 = 0.f;
  if (lane < nt) {
    p0 = __fadd_rn(v[0], 0.f);
    p1 = __fadd_rn(v[pc], 0.f);
    p2 = __fadd_rn(v[2 * pc], 0.f);
#pragma unroll
    for (int q = 1; q < kScanBlock; ++q) {
      if (q <= lane) {
        p0 = p0 + v[q];
        p1 = p1 + v[pc + q];
        p2 = p2 + v[2 * pc + q];
      }
    }
  }
  __syncwarp();
  if (lane < nt) {
    v[lane] = p0;
    v[pc + lane] = p1;
    v[2 * pc + lane] = p2;
  }
  __syncwarp();
}

// In place, each channel c of lv [3][L.per_chan] (level 0: the n = L.n[0]
// block totals, the rest +0.0) becomes block_cumsum of its level 0.
// Levels below the top: lane t adds block t of 16 in order from +0.0 and
// writes its total a level up; the top (at most 16): top_prefix; then
// down, each element plus the previous blocks' total (+0.0 in the first
// block).
__device__ void warp_block_cumsum(float* lv, int n0, int lane) {
  const Levels L = make_levels(n0);
  const int pc = L.per_chan;
  for (int j = 0; j < L.top; ++j) {
    for (int t = lane; t < L.n[j + 1]; t += 32) {
      for (int c = 0; c < 3; ++c) {
        float* v = lv + c * pc + L.off[j] + t * kScanBlock;
        float acc = __fadd_rn(v[0], 0.f);
        v[0] = acc;
        for (int k = 1; k < kScanBlock; ++k) {
          acc = acc + v[k];
          v[k] = acc;
        }
        lv[c * pc + L.off[j + 1] + t] = acc;
      }
    }
    __syncwarp();
  }
  top_prefix(lv + L.off[L.top], pc, L.n[L.top], lane);
  for (int j = L.top - 1; j >= 0; --j) {
    const int len = kScanBlock * L.n[j + 1];
    for (int i = lane; i < len; i += 32) {
      const int b = i / kScanBlock;
      for (int c = 0; c < 3; ++c) {
        float* v = lv + c * pc;
        const float off = (b == 0) ? 0.f : v[L.off[j + 1] + b - 1];
        v[L.off[j] + i] = v[L.off[j] + i] + off;
      }
    }
    __syncwarp();
  }
}

// One warp's prefix sums of row k in block_cumsum's order, in place: the
// NaN bin's sums kept first; level 0, lane b owning blocks b, b + 32, ...
// (bins >= nb read as +0.0; three chains interleaved, each from +0.0
// unless the row is one bin); then, past one block, the totals'
// block_cumsum in lv, which the gains read as each block's offset (at
// most 16 blocks, MB <= 256: top_prefix alone).  No shuffles here: this
// runs in the warps that own a row only, and a shuffle after such a
// branch is compiled as a slow collective loop.
__device__ void row_prefix(const BlockRows& br, int k, int nb, int missing,
                           int lane) {
  float* row = br.row(k);
  float* lv = br.lv(k);
  const int mb = br.mb, nb0 = br.nb0, pc = br.pc;
  if (lane < 3)
    br.nanv(k)[lane] = (missing == kMissingNan && nb >= 1 && nb <= mb)
                           ? row[row_at(3 * (nb - 1) + lane)]
                           : 0.f;
  __syncwarp();
  for (int b = lane; b < nb0; b += 32) {
    float* v = row + b * kBlockStride;
    const int lim = nb - kScanBlock * b;          // bins of the block < nb
    float a0 = lim > 0 ? v[0] : 0.f, a1 = lim > 0 ? v[1] : 0.f,
          a2 = lim > 0 ? v[2] : 0.f;
    if (mb > 1) {                                  // from the init +0.0
      a0 = __fadd_rn(a0, 0.f);
      a1 = __fadd_rn(a1, 0.f);
      a2 = __fadd_rn(a2, 0.f);
    }
    v[0] = a0;
    v[1] = a1;
    v[2] = a2;
#pragma unroll
    for (int q = 1; q < kScanBlock; ++q) {
      a0 = a0 + (q < lim ? v[3 * q] : 0.f);
      a1 = a1 + (q < lim ? v[3 * q + 1] : 0.f);
      a2 = a2 + (q < lim ? v[3 * q + 2] : 0.f);
      v[3 * q] = a0;
      v[3 * q + 1] = a1;
      v[3 * q + 2] = a2;
    }
    lv[b] = a0;
    lv[pc + b] = a1;
    lv[2 * pc + b] = a2;
  }
  __syncwarp();
  if (nb0 > kScanBlock)
    warp_block_cumsum(lv, nb0, lane);
  else if (nb0 > 1)
    top_prefix(lv, pc, nb0, lane);
}

// Candidate rows of (s, f) in cand [S, 2, F, 8].
__device__ __forceinline__ float* cand_row(float* cand, int s, int cs,
                                           int f, int F) {
  return cand + ((static_cast<size_t>(s) * 2 + cs) * F + f) * kCandCols;
}

// The scan of the block's staged rows, shared by K2, K3 and K5: warp k
// makes row k's prefix sums; then the block's warps split into g groups,
// group k scans row k's bins (bins t, t + threads of the group, ...: one
// or a few a thread, the gains' IEEE divides spread over every warp);
// each warp's first-wins best by five __shfl_xor_sync steps, the group's
// from its warps' through shared memory and five more; the group's first
// warp writes the two candidate rows.
__device__ void scan_block(const BlockRows& br, int g, const RowMeta& m,
                           const ScanParams p, float* __restrict__ cand) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5, wpg = warps / g;
  if (warp < br.nrows) row_prefix(br, warp, m.nb_p, m.miss_p, lane);
  __syncthreads();
  const int k = warp / wpg;
  float* best_v = br.smem + g * br.rf;
  int* best_i = reinterpret_cast<int*>(best_v + 2 * warps);
  const float neg_inf = __int_as_float(0xff800000);
  const int mb = br.mb;
  float bv0 = neg_inf, bv1 = neg_inf;
  int bi0 = mb, bi1 = mb;
  const float* row = br.row(0);
  const float* lv = br.lv(0);
  const float* nanv = br.nanv(0);
  if (k < br.nrows) {
    row = br.row(k);
    lv = br.lv(k);
    nanv = br.nanv(k);
    const int nb = m.nb;
    const bool has_nan = m.miss == kMissingNan;
    const float pg = m.pg, ph = m.ph, pcnt = m.pcnt;
    const float shift = leaf_gain(pg, ph, p.l1, p.l2) + p.min_gain;
    const int t_max = nb - 2 - (has_nan ? 1 : 0);
    const float n0 = nanv[0], n1 = nanv[1], n2 = nanv[2];
    const int tg = 32 * wpg;
    for (int b = (warp % wpg) * 32 + lane; b < mb; b += tg) {
      const int blk = b / kScanBlock;
      const float* x = row + row_at(3 * b);
      float cg = x[0], ch = x[1], cc = x[2];
      if (br.nb0 > 1) {                // a one-block row is final as it is
        const float o0 = blk ? lv[blk - 1] : 0.f;
        const float o1 = blk ? lv[br.pc + blk - 1] : 0.f;
        const float o2 = blk ? lv[2 * br.pc + blk - 1] : 0.f;
        cg = cg + o0;
        ch = ch + o1;
        cc = cc + o2;
      }
#pragma unroll
      for (int cs = 0; cs < 2; ++cs) {
        const float lg = cs ? cg + n0 : cg;
        const float lh = cs ? ch + n1 : ch;
        const float lc = cs ? cc + n2 : cc;
        const float rg = pg - lg, rh = ph - lh, rc = pcnt - lc;
        const bool ok = b <= t_max && (cs == 0 || has_nan) &&
                        lc >= p.min_data && rc >= p.min_data &&
                        lh >= p.min_hess && rh >= p.min_hess;
        float v = neg_inf;
        if (ok)
          v = (leaf_gain(lg, lh, p.l1, p.l2) +
               leaf_gain(rg, rh, p.l1, p.l2)) - shift;
        if (cs == 0 && beats(v, b, bv0, bi0)) {
          bv0 = v;
          bi0 = b;
        }
        if (cs == 1 && beats(v, b, bv1, bi1)) {
          bv1 = v;
          bi1 = b;
        }
      }
    }
  }
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) {
    const float ov0 = __shfl_xor_sync(kFull, bv0, m);
    const int oi0 = __shfl_xor_sync(kFull, bi0, m);
    const float ov1 = __shfl_xor_sync(kFull, bv1, m);
    const int oi1 = __shfl_xor_sync(kFull, bi1, m);
    if (beats(ov0, oi0, bv0, bi0)) {
      bv0 = ov0;
      bi0 = oi0;
    }
    if (beats(ov1, oi1, bv1, bi1)) {
      bv1 = ov1;
      bi1 = oi1;
    }
  }
  if (lane == 0) {
    best_v[2 * warp] = bv0;
    best_i[2 * warp] = bi0;
    best_v[2 * warp + 1] = bv1;
    best_i[2 * warp + 1] = bi1;
  }
  __syncthreads();
  // every warp combines its group's bests, with no branch before the
  // shuffles (a shuffle after one is compiled as a slow collective loop):
  // lane l takes warp l % wpg's best, and five xor steps leave the most
  // of all 32 (each best at least once) in every lane; the group's first
  // warp writes
  {
    const int w = (warp / wpg) * wpg + lane % wpg;
    bv0 = best_v[2 * w];
    bi0 = best_i[2 * w];
    bv1 = best_v[2 * w + 1];
    bi1 = best_i[2 * w + 1];
  }
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) {
    const float ov0 = __shfl_xor_sync(kFull, bv0, m);
    const int oi0 = __shfl_xor_sync(kFull, bi0, m);
    const float ov1 = __shfl_xor_sync(kFull, bv1, m);
    const int oi1 = __shfl_xor_sync(kFull, bi1, m);
    if (beats(ov0, oi0, bv0, bi0)) {
      bv0 = ov0;
      bi0 = oi0;
    }
    if (beats(ov1, oi1, bv1, bi1)) {
      bv1 = ov1;
      bi1 = oi1;
    }
  }
  // lanes 0-7 write case 0's row, lanes 8-15 case 1's; a row with every
  // candidate gated has its winner at bin 0 (-inf beats the initial
  // (-inf, mb)), so b < mb
  if (k < br.nrows && warp % wpg == 0 && lane < 2 * kCandCols) {
    const int cs = lane / kCandCols, col = lane % kCandCols;
    const int b = cs ? bi1 : bi0;
    float o = 0.f;
    if (col == 0) {
      o = cs ? bv1 : bv0;
    } else if (col == 1) {
      o = static_cast<float>(b);
    } else if (col < 5) {
      const int c = col - 2, blk = b / kScanBlock;
      float x = row[row_at(3 * b + c)];
      if (br.nb0 > 1) x = x + (blk ? lv[c * br.pc + blk - 1] : 0.f);
      o = cs ? x + nanv[c] : x;
    }
    cand_row(cand, m.s, cs, m.f, br.F)[col] = o;
  }
}

// K3 (and K2's scan): g consecutive rows of hist [S, F, MB, 3] a block.
__global__ void __launch_bounds__(kScanWarps * 32)
scan_kernel(const float* __restrict__ hist, int S, int F, int MB, int g,
            const int* __restrict__ feat_nb,
            const int* __restrict__ feat_missing,
            const float* __restrict__ parent, ScanParams p,
            float* __restrict__ cand) {
  const RowMeta m = row_meta(S, F, g, feat_nb, feat_missing, parent);
  const BlockRows br = block_rows(S, F, MB, g);
  stage_hist_rows(hist + static_cast<long long>(br.r0) * 3 * MB, br);
  __syncthreads();
  scan_block(br, g, m, p, cand);
}

// K5's second stage: g consecutive rows a block.  Every thread sums cells
// of those rows (contiguous in work [chunks, S, F, MB, 3] and in hist),
// kQCells cells at a time with their pieces' loads in flight together
// (any order gives the same integer), dequantizes them as K4's reduce
// does (`dequant_cell`), writes them to `hist` and stages them; then
// scan_block.
__global__ void __launch_bounds__(kDequantWarps * 32)
dequant_scan_kernel(const int* __restrict__ work, int chunks, int S, int F,
                    int MB, int g, const int* __restrict__ slots,
                    const int* __restrict__ slot_start,
                    const float* __restrict__ scales,
                    const int* __restrict__ feat_nb,
                    const int* __restrict__ feat_missing,
                    const float* __restrict__ parent, ScanParams p,
                    float* __restrict__ hist, float* __restrict__ cand) {
  const RowMeta m = row_meta(S, F, g, feat_nb, feat_missing, parent);
  const BlockRows br = block_rows(S, F, MB, g, slots, slot_start, chunks);
  const int n = 3 * MB;
  const long long total = static_cast<long long>(S) * F * n;
  const long long base =                  // cell j of the block: base + j
      static_cast<long long>(br.r0) * n;
  const int cells = br.nrows * n;
  const int step = blockDim.x;
  for (int j0 = threadIdx.x; j0 < cells; j0 += kQCells * step) {
    int acc[kQCells], pcs[kQCells];
    int most = 0;
#pragma unroll
    for (int u = 0; u < kQCells; ++u) {
      const int j = j0 + u * step;
      pcs[u] = (j < cells) ? br.pieces(j / n) : 0;
      most = max(most, pcs[u]);
      acc[u] = (j < cells) ? __ldg(work + base + j) : 0;
    }
#pragma unroll 4
    for (int c = 1; c < most; ++c) {
      const int* w = work + c * total + base;
#pragma unroll
      for (int u = 0; u < kQCells; ++u)
        if (c < pcs[u]) acc[u] += __ldg(w + j0 + u * step);
    }
#pragma unroll
    for (int u = 0; u < kQCells; ++u) {
      const int j = j0 + u * step;
      if (j < cells) {
        const int k = j / n, i = j - k * n;
        const float v = dequant_cell(acc[u], i % 3, scales);
        hist[base + j] = v;
        br.row(k)[row_at(i)] = v;
      }
    }
  }
  __syncthreads();
  scan_block(br, g, m, p, cand);
}

// A scan launch over S * F rows of MB bins with `warps` warps a block:
// g rows a block (a power of two, at most one a warp), as many as still
// leave two blocks an SM, so a small grid gives each row the whole block
// (its loads, its gains) and a large one packs rows; fewer where their
// shared memory would pass the 227 KB a block can have (MB in the
// thousands), opted in above 48 KB.
struct ScanLaunch {
  unsigned blocks;
  int g;
  size_t smem;
};

cudaError_t scan_setup(const void* kernel, int warps, int S, int F, int MB,
                       ScanLaunch* out) {
  if (F <= 0 || S <= 0 || MB <= 0 || S > 65535 ||
      static_cast<long long>(S) * F > 0x7FFFFFFFLL)
    return cudaErrorInvalidValue;
  const Levels L = make_levels(row_blocks(MB));
  if (L.n[L.top] > kScanBlock) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long rows = static_cast<long long>(S) * F;
  int g = 1;
  while (g < warps && (rows + 2 * g - 1) / (2 * g) >= 2LL * sms) g *= 2;
  while (g > 1 && block_smem_bytes(g, MB, warps) >
                      static_cast<size_t>(kSmemMax))
    g /= 2;
  if (block_smem_bytes(g, MB, warps) > static_cast<size_t>(kSmemMax))
    return cudaErrorInvalidValue;
  const long long blocks = (rows + g - 1) / g;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  out->blocks = static_cast<unsigned>(blocks);
  out->g = g;
  out->smem = block_smem_bytes(g, MB, warps);
  if (out->smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(out->smem));
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
  ScanLaunch sl;
  cudaError_t e = scan_setup(reinterpret_cast<const void*>(scan_kernel),
                             kScanWarps, S, F, MB, &sl);
  if (e != cudaSuccess) return e;
  e = launch_first_stage(bins, bin_bytes, payload, leaf_id, slots, N, F, S,
                         MB, Fg, chunks, rowbuf, ticket, work, stream);
  if (e != cudaSuccess) return e;
  e = launch_reduce(work, chunks, N, S, F, MB, slots, rowbuf, hist, stream);
  if (e != cudaSuccess) return e;
  const ScanParams p{l1, l2, min_data, min_hess, min_gain};
  scan_kernel<<<sl.blocks, kScanWarps * 32, sl.smem, stream>>>(
      hist, S, F, MB, sl.g, feat_nb, feat_missing, parent, p, cand);
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
  ScanLaunch sl;
  cudaError_t e = scan_setup(
      reinterpret_cast<const void*>(dequant_scan_kernel), kDequantWarps, S, F,
      MB, &sl);
  if (e != cudaSuccess) return e;
  e = launch_q_first_stage(bins, bin_bytes, pw3, leaf_id, slots, N, F, S, MB,
                           Fg, chunks, rowbuf, ticket, work, stream);
  if (e != cudaSuccess) return e;
  const ScanParams p{l1, l2, min_data, min_hess, min_gain};
  dequant_scan_kernel<<<sl.blocks, kDequantWarps * 32, sl.smem, stream>>>(
      work, chunks, S, F, MB, sl.g, slots, slot_start_of(rowbuf, N, S),
      scales, feat_nb, feat_missing, parent, p, hist, cand);
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
  ScanLaunch sl;
  const cudaError_t e = scan_setup(
      reinterpret_cast<const void*>(scan_kernel), kScanWarps, S, F, MB, &sl);
  if (e != cudaSuccess) return e;
  const ScanParams p{l1, l2, min_data, min_hess, min_gain};
  scan_kernel<<<sl.blocks, kScanWarps * 32, sl.smem, stream>>>(
      hist, S, F, MB, sl.g, feat_nb, feat_missing, parent, p, cand);
  return static_cast<int>(cudaGetLastError());
}
