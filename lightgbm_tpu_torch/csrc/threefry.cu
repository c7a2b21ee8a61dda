// threefry2x32 random bits and uniforms, as `jax.random` draws them.
//
// Not a TPU kernel: the reference draws its random numbers in XLA
// (`jax.random.uniform` in `lightgbm_tpu/ops/fused.py:38 bagging_weights`,
// `:51 goss_weights`, `:78 quantize_gradients`, and `jax.random.permutation`
// in `:127 feature_mask` and `ops/grow.py:298 make_node_samplers`).
// `ops/threefry.py` states that arithmetic and runs it as torch ops on the
// CPU (the plain version); on the card those are some 150 elementwise
// int64 launches over the whole draw.  This kernel does the hash in
// registers:
//   out[r, i] = x0 ^ x1, where (x0, x1) = threefry2x32 of the count words
//   (i >> 32, i & 0xFFFFFFFF) under key r (`_threefry_random_bits_
//   partitionable` at 32 bits: the row-major flat index is the count);
//   in the uniform mode the f32 (bits >> 9 | 0x3F800000) - 1.0 instead
//   (`_uniform` over [0, 1)), exact by Sterbenz.
// The hash is 20 rounds of (add, rotate, xor) in five groups of four, the
// rotations (13, 15, 26, 6) and (17, 29, 16, 24) in turn, with the key
// schedule (k0, k1, k0 ^ k1 ^ 0x1BD11BDA) injected after each group
// (`_threefry2x32_lowering`).  Integer arithmetic only, so every device
// gives the plain version's bits by construction; `chip_smoke.py` holds
// them bitwise anyway.
//
// Keys: one key's two words as arguments (the per-round draws: bagging,
// GOSS, the quantizer), or a table of R keys on the card (the per-node
// draws of a tree: R node keys, n = the feature count).
//
// What bounds it on the H100: the operations.  A value takes 20
// rotations (a funnel shift each) and 21 xors, which only the INT32 lanes
// run, and 32 adds (2 of the key, 20 of the rounds, 2 at each of the 5
// injections, their constant folded into the key word), which nvcc may
// also run as IMAD on the f32 lanes; a uniform adds a shift, an or and
// an f32 subtract.  The INT32 lanes' 43 a uniform bind: 0.0051 ms for
// 2M values at 132 SMs x 64 lanes x 1.98 GHz, against 0.0045 ms for all
// 76 at the schedulers' dispatch rate and 0.0024 ms for the 8 MB written
// (`chip_smoke.py _threefry_bound`).  The design keeps the key
// schedule in registers, rotates with `__funnelshift_l` (one SHF), gives
// each thread four consecutive elements, written as one 16-byte store,
// and sizes the grid to the card: a grid-stride loop over at most
// kBlocksPerSm blocks an SM, the n % 4 tail by scalar stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;    // 2048 threads an SM
constexpr uint32_t kParity = 0x1BD11BDAu;

struct Key {
  uint32_t k0, k1, k2;
};

__device__ __forceinline__ Key make_key(uint32_t a, uint32_t b) {
  return Key{a, b, a ^ b ^ kParity};
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// four rounds with rotations (a, b, c, d)
#define LGBT_TF_ROUNDS(a, b, c, d)            \
  x0 += x1; x1 = rotl(x1, a) ^ x0;            \
  x0 += x1; x1 = rotl(x1, b) ^ x0;            \
  x0 += x1; x1 = rotl(x1, c) ^ x0;            \
  x0 += x1; x1 = rotl(x1, d) ^ x0;

__device__ __forceinline__ uint32_t threefry_bits(const Key& k,
                                                  unsigned long long i) {
  uint32_t x0 = static_cast<uint32_t>(i >> 32) + k.k0;
  uint32_t x1 = static_cast<uint32_t>(i) + k.k1;
  LGBT_TF_ROUNDS(13, 15, 26, 6)
  x0 += k.k1; x1 += k.k2 + 1u;
  LGBT_TF_ROUNDS(17, 29, 16, 24)
  x0 += k.k2; x1 += k.k0 + 2u;
  LGBT_TF_ROUNDS(13, 15, 26, 6)
  x0 += k.k0; x1 += k.k1 + 3u;
  LGBT_TF_ROUNDS(17, 29, 16, 24)
  x0 += k.k1; x1 += k.k2 + 4u;
  LGBT_TF_ROUNDS(13, 15, 26, 6)
  x0 += k.k2; x1 += k.k0 + 5u;
  return x0 ^ x1;
}

#undef LGBT_TF_ROUNDS

template <bool kUniform>
__device__ __forceinline__ uint32_t value(const Key& k,
                                          unsigned long long i) {
  const uint32_t bits = threefry_bits(k, i);
  if (!kUniform) return bits;
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u),
                            1.0f);
  return __float_as_uint(f);
}

// The key of row r: the argument key, or the table's row r.
__device__ __forceinline__ Key row_key(const uint32_t* __restrict__ keys,
                                       uint32_t a, uint32_t b, long long r) {
  if (keys == nullptr) return make_key(a, b);
  return make_key(__ldg(keys + 2 * r), __ldg(keys + 2 * r + 1));
}

// out[r * n + i] for r < rows, i < n, over the flat index q = r * n + i:
// groups of four q a thread (one 16-byte store), then the scalar tail.
// A group may cross a row's end: its row and key advance there.
template <bool kUniform>
__global__ void __launch_bounds__(kThreads)
threefry_kernel(const uint32_t* __restrict__ keys, uint32_t a, uint32_t b,
                long long rows, long long n, uint32_t* __restrict__ out) {
  const long long total = rows * n;
  const long long groups = total / 4;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  uint4* out4 = reinterpret_cast<uint4*>(out);
  for (long long g = tid; g < groups; g += stride) {
    const long long q = 4 * g;
    long long r = rows == 1 ? 0 : q / n;
    unsigned long long i = static_cast<unsigned long long>(q - r * n);
    Key k = row_key(keys, a, b, r);
    uint32_t v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (i == static_cast<unsigned long long>(n)) {   // the next row
        ++r;
        i = 0;
        k = row_key(keys, a, b, r);
      }
      v[u] = value<kUniform>(k, i);
      ++i;
    }
    out4[g] = make_uint4(v[0], v[1], v[2], v[3]);
  }
  for (long long q = 4 * groups + tid; q < total; q += stride) {
    const long long r = rows == 1 ? 0 : q / n;
    out[q] = value<kUniform>(row_key(keys, a, b, r),
                             static_cast<unsigned long long>(q - r * n));
  }
}

}  // namespace

// out [rows, n] (uint32 bits, or f32 uniforms when `uniform` is 1) under
// the keys: `keys` [rows, 2] uint32 on the card, or, when it is null, the
// one key (key0, key1) for every row.  `out` must be 16-byte aligned.
// Returns the cudaError_t of the launch.
extern "C" int lgbt_threefry(const uint32_t* keys, unsigned key0,
                             unsigned key1, long long rows, long long n,
                             int uniform, void* out, cudaStream_t stream) {
  if (rows <= 0 || n <= 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15u) != 0)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long total = rows * n;
  long long blocks = ((total + 3) / 4 + kThreads - 1) / kThreads;
  if (blocks > static_cast<long long>(sms) * kBlocksPerSm)
    blocks = static_cast<long long>(sms) * kBlocksPerSm;
  if (blocks < 1) blocks = 1;
  uint32_t* o = static_cast<uint32_t*>(out);
  if (uniform)
    threefry_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(keys, key0, key1, rows, n, o);
  else
    threefry_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0,
                             stream>>>(keys, key0, key1, rows, n, o);
  return static_cast<int>(cudaGetLastError());
}
