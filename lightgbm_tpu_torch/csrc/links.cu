// XLA's CPU f32 exp and sigmoid, bit for bit.
//
// Not a TPU kernel: the reference's objectives apply `jnp.exp` and
// `jax.nn.sigmoid` (`lightgbm_tpu/objectives.py:320`, `:328`), which XLA
// lowers to its own Cephes polynomial.  `ops/xla_math.py` states that
// arithmetic and runs it as torch ops on the CPU (the plain version);
// there it is about 60 elementwise launches with f64 temporaries, which on
// the card cost more than the request they convert.  This kernel does the
// same arithmetic in registers:
//   * n = floor(x * log2(e) + 0.5) with x clamped below at -88.5, then at
//     most 127 (f32 multiply and add, each rounded; the floor by adds,
//     `floor_magic`);
//   * the two reductions and the Horner steps as hardware fused
//     multiply-adds (__fmaf_rn, rounded once: the correctly rounded fma,
//     which `scripts/check_xla_exp_exhaustive.py` holds equal to XLA's
//     `exp` over all 2^32 inputs, as it does the plain version's
//     twice-rounded f64 multiply-adds);
//   * z * 2^n, results below 2^-126 flushed to +0, the rest rounded to
//     f32 (exact, or +inf), by integer arithmetic on z's exponent field
//     (below);
//   * NaN in, the same NaN out;
//   * sigmoid: 1 / (exp(-x) + 1), the correctly rounded reciprocal (the
//     IEEE divide's value), flushed likewise.
// Every other operation is an explicit round-to-nearest intrinsic, and the
// library is built with -fmad=false, so nothing is contracted.
//
// The scale.  The plain version multiplies z by 2^n in f64 (exact), flushes
// a product below 2^-126 to +0 and rounds the rest to f32.  Here: for a
// non-NaN x, z is +inf or a positive normal f32 (z = 1 + r + r^2 p(r) with
// |r| < 0.35 below the cap, about 0.70 to 1.42; at n = 127 r only grows
// and z with it, up to +inf), and n an integer in [-128, 127].  With E the
// biased exponent field of z, z lies in [2^(E-127), 2^(E-126)), so the
// exact product z * 2^n lies in [2^(E+n-127), 2^(E+n-126)):
//   * E + n < 1: the product is below 2^-126, flushed to +0;
//   * 1 <= E + n <= 254: the product is a normal f32 with z's 24-bit
//     significand, exact, and its bits are z's plus n << 23;
//   * E + n >= 255 (z = +inf included, E = 255 and n >= 0): the product
//     is at least 2^128 and rounds to +inf.
// So both give the same f32 for every (z, n) the polynomial produces;
// `tests/test_torch_xla_math.py` checks this case split against the f64
// rule over every exponent field and n, and `chip_smoke.py`'s objective
// phase runs all 2^32 f32 inputs through the kernel against the plain
// version on the card, for exp and for sigmoid.
//
// What bounds it on the H100: on paper the bytes, 4 in and 4 out an
// element: 2M values, 16 MB, 4.8 us at 3.35 TB/s.  The design moves them
// in 16-byte loads and stores, kVec a thread in flight (8 independent
// values, which also hides the reciprocal's latency), a grid-stride loop
// over at most kBlocksPerSm blocks an SM, and a scalar path for the n % 4
// tail and for pointers off a 16-byte boundary.  With L2 warm the
// polynomial's instructions, not the bytes, set its time (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 2;            // float4s a thread loads together
constexpr int kBlocksPerSm = 8;    // 2048 threads an SM
constexpr float kMagic = 12582912.0f;          // 1.5 * 2^23
constexpr int kMagicBits = 0x4B400000;         // its bits

// floor(v) for the exp's v = x log2(e) + 0.5 >= -127.2: v + 1.5 * 2^23
// rounded down is floor(v) + 1.5 * 2^23 exactly while v < 2^22 (where f32
// holds every integer of the sum's binade), and at or past 2^22 (or
// +inf) it is at least 2^22 + 1.5 * 2^23, so floor_magic(v) >= 2^22 and
// the min with 127 below is 127 either way: full-rate adds in place of
// the conversion unit's round-to-integer.
__device__ __forceinline__ float floor_magic(float v) {
  return __fsub_rn(__fadd_rd(v, kMagic), kMagic);
}

__device__ __forceinline__ float xla_exp(float x) {
  const float xc = fmaxf(x, -88.5f);
  const float v = __fadd_rn(__fmul_rn(xc, 1.44269504088896341f), 0.5f);
  float n = fminf(floor_magic(v), 127.0f);
  float r = __fmaf_rn(n, -0.693359375f, xc);
  r = __fmaf_rn(n, 2.12194440e-4f, r);
  float z = 1.9875691500e-4f;
  z = __fmaf_rn(z, r, 1.3981999507e-3f);
  z = __fmaf_rn(z, r, 8.3334519073e-3f);
  z = __fmaf_rn(z, r, 4.1665795894e-2f);
  z = __fmaf_rn(z, r, 1.6666665459e-1f);
  z = __fmaf_rn(z, r, 5.0000001201e-1f);
  z = __fmaf_rn(z, __fmul_rn(r, r), r);
  z = __fadd_rn(z, 1.0f);
  // z * 2^n (see the header): z's exponent field plus n decides; n is
  // integral in [-128, 127], so n + kMagic holds it in its low bits
  const int ni = __float_as_int(__fadd_rn(n, kMagic)) - kMagicBits;
  const int zb = __float_as_int(z);
  const int e = (zb >> 23) + ni;
  // selects, not branches: the thread's eight values stay in step
  const unsigned bits =
      static_cast<unsigned>(zb) + (static_cast<unsigned>(ni) << 23);
  float y = __int_as_float(static_cast<int>(bits));
  y = (e < 1) ? 0.0f : y;
  y = (e > 254) ? __int_as_float(0x7f800000) : y;
  return (x != x) ? x : y;                         // NaN in, NaN out
}

template <bool kSigmoid>
__device__ __forceinline__ float link(float v) {
  if (!kSigmoid) return xla_exp(v);
  // 1 / d correctly rounded: the IEEE divide's value, without its
  // general-case checks
  const float p = __frcp_rn(__fadd_rn(xla_exp(-v), 1.0f));
  return p < 1.17549435e-38f ? 0.0f : p;
}

__device__ __forceinline__ float4 link4(float4 a, bool sigmoid) {
  return sigmoid ? make_float4(link<true>(a.x), link<true>(a.y),
                               link<true>(a.z), link<true>(a.w))
                 : make_float4(link<false>(a.x), link<false>(a.y),
                               link<false>(a.z), link<false>(a.w));
}

// y = link(x) over n values: float4 groups q = tid, tid + stride, ...,
// kVec of them loaded before any is computed; then the scalar rest (the
// n % 4 tail, or every value when x or y lies off a 16-byte boundary).
template <bool kSigmoid>
__global__ void __launch_bounds__(kThreads)
xla_link_kernel(const float* __restrict__ x, long long n,
                float* __restrict__ y) {
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(y)) & 15u) == 0;
  const long long nv = aligned ? n / 4 : 0;
  const float4* xv = reinterpret_cast<const float4*>(x);
  float4* yv = reinterpret_cast<float4*>(y);
  for (long long q = tid; q < nv; q += kVec * stride) {
    float4 a[kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u)
      if (q + u * stride < nv) a[u] = __ldg(xv + q + u * stride);
#pragma unroll
    for (int u = 0; u < kVec; ++u)
      if (q + u * stride < nv) yv[q + u * stride] = link4(a[u], kSigmoid);
  }
  for (long long i = 4 * nv + tid; i < n; i += stride)
    y[i] = link<kSigmoid>(__ldg(x + i));
}

}  // namespace

// y[i] = XLA's exp(x[i]) (sigmoid 0) or sigmoid(x[i]) (sigmoid 1) for n
// f32 values.  Returns the cudaError_t of the launch.
extern "C" int lgbt_xla_link(const float* x, long long n, int sigmoid,
                             float* y, cudaStream_t stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long groups = (n + 4LL * kVec - 1) / (4LL * kVec);
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > static_cast<long long>(sms) * kBlocksPerSm)
    blocks = static_cast<long long>(sms) * kBlocksPerSm;
  if (sigmoid)
    xla_link_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(x, n, y);
  else
    xla_link_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0,
                             stream>>>(x, n, y);
  return static_cast<int>(cudaGetLastError());
}
