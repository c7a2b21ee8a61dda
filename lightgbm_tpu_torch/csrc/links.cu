// XLA's CPU f32 exp and sigmoid, bit for bit, one thread an element.
//
// Not a TPU kernel: the reference's objectives apply `jnp.exp` and
// `jax.nn.sigmoid` (`lightgbm_tpu/objectives.py:320`, `:328`), which XLA
// lowers to its own Cephes polynomial.  `ops/xla_math.py` states that
// arithmetic and runs it as torch ops on the CPU (the plain version);
// there it is about 60 elementwise launches with f64 temporaries, which on
// the card cost more than the request they convert.  This kernel does the
// same arithmetic in registers:
//   * n = floor(x * log2(e) + 0.5) with x clamped below at -88.5, then at
//     most 127 (f32 multiply and add, each rounded);
//   * the two reductions and the Horner steps as hardware fused
//     multiply-adds (__fmaf_rn, rounded once: the correctly rounded fma,
//     which `scripts/check_xla_exp_exhaustive.py` holds equal to XLA's
//     `exp` over all 2^32 inputs, as it does the plain version's
//     twice-rounded f64 multiply-adds);
//   * z * 2^n in f64 (exact), results below 2^-126 flushed to +0, the rest
//     rounded to f32 (exact, or +inf);
//   * NaN in, the same NaN out;
//   * sigmoid: 1 / (exp(-x) + 1) by an IEEE divide, flushed likewise.
// Every other operation is an explicit round-to-nearest intrinsic, and the
// library is built with -fmad=false, so nothing is contracted.
//
// What bounds it on the H100: the bytes, 4 in and 4 out an element (about
// 20 f32 operations an element is far below the card's rate): 2M values,
// 16 MB, 4.8 us at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float xla_exp(float x) {
  if (x != x) return x;
  const float xc = fmaxf(x, -88.5f);
  float n = floorf(__fadd_rn(__fmul_rn(xc, 1.44269504088896341f), 0.5f));
  n = fminf(n, 127.0f);
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
  const long long bits = (static_cast<long long>(n) + 1023) << 52;
  const double y = __dmul_rn(static_cast<double>(z), __longlong_as_double(bits));
  return y < 1.1754943508222875e-38 ? 0.0f : __double2float_rn(y);
}

__global__ void __launch_bounds__(kThreads)
xla_link_kernel(const float* __restrict__ x, long long n, int sigmoid,
                float* __restrict__ y) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  const float v = __ldg(x + i);
  if (!sigmoid) {
    y[i] = xla_exp(v);
    return;
  }
  const float p = __fdiv_rn(1.0f, __fadd_rn(xla_exp(-v), 1.0f));
  y[i] = p < 1.17549435e-38f ? 0.0f : p;
}

}  // namespace

// y[i] = XLA's exp(x[i]) (sigmoid 0) or sigmoid(x[i]) (sigmoid 1) for n
// f32 values.  Returns the cudaError_t of the launch.
extern "C" int lgbt_xla_link(const float* x, long long n, int sigmoid,
                             float* y, cudaStream_t stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  xla_link_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      x, n, sigmoid, y);
  return static_cast<int>(cudaGetLastError());
}
