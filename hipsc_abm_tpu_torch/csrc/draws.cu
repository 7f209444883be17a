// The step's per-agent random draws: one thread per agent id computes the
// whole draw, from the id-keyed hash to the float32 output.
//
// Not a port of a TPU kernel: the JAX package draws with XLA ops
// (hipsc_abm_tpu/ops/rng.py `normal`, `unit_vectors`). On XLA:CPU those ops
// are XLA's own float32 `log` polynomial and glibc's `cosf`/`sinf`; the port
// mirrors both so that its draws equal the JAX package's bit for bit. The
// plain versions are hipsc_abm_tpu_torch/ops/rng.py `normal_plain` and
// `unit_vectors_plain`, eager PyTorch ops of which each rounds once.
//
// Why a kernel: the mirrors are some 30-60 dependent elementwise operations
// per value, so as PyTorch ops on the card a draw would be ~100 launches,
// and the step at small colonies is bound by launches. Here it is one.
//
// Every rounding is the plain version's: the library is built with
// --fmad=false, the float32 arithmetic is spelled with the _rn intrinsics,
// and a fused multiply-add appears only where XLA:CPU (log) or glibc 2.36's
// __cosf_fma/__sinf_fma (cos, sin) fuse one. The plain version evaluates
// glibc's double polynomials unfused; over the draws' 2^24 inputs that never
// changes the float32 result (the CPU tests hold both against JAX, and
// chip_smoke.py this kernel against the plain version, over all of them).
//
// What bounds it on the card: the bytes of the ids read and the floats
// written; the arithmetic is ~100 operations per id, far under the card's
// rate. At the step's colony sizes a launch costs more than either.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr float kTwoPi = 0x1.921fb6p+2f;  // float32(2 pi)

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// rng.uniform: the top 24 bits of the keyed hash, times 2^-24
__device__ __forceinline__ float uniform24(uint32_t k0, uint32_t k1, uint32_t id,
                                           int salt) {
  const uint32_t h = fmix32(fmix32(id ^ k0) ^ (k1 + kGolden * (uint32_t)(salt + 1)));
  return __fmul_rn(__uint2float_rn(h >> 8), 0x1p-24f);
}

// rng.log_f32 for x in (0, 1], the draws' domain: XLA:CPU's float32 log
// (Cephes), with the fused multiply-adds its backend forms
__device__ __forceinline__ float log_xla(float x) {
  const int bits = __float_as_int(x);
  float e = __fadd_rn(__int2float_rn((bits >> 23) - 127), 1.0f);
  const float m = __int_as_float((int)(((uint32_t)bits & 0x807FFFFFu) | 0x3F000000u));
  const bool below = m < 0x1.6a09e6p-1f;  // sqrt(1/2)
  e = __fsub_rn(e, below ? 1.0f : 0.0f);
  const float r = __fadd_rn(__fsub_rn(m, 1.0f), below ? m : 0.0f);
  const float r2 = __fmul_rn(r, r);
  const float r3 = __fmul_rn(r2, r);
  float y = __fmaf_rn(__fmaf_rn(r, 0x1.204376p-4f, -0x1.d7a37p-4f), r, 0x1.de4a34p-4f);
  const float y1 = __fmaf_rn(__fmaf_rn(r, -0x1.fcba9ep-4f, 0x1.23d37ep-3f), r, -0x1.555ca0p-3f);
  const float y2 = __fmaf_rn(__fmaf_rn(r, 0x1.999d58p-3f, -0x1.fffff8p-3f), r, 0x1.555554p-2f);
  y = __fmaf_rn(__fmaf_rn(__fmaf_rn(y, r3, y1), r3, y2), r3, __fmul_rn(e, -0x1.bd0106p-13f));
  return __fmaf_rn(e, 0x1.63p-1f, __fadd_rn(__fsub_rn(r, __fmul_rn(r2, 0.5f)), y));
}

// glibc 2.36's sinf_poly (sysdeps/ieee754/flt-32/sincosf.h) as __sinf_fma
// and __cosf_fma evaluate it: the sine polynomial of xs, x2 = x^2 ...
__device__ __forceinline__ double sin_poly(double xs, double x2) {
  const double x3 = __dmul_rn(x2, xs);
  const double x5 = __dmul_rn(x2, x3);
  const double s1 = __fma_rn(x2, -0x1.994eb3774cf24p-13, 0x1.1107605230bc4p-7);
  return __fma_rn(x5, s1, __fma_rn(x3, -0x1.555545995a603p-3, xs));
}

// ... and the cosine polynomial, `sign` -1 for the table with c0..c4 negated
__device__ __forceinline__ double cos_poly(double x2, double sign) {
  const double x4 = __dmul_rn(x2, x2);
  const double x6 = __dmul_rn(x2, x4);
  const double c1 = __fma_rn(x2, sign * -0x1.ffffffd0c621cp-2, sign);
  const double c2 = __fma_rn(x2, sign * 0x1.99343027bf8c3p-16, sign * -0x1.6c087e89a359dp-10);
  return __fma_rn(x6, c2, __fma_rn(x4, sign * 0x1.55553e1068f19p-5, c1));
}

// glibc 2.36's sinf (SINE) or cosf of y, 0 <= y < 120 (rng.sinf_glibc,
// rng.cosf_glibc): the direct polynomial below 0.75, else the quadrant n by
// glibc's truncating reduction, the remainder x - n pi/2 in one fused step,
// and the polynomial of the quadrant
template <bool SINE>
__device__ __forceinline__ float sincosf_glibc(float y) {
  const uint32_t top = (__float_as_uint(y) >> 20) & 0x7FF;
  if (top < 0x398) return SINE ? y : 1.0f;
  const double x = (double)y;
  if (top < 0x3F4) {
    const double x2 = __dmul_rn(x, x);
    return __double2float_rn(SINE ? sin_poly(x, x2) : cos_poly(x2, 1.0));
  }
  const int n = (__double2int_rz(__dmul_rn(x, 0x1.45f306dc9c883p+23)) + 0x800000) >> 24;
  const double xr = __fma_rn(-(double)n, 0x1.921fb54442d18p+0, x);
  const double x2 = __dmul_rn(xr, xr);
  const bool use_sin = SINE ? (n & 1) == 0 : (n & 1) == 1;
  if (use_sin) {
    const double sign = ((n & 3) == 1 || (n & 3) == 2) ? -1.0 : 1.0;
    return __double2float_rn(sin_poly(xr * sign, x2));
  }
  return __double2float_rn(cos_poly(x2, (n & 2) ? -1.0 : 1.0));
}

// rng.normal: Box-Muller on the streams `salt` and `salt + 17`
__global__ void __launch_bounds__(kThreads) normal_kernel(
    const int64_t* __restrict__ key, const int* __restrict__ ids,
    float* __restrict__ out, long long n, int salt) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t k0 = (uint32_t)key[0], k1 = (uint32_t)key[1];
  const uint32_t id = (uint32_t)ids[i];
  const float u1 = __fadd_rn(uniform24(k0, k1, id, salt), 0x1p-25f);
  const float u2 = uniform24(k0, k1, id, salt + 17);
  const float radius = __fsqrt_rn(__fmul_rn(-2.0f, log_xla(u1)));
  out[i] = __fmul_rn(radius, sincosf_glibc<false>(__fmul_rn(kTwoPi, u2)));
}

// rng.unit_vectors: the angle from stream `salt`, in 3D the elevation from
// `salt + 29`; (n, 3) rows
template <bool TWO_D>
__global__ void __launch_bounds__(kThreads) unit_vectors_kernel(
    const int64_t* __restrict__ key, const int* __restrict__ ids,
    float* __restrict__ out, long long n, int salt) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t k0 = (uint32_t)key[0], k1 = (uint32_t)key[1];
  const uint32_t id = (uint32_t)ids[i];
  const float theta = __fmul_rn(uniform24(k0, k1, id, salt), kTwoPi);
  const float c = sincosf_glibc<false>(theta), s = sincosf_glibc<true>(theta);
  float* row = out + 3 * i;
  if (TWO_D) {
    row[0] = c;
    row[1] = s;
    row[2] = 0.0f;
  } else {
    const float phi = __fmul_rn(uniform24(k0, k1, id, salt + 29), kTwoPi);
    const float radius = sincosf_glibc<false>(phi);
    row[0] = __fmul_rn(radius, c);
    row[1] = __fmul_rn(radius, s);
    row[2] = sincosf_glibc<true>(phi);
  }
}

bool grid_of(long long n, unsigned* blocks) {
  const long long b = (n + kThreads - 1) / kThreads;
  if (b > 0x7fffffffLL) return false;
  *blocks = (unsigned)b;
  return true;
}

}  // namespace

// `key`: (2,) int64, the raw key's two uint32 words; `ids`: (n,) int32;
// `out`: (n,) float32.
extern "C" int hipsc_draw_normal(const void* key, const void* ids, void* out,
                                 long long n, int salt, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  unsigned blocks;
  if (!grid_of(n, &blocks)) return (int)cudaErrorInvalidValue;
  normal_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)key, (const int*)ids, (float*)out, n, salt);
  return (int)cudaGetLastError();
}

// As above with `out` (n, 3) float32; `two_d` 1 for the unit circle.
extern "C" int hipsc_draw_unit_vectors(const void* key, const void* ids, void* out,
                                       long long n, int salt, int two_d, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  unsigned blocks;
  if (!grid_of(n, &blocks)) return (int)cudaErrorInvalidValue;
  if (two_d)
    unit_vectors_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)key, (const int*)ids, (float*)out, n, salt);
  else
    unit_vectors_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)key, (const int*)ids, (float*)out, n, salt);
  return (int)cudaGetLastError();
}
