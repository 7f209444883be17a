// Elementwise float32 fused multiply-add, out = a * b + c rounded once.
//
// Replaces no TPU kernel: glue. XLA:CPU fuses a product into the add that
// consumes it (ops/xla_f32.py), and the plain mirror of that FMA,
// `rng.fma_f32`, is some twenty eager float64 and integer operations (round
// to odd), each a launch on the card. Where the step's glue needs one (the
// daughters' displacement, the motility norm, the deposit's distance) this
// kernel does it in one launch: `__fmaf_rn`, the same single rounding. `b`
// and `c` are arrays of a's shape or scalars (null pointer, value passed).
//
// What bounds it on the card: bytes, 12 per element (a few ms of nothing at
// the step's sizes: its launch is most of its time).

#include <cuda_runtime.h>

namespace {

__global__ void fma_kernel(const float* __restrict__ a, const float* __restrict__ b, float bs,
                           const float* __restrict__ c, float cs, float* __restrict__ out,
                           long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __fmaf_rn(a[i], b ? b[i] : bs, c ? c[i] : cs);
}

}  // namespace

extern "C" int hipsc_fma(const void* a, const void* b, float bs, const void* c, float cs,
                         void* out, long long n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 256;
  fma_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, bs, (const float*)c, cs, (float*)out, n);
  return (int)cudaGetLastError();
}
