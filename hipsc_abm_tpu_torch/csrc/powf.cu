// glibc's powf over an array: the device twin of the general pair law's
// cube root (glibc_powf.cuh `powf_glibc`), so that it can be held against
// the plain mirror (ops/xla_f32.py `powf`) over every input of a range.
// Not on the step's path: the contact kernels inline the device function.

#include <cuda_runtime.h>

#include "glibc_powf.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) powf_kernel(const float* __restrict__ x,
                                                        float* __restrict__ out, float y,
                                                        long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) out[i] = hipsc::powf_glibc(x[i], y);
}

}  // namespace

extern "C" int hipsc_powf(const void* x, void* out, float y, long long n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  powf_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, y, n);
  return (int)cudaGetLastError();
}
