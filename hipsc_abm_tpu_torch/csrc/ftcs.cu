// One FTCS diffusion subcycle on the morphogen lattice.
//
// Replaces: hipsc_abm_tpu/ops/pallas_diffusion.py `_ftcs_kernel` via
// `ftcs_diffuse_pallas` (B5); the plain version is
// hipsc_abm_tpu/ops/diffusion.py `ftcs_subcycle` / `ftcs_diffuse`.
//
// What it computes: new = b * c + a * (((down + up) + right) + left) on the
// (nx, ny) interior. The reference reflects a ghost ring (columns, then
// rows) before every subcycle; the five-point stencil never reads a corner,
// so that reflection is exactly a clamp of each neighbour index into the
// interior, fused here into the loads. The association of the sum is the
// plain version's, and the products and sums are written with
// __fmul_rn/__fadd_rn so that nvcc cannot contract them into FMAs: each
// subcycle is bit-identical to the plain float32 one.
//
// What bounds it on the card: a 449 x 449 lattice is 0.8 MB and stays in
// L2, so one subcycle is a few microseconds of launch overhead rather than
// memory time; the ~300 subcycles of a step are ~300 launches. The TPU
// kernel held the lattice in VMEM and looped all subcycles inside one
// kernel; a grid-wide barrier per subcycle has no cheap counterpart here,
// so this first version ping-pongs two buffers with one launch per
// subcycle (a CUDA graph or a persistent kernel is later work).

#include <cuda_runtime.h>

namespace {

__global__ void ftcs_subcycle_kernel(const float* __restrict__ src,
                                     float* __restrict__ dst, int nx, int ny,
                                     float a, float b) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;  // minor axis
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const int up_i = i > 0 ? i - 1 : 0;
  const int down_i = i < nx - 1 ? i + 1 : nx - 1;
  const int left_j = j > 0 ? j - 1 : 0;
  const int right_j = j < ny - 1 ? j + 1 : ny - 1;
  const size_t row = (size_t)i * ny;
  const float c = src[row + j];
  const float down = src[(size_t)down_i * ny + j];
  const float up = src[(size_t)up_i * ny + j];
  const float right = src[row + right_j];
  const float left = src[row + left_j];
  const float sum = __fadd_rn(__fadd_rn(__fadd_rn(down, up), right), left);
  dst[row + j] = __fadd_rn(__fmul_rn(b, c), __fmul_rn(a, sum));
}

}  // namespace

extern "C" int hipsc_ftcs_subcycle(const void* src, void* dst, int nx, int ny,
                                   float a, float b, void* stream) {
  if (nx <= 0 || ny <= 0) return (int)cudaSuccess;
  const dim3 threads(32, 8);
  const dim3 blocks((ny + threads.x - 1) / threads.x,
                    (nx + threads.y - 1) / threads.y);
  ftcs_subcycle_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)src, (float*)dst, nx, ny, a, b);
  return (int)cudaGetLastError();
}
