// FTCS diffusion on the morphogen lattice: the whole subcycle schedule of a
// step in one persistent, cooperatively launched kernel.
//
// Replaces: hipsc_abm_tpu/ops/pallas_diffusion.py `_ftcs_kernel` via
// `ftcs_diffuse_pallas` (B5), which runs every subcycle inside one
// pallas_call; the plain version is hipsc_abm_tpu_torch/ops/diffusion.py
// `ftcs_diffuse`.
//
// What it computes: `steps` subcycles new = fma(b, c, a * (((down + up) +
// right) + left)) on the (nx, ny) lattice, with (a_main, b_main) for all but
// the last and (a_last, b_last) for the last (`diffusion_dts` always ends
// with its remainder subcycle). The reference reflects a ghost ring (columns,
// then rows) before every subcycle; the five-point stencil never reads a
// corner, so that reflection is exactly a clamp of each neighbour index into
// the lattice. The association of the sum is the plain version's, and the
// arithmetic is written with __fmul_rn/__fadd_rn/__fmaf_rn: the one FMA is
// where XLA:CPU fuses the TPU kernel's `b * c + temp` (ops/xla_f32.py),
// and nvcc may contract nothing else, so every subcycle is bit-identical to
// the plain float32 one.
//
// What bounds it on the card: per step the lattice must be read once and
// written once (0.8 MB at 449 x 449, 4 MB at 1001 x 1001) and each subcycle
// does 9 float32 operations per cell, ~0.008 ms of operations per step at
// 449 x 449 and 301 subcycles. One launch per subcycle, as the first port
// did, cost ~17 us of host time per subcycle for ~2 us of device work. The
// design, after the TPU kernel that kept the lattice in VMEM:
// - One CTA per tile of the lattice (ops/ftcs.py `ftcs_plan` chooses the
//   tiles and the halo width T, at most one CTA per SM, so a cooperative
//   launch keeps them all resident).
// - Temporal blocking: each CTA loads its tile plus a halo of T cells into
//   shared memory and runs T subcycles there, ping-ponging two buffers with
//   __syncthreads() between subcycles. Subcycle k recomputes the halo cells
//   that are still exact: the region shrinks by one cell per subcycle on
//   every side that lies inside the lattice, and on a lattice border the
//   neighbour index is clamped into the lattice as above, so each cell a
//   CTA keeps went through exactly the plain version's arithmetic. After T
//   subcycles the tile's own cells are written to a global ping-pong
//   buffer, all CTAs pass a grid barrier, and the next T subcycles reload
//   tile plus halo from there: ceil(steps / T) - 1 grid barriers per step
//   instead of `steps` launches.
// - The grid barrier is an arrival counter in device memory (zeroed by the
//   wrapper, a memset that a captured CUDA graph replays before the
//   kernel), valid because the cooperative launch guarantees co-residency;
//   no CTA returns before the last barrier. Reloads read through L2
//   (__ldcg), since L1 is not coherent across SMs.

#include <algorithm>

#include <cuda_runtime.h>

namespace {

// threads per CTA: 32 columns x 16 rows (ops/ftcs.py FTCS_THREADS)
constexpr int kCols = 32;
constexpr int kRows = 16;

struct Tiling {
  int nx, ny;    // lattice
  int th, tw;    // tile rows, columns (the last tile of a row/column may be short)
  int gy;        // tiles per lattice row of tiles
  int halo;      // T: subcycles per reload
  int pitch;     // shared row pitch: min(tw + 2T, ny)
  int buf;       // floats per shared buffer: min(th + 2T, nx) * pitch
};

// All CTAs arrive; none leaves before `target` arrivals in all.
__device__ __forceinline__ void grid_barrier(unsigned* arrived, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    __threadfence();
    atomicAdd(arrived, 1u);
    while (*(volatile unsigned*)arrived < target) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kCols * kRows, 1) ftcs_diffuse_kernel(
    float* buf0, float* buf1, unsigned* arrived, Tiling g, int steps,
    float a_main, float b_main, float a_last, float b_last) {
  extern __shared__ float smem[];
  const int ti = blockIdx.x / g.gy, tj = blockIdx.x % g.gy;
  // the tile [r0, r1) x [c0, c1) and its region with halo, clipped to the lattice
  const int r0 = ti * g.th, r1 = min(r0 + g.th, g.nx);
  const int c0 = tj * g.tw, c1 = min(c0 + g.tw, g.ny);
  const int R0 = max(r0 - g.halo, 0), R1 = min(r1 + g.halo, g.nx);
  const int Q0 = max(c0 - g.halo, 0), Q1 = min(c1 + g.halo, g.ny);
  const int n_blocks = (steps + g.halo - 1) / g.halo;
  for (int blk = 0; blk < n_blocks; ++blk) {
    const float* src = (blk & 1) ? buf1 : buf0;
    float* dst = (blk & 1) ? buf0 : buf1;
    float* in = smem;
    float* out = smem + g.buf;
    for (int r = R0 + threadIdx.y; r < R1; r += kRows)
      for (int c = Q0 + threadIdx.x; c < Q1; c += kCols)
        in[(r - R0) * g.pitch + (c - Q0)] = __ldcg(src + (size_t)r * g.ny + c);
    __syncthreads();
    const int first = blk * g.halo;
    const int n_sub = min(g.halo, steps - first);
    for (int k = 1; k <= n_sub; ++k) {
      const bool last = first + k == steps;
      const float a = last ? a_last : a_main;
      const float b = last ? b_last : b_main;
      // the cells still exact after k subcycles: the region less k on
      // every side inside the lattice
      const int lo_r = R0 > 0 ? R0 + k : 0, hi_r = R1 < g.nx ? R1 - k : g.nx;
      const int lo_c = Q0 > 0 ? Q0 + k : 0, hi_c = Q1 < g.ny ? Q1 - k : g.ny;
      for (int r = lo_r + threadIdx.y; r < hi_r; r += kRows) {
        const float* mid = in + (r - R0) * g.pitch;
        const float* up = in + (max(r - 1, 0) - R0) * g.pitch;
        const float* down = in + (min(r + 1, g.nx - 1) - R0) * g.pitch;
        float* res = out + (r - R0) * g.pitch;
        for (int c = lo_c + threadIdx.x; c < hi_c; c += kCols) {
          const int cc = c - Q0;
          const int left = max(c - 1, 0) - Q0;
          const int right = min(c + 1, g.ny - 1) - Q0;
          const float sum =
              __fadd_rn(__fadd_rn(__fadd_rn(down[cc], up[cc]), mid[right]), mid[left]);
          res[cc] = __fmaf_rn(b, mid[cc], __fmul_rn(a, sum));
        }
      }
      __syncthreads();
      float* tmp = in;
      in = out;
      out = tmp;
    }
    for (int r = r0 + threadIdx.y; r < r1; r += kRows)
      for (int c = c0 + threadIdx.x; c < c1; c += kCols)
        dst[(size_t)r * g.ny + c] = in[(r - R0) * g.pitch + (c - Q0)];
    if (blk + 1 < n_blocks) grid_barrier(arrived, (unsigned)(blk + 1) * gridDim.x);
  }
}

}  // namespace

// `buf0` holds the clipped lattice and is overwritten; the result lies in
// buf0 if ceil(steps / halo) is even, else in buf1. `arrived` is one zeroed
// uint32. The tiling is ops/ftcs.py `ftcs_plan`'s: gx x gy tiles of th x tw
// cells, one CTA each.
extern "C" int hipsc_ftcs_diffuse(void* buf0, void* buf1, void* arrived, int nx,
                                  int ny, int th, int tw, int gx, int gy,
                                  int halo, int steps, float a_main,
                                  float b_main, float a_last, float b_last,
                                  void* stream) {
  if (nx <= 0 || ny <= 0 || steps <= 0) return (int)cudaSuccess;
  if (th < 1 || tw < 1 || halo < 1 || (gx - 1) * th >= nx || gx * th < nx ||
      (gy - 1) * tw >= ny || gy * tw < ny)
    return (int)cudaErrorInvalidValue;
  // the largest region of tile plus halo, clipped to the lattice (as
  // ops/ftcs.py FtcsPlan.region)
  const int pitch = std::min(tw + 2 * halo, ny);
  Tiling g{nx, ny, th, tw, gy, halo, pitch, std::min(th + 2 * halo, nx) * pitch};
  const size_t smem = 2 * (size_t)g.buf * sizeof(float);
  const dim3 threads(kCols, kRows);
  const int ctas = gx * gy;
  cudaError_t err = cudaFuncSetAttribute(
      ftcs_diffuse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, ftcs_diffuse_kernel, kCols * kRows, smem)) != cudaSuccess)
    return (int)err;
  if (ctas > per_sm * n_sm) return (int)cudaErrorCooperativeLaunchTooLarge;
  float* p0 = (float*)buf0;
  float* p1 = (float*)buf1;
  unsigned* cnt = (unsigned*)arrived;
  // a cooperative launch through cudaLaunchKernelEx, which a stream capture
  // records into a CUDA graph as a cooperative kernel node
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ctas);
  config.blockDim = threads;
  config.dynamicSmemBytes = smem;
  config.stream = (cudaStream_t)stream;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, ftcs_diffuse_kernel, p0, p1, cnt, g, steps, a_main,
                           b_main, a_last, b_last);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
