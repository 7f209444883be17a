// Radius-15 neighbourhood moments for the biology phases.
//
// Replaces: hipsc_abm_tpu/ops/pallas_bio.py `_bio_kernel` via
// `bio_reduce_pallas` (B4); the plain twin is
// hipsc_abm_tpu/engine.py `make_bio_moments_xla`.
//
// What it computes, per sorted row i: walk the row's three build-time
// stencil runs [lo_r, hi_r) (sorted positions, ascending). A candidate p
// counts if p != i, its flat bin id is live (< num_bins; the caller
// re-sentinels agents that died since the build), the row's own flat id is
// live, and |loc0_p - loc0_i|^2 <= radius^2 on the build-time positions.
// Output lanes (16 floats per row):
//   0 count, 1 sum f0, 2 sum f0^2,
//   3 count(f1 > f0), 4-6 sum of (loc1_p - loc1_i) over those,
//   7 count(f2 != 0), 8-10 sum of (loc1_p - loc1_i) over those, 11-15 zero.
// `mode` trims the work to the lanes a phase reads: 0 count, 1 pathway
// (lanes 0-2), 2 motility (lanes 0 and 3-10), 3 full.
//
// What bounds it on the card: ~70 candidates per row at radius 15 and
// reference density, 36 bytes each, from a few neighbouring bins: load
// latency and cache traffic, not arithmetic. The TPU kernel DMA'd
// 128-aligned spans of the sorted pack into VMEM per block of rows; here
// each thread reads only its own run slices, and the rows of a warp are
// sorted neighbours whose runs overlap, so the reads are served from L1/L2.
// The pack is 32-byte rows read as two float4 loads.

#include <cuda_runtime.h>

namespace {

__global__ void bio_moments_kernel(const float4* __restrict__ pack,
                                   const int* __restrict__ flat,
                                   const int* __restrict__ bounds,
                                   float* __restrict__ out, int C,
                                   int num_bins, float radius2, int mode) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= C) return;
  const bool want_f0 = mode == 1 || mode == 3;
  const bool want_disp = mode == 2 || mode == 3;

  float count = 0.f, sf0 = 0.f, sf0sq = 0.f;
  float ca = 0.f, ax = 0.f, ay = 0.f;
  float cb = 0.f, bx = 0.f, by = 0.f;
  if (flat[row] < num_bins) {
    const float4 me = pack[2 * (size_t)row];  // x0, y0, x1, y1
    for (int r = 0; r < 3; ++r) {
      const int lo = bounds[row * 6 + 2 * r];
      const int hi = bounds[row * 6 + 2 * r + 1];
      for (int p = lo; p < hi; ++p) {
        if (p == row || flat[p] >= num_bins) continue;
        const float4 c = pack[2 * (size_t)p];
        const float dx0 = c.x - me.x;
        const float dy0 = c.y - me.y;
        if (dx0 * dx0 + dy0 * dy0 > radius2) continue;
        count += 1.f;
        if (!(want_f0 || want_disp)) continue;
        const float4 f = pack[2 * (size_t)p + 1];  // f0, f1, f2, 0
        if (want_f0) {
          sf0 += f.x;
          sf0sq += f.x * f.x;
        }
        if (want_disp) {
          const float ddx = c.z - me.z;
          const float ddy = c.w - me.w;
          if (f.y > f.x) {
            ca += 1.f;
            ax += ddx;
            ay += ddy;
          }
          if (f.z != 0.f) {
            cb += 1.f;
            bx += ddx;
            by += ddy;
          }
        }
      }
    }
  }
  float* o = out + (size_t)row * 16;
  o[0] = count;
  o[1] = sf0;
  o[2] = sf0sq;
  o[3] = ca;
  o[4] = ax;
  o[5] = ay;
  o[6] = 0.f;
  o[7] = cb;
  o[8] = bx;
  o[9] = by;
#pragma unroll
  for (int l = 10; l < 16; ++l) o[l] = 0.f;
}

}  // namespace

extern "C" int hipsc_bio_moments(const void* pack, const void* flat,
                                 const void* bounds, void* out, int C,
                                 int num_bins, float radius2, int mode,
                                 void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  const int threads = 128;
  const int blocks = (C + threads - 1) / threads;
  bio_moments_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)pack, (const int*)flat, (const int*)bounds, (float*)out,
      C, num_bins, radius2, mode);
  return (int)cudaGetLastError();
}
