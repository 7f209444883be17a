// Radius-15 neighbourhood moments for the biology phases.
//
// Replaces: hipsc_abm_tpu/ops/pallas_bio.py `_bio_kernel` via
// `bio_reduce_pallas` (B4), in both of its forms (8-lane pack and 3 runs in
// 2D, 16-lane pack and 9 runs in 3D); the plain twin is
// hipsc_abm_tpu/engine.py `make_bio_moments_xla`.
//
// What it computes, per sorted row i: walk the row's build-time stencil runs
// [lo_r, hi_r) (sorted positions, ascending; N_RUNS = 3 in 2D, 9 in 3D). A
// candidate p counts if p != i, its flat bin id is live (< num_bins; the
// caller re-sentinels agents that died since the build), the row's own flat
// id is live, and |loc0_p - loc0_i|^2 <= radius^2 on the build-time
// positions. Output lanes (16 floats per row):
//   0 count, 1 sum f0, 2 sum f0^2,
//   3 count(f1 > f0), 4-6 sum of (loc1_p - loc1_i) over those,
//   7 count(f2 != 0), 8-10 sum of (loc1_p - loc1_i) over those, 11-15 zero
//   (lanes 6 and 10, the z sums, are zero in 2D).
// `mode` trims the work to the lanes a phase reads: 0 count, 1 pathway
// (lanes 0-2), 2 motility (lanes 0 and 3-10), 3 full.
//
// Pack rows. 2D: 8 floats, two float4 loads, [x0 y0 x1 y1 | f0 f1 f2 0].
// 3D: 12 floats (48 bytes, so every row starts 16-byte aligned), three
// float4 loads, [x0 y0 z0 f0 | x1 y1 z1 f1 | f2 0 0 0]. The TPU's 3D pack is
// 16 lanes because its DMA tiles want a power of two; here the layout
// follows the modes instead: the distance test needs only the first float4,
// and the pathway mode finds f0 in the same load, so the count and pathway
// passes read 16 bytes per candidate and only motility reads all 48.
//
// What bounds it on the card: a row's candidates lie in a few neighbouring
// bins (3.8 per live row at the 2D bench colony's density, 53 over the 27
// bins of the 3D spheroid, chip_smoke.py's 100k and 99k states): load
// latency and cache traffic, not arithmetic. The TPU kernel DMA'd
// 128-aligned spans of the sorted pack into VMEM per block of rows; here
// each thread reads only its own run slices, and the rows of a warp are
// sorted neighbours whose runs overlap, so the reads are served from L1/L2.

#include <cuda_runtime.h>

namespace {

template <int N_RUNS>
__global__ void bio_moments_kernel(const float4* __restrict__ pack,
                                   const int* __restrict__ flat,
                                   const int* __restrict__ bounds,
                                   float* __restrict__ out, int C,
                                   int num_bins, float radius2, int mode) {
  constexpr bool k3D = N_RUNS == 9;
  constexpr int kRow = k3D ? 3 : 2;  // float4s per pack row
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= C) return;
  const bool want_f0 = mode == 1 || mode == 3;
  const bool want_disp = mode == 2 || mode == 3;

  float count = 0.f, sf0 = 0.f, sf0sq = 0.f;
  float ca = 0.f, ax = 0.f, ay = 0.f, az = 0.f;
  float cb = 0.f, bx = 0.f, by = 0.f, bz = 0.f;
  if (flat[row] < num_bins) {
    // 2D: x0, y0, x1, y1; 3D: x0, y0, z0, f0 and x1, y1, z1, f1
    const float4 me = pack[kRow * (size_t)row];
    const float4 me1 = k3D ? pack[kRow * (size_t)row + 1] : me;
    for (int r = 0; r < N_RUNS; ++r) {
      const int lo = bounds[row * 2 * N_RUNS + 2 * r];
      const int hi = bounds[row * 2 * N_RUNS + 2 * r + 1];
      for (int p = lo; p < hi; ++p) {
        if (p == row || flat[p] >= num_bins) continue;
        const float4 c = pack[kRow * (size_t)p];
        const float dx0 = c.x - me.x;
        const float dy0 = c.y - me.y;
        float dist2 = dx0 * dx0 + dy0 * dy0;
        if (k3D) {
          const float dz0 = c.z - me.z;
          dist2 = dist2 + dz0 * dz0;
        }
        if (dist2 > radius2) continue;
        count += 1.f;
        if (!(want_f0 || want_disp)) continue;
        float f0 = 0.f, f1 = 0.f, f2 = 0.f, ddx = 0.f, ddy = 0.f, ddz = 0.f;
        if (k3D) {
          f0 = c.w;
          if (want_disp) {
            const float4 c1 = pack[3 * (size_t)p + 1];  // x1, y1, z1, f1
            f1 = c1.w;
            f2 = pack[3 * (size_t)p + 2].x;
            ddx = c1.x - me1.x;
            ddy = c1.y - me1.y;
            ddz = c1.z - me1.z;
          }
        } else {
          const float4 f = pack[2 * (size_t)p + 1];  // f0, f1, f2, 0
          f0 = f.x;
          f1 = f.y;
          f2 = f.z;
          ddx = c.z - me.z;
          ddy = c.w - me.w;
        }
        if (want_f0) {
          sf0 += f0;
          sf0sq += f0 * f0;
        }
        if (want_disp) {
          if (f1 > f0) {
            ca += 1.f;
            ax += ddx;
            ay += ddy;
            az += ddz;
          }
          if (f2 != 0.f) {
            cb += 1.f;
            bx += ddx;
            by += ddy;
            bz += ddz;
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
  o[6] = az;
  o[7] = cb;
  o[8] = bx;
  o[9] = by;
  o[10] = bz;
#pragma unroll
  for (int l = 11; l < 16; ++l) o[l] = 0.f;
}

}  // namespace

extern "C" int hipsc_bio_moments(const void* pack, const void* flat,
                                 const void* bounds, void* out, int C,
                                 int num_bins, float radius2, int mode,
                                 int n_runs, void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  if (n_runs != 3 && n_runs != 9) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (C + threads - 1) / threads;
  auto kernel = n_runs == 3 ? bio_moments_kernel<3> : bio_moments_kernel<9>;
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)pack, (const int*)flat, (const int*)bounds, (float*)out,
      C, num_bins, radius2, mode);
  return (int)cudaGetLastError();
}
