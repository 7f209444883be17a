// JKR contact substep over per-row stencil runs (id-list bonds).
//
// Replaces: hipsc_abm_tpu/ops/pallas_contact.py `_contact_kernel` via
// `contact_substep_pallas` (B6), which computes the same physics as
// hipsc_abm_tpu/ops/jkr.py `jkr_substep`.
//
// What it computes, per sorted row i (alive): walk the stencil runs
// r = 0..N_RUNS-1 (3 in 2D, 9 in 3D: a template parameter, as the TPU
// kernel's `run_offs` length was static), sorted positions p in [lo_r, hi_r)
// ascending. A candidate p counts if its id differs from the row's id and it
// is a fresh contact (dist^2 <= radius^2) or already in the row's partner
// list. The JKR pair law gives the force and a survival flag
// (nondimensional overlap d > break_d). Survivors add their force and are
// appended to the new partner list in walk order; the list keeps the first
// K and the returned degree is the untruncated count (the bond-capacity
// overflow probe).
//
// What bounds it on the card: a row walks its candidates of 20 bytes each,
// all inside a few neighbouring bins (8.6 per live row at the 2D bench
// colony's density, 222 over nine runs in the 3D spheroid, chip_smoke.py's
// 100k and 99k states), so the kernel is bound by load latency and L1/L2
// traffic, not arithmetic. The TPU kernel DMA'd 128-aligned spans into VMEM
// and tested every lane of a span against every row of a block; on Hopper
// each thread reads only its own run slices (the rows of a warp are
// neighbours in the sorted order, so their runs overlap and the reads hit
// L1), and the per-row bond membership test is a loop over the row's K
// partner ids that runs only for candidates outside the search radius. In
// 3D that loop dominates: most candidates lie beyond the search radius, and
// each reads all K partner ids (K = 24 there). The partner lists stay in
// global memory (no K-sized register array), so any K up to the engine's
// guard works.
//
// One thread per row rather than one warp per row: a row has 3 (2D) to 25
// (3D) candidates per run, too few to keep 32 lanes busy, and a thread per
// row keeps the first-K compaction a plain sequential append.

#include <cuda_runtime.h>

#include "jkr_pair.cuh"

namespace {

using hipsc::PairLaw;

template <int N_RUNS>
__global__ void contact_substep_kernel(
    const float4* __restrict__ xyzr, const int* __restrict__ ids,
    const unsigned char* __restrict__ alive, const int* __restrict__ bounds,
    const int* __restrict__ partners, float* __restrict__ force,
    int* __restrict__ degree, int* __restrict__ new_partners, int C, int K,
    PairLaw law) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= C) return;
  const int* my_partners = partners + (size_t)row * K;
  int* out_partners = new_partners + (size_t)row * K;

  float fx = 0.f, fy = 0.f, fz = 0.f;
  int count = 0;
  if (alive[row]) {
    const float4 me = xyzr[row];
    const int my_id = ids[row];
    for (int r = 0; r < N_RUNS; ++r) {
      const int lo = bounds[row * 2 * N_RUNS + 2 * r];
      const int hi = bounds[row * 2 * N_RUNS + 2 * r + 1];
      for (int p = lo; p < hi; ++p) {
        const int cid = ids[p];
        if (cid == my_id) continue;
        const float4 c = xyzr[p];
        const float dx = me.x - c.x;
        const float dy = me.y - c.y;
        const float dz = me.z - c.z;
        const float dist2 = dx * dx + dy * dy + dz * dz;
        bool eligible = dist2 <= law.radius2;
        for (int k = 0; k < K && !eligible; ++k) {
          eligible = my_partners[k] == cid;
        }
        if (!eligible) continue;

        // the bond breaks: no force, no entry
        if (!hipsc::jkr_pair(law, me, c, dx, dy, dz, dist2, fx, fy, fz)) continue;
        if (count < K) out_partners[count] = cid;
        ++count;
      }
    }
  }
  for (int k = count < K ? count : K; k < K; ++k) out_partners[k] = -1;
  force[(size_t)row * 3 + 0] = fx;
  force[(size_t)row * 3 + 1] = fy;
  force[(size_t)row * 3 + 2] = fz;
  degree[row] = count;
}

}  // namespace

extern "C" int hipsc_contact_substep(
    const void* xyzr, const void* ids, const void* alive, const void* bounds,
    const void* partners, void* force, void* degree, void* new_partners, int C,
    int K, int n_runs, float radius2, float break_d, int uniform, float two_r,
    float inv_scale, float fpre, float scale_c, float pi_f, float adhesion,
    void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  if (n_runs != 3 && n_runs != 9) return (int)cudaErrorInvalidValue;
  PairLaw law{radius2, break_d, uniform, two_r, inv_scale, fpre, scale_c, pi_f, adhesion};
  const int threads = 128;
  const int blocks = (C + threads - 1) / threads;
  auto kernel = n_runs == 3 ? contact_substep_kernel<3> : contact_substep_kernel<9>;
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)xyzr, (const int*)ids, (const unsigned char*)alive,
      (const int*)bounds, (const int*)partners, (float*)force, (int*)degree,
      (int*)new_partners, C, K, law);
  return (int)cudaGetLastError();
}

extern "C" const char* hipsc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
