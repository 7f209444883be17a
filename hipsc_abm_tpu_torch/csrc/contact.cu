// JKR contact substep over per-row stencil runs (id-list bonds).
//
// Replaces: hipsc_abm_tpu/ops/pallas_contact.py `_contact_kernel` via
// `contact_substep_pallas` (B6), which computes the same physics as
// hipsc_abm_tpu/ops/jkr.py `jkr_substep`.
//
// What it computes, per sorted row i (alive): walk the stencil runs
// r = 0..N_RUNS-1 (3 in 2D, 9 in 3D: a template parameter, as the TPU
// kernel's `run_offs` length was static), sorted positions p in [lo_r, hi_r)
// ascending, chunk-major as the TPU kernel walks them: for each chunk of its
// span lanes, each run's positions in that chunk (group_sum.cuh). A
// candidate p counts if its id differs from the row's id, the JKR pair law
// lets it survive (nondimensional overlap d > break_d), and it is a fresh
// contact (dist^2 <= radius^2) or already in the row's partner list.
// Survivors add their force to the row's sum in the TPU kernel's grouping
// (group_sum.cuh `GroupSum3`, ops/neighbors.py `grouped_sum`) and are
// appended to the new partner list in the walk's order, the TPU kernel's;
// the list keeps the first K and the returned degree is the untruncated
// count (the bond-capacity overflow probe).
//
// What bounds it on the card: a row walks its candidates of 20 bytes each,
// all inside a few neighbouring bins (8.6 per live row at the 2D bench
// colony's density, 222 over nine runs in the 3D spheroid, chip_smoke.py's
// 100k and 99k states); the compulsory bytes are the rows' own 16-byte
// packs, ids, bounds and partner lists, so the kernel is bound by the
// instructions it issues per candidate and the load latency and L1/L2
// traffic of the walk, not by bytes or arithmetic. The TPU kernel DMA'd
// 128-aligned spans into VMEM and tested every lane of a span against
// every row of a block; on Hopper each thread walks only its own run slices
// (the rows of a CTA are neighbours in the sorted order, so their runs
// overlap and the reads hit L1). What the design does about the rest:
// - A candidate that the law certainly breaks is dropped before the law,
//   by one cut on its squared distance: on the general law (per-pair
//   radii, growth on; the kGeneral instantiation) against the row's reach
//   (jkr_pair.cuh `certainly_breaks`, which states the margin argument),
//   where the law asks a `powf` and two divisions of every candidate; on
//   the uniform law against one reach for all pairs (`uniform_cut2`), where
//   it asks XLA's rsqrt, a table load and two fused Newton steps.
//   A position load, the squared distance and the cut, with no id read.
//   Such a pair gives no force and no entry, bonded or not, and every other
//   candidate runs the law exactly as before, so the outputs are bit-equal
//   to the law asked of every candidate.
// - The sum's grouping costs a shift and a compare per kept candidate, a
//   window partial and a (chunk, run) total beside the row's sum, and a
//   first pass over the row's bounds that finds the chunks its runs reach
//   (one for most rows: then the walk is run by run, as before).
// - The break test comes next. The pair law decides from distance and
//   radii alone whether a pair survives, and a pair that breaks gives no
//   force and no entry, bonded or not; so only candidates that survive ask
//   whether they are eligible, and the membership test over the row's K
//   partner ids runs only for those beyond the search radius: the thin
//   shell of about jkr_break_band (0.31 um) past it. In 3D most of a row's
//   candidates lie beyond the radius (K = 24 there), so a membership test
//   ahead of the break test would set the kernel's time. Both tests must
//   pass, so their order changes no output, and the force sum runs in the
//   same walk order.
// - The CTA's rows are consecutive, so their partner lists are one
//   contiguous rows x K block: it is copied into shared memory with
//   coalesced asynchronous copies (cp.async), and the new lists are staged
//   there and written back as one coalesced block. Shared rows have an odd
//   pitch (K | 1), so the per-thread appends do not conflict on banks.
// - The candidates are read through L1. Staging each run's union of the
//   CTA's slices in shared memory (cp.async) was tried: it gave the same
//   output, was 3% faster in 2D and 7% slower at the 99k 3D state, where its
//   budget costs CTAs per SM (PERF.md section 6), so it was taken out.
//
// One thread per row rather than one warp per row: a row has 3 (2D) to 25
// (3D) candidates per run, too few to keep 32 lanes busy, and a thread per
// row keeps the first-K compaction a plain sequential append.
//
// Given `probes`, the kernel also reduces the substep's probes (widest run,
// widest row, largest degree; probes.cuh) from the bounds it reads and the
// degrees it writes, so that the scan launches nothing else to read them.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "group_sum.cuh"
#include "jkr_pair.cuh"
#include "probes.cuh"

namespace {

using hipsc::PairLaw;

// rows per CTA (ops/contact.py ROWS_PER_CTA)
constexpr int kThreads = 128;

// kGeneral: the general law (law.uniform == 0), with the cut before it
template <int N_RUNS, bool kGeneral>
__global__ void __launch_bounds__(kThreads) contact_substep_kernel(
    const float4* __restrict__ xyzr, const int* __restrict__ ids,
    const unsigned char* __restrict__ alive, const int* __restrict__ bounds,
    const int* __restrict__ partners, float* __restrict__ force,
    int* __restrict__ degree, int* __restrict__ new_partners, int C, int K,
    int pitch, PairLaw law, hipsc::Grouping grp, int* __restrict__ probes) {
  extern __shared__ int in_lists[];              // kThreads x pitch
  int* out_lists = in_lists + kThreads * pitch;  // kThreads x pitch
  const int t = threadIdx.x;
  const int row0 = blockIdx.x * kThreads;
  const int rows = min(kThreads, C - row0);
  const int row = row0 + t;

  // the CTA's partner block: rows * K contiguous ids, one shared row each
  const int n_ids = rows * K;
  const int* block_in = partners + (size_t)row0 * K;
  for (int e = t; e < n_ids; e += kThreads) {
    const int r = e / K;
    __pipeline_memcpy_async(in_lists + r * pitch + (e - r * K), block_in + e, 4);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  const int* in = in_lists + t * pitch;
  int* out = out_lists + t * pitch;
  hipsc::GroupSum3 sum;
  int count = 0;
  if (t < rows && alive[row]) {
    const float4 me = xyzr[row];
    const int my_id = ids[row];
    const float reach = kGeneral ? hipsc::cull_reach(law, me.w) : 0.f;
    const float cut2 = kGeneral ? 0.f : hipsc::uniform_cut2(law);
    const int* b = bounds + (size_t)row * 2 * N_RUNS;
    const int blk = hipsc::row_block(grp, row);
    // the chunks the row's runs reach
    int c_first = 0x7fffffff, c_last = -1;
    for (int r = 0; r < N_RUNS; ++r) {
      const int lo = b[2 * r], hi = b[2 * r + 1];
      if (hi <= lo) continue;
      const hipsc::RunLanes run(grp, r, blk, lo, hi);
      c_first = min(c_first, run.chunk_of(lo, grp.chunk_shift));
      c_last = max(c_last, run.chunk_of(hi - 1, grp.chunk_shift));
    }
    // chunk-major: each chunk's part of each run, a run's positions being
    // contiguous, so no candidate is visited twice
    for (int ch = c_first; ch <= c_last; ++ch) {
      for (int r = 0; r < N_RUNS; ++r) {
        const int lo = b[2 * r], hi = b[2 * r + 1];
        if (hi <= lo) continue;
        const hipsc::RunLanes run(grp, r, blk, lo, hi);
        const int end = run.begin(ch + 1, grp.chunk_shift);
        for (int p = run.begin(ch, grp.chunk_shift); p < end; ++p) {
          const float4 c = xyzr[p];
          const float dx = __fsub_rn(me.x, c.x);
          const float dy = __fsub_rn(me.y, c.y);
          const float dz = __fsub_rn(me.z, c.z);
          const float dist2 = hipsc::pair_dist2(dx, dy, dz);
          // the cut, then the id: a dropped candidate reads no id, and the
          // row itself (distance 0) is never dropped
          if (kGeneral ? hipsc::certainly_breaks(reach, c.w, dist2) : dist2 > cut2) continue;
          const int cid = ids[p];
          if (cid == my_id) continue;
          // the pair breaks: no force, no entry, whether bonded or not
          const hipsc::PairOverlap o = hipsc::jkr_overlap(law, me, c, dist2);
          if (!(o.d > law.break_d)) continue;
          bool eligible = dist2 <= law.radius2;
          for (int k = 0; k < K && !eligible; ++k) eligible = in[k] == cid;
          if (!eligible) continue;
          float tx, ty, tz;
          hipsc::jkr_force(law, o, dx, dy, dz, tx, ty, tz);
          sum.add(run.g_lo + (p - lo), tx, ty, tz);
          if (count < K) out[count] = cid;
          ++count;
        }
        sum.close();
      }
    }
  }
  if (t < rows) {
    for (int k = count < K ? count : K; k < K; ++k) out[k] = -1;
    force[(size_t)row * 3 + 0] = sum.x;
    force[(size_t)row * 3 + 1] = sum.y;
    force[(size_t)row * 3 + 2] = sum.z;
    degree[row] = count;
  }
  if (probes != nullptr)
    hipsc::reduce_probes<kThreads, N_RUNS>(bounds, row, t < rows && alive[row], count, probes);
  __syncthreads();
  int* block_out = new_partners + (size_t)row0 * K;
  for (int e = t; e < n_ids; e += kThreads) {
    const int r = e / K;
    block_out[e] = out_lists[r * pitch + (e - r * K)];
  }
}

}  // namespace

// `pitch` (odd, >= K) and `smem_bytes` are the shared-memory layout of
// ops/contact.py `contact_layout`; `probes` (3 ints, or null) the substep's
// probes, reduced into by atomicMax.
extern "C" int hipsc_contact_substep(
    const void* xyzr, const void* ids, const void* alive, const void* bounds,
    const void* partners, void* force, void* degree, void* new_partners, int C,
    int K, int n_runs, int pitch, int smem_bytes, float radius2, float break_d,
    int uniform, float two_r, float inv_scale, float fpre, float scale_c,
    const void* rsqrt_tab, const void* starts,
    const void* gpos, int nblocks, int chunk_shift, int block_shift, void* probes,
    void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  if (n_runs != 3 && n_runs != 9) return (int)cudaErrorInvalidValue;
  if (K < 1 || pitch < K) return (int)cudaErrorInvalidValue;
  if (nblocks < 1 || chunk_shift < 5 || chunk_shift > 30 || block_shift < 0 || block_shift > 30)
    return (int)cudaErrorInvalidValue;
  const hipsc::Grouping grp{(const int*)starts, (const int*)gpos, nblocks, chunk_shift,
                           block_shift};
  PairLaw law{radius2, break_d, uniform,   two_r,
              inv_scale, fpre, scale_c, (const int*)rsqrt_tab};
  auto kernel = n_runs == 3 ? (uniform ? contact_substep_kernel<3, false>
                                       : contact_substep_kernel<3, true>)
                            : (uniform ? contact_substep_kernel<9, false>
                                       : contact_substep_kernel<9, true>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(C + kThreads - 1) / kThreads, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const float4*)xyzr, (const int*)ids, (const unsigned char*)alive,
      (const int*)bounds, (const int*)partners, (float*)force, (int*)degree,
      (int*)new_partners, C, K, pitch, law, grp, (int*)probes);
  return (int)cudaGetLastError();
}

// The card's SM count and the most dynamic shared memory one block may ask
// for (after cudaFuncSetAttribute), for the wrappers' plans and checks.
extern "C" int hipsc_device_limits(int* n_sm, int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}

extern "C" const char* hipsc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
