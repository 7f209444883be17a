// Radius-15 neighbourhood moments for the biology phases.
//
// Replaces: hipsc_abm_tpu/ops/pallas_bio.py `_bio_kernel` via
// `bio_reduce_pallas` (B4), in both of its forms (3 runs in 2D, 9 runs in
// 3D); the plain twin is hipsc_abm_tpu/engine.py `make_bio_moments_xla`.
//
// What it computes, per sorted row i: walk the row's build-time stencil runs
// [lo_r, hi_r) (sorted positions, ascending; N_RUNS = 3 in 2D, 9 in 3D). A
// candidate p counts if p != i, p and i are both alive now, and
// |pos0_p - pos0_i|^2 <= radius^2 on the build-time positions. Output lanes
// (16 floats per row):
//   0 count, 1 sum f0, 2 sum f0^2,
//   3 count(f1 > f0), 4-6 sum of (loc1_p - loc1_i) over those,
//   7 count(f2 != 0), 8-10 sum of (loc1_p - loc1_i) over those, 11-15 zero
//   (lanes 6 and 10, the z sums, are zero in 2D).
// `mode` trims the work to the lanes a phase reads: 0 count, 1 pathway
// (lanes 0-2), 2 motility (lanes 0 and 3-10), 3 full.
//
// Inputs. The kernel reads what the step already holds: the build-time
// positions as float4 rows (x, y, z, 0; made once per step), the current
// liveness (1 byte per row), the run bounds as int2 pairs, and, only in the
// modes that use them, the current positions (C, 3) and the features as the
// engine's int32 columns (converted to float32 as the plain version does).
// Liveness replaces the build-time bin ids the caller used to re-sentinel
// before every call: run_bounds gives a row dead at the build empty runs,
// so every candidate inside a run was alive at the build, and "alive now"
// is exactly "live bin id and not killed since". A daughter born since the
// build is alive now but has empty runs, so it counts nobody and nobody
// counts it, as before. No pack and no re-sentineled copy is built per call.
//
// What bounds it on the card: a row's candidates lie in a few neighbouring
// bins (3.8 per live row at the 2D bench colony's density, 52 over the 27
// bins of the 3D spheroid, chip_smoke.py's 100k and 99k states), neighbours
// in the sorted order whose loads hit L1: the latency of the loads and the
// instructions issued per candidate, not bytes or arithmetic. The bytes it
// must move are, per live row, its build-time and current positions,
// liveness, bounds, three features and the 11 lanes that are not always
// zero, and per dead row its liveness and those lanes; the kernel runs at a
// few times that bound in 2D and several times it in 3D (PERF.md section 6
// gives the multiples), most of the 3D excess in the motility mode's loads
// per neighbour (7.8 per live row: three feature columns and the current
// position, each a load of its own), which take the 3D motility pass to
// 1.8x the count pass. What the design does:
// - each row's bounds come in as N_RUNS int2 loads, all issued before the
//   walk, not two dependent scalar loads at the start of every run;
// - the walk loads the positions and liveness of kAhead candidates of a
//   run before testing any of them (the tail re-reads the run's last
//   candidate), so a thread has several loads in flight instead of one
//   dependent chain per candidate; the features and current positions are
//   loaded only for the candidates within the radius, all at once;
// - the block's rows (contiguous in the output) are staged in shared
//   memory and written with one coalesced pass of float4 stores (in 2D 15%
//   faster than four float4 stores per thread at a 64-byte stride, in 3D
//   the same).
// The squared distance is XLA:CPU's in the TPU kernel, fma(dz, dz, fma(dx,
// dx, dy dy)) (the library is built with --fmad=false, so the only FMAs are
// the __fmaf_rn written), and the displacement lanes add their terms in the
// TPU kernel's grouping: the walk is chunk-major over the span lanes, each
// (chunk, run) summed in 32-lane windows of the colony's sorted order
// (group_sum.cuh); the counts and feature sums are integers, exact in any
// order. The plain version (ops/bio_moments.py) does both the same way, bit
// for bit.
// Tried and dropped (PERF.md section 6, each bit-equal): 8 candidates ahead
// (3D 30-50% slower, 2D 5%); the chunk's neighbours found first and their
// feature loads issued together (3D 10-30% slower, 2D 8-15%); each run's
// bounds loaded at its start (within the spread).
// The TPU kernel DMA'd 128-aligned spans of the sorted pack into VMEM per
// block of rows; here each thread reads only its own run slices.

#include <cuda_runtime.h>

#include "group_sum.cuh"

namespace {

constexpr int kThreads = 128;
// candidates of a run whose positions are loaded before the first is tested
constexpr int kAhead = 4;

template <int N_RUNS>
__global__ void __launch_bounds__(kThreads) bio_moments_kernel(
    const float4* __restrict__ pos0, const unsigned char* __restrict__ alive,
    const int2* __restrict__ bounds, const float* __restrict__ loc1,
    const int* __restrict__ f0, const int* __restrict__ f1,
    const int* __restrict__ f2, float4* __restrict__ out, int C, float radius2,
    int mode, hipsc::Grouping grp) {
  constexpr bool k3D = N_RUNS == 9;
  __shared__ float4 stage[kThreads * 4];  // the block's rows, 16 lanes each
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const bool want_f0 = mode == 1 || mode == 3;
  const bool want_disp = mode == 2 || mode == 3;

  float count = 0.f, sf0 = 0.f, sf0sq = 0.f, ca = 0.f, cb = 0.f;
  hipsc::GroupSum3 sa, sb;  // the displacement sums, in the TPU kernel's grouping
  if (row < C && alive[row]) {
    int2 b[N_RUNS];
#pragma unroll
    for (int r = 0; r < N_RUNS; ++r) b[r] = bounds[(size_t)row * N_RUNS + r];
    const float4 me = pos0[row];
    float mx = 0.f, my = 0.f, mz = 0.f;  // the row's current position
    if (want_disp) {
      mx = loc1[3 * (size_t)row];
      my = loc1[3 * (size_t)row + 1];
      if (k3D) mz = loc1[3 * (size_t)row + 2];
    }
    const int blk = hipsc::row_block(grp, row);
    // the chunks the row's runs reach
    int c_first = 0x7fffffff, c_last = -1;
#pragma unroll
    for (int r = 0; r < N_RUNS; ++r) {
      if (b[r].y <= b[r].x) continue;
      const hipsc::RunLanes run(grp, r, blk, b[r].x, b[r].y);
      c_first = min(c_first, run.chunk_of(b[r].x, grp.chunk_shift));
      c_last = max(c_last, run.chunk_of(b[r].y - 1, grp.chunk_shift));
    }
    // chunk-major: each chunk's part of each run
    for (int ch = c_first; ch <= c_last; ++ch) {
#pragma unroll
      for (int r = 0; r < N_RUNS; ++r) {
        if (b[r].y <= b[r].x) continue;
        const hipsc::RunLanes run(grp, r, blk, b[r].x, b[r].y);
        const int hi = run.begin(ch + 1, grp.chunk_shift);
        for (int p0 = run.begin(ch, grp.chunk_shift); p0 < hi; p0 += kAhead) {
          float4 c[kAhead];
          unsigned char live[kAhead];
#pragma unroll
          for (int u = 0; u < kAhead; ++u) {
            const int q = min(p0 + u, hi - 1);
            c[u] = pos0[q];
            live[u] = alive[q];
          }
#pragma unroll
          for (int u = 0; u < kAhead; ++u) {
            const int p = p0 + u;
            if (p >= hi) break;
            if (p == row || !live[u]) continue;
            // XLA:CPU's squared distance in the TPU kernel: the first
            // product fused into the sum, fma(dz, dz, fma(dx, dx, dy dy))
            const float dx0 = __fsub_rn(c[u].x, me.x);
            const float dy0 = __fsub_rn(c[u].y, me.y);
            float dist2 = __fmaf_rn(dx0, dx0, __fmul_rn(dy0, dy0));
            if (k3D) {
              const float dz0 = __fsub_rn(c[u].z, me.z);
              dist2 = __fmaf_rn(dz0, dz0, dist2);
            }
            if (dist2 > radius2) continue;
            count += 1.f;
            if (!(want_f0 || want_disp)) continue;
            const float g0 = (float)f0[p];
            if (want_f0) {
              sf0 += g0;
              sf0sq += g0 * g0;
            }
            if (want_disp) {
              const float g1 = (float)f1[p];
              const float g2 = (float)f2[p];
              const float ddx = loc1[3 * (size_t)p] - mx;
              const float ddy = loc1[3 * (size_t)p + 1] - my;
              const float ddz = k3D ? loc1[3 * (size_t)p + 2] - mz : 0.f;
              const int g = run.g_lo + (p - run.lo);
              if (g1 > g0) {
                ca += 1.f;
                sa.add(g, ddx, ddy, ddz);
              }
              if (g2 != 0.f) {
                cb += 1.f;
                sb.add(g, ddx, ddy, ddz);
              }
            }
          }
        }
        sa.close();
        sb.close();
      }
    }
  }
  float4* o = stage + 4 * threadIdx.x;
  o[0] = make_float4(count, sf0, sf0sq, ca);
  o[1] = make_float4(sa.x, sa.y, sa.z, cb);
  o[2] = make_float4(sb.x, sb.y, sb.z, 0.f);
  o[3] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  // the block's rows are contiguous in out: one coalesced pass of float4s
  const int first = blockIdx.x * blockDim.x;
  const int n = 4 * min((int)blockDim.x, C - first);
  float4* dst = out + 4 * (size_t)first;
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = stage[i];
}

}  // namespace

extern "C" int hipsc_bio_moments(const void* pos0, const void* alive,
                                 const void* bounds, const void* loc1,
                                 const void* f0, const void* f1, const void* f2,
                                 void* out, int C, float radius2, int mode,
                                 int n_runs, const void* starts, const void* gpos,
                                 int nblocks, int chunk_shift, int block_shift, void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  if (n_runs != 3 && n_runs != 9) return (int)cudaErrorInvalidValue;
  if (nblocks < 1 || chunk_shift < 5 || chunk_shift > 30 || block_shift < 0 || block_shift > 30)
    return (int)cudaErrorInvalidValue;
  const hipsc::Grouping grp{(const int*)starts, (const int*)gpos, nblocks, chunk_shift,
                           block_shift};
  const int blocks = (C + kThreads - 1) / kThreads;
  auto kernel = n_runs == 3 ? bio_moments_kernel<3> : bio_moments_kernel<9>;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)pos0, (const unsigned char*)alive, (const int2*)bounds,
      (const float*)loc1, (const int*)f0, (const int*)f1, (const int*)f2,
      (float4*)out, C, radius2, mode, grp);
  return (int)cudaGetLastError();
}
