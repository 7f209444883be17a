// The contact substep's window and degree probes, reduced by the kernels
// that walk the window (contact.cu, contact_mask.cu).
//
// Of a substep the scan probes the widest stencil run (max over rows and
// runs of max(hi - lo, 0)), the widest row (max over rows of the summed
// widths of its runs) and the largest untruncated degree. The kernels read
// each row's bounds and count its degree, so each CTA reduces the three
// with warp reductions and one atomicMax per probe into the substep's
// scratch row (ops/integrate.py `contact_probes`: three int32 words, zero
// before the substep), as update.cu reduces its maxima. The values are
// non-negative integers, so the maxima do not depend on the order of the
// CTAs. Dead rows have empty runs and degree 0, so a kernel that skips them
// reduces the same maxima as the whole table would give.
#pragma once

#include <cuda_runtime.h>

namespace hipsc {

// Every thread of the CTA calls it. `live`: the thread has a live row
// `row`, whose run bounds (N_RUNS pairs of a (C, 2 N_RUNS) table) it reads
// again here, after its walk, so that the walk holds no more registers than
// without the probes (a reduction carried through the walk made the
// span-mask kernels spill more); `degree` its degree (0 without a row).
// kThreads is the CTA's size, a multiple of 32.
template <int kThreads, int N_RUNS>
__device__ __forceinline__ void reduce_probes(const int* __restrict__ bounds, int row,
                                              bool live, int degree,
                                              int* __restrict__ probes) {
  int run = 0, cands = 0;
  if (live) {
    const int2* b = reinterpret_cast<const int2*>(bounds) + (size_t)row * N_RUNS;
#pragma unroll
    for (int r = 0; r < N_RUNS; ++r) {
      const int2 lohi = b[r];
      const int width = max(lohi.y - lohi.x, 0);
      run = max(run, width);
      cands += width;
    }
  }
  __shared__ int part[3][kThreads / 32];
  run = __reduce_max_sync(0xffffffffu, run);
  cands = __reduce_max_sync(0xffffffffu, cands);
  degree = __reduce_max_sync(0xffffffffu, degree);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    part[0][warp] = run;
    part[1][warp] = cands;
    part[2][warp] = degree;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    int v = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) v = max(v, part[threadIdx.x][w]);
    if (v > 0) atomicMax(probes + threadIdx.x, v);
  }
}

}  // namespace hipsc
