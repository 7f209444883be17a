// The FGF4 deposit's sum onto the morphogen lattice, in a fixed order.
//
// Not a port of a TPU kernel: the JAX package's deposit is XLA
// (hipsc_abm_tpu/ops/diffusion.py `deposit_morphogen`, a scatter-add). On
// the card PyTorch's `index_add` adds float32 with atomics in no fixed
// order, so the lattice changed in its low bits from run to run, and with
// field coupling on it feeds the pathway's integer update. The plain
// version is hipsc_abm_tpu_torch/ops/diffusion.py `scatter_add_plain`, the
// CPU's sequential `index_add`.
//
// What it computes: the CPU's `index_add` on a 1-D tensor adds the sources
// in flat order, so point p ends as lattice[p] + c_0 + c_1 + ..., left to
// right, where c_0, c_1, ... are p's contributions in the order of their
// flat index (slot, corner). The caller sorts the point indices stably
// (`torch.sort(stable=True)`, deterministic on the card), so each point's
// contributions lie together in that order. One thread per sorted entry; the
// first entry of each point's run adds the run serially into the point,
// starting from the lattice's value; every other thread returns. Points
// without contributions keep the lattice's value (the caller passes a
// copy). Entries at or past `n_points` (the sentinel of agents out of
// range) are dropped. The adds are __fadd_rn, so nvcc cannot contract them
// and every point is bit-equal to the sequential `index_add`.
//
// What bounds it on the card: the bytes of the sorted indices, the order,
// the contributions and one read and one write of each point touched; a
// point holds a few contributions at the colony's density, so a run's
// serial walk is short.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) deposit_sorted_kernel(
    const int* __restrict__ sorted_idx, const int64_t* __restrict__ order,
    const float* __restrict__ contrib, float* __restrict__ lattice, long long n,
    int n_points) {
  const long long j = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (j >= n) return;
  const int p = sorted_idx[j];
  if (p < 0 || p >= n_points) return;
  if (j > 0 && sorted_idx[j - 1] == p) return;  // not the first of its run
  float acc = lattice[p];
  for (long long t = j; t < n && sorted_idx[t] == p; ++t)
    acc = __fadd_rn(acc, contrib[order[t]]);
  lattice[p] = acc;
}

}  // namespace

// `sorted_idx`: (n,) int32 point indices sorted stably; `order`: (n,) int64,
// the position of each sorted entry in `contrib` ((n,) float32); `lattice`:
// (n_points,) float32, updated in place.
extern "C" int hipsc_deposit(const void* sorted_idx, const void* order,
                             const void* contrib, void* lattice, long long n,
                             int n_points, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n_points < 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  deposit_sorted_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)sorted_idx, (const int64_t*)order, (const float*)contrib,
      (float*)lattice, n, n_points);
  return (int)cudaGetLastError();
}
