// The span-mask contact substeps: seed, masked substep and mask compaction.
//
// Replaces, in hipsc_abm_tpu/ops/pallas_contact.py:
//   B2 `_contact_kernel_seed` via `contact_substep_ids_to_mask` (:697, :821)
//      -> contact_mask_kernel<true> (the seed);
//   B1 `_contact_kernel_mask` via `contact_substep_masked` (:481, :627)
//      -> contact_mask_kernel<false> (the masked substep);
//   B3 `_compact_mask_kernel` via `compact_mask_bonds` (:877, :966)
//      -> mask_compact_kernel.
//
// While the Verlet window is frozen (sort order and per-row run bounds
// unchanged between rebuilds), the bond set is a keep mask over each row's
// candidates instead of a (C, K) partner-id list. Candidate j of sorted row
// i is the j-th agent of the concatenation of its runs [lo_r, hi_r) (N_RUNS
// = 3 in 2D, 9 in 3D, a template parameter of every kernel here),
// in run order and ascending sorted position (the walk order of contact.cu,
// self included so that j is a pure function of the bounds). The mask holds
// bit (j & 31) of word (j >> 5) per row, stored word-major as W x C uint32
// words (element [w * C + i]) so that neighbouring threads, which own
// neighbouring rows, touch neighbouring words.
//
// What each computes, per sorted row (one thread per row, which owns the
// row's mask words, so the in-place update of the masked substep has no
// races):
// - seed: the contact.cu walk, with membership taken from the row's K
//   partner ids (tested only for candidates beyond the search radius); the
//   keep set is written as W fresh words, zero beyond the row's candidates.
//   Runs at the scan's entry and at every rebuild.
// - masked: the same walk, with membership taken from bit j of the mask;
//   the new keep set overwrites the words in place. Runs on every other
//   substep.
// - compact: walks the set bits in order (__ffs over each word), maps bit j
//   back to its sorted position through the run bounds, and writes the
//   first K partner ids, NO_BOND (-1) padded. Runs before each re-sort (ids
//   are the only bond form that survives one) and at the scan's exit.
// Force and degree (the untruncated keep count, the bond-capacity probe)
// are those of contact.cu's kernel for the same bond set.
//
// What bounds them on the card: bytes. A row reads its 16-byte pack, id,
// liveness and 8 bytes of bounds per run and writes 16 bytes of force and
// degree plus 4 bytes per mask word; its candidates are neighbours in the
// sorted order whose loads hit L1/L2, and the pair law is ~20 float32
// operations per kept pair, far below the card's float32 rate. The masked
// substep is where the design pays: membership is one bit test in a
// register instead of the seed's loop over K partner ids per candidate
// beyond the search radius, and no first-K compaction runs. In 3D, where
// most of a row's ~220 candidates lie beyond the search radius, that loop
// makes the seed ten times the masked substep's time (PERF.md). The TPU kernels
// DMA'd 128-aligned spans plus chunk-major int8 mask slabs into VMEM
// (~1.5 KB of mask per row); here each thread reads only its own run
// slices and 4 bytes per 32 candidates of mask. The words are read and
// written whole, coalesced across the warp.

#include <cuda_runtime.h>

#include "jkr_pair.cuh"

namespace {

using hipsc::PairLaw;

template <bool kSeed, int N_RUNS>
__global__ void contact_mask_kernel(
    const float4* __restrict__ xyzr, const int* __restrict__ ids,
    const unsigned char* __restrict__ alive, const int* __restrict__ bounds,
    const int* __restrict__ partners,  // seed: (C, K) partner ids
    const unsigned* in_mask,           // masked: (W, C) words, aliased with out_mask
    unsigned* out_mask,                // (W, C) words
    float* __restrict__ force, int* __restrict__ degree, int C, int K, int W,
    PairLaw law) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= C) return;

  float fx = 0.f, fy = 0.f, fz = 0.f;
  int count = 0;
  int j = 0;              // candidate index along the row's runs
  unsigned in_word = 0;   // masked: the current word of the old keep set
  unsigned out_word = 0;  // the current word of the new keep set
  if (alive[row]) {
    const float4 me = xyzr[row];
    const int my_id = ids[row];
    const int* my_partners = kSeed ? partners + (size_t)row * K : nullptr;
    for (int r = 0; r < N_RUNS; ++r) {
      const int lo = bounds[row * 2 * N_RUNS + 2 * r];
      const int hi = bounds[row * 2 * N_RUNS + 2 * r + 1];
      for (int p = lo; p < hi; ++p, ++j) {
        const int bit = j & 31;
        if (bit == 0) {
          if (j > 0) {  // the previous word is complete
            out_mask[(size_t)((j >> 5) - 1) * C + row] = out_word;
            out_word = 0;
          }
          if (!kSeed) in_word = in_mask[(size_t)(j >> 5) * C + row];
        }
        const int cid = ids[p];
        if (cid == my_id) continue;
        const float4 c = xyzr[p];
        const float dx = me.x - c.x;
        const float dy = me.y - c.y;
        const float dz = me.z - c.z;
        const float dist2 = dx * dx + dy * dy + dz * dz;
        bool eligible = dist2 <= law.radius2;
        if (kSeed) {
          for (int k = 0; k < K && !eligible; ++k) eligible = my_partners[k] == cid;
        } else {
          eligible = eligible || ((in_word >> bit) & 1u);
        }
        if (!eligible) continue;
        if (!hipsc::jkr_pair(law, me, c, dx, dy, dz, dist2, fx, fy, fz)) continue;
        out_word |= 1u << bit;
        ++count;
      }
    }
  }
  // the last (partial) word, then zeros up to W: a dead or short row leaves
  // no stale bits for a later masked substep or compaction to read
  int w = j > 0 ? ((j - 1) >> 5) : 0;
  out_mask[(size_t)w * C + row] = out_word;
  for (++w; w < W; ++w) out_mask[(size_t)w * C + row] = 0u;
  force[(size_t)row * 3 + 0] = fx;
  force[(size_t)row * 3 + 1] = fy;
  force[(size_t)row * 3 + 2] = fz;
  degree[row] = count;
}

template <int N_RUNS>
__global__ void mask_compact_kernel(const int* __restrict__ ids,
                                    const int* __restrict__ bounds,
                                    const unsigned* __restrict__ mask,
                                    int* __restrict__ out, int C, int K, int W) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= C) return;
  const int* b = bounds + row * 2 * N_RUNS;
  int* dst = out + (size_t)row * K;
  int count = 0;
  // bits come in ascending j, so the run holding bit j only moves forward:
  // run r spans candidates [first, first + width)
  int r = 0, first = 0, width = max(b[1] - b[0], 0);
  for (int w = 0; w < W && count < K; ++w) {
    unsigned bits = mask[(size_t)w * C + row];
    while (bits != 0u && count < K) {
      const int j = (w << 5) + (__ffs((int)bits) - 1);
      bits &= bits - 1u;
      while (j >= first + width && r + 1 < N_RUNS) {
        first += width;
        ++r;
        width = max(b[2 * r + 1] - b[2 * r], 0);
      }
      dst[count++] = ids[b[2 * r] + (j - first)];
    }
  }
  for (; count < K; ++count) dst[count] = -1;
}

constexpr int kThreads = 128;

int blocks_for(int C) { return (C + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int hipsc_contact_seed(
    const void* xyzr, const void* ids, const void* alive, const void* bounds,
    const void* partners, void* mask, void* force, void* degree, int C, int K,
    int W, int n_runs, float radius2, float break_d, int uniform, float two_r,
    float inv_scale, float fpre, float scale_c, float pi_f, float adhesion,
    void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  if (n_runs != 3 && n_runs != 9) return (int)cudaErrorInvalidValue;
  PairLaw law{radius2, break_d, uniform, two_r, inv_scale, fpre, scale_c, pi_f, adhesion};
  auto kernel = n_runs == 3 ? contact_mask_kernel<true, 3> : contact_mask_kernel<true, 9>;
  kernel<<<blocks_for(C), kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)xyzr, (const int*)ids, (const unsigned char*)alive,
      (const int*)bounds, (const int*)partners, nullptr, (unsigned*)mask,
      (float*)force, (int*)degree, C, K, W, law);
  return (int)cudaGetLastError();
}

extern "C" int hipsc_contact_masked(
    const void* xyzr, const void* ids, const void* alive, const void* bounds,
    void* mask, void* force, void* degree, int C, int W, int n_runs,
    float radius2, float break_d, int uniform, float two_r, float inv_scale,
    float fpre, float scale_c, float pi_f, float adhesion, void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  if (n_runs != 3 && n_runs != 9) return (int)cudaErrorInvalidValue;
  PairLaw law{radius2, break_d, uniform, two_r, inv_scale, fpre, scale_c, pi_f, adhesion};
  auto kernel = n_runs == 3 ? contact_mask_kernel<false, 3> : contact_mask_kernel<false, 9>;
  kernel<<<blocks_for(C), kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)xyzr, (const int*)ids, (const unsigned char*)alive,
      (const int*)bounds, nullptr, (const unsigned*)mask, (unsigned*)mask,
      (float*)force, (int*)degree, C, 0, W, law);
  return (int)cudaGetLastError();
}

extern "C" int hipsc_mask_compact(const void* ids, const void* bounds,
                                  const void* mask, void* out, int C, int K,
                                  int W, int n_runs, void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  if (n_runs != 3 && n_runs != 9) return (int)cudaErrorInvalidValue;
  auto kernel = n_runs == 3 ? mask_compact_kernel<3> : mask_compact_kernel<9>;
  kernel<<<blocks_for(C), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)ids, (const int*)bounds, (const unsigned*)mask, (int*)out, C,
      K, W);
  return (int)cudaGetLastError();
}
