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
//   partner ids; the keep set is written as W fresh words, zero beyond the
//   row's candidates. Runs at the scan's entry and at every rebuild.
// - masked: the same walk, with membership taken from bit j of the mask;
//   the new keep set overwrites the words in place. Runs on every other
//   substep.
// - compact: walks the set bits in order (__ffs over each word), maps bit j
//   back to its sorted position through the run bounds, and writes the
//   first K partner ids, NO_BOND (-1) padded. Runs before each re-sort (ids
//   are the only bond form that survives one) and at the scan's exit.
// Force and degree (the untruncated keep count, the bond-capacity probe)
// are those of contact.cu's kernel for the same bond set, the force summed
// in the TPU kernels' grouping (group_sum.cuh): the walk is chunk-major over
// the span lanes. Where a row's runs lie in one chunk (most rows) that is
// candidate order and each mask word is entered once; where they reach
// several, the walk revisits words, so it holds one word at a time and
// reads it back on entry (the seed having cleared the row's words first),
// which also keeps the masked substep's in-place update right: a word holds
// the new bits of the candidates visited and the old bits of the rest.
//
// The mask's width W is a static capacity (the engine's
// EngineConfig.mask_bits / 32), not the widest row of this window: no kernel
// here reads or writes a word at w >= W. A row with more than 32 W
// candidates still gets the force and degree of its whole walk, but the
// keep bits past the capacity are dropped (and read as 0); the engine
// probes the widest row of every build and re-executes the step with a
// grown capacity, so no kept result depends on a dropped bit.
//
// Each entry point takes `pred`, a device pointer to one int, or null: the
// kernel returns at once unless *pred != 0. The engine's scan decides on
// the device whether the window is stale and runs, on every substep after
// the first, the compaction and the seed under that flag and the masked
// substep under its negation: exactly one of the two substeps writes the
// force, degree and mask buffers they share, and no host read takes the
// decision (the JAX engine's lax.cond). Given `probes` as well, the substep
// that runs reduces the substep's probes (widest run, widest row, largest
// degree; probes.cuh) from the bounds it reads and the degrees it writes; a
// substep that returns under its predicate writes none.
//
// What bounds the compaction: its output. A row's K ids are mostly padding
// (a mean degree of 2.5 against K = 24 in the 3D spheroid, 8 in 2D), and
// written one int at a time at a stride of 4K bytes they cost a scattered
// store per id, each touching its own sector. The design: the block's rows
// are contiguous in the output, so the block fills a shared-memory tile of
// its rows with NO_BOND, each thread writes only its few ids into its row
// of the tile, and the block stores the tile with coalesced 16-byte stores.
// A row reads only the mask words that hold its candidates (the sum of its
// run widths, from the same int2 loads of its bounds that map bits to runs),
// not all W words of the widest row: none for a row with empty runs. With
// that it runs within 1.4x (2D) and 1.8x (3D) of the bytes it must move
// (PERF.md section 6); no other form was tried.
//
// What bounds the two substeps on the card: neither bytes nor arithmetic,
// but the instructions the walk issues per candidate. The compulsory bytes
// are a row's 16-byte pack, liveness, 8 bytes of bounds per run, 16 bytes of
// force and degree and 4 bytes per mask word (plus, for the seed, the K
// partner ids of a row where a candidate reaches its membership test); a
// row then visits its candidates (8.6 per live row in the 2D bench colony,
// 222 over nine runs in the 3D spheroid), neighbours in the sorted order
// whose loads hit L1, and the pair law runs only for the few that are kept.
// Each visit is a load, the squared distance, two tests and the mask-word
// bookkeeping, some twenty instructions. What the design does:
// - The self test is `p == row`: live ids are unique and a row dead at the
//   window's build has empty runs (ops/neighbors.py), so the only candidate
//   of a live row's runs that carries its id is the row itself. The walk
//   reads no ids: the masked substep never does, the seed only at its
//   membership test. The row itself (distance 0) passes every other test,
//   so the self test is asked only of the few pairs that do.
// - The walk streams positions only, loading the float4s of kAhead
//   candidates of a run before testing any of them (the tail re-reads the
//   run's last candidate), so each thread has several loads in flight
//   instead of one dependent load behind each test.
// - The seed drops a candidate that the law certainly breaks before the
//   law, by one cut on its squared distance, as contact.cu does: on the
//   general law (kGeneral) against the row's reach (jkr_pair.cuh
//   `certainly_breaks`, which states the margin argument), on the uniform
//   law against one reach for all pairs (`uniform_cut2`: that law asks
//   XLA's rsqrt of every candidate); the cut comes after the
//   candidate counter j and the mask-word bookkeeping, so bit positions do
//   not move, and a dropped pair sets no bit and adds no force, as the law
//   would have decided. Every other candidate runs the law as before, bit
//   for bit.
// - The seed tests the break first, as contact.cu does: a pair that breaks
//   gives no force and no bit, bonded or not, so the scan over the row's K
//   partner ids runs only for candidates that survive beyond the search
//   radius, the thin shell of about jkr_break_band (0.31 um) past it (a
//   fraction of a candidate per row, PERF.md). Asked first, for every
//   candidate beyond the radius (most of a row's candidates in 3D), that
//   scan set the seed's time. Both tests must pass, so their order changes
//   no output. The masked substep asks its mask bit first instead, a
//   register test that few candidates pass, so the law runs only on its
//   eligible pairs and it takes no cut.
// - The mask words are read and written whole, coalesced across the warp.
// Tried and dropped (PERF.md section 6): a row shared by G = 2, 4 or 8
// lanes of a warp, each lane taking every G-th candidate of a run and the
// row summing the kept forces in walk order through warp shuffles, was 1.8
// to 3.9 times slower in 3D (most likely because every lane repeats the
// per-chunk bookkeeping and the groups of one warp diverge); kAhead = 8 was
// within the run-to-run spread of 4; on the uniform law, a host-computed
// squared-distance cut through a second entry point took 22% off the 3D
// seed alone; the cut is now computed in the kernel from the law's
// constants, with no second entry point.
// The TPU kernels DMA'd 128-aligned spans plus chunk-major int8 mask slabs
// into VMEM (~1.5 KB of mask per row); here each thread reads only its own
// run slices and 4 bytes per 32 candidates of mask.

#include <cuda_runtime.h>

#include "group_sum.cuh"
#include "jkr_pair.cuh"
#include "probes.cuh"

namespace {

using hipsc::PairLaw;

constexpr int kThreads = 128;
// candidates of a run whose positions are loaded before the first is tested
constexpr int kAhead = 4;

// kGeneral (seed only): the general law (law.uniform == 0), with the cut
// before it
template <bool kSeed, int N_RUNS, bool kGeneral>
__global__ void __launch_bounds__(kThreads) contact_mask_kernel(
    const float4* __restrict__ xyzr, const int* __restrict__ ids,
    const unsigned char* __restrict__ alive, const int* __restrict__ bounds,
    const int* __restrict__ partners,  // seed: (C, K) partner ids
    unsigned* mask,                    // (W, C) words; masked: read and written in place
    float* __restrict__ force, int* __restrict__ degree, int C, int K, int W,
    PairLaw law, const int* __restrict__ pred, hipsc::Grouping grp,
    int* __restrict__ probes) {
  if (pred != nullptr && *pred == 0) return;  // the other branch runs
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  int count = 0;
  if (row < C) {
    hipsc::GroupSum3 sum;
    int n_words = 0;  // words holding the row's candidates
    if (alive[row]) {
      const float4 me = xyzr[row];
      const int* b = bounds + (size_t)row * 2 * N_RUNS;
      const int* my_partners = kSeed ? partners + (size_t)row * K : nullptr;
      const float reach = kGeneral ? hipsc::cull_reach(law, me.w) : 0.f;
      const float cut2 = kGeneral ? 0.f : hipsc::uniform_cut2(law);
      const int blk = hipsc::row_block(grp, row);
      // the chunks the row's runs reach, and its candidate count
      int c_first = 0x7fffffff, c_last = -1, n_cand = 0;
      for (int r = 0; r < N_RUNS; ++r) {
        const int lo = b[2 * r], hi = b[2 * r + 1];
        if (hi <= lo) continue;
        const hipsc::RunLanes run(grp, r, blk, lo, hi);
        c_first = min(c_first, run.chunk_of(lo, grp.chunk_shift));
        c_last = max(c_last, run.chunk_of(hi - 1, grp.chunk_shift));
        n_cand += hi - lo;
      }
      n_words = min((n_cand + 31) >> 5, W);
      // One chunk: the walk is in candidate order and every word is entered
      // once, in order. Several: the chunk-major walk revisits words, so the
      // seed clears the row's words first and every entered word is read.
      const bool in_order = c_first == c_last;
      if (kSeed && !in_order)
        for (int w = 0; w < n_words; ++w) mask[(size_t)w * C + row] = 0u;
      int cur_w = -1;     // the word held in `word`
      unsigned word = 0;  // the seed's new bits; masked: new bits where visited, old elsewhere
      for (int ch = c_first; ch <= c_last; ++ch) {
        int j_run = 0;  // the candidate index of the run's first position
        for (int r = 0; r < N_RUNS; ++r) {
          const int lo = b[2 * r], hi = b[2 * r + 1];
          if (hi <= lo) continue;
          const hipsc::RunLanes run(grp, r, blk, lo, hi);
          const int end = run.begin(ch + 1, grp.chunk_shift);
          for (int p0 = run.begin(ch, grp.chunk_shift); p0 < end; p0 += kAhead) {
            float4 cand[kAhead];
#pragma unroll
            for (int u = 0; u < kAhead; ++u) cand[u] = xyzr[min(p0 + u, end - 1)];
#pragma unroll
            for (int u = 0; u < kAhead; ++u) {
              const int p = p0 + u;
              if (p >= end) break;
              const int j = j_run + (p - lo);
              if ((j >> 5) != cur_w) {  // enter the word of j, writing back the one held
                if (cur_w >= 0 && cur_w < W) mask[(size_t)cur_w * C + row] = word;
                cur_w = j >> 5;
                word = (cur_w < W && !(kSeed && in_order)) ? mask[(size_t)cur_w * C + row] : 0u;
              }
              const unsigned bit = 1u << (j & 31);
              const float4 c = cand[u];
              const float dx = __fsub_rn(me.x, c.x);
              const float dy = __fsub_rn(me.y, c.y);
              const float dz = __fsub_rn(me.z, c.z);
              const float dist2 = hipsc::pair_dist2(dx, dy, dz);
              float tx, ty, tz;
              bool keep;
              if (kSeed) {
                // the pair breaks: no force, no bit, whether bonded or not
                if (kGeneral ? hipsc::certainly_breaks(reach, c.w, dist2) : dist2 > cut2) continue;
                const hipsc::PairOverlap o = hipsc::jkr_overlap(law, me, c, dist2);
                if (!(o.d > law.break_d)) continue;
                if (p == row) continue;  // the row itself passes both tests above
                keep = dist2 <= law.radius2;
                if (!keep) {
                  const int cid = ids[p];
                  for (int k = 0; k < K && !keep; ++k) keep = my_partners[k] == cid;
                }
                if (keep) hipsc::jkr_force(law, o, dx, dy, dz, tx, ty, tz);
              } else {
                keep = (dist2 <= law.radius2 || (word & bit)) && p != row &&
                       hipsc::jkr_pair(law, me, c, dx, dy, dz, dist2, tx, ty, tz);
                word &= ~bit;
              }
              if (keep) {
                word |= bit;
                sum.add(run.g_lo + (p - lo), tx, ty, tz);
                ++count;
              }
            }
          }
          sum.close();
          j_run += hi - lo;
        }
      }
      if (cur_w >= 0 && cur_w < W) mask[(size_t)cur_w * C + row] = word;
    }
    // zeros past the row's candidates: a dead or short row leaves no stale
    // bits for a later masked substep or compaction to read
    for (int w = n_words; w < W; ++w) mask[(size_t)w * C + row] = 0u;
    force[(size_t)row * 3 + 0] = sum.x;
    force[(size_t)row * 3 + 1] = sum.y;
    force[(size_t)row * 3 + 2] = sum.z;
    degree[row] = count;
  }
  if (probes != nullptr)
    hipsc::reduce_probes<kThreads, N_RUNS>(bounds, row, row < C && alive[row], count, probes);
}

// One thread per row, kThreads rows per block; the block's output rows are
// contiguous (kThreads x K ints) and are built in a shared-memory tile of
// that size (dynamic shared memory: 4 KB at K = 8, 64 KB at the engine's
// largest bond capacity, 128).
template <int N_RUNS>
__global__ void mask_compact_kernel(const int* __restrict__ ids,
                                    const int2* __restrict__ bounds,
                                    const unsigned* __restrict__ mask,
                                    int* __restrict__ out, int C, int K, int W,
                                    const int* __restrict__ pred) {
  if (pred != nullptr && *pred == 0) return;  // the whole grid returns, no barrier waits
  extern __shared__ int4 tile4[];
  int* tile = reinterpret_cast<int*>(tile4);
  const int first_row = blockIdx.x * blockDim.x;
  const int tile_ints = min((int)blockDim.x, C - first_row) * K;
  for (int i = threadIdx.x; i < (tile_ints + 3) >> 2; i += blockDim.x)
    tile4[i] = make_int4(-1, -1, -1, -1);  // NO_BOND
  __syncthreads();

  const int row = first_row + threadIdx.x;
  if (row < C) {
    int2 b[N_RUNS];
    int n_cand = 0;
#pragma unroll
    for (int r = 0; r < N_RUNS; ++r) {
      b[r] = bounds[(size_t)row * N_RUNS + r];
      n_cand += max(b[r].y - b[r].x, 0);
    }
    // bits past a row's candidates are zero: read only the words that hold
    // its candidates (none for a row with empty runs)
    const int n_words = min((n_cand + 31) >> 5, W);
    int* dst = tile + threadIdx.x * K;
    int count = 0;
    // bits come in ascending j, so the run holding bit j only moves forward:
    // run r spans candidates [first, first + width) from sorted position lo
    int r = 0, first = 0, lo = b[0].x, width = max(b[0].y - b[0].x, 0);
    for (int w = 0; w < n_words && count < K; ++w) {
      unsigned bits = mask[(size_t)w * C + row];
      while (bits != 0u && count < K) {
        const int j = (w << 5) + (__ffs((int)bits) - 1);
        bits &= bits - 1u;
        while (j >= first + width && r + 1 < N_RUNS) {
          first += width;
          ++r;
#pragma unroll
          for (int q = 1; q < N_RUNS; ++q) {  // b[r] without indexing b by a variable
            if (q == r) {
              lo = b[q].x;
              width = max(b[q].y - b[q].x, 0);
            }
          }
        }
        dst[count++] = ids[lo + (j - first)];
      }
    }
  }
  __syncthreads();
  // the tile out with coalesced 16-byte stores (blockDim and so the tile's
  // offset are multiples of 4 ints), then the tail of a last partial block
  int* dst = out + (size_t)first_row * K;
  const int n4 = tile_ints >> 2;
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    reinterpret_cast<int4*>(dst)[i] = tile4[i];
  for (int i = 4 * n4 + threadIdx.x; i < tile_ints; i += blockDim.x) dst[i] = tile[i];
}

int blocks_for(int C) { return (C + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int hipsc_contact_seed(
    const void* xyzr, const void* ids, const void* alive, const void* bounds,
    const void* partners, void* mask, void* force, void* degree, int C, int K,
    int W, int n_runs, float radius2, float break_d, int uniform, float two_r,
    float inv_scale, float fpre, float scale_c,
    const void* rsqrt_tab, const void* pred, const void* starts, const void* gpos,
    int nblocks, int chunk_shift, int block_shift, void* probes, void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  if ((n_runs != 3 && n_runs != 9) || W < 1) return (int)cudaErrorInvalidValue;
  if (nblocks < 1 || chunk_shift < 5 || chunk_shift > 30 || block_shift < 0 || block_shift > 30)
    return (int)cudaErrorInvalidValue;
  PairLaw law{radius2, break_d, uniform,   two_r,
              inv_scale, fpre, scale_c, (const int*)rsqrt_tab};
  const hipsc::Grouping grp{(const int*)starts, (const int*)gpos, nblocks, chunk_shift,
                           block_shift};
  auto kernel = n_runs == 3 ? (uniform ? contact_mask_kernel<true, 3, false>
                                       : contact_mask_kernel<true, 3, true>)
                            : (uniform ? contact_mask_kernel<true, 9, false>
                                       : contact_mask_kernel<true, 9, true>);
  kernel<<<blocks_for(C), kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)xyzr, (const int*)ids, (const unsigned char*)alive,
      (const int*)bounds, (const int*)partners, (unsigned*)mask,
      (float*)force, (int*)degree, C, K, W, law, (const int*)pred, grp, (int*)probes);
  return (int)cudaGetLastError();
}

extern "C" int hipsc_contact_masked(
    const void* xyzr, const void* alive, const void* bounds, void* mask,
    void* force, void* degree, int C, int W, int n_runs, float radius2,
    float break_d, int uniform, float two_r, float inv_scale, float fpre,
    float scale_c, const void* rsqrt_tab, const void* pred,
    const void* starts, const void* gpos, int nblocks, int chunk_shift, int block_shift,
    void* probes, void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  if ((n_runs != 3 && n_runs != 9) || W < 1) return (int)cudaErrorInvalidValue;
  if (nblocks < 1 || chunk_shift < 5 || chunk_shift > 30 || block_shift < 0 || block_shift > 30)
    return (int)cudaErrorInvalidValue;
  PairLaw law{radius2, break_d, uniform,   two_r,
              inv_scale, fpre, scale_c, (const int*)rsqrt_tab};
  const hipsc::Grouping grp{(const int*)starts, (const int*)gpos, nblocks, chunk_shift,
                           block_shift};
  auto kernel = n_runs == 3 ? contact_mask_kernel<false, 3, false>
                            : contact_mask_kernel<false, 9, false>;
  kernel<<<blocks_for(C), kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)xyzr, nullptr, (const unsigned char*)alive,
      (const int*)bounds, nullptr, (unsigned*)mask,
      (float*)force, (int*)degree, C, 0, W, law, (const int*)pred, grp, (int*)probes);
  return (int)cudaGetLastError();
}

extern "C" int hipsc_mask_compact(const void* ids, const void* bounds,
                                  const void* mask, void* out, int C, int K,
                                  int W, int n_runs, const void* pred, void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  if ((n_runs != 3 && n_runs != 9) || K < 1 || W < 1) return (int)cudaErrorInvalidValue;
  auto kernel = n_runs == 3 ? mask_compact_kernel<3> : mask_compact_kernel<9>;
  // the tile may pass the 48 KB a block gets without opting in (K > 96)
  const int tile_bytes = kThreads * K * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tile_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks_for(C), kThreads, tile_bytes, (cudaStream_t)stream>>>(
      (const int*)ids, (const int2*)bounds, (const unsigned*)mask, (int*)out, C,
      K, W, (const int*)pred);
  return (int)cudaGetLastError();
}
