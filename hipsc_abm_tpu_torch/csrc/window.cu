// The contact window's rebuild inside a scan, predicated by the drift flag.
//
// Replaces no TPU kernel. The JAX engine takes the rebuild under lax.cond,
// so XLA runs its sort, run bounds and gathers only on the substeps whose
// drift test fires. A CUDA graph cannot branch, and the card's torch has
// no conditional graph node, so the port's PyTorch rebuild
// (engine._rebuild_where) computed the whole window on each of the 10
// later substeps of a step and selected it with torch.where: ~65 graph
// nodes a substep (an int64 radix sort of every capacity row, a
// searchsorted bin table, seven row gathers, the selects) for a result kept
// on 1.1-1.3 substeps a step. These kernels read the flag `stale` (the
// update kernel's byte, update.cu) from device memory and return at once
// when it is false; when it is true they write the rebuilt window into the
// scan's own buffers, in place, bit for bit what _rebuild_where selects.
//
// What the design rests on (held by tests/test_torch_window.py on the CPU
// at every rebuild of real scans): `alive` does not change during a scan,
// and the entry build sorted the rows dead there last, in key order
// (sentinel, id, position). So a stable re-sort leaves that tail where it
// is, and the rebuild only permutes the live prefix [0, n_live), into
// build_grid's (flat bin, id) order. Dead rows' bounds [C, 0) and the span
// starts of blocks whose first row is dead do not change either, and dead
// rows do not move (the update keeps them), so the drift reference's tail
// is already their locations. Only the live rows are binned, placed and
// moved.
//
// The launches, each grid-stride over a few waves of the SMs (a skipped
// launch costs its launch and not a grid of early exits):
//   1. count: each live row's flat bin, as neighbors._bin_coords and
//      _flat_from_coords compute it (floor(loc * recip(cell)) + 1, clamped;
//      the library is built with --fmad=false), and its arrival in its bin
//      (an atomic add into `counts`, which the scan kernel leaves zero).
//      Skipped, it carries the span probe's slot forward.
//   2. tile sums of the counts, kTile bins a tile.
//   3. scan: the exclusive prefix of the counts (neighbors._bin_table's
//      table, without the searchsorted), each tile offset by the sum of
//      the tiles before it; the counts are zeroed as they are read.
//   4. scatter: each live row's key (id, row) into its bin's slots at its
//      arrival.
//   5. place: a row's position is its bin's start plus the number of keys
//      of its bin below its own: build_grid's stable order by id within a
//      bin, whatever the arrival order and the bin's occupancy (a row reads
//      its bin's keys, ~1 in the 2D template colony). The row goes to the
//      scratch at its position, with `ref` (the new drift reference, a
//      buffer of its own), its run bounds from the table (run_bounds) and,
//      for the first row of a block, the block's span starts
//      (block_starts: rounded down to `align`, clipped at max_start).
//   6. write back: the scratch rows over the live prefix of the scan's
//      rows, with their packed (x, y, z, r) rows where the scan carries them
//      (`xyzr`, which the update kernel keeps for the contact launches), and
//      the span probe (block_span_needed) by an atomic max.
//
// What bounds it on the card, taken: bytes, ~0.35 KB a live row over the six
// launches (the rows' 72 bytes at K = 8 read, scattered, read and written
// back; bounds, keys, bins) plus 12 bytes a bin for the table, ~0.2 GB at
// 550k rows, ~60 us at 3.35 TB/s. Skipped: six launches that return.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                    // bins a thread scans
constexpr int kTile = kThreads * kItems;     // bins a scan tile

struct Bins {
  float inv;  // float32 reciprocal of the bin size
  int nx, ny, nz, two_d, num_bins;
};

__device__ __forceinline__ int flat_bin(const float* __restrict__ loc, int i, const Bins& g) {
  const int n[3] = {g.nx, g.ny, g.nz};
  int c[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    long long q = (long long)floorf(__fmul_rn(loc[3 * i + d], g.inv)) + 1;
    q = q < 0 ? 0 : q;
    q = q > n[d] - 1 ? n[d] - 1 : q;
    c[d] = (int)q;
  }
  return g.two_d ? c[0] * g.ny + c[1] : (c[0] * g.ny + c[1]) * g.nz + c[2];
}

// The block's sum (or max) of one int a thread, returned to every thread.
template <bool MAX>
__device__ __forceinline__ int block_reduce(int v, int* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int w = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? max(v, w) : v + w;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // smem may still be read from the previous call
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = lane < kThreads / 32 ? smem[lane] : (MAX ? INT_MIN : 0);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int w = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? max(v, w) : v + w;
  }
  return v;
}

// The block's exclusive prefix of one int a thread.
__device__ __forceinline__ int block_exclusive(int v, int* smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int w = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += w;
  }
  __syncthreads();
  if (lane == 31) smem[warp] = inc;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += smem[w];
  return before + inc - v;
}

__global__ void __launch_bounds__(kThreads) count_kernel(
    const unsigned char* __restrict__ stale, const float* __restrict__ loc,
    const unsigned char* __restrict__ alive, int C, Bins g, int* __restrict__ bin,
    int* __restrict__ arrival, int* __restrict__ counts, const int* __restrict__ needed_prev,
    int* __restrict__ needed) {
  const bool first = blockIdx.x == 0 && threadIdx.x == 0;
  if (*stale == 0) {
    if (first) *needed = *needed_prev;  // the held window's probe
    return;
  }
  if (first) *needed = 0;  // the write-back's atomic max starts from 0
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < C; i += gridDim.x * kThreads) {
    if (!alive[i]) continue;
    const int b = flat_bin(loc, i, g);
    bin[i] = b;
    arrival[i] = atomicAdd(counts + b, 1);
  }
}

__global__ void __launch_bounds__(kThreads) tile_sum_kernel(
    const unsigned char* __restrict__ stale, const int* __restrict__ counts, int num_bins,
    int* __restrict__ tile_sums, int n_tiles) {
  if (*stale == 0) return;
  __shared__ int smem[kThreads / 32];
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    int sum = 0;
    for (int k = threadIdx.x; k < kTile; k += kThreads) {
      const int b = t * kTile + k;
      if (b < num_bins) sum += counts[b];
    }
    sum = block_reduce<false>(sum, smem);
    if (threadIdx.x == 0) tile_sums[t] = sum;
  }
}

__global__ void __launch_bounds__(kThreads) scan_kernel(
    const unsigned char* __restrict__ stale, int* __restrict__ counts, int num_bins,
    const int* __restrict__ tile_sums, int n_tiles, int* __restrict__ table) {
  if (*stale == 0) return;
  __shared__ int smem[kThreads / 32];
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    int part = 0;
    for (int k = threadIdx.x; k < t; k += kThreads) part += tile_sums[k];
    const int offset = block_reduce<false>(part, smem);
    const int base = t * kTile + threadIdx.x * kItems;
    int v[kItems], local = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int b = base + j;
      v[j] = b < num_bins ? counts[b] : 0;
      if (b < num_bins) counts[b] = 0;  // clean for the next rebuild
      local += v[j];
    }
    int run = offset + block_exclusive(local, smem);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int b = base + j;
      if (b < num_bins) table[b] = run;
      run += v[j];
    }
    if (t == n_tiles - 1 && threadIdx.x == kThreads - 1) table[num_bins] = run;  // n_live
  }
}

__global__ void __launch_bounds__(kThreads) scatter_kernel(
    const unsigned char* __restrict__ stale, const unsigned char* __restrict__ alive, int C,
    const int* __restrict__ bin, const int* __restrict__ arrival, const int* __restrict__ table,
    const int* __restrict__ ids, unsigned long long* __restrict__ slot_key) {
  if (*stale == 0) return;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < C; i += gridDim.x * kThreads) {
    if (!alive[i]) continue;
    slot_key[table[bin[i]] + arrival[i]] =
        ((unsigned long long)(unsigned)ids[i] << 32) | (unsigned)i;
  }
}

struct Rows {
  float* loc;
  float* rad;
  float* mot;
  int* ids;
  int* partners;
  long long* perm;
};

struct Window {
  int* bounds;   // (C, 2 * N_RUNS)
  int* starts;   // (N_RUNS, nblocks)
  int nblocks, block_shift, align, max_start;
};

template <int N_RUNS>
__device__ __forceinline__ int run_first(int r, const Bins& g) {
  // the run's first flat bin relative to the row's (neighbors._run_index)
  return N_RUNS == 3 ? (r - 1) * g.ny - 1
                     : ((r / 3 - 1) * g.ny + (r % 3 - 1)) * g.nz - 1;
}

template <int N_RUNS>
__global__ void __launch_bounds__(kThreads) place_kernel(
    const unsigned char* __restrict__ stale, const unsigned char* __restrict__ alive, int C,
    int K, Bins g, const int* __restrict__ bin, const int* __restrict__ table,
    const unsigned long long* __restrict__ slot_key, Rows rows, Rows out,
    float* __restrict__ ref, Window win) {
  if (*stale == 0) return;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < C; i += gridDim.x * kThreads) {
    if (!alive[i]) continue;
    const int b = bin[i];
    const int lo = table[b], hi = table[b + 1];
    const unsigned long long key = ((unsigned long long)(unsigned)rows.ids[i] << 32) | (unsigned)i;
    int p = lo;
    for (int k = lo; k < hi; ++k) p += slot_key[k] < key;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float l = rows.loc[3 * i + d];
      out.loc[3 * p + d] = l;
      ref[3 * p + d] = l;
      out.mot[3 * p + d] = rows.mot[3 * i + d];
    }
    out.rad[p] = rows.rad[i];
    out.ids[p] = rows.ids[i];
    out.perm[p] = rows.perm[i];
    for (int k = 0; k < K; ++k) out.partners[(size_t)p * K + k] = rows.partners[(size_t)i * K + k];
    const bool block_first = (p & ((1 << win.block_shift) - 1)) == 0;
#pragma unroll
    for (int r = 0; r < N_RUNS; ++r) {
      int at = b + run_first<N_RUNS>(r, g);
      at = at < 0 ? 0 : (at > g.num_bins - 3 ? g.num_bins - 3 : at);
      const int run_lo = table[at];
      win.bounds[(size_t)p * 2 * N_RUNS + 2 * r] = run_lo;
      win.bounds[(size_t)p * 2 * N_RUNS + 2 * r + 1] = table[at + 3];
      if (block_first)
        win.starts[(size_t)r * win.nblocks + (p >> win.block_shift)] =
            min(run_lo & -win.align, win.max_start);
    }
  }
}

template <int N_RUNS>
__global__ void __launch_bounds__(kThreads) write_back_kernel(
    const unsigned char* __restrict__ stale, int K, int num_bins,
    const int* __restrict__ table, Rows src, Rows rows, float4* __restrict__ xyzr, Window win,
    int* __restrict__ needed) {
  if (*stale == 0) return;
  __shared__ int smem[kThreads / 32];
  const int n_live = table[num_bins];
  int need = 0;
  // every thread runs the same number of rounds, so the block reduces once
  const int stride = gridDim.x * kThreads;
  for (int base = blockIdx.x * kThreads; base < n_live; base += stride) {
    const int p = base + threadIdx.x;
    if (p < n_live) {
      float l[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        l[d] = src.loc[3 * p + d];
        rows.loc[3 * p + d] = l[d];
        rows.mot[3 * p + d] = src.mot[3 * p + d];
      }
      rows.rad[p] = src.rad[p];
      if (xyzr != nullptr) xyzr[p] = make_float4(l[0], l[1], l[2], src.rad[p]);
      rows.ids[p] = src.ids[p];
      rows.perm[p] = src.perm[p];
      for (int k = 0; k < K; ++k) rows.partners[(size_t)p * K + k] = src.partners[(size_t)p * K + k];
      const int blk = p >> win.block_shift;
#pragma unroll
      for (int r = 0; r < N_RUNS; ++r)
        need = max(need, win.bounds[(size_t)p * 2 * N_RUNS + 2 * r + 1] -
                             win.starts[(size_t)r * win.nblocks + blk]);
    }
  }
  need = block_reduce<true>(need, smem);
  if (threadIdx.x == 0 && need > 0) atomicMax(needed, need);
}

template <int N_RUNS>
void launch_all(cudaStream_t stream, int grid, const unsigned char* stale,
                const unsigned char* alive, int C, int K, Bins g, int* bin, int* arrival,
                int* counts, int* tile_sums, int n_tiles, int* table,
                unsigned long long* slot_key, Rows rows, Rows scratch, float* ref, float4* xyzr,
                Window win, const int* needed_prev, int* needed) {
  const int tiles_grid = n_tiles < grid ? n_tiles : grid;
  count_kernel<<<grid, kThreads, 0, stream>>>(stale, rows.loc, alive, C, g, bin, arrival,
                                              counts, needed_prev, needed);
  tile_sum_kernel<<<tiles_grid, kThreads, 0, stream>>>(stale, counts, g.num_bins, tile_sums,
                                                       n_tiles);
  scan_kernel<<<tiles_grid, kThreads, 0, stream>>>(stale, counts, g.num_bins, tile_sums,
                                                   n_tiles, table);
  scatter_kernel<<<grid, kThreads, 0, stream>>>(stale, alive, C, bin, arrival, table,
                                                rows.ids, slot_key);
  place_kernel<N_RUNS><<<grid, kThreads, 0, stream>>>(stale, alive, C, K, g, bin, table,
                                                      slot_key, rows, scratch, ref, win);
  write_back_kernel<N_RUNS><<<grid, kThreads, 0, stream>>>(stale, K, g.num_bins, table,
                                                           scratch, rows, xyzr, win, needed);
}

}  // namespace

// One rebuild under the flag `stale`: six launches on `stream`. `rows` are
// the scan's loc (C, 3), rad (C,), mot (C, 3), ids (C,), partners (C, K)
// and perm (C,) int64, rewritten in place, `scratch` their like-shaped
// buffers; `xyzr` (C, 4) the rows' packed (x, y, z, r), rewritten where the
// rows move, or null; `counts` (num_bins,) zero on entry and on return,
// `table` (num_bins + 1,), `tile_sums` (ceil(num_bins / kTile),), `bin` and
// `arrival` (C,), `slot_key` (C,) uint64. `grid` is the blocks of the
// grid-stride launches.
extern "C" int hipsc_window_rebuild(
    const void* stale, const void* alive, void* loc, void* rad, void* mot, void* ids,
    void* partners, void* perm, void* s_loc, void* s_rad, void* s_mot, void* s_ids,
    void* s_partners, void* s_perm, void* ref, void* xyzr, void* bounds, void* starts,
    const void* needed_prev, void* needed, void* counts, void* table, void* tile_sums,
    void* bin, void* arrival, void* slot_key, int C, int K, int n_runs, float inv,
    int nx, int ny, int nz, int nblocks, int block_shift, int align, int max_start,
    int grid, void* stream) {
  if (C <= 0 || K < 1 || grid < 1 || (n_runs != 3 && n_runs != 9)) return (int)cudaErrorInvalidValue;
  if (nblocks < 1 || block_shift < 0 || block_shift > 30 || align < 1 || (align & (align - 1)))
    return (int)cudaErrorInvalidValue;
  const long long num_bins = (long long)nx * ny * nz;
  if (nx < 3 || ny < 3 || nz < 1 || num_bins >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  const Bins g{inv, nx, ny, nz, n_runs == 3 ? 1 : 0, (int)num_bins};
  const int n_tiles = (int)((num_bins + kTile - 1) / kTile);
  const Rows r{(float*)loc, (float*)rad, (float*)mot, (int*)ids, (int*)partners, (long long*)perm};
  const Rows s{(float*)s_loc, (float*)s_rad, (float*)s_mot, (int*)s_ids, (int*)s_partners,
               (long long*)s_perm};
  const Window w{(int*)bounds, (int*)starts, nblocks, block_shift, align, max_start};
  auto all = n_runs == 3 ? launch_all<3> : launch_all<9>;
  all((cudaStream_t)stream, grid, (const unsigned char*)stale, (const unsigned char*)alive, C,
      K, g, (int*)bin, (int*)arrival, (int*)counts, (int*)tile_sums, n_tiles, (int*)table,
      (unsigned long long*)slot_key, r, s, (float*)ref, (float4*)xyzr, w,
      (const int*)needed_prev, (int*)needed);
  return (int)cudaGetLastError();
}

// The scan tile's bins, for the wrapper's `tile_sums`.
extern "C" int hipsc_window_tile_bins() { return kTile; }
