// The order in which the interpreted TPU kernels add a row's float sums,
// kept by the contact kernels (contact.cu, contact_mask.cu) and the
// moments kernel (bio_moments.cu); the plain versions' twin is
// ops/neighbors.py `grouped_sum`.
//
// A TPU kernel program holds a block of `block` sorted rows and walks, per
// run, a span of the colony's sorted order that starts at `starts[r][b]`
// (128-aligned below the block's first row's run start, clipped near the
// end of the order), in chunks of `chunk` lanes, chunk-major: for each
// chunk, each run's lanes of it. XLA:CPU, which runs the interpreted
// kernels, reduces a chunk's lanes in 32-lane windows: each window's terms
// in lane order from +0, then the windows from +0, and adds that total to
// the row's sum. So a row's sum here is: for each (chunk, run) in
// chunk-major order, the run's candidates in that chunk, grouped by 32-lane
// windows of their positions in the colony's sorted order; a window's
// partial sum, a (chunk, run) total and the row's sum are kept apart.
//
// Positions in the colony's order: in the single engine the rows are that
// order (`gpos` null); a domain engine's tile passes each of its rows'
// positions (`gpos`). A run's candidates lie in consecutive bins, so their
// positions are consecutive in the colony too: candidate p of a run whose
// first candidate is lo lies at gpos[lo] + (p - lo), one load per run.

#pragma once

#include <cuda_runtime.h>

namespace hipsc {

struct Grouping {
  const int* starts;  // (n_runs, nblocks) span starts
  const int* gpos;    // (C,) the rows' positions in the colony's order; null: the row index
  int nblocks;
  int chunk_shift;    // log2 of the lanes per chunk (>= 5: a chunk holds whole windows)
  int block_shift;    // log2 of the rows per block
};

__device__ __forceinline__ int colony_pos(const Grouping& g, int p) {
  return g.gpos != nullptr ? __ldg(g.gpos + p) : p;
}

// The block of the colony's sorted rows that holds `row`.
__device__ __forceinline__ int row_block(const Grouping& g, int row) {
  return min(max(colony_pos(g, row) >> g.block_shift, 0), g.nblocks - 1);
}

// One nonempty run [lo, hi) of a row in block `blk`: its first candidate's
// colony position and its span start, and the range of chunks it reaches.
struct RunLanes {
  int lo, hi, g_lo, s;
  __device__ __forceinline__ RunLanes(const Grouping& g, int r, int blk, int lo_, int hi_)
      : lo(lo_), hi(hi_), g_lo(colony_pos(g, lo_)), s(__ldg(g.starts + r * g.nblocks + blk)) {}
  // the chunk of position p of the run (lanes before the span, which a
  // consistent grouping never gives, count to chunk 0)
  __device__ __forceinline__ int chunk_of(int p, int shift) const {
    return max(g_lo + (p - lo) - s, 0) >> shift;
  }
  // the run's positions in chunk c: [begin(c), begin(c + 1))
  __device__ __forceinline__ int begin(int c, int shift) const {
    return c == 0 ? lo : min(max(lo + s + (c << shift) - g_lo, lo), hi);
  }
};

// A sum of float triples in the TPU kernels' grouping: `add` the terms of
// one (chunk, run) in walk order with their colony positions, then `close`.
struct GroupSum3 {
  float x = 0.f, y = 0.f, z = 0.f;     // the row's sum
  float tx = 0.f, ty = 0.f, tz = 0.f;  // the (chunk, run) total
  float px = 0.f, py = 0.f, pz = 0.f;  // the window's partial sum
  int window = -1;                     // the open window, -1: none yet in this group

  __device__ __forceinline__ void add(int g, float ax, float ay, float az) {
    const int w = g >> 5;
    if (w != window) {
      tx = __fadd_rn(tx, px);
      ty = __fadd_rn(ty, py);
      tz = __fadd_rn(tz, pz);
      px = py = pz = 0.f;
      window = w;
    }
    px = __fadd_rn(px, ax);
    py = __fadd_rn(py, ay);
    pz = __fadd_rn(pz, az);
  }
  // the end of a (chunk, run): its total joins the row's sum (a group with
  // no term adds nothing)
  __device__ __forceinline__ void close() {
    if (window < 0) return;
    x = __fadd_rn(x, __fadd_rn(tx, px));
    y = __fadd_rn(y, __fadd_rn(ty, py));
    z = __fadd_rn(z, __fadd_rn(tz, pz));
    tx = ty = tz = px = py = pz = 0.f;
    window = -1;
  }
};

}  // namespace hipsc
