// The JKR pair law shared by the contact kernels (contact.cu, contact_mask.cu).
//
// Same physics as hipsc_abm_tpu/ops/jkr.py `_pair_jkr` and the Pallas
// kernels' `_pair_keep` (hipsc_abm_tpu/ops/pallas_contact.py): the
// nondimensional overlap d of a candidate pair decides survival (d >
// break_d); a survivor pulls or pushes the row agent along the pair normal
// with the JKR force polynomial. The constants arrive rounded to float32 by
// the Python wrappers (`ops.contact._pair_law_args`), and the library is
// built with --fmad=false, so every kernel that includes this header rounds
// the same way.
//
// Two forms. The uniform law (`law.uniform == 1`: every radius equal, as
// when growth is off) folds the radii into three constants, so a
// candidate's overlap costs a subtraction and a product. The general law
// (`law.uniform == 0`: per-pair radii, as growth makes them) computes the
// reduced radius r_hat, its cube root by `powf`, and two divisions per
// candidate. The kernels ask `jkr_overlap` of every candidate before the
// distance and membership tests (the break test first, contact.cu), so on
// the general branch what bounds them is that per-candidate `powf` and the
// divisions, paid by candidates far beyond the break distance too (~222 per
// row over nine runs in the 3D spheroid). CUDA's `powf` is not correctly
// rounded (2 ulp), nor is the plain versions' `pow`: a pair whose overlap
// lies within a few ulps of `break_d` can be decided apart on the card and
// on the CPU (chip_smoke.py reports each such pair and its distance from
// the break).

#pragma once

#include <cuda_runtime.h>

namespace hipsc {

struct PairLaw {
  float radius2;      // fresh-contact radius squared
  float break_d;      // bond-break threshold on the nondimensional overlap
  int uniform;        // 1: every radius equals `two_r / 2` (fast path)
  float two_r;        // uniform path: r_i + r_j
  float inv_scale;    // uniform path: 1 / (1e6 * overlap scale)
  float fpre;         // uniform path: pi * adhesion_const * r_hat
  float scale_c;      // general path: ((pi * adhesion_const) / e_hat)^(2/3)
  float pi_f;         // general path: pi
  float adhesion;     // general path: adhesion_const
};

// The pair law in two parts, so that a kernel can drop a pair that breaks
// before it asks whether the pair is eligible (a breaking pair gives no
// force and no entry, bonded or not). `jkr_overlap` computes the distance
// `mag` and the nondimensional overlap `d` (the pair survives iff
// d > break_d); `jkr_force` adds a survivor's force on the row agent. Each
// does the float32 operations of the single function they were split from,
// in the same order, so the forces do not change by a bit.
struct PairOverlap {
  float mag;    // |me - c|
  float d;      // nondimensional overlap
  float r_hat;  // general path: reduced radius (m)
};

__device__ __forceinline__ PairOverlap jkr_overlap(const PairLaw& law,
                                                   const float4& me,
                                                   const float4& c,
                                                   float dist2) {
  PairOverlap o;
  o.mag = dist2 > 0.f ? sqrtf(dist2) : 0.f;
  if (law.uniform) {
    o.d = (law.two_r - o.mag) * law.inv_scale;
    o.r_hat = 0.f;
  } else {
    const float ri = me.w, rj = c.w;
    const float overlap = (ri + rj - o.mag) / 1e6f;
    o.r_hat = (ri * rj) / (1e6f * fmaxf(ri + rj, 1e-12f));
    const float scale = o.r_hat > 0.f ? law.scale_c * powf(o.r_hat, 1.0f / 3.0f) : 0.f;
    o.d = overlap / fmaxf(scale, 1e-30f);
  }
  return o;
}

// A survivor's force (o.d > law.break_d) on the row agent, added to
// (fx, fy, fz); (dx, dy, dz) = me - c.
__device__ __forceinline__ void jkr_force(const PairLaw& law,
                                          const PairOverlap& o, float dx,
                                          float dy, float dz, float& fx,
                                          float& fy, float& fz) {
  float fmag;
  if (law.uniform) {
    const float d = o.d;
    const float f = ((-0.0204f * d + 0.4942f) * d + 1.0801f) * d - 1.324f;
    fmag = f * law.fpre;
  } else {
    const float dc = fminf(fmaxf(o.d, -1e8f), 1e8f);
    const float f = ((-0.0204f * dc + 0.4942f) * dc + 1.0801f) * dc - 1.324f;
    fmag = f * law.pi_f * law.adhesion * o.r_hat;
  }
  if (o.mag > 0.f) {
    fx += fmag * (dx / o.mag);
    fy += fmag * (dy / o.mag);
    fz += fmag * (dz / o.mag);
  }
}

// One eligible pair (row `me`, candidate `c`, offset (dx, dy, dz) = me - c,
// squared distance dist2). Returns whether the bond survives; a survivor's
// force on the row agent is added to (fx, fy, fz).
__device__ __forceinline__ bool jkr_pair(const PairLaw& law, const float4& me,
                                         const float4& c, float dx, float dy,
                                         float dz, float dist2, float& fx,
                                         float& fy, float& fz) {
  const PairOverlap o = jkr_overlap(law, me, c, dist2);
  if (!(o.d > law.break_d)) return false;  // the bond breaks: no force, no entry
  jkr_force(law, o, dx, dy, dz, fx, fy, fz);
  return true;
}

}  // namespace hipsc
