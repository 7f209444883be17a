// The JKR pair law shared by the contact kernels (contact.cu, contact_mask.cu).
//
// Same physics as hipsc_abm_tpu/ops/jkr.py `_pair_jkr` and the Pallas
// kernels' `_pair_keep` (hipsc_abm_tpu/ops/pallas_contact.py): the
// nondimensional overlap d of a candidate pair decides survival (d >
// break_d); a survivor pulls or pushes the row agent along the pair normal
// with the JKR force polynomial. The constants arrive rounded to float32 by
// the Python wrappers (`ops.contact.pair_law_args`), and the library is
// built with --fmad=false, so every kernel that includes this header rounds
// the same way.
//
// Two forms. The uniform law (`law.uniform == 1`: every radius equal, as
// when growth is off) folds the radii into three constants, so a
// candidate's overlap costs a subtraction and a product. The general law
// (`law.uniform == 0`: per-pair radii, as growth makes them) computes the
// reduced radius r_hat, its cube root by `powf`, and two divisions per
// pair. CUDA's `powf` is not correctly rounded (2 ulp), nor is the plain
// versions' `pow`: a pair whose overlap lies within a few ulps of `break_d`
// can be decided apart on the card and on the CPU (chip_smoke.py reports
// each such pair and its distance from the break).
//
// What bounded the general law on the card was that per-pair `powf` and the
// divisions, asked of every candidate a row walks (~222 over nine runs in
// the 3D spheroid, of which ~2 are kept). So B6 and the seed (B2) first
// drop the candidates that the law certainly breaks (`certainly_breaks`):
// such a pair gives no force, no entry and no bit, bonded or not, so
// dropping it changes no output, and every other candidate runs the law
// as before, the same float32 operations in the same order. The argument:
// a pair survives iff d = (ri + rj - mag) / scale > break_d, and since
// r_hat = ri rj / (1e6 (ri + rj)) < ri / 1e6 for rj > 0, the scale is below
// scale_c cbrt(ri / 1e6); so with the row's band
// b_i = |break_d| scale_c cbrt(ri / 1e6) 1e6 (um, one `powf` per row,
// `cull_reach`), every pair with mag > ri + rj + b_i breaks. The cut is
// widened by the relative slack 2^-12 (~2.5e-3 um at the radii growth
// makes): the float32 evaluation of the law and of the cut (sqrtf and the
// divisions correctly rounded, `powf` within 2 ulp, a few products) errs by
// some 1e-6 relative, so a culled pair's computed d is below -|break_d|
// by ~2^-12 of it, hundreds of times any rounding (one ulp of d near the
// break is ~2.5e-8 um of distance). The argument needs a row radius in
// [kCullMinRadius, kCullMaxRadius] (no overflow or underflow in r_hat) and
// a positive candidate radius; elsewhere nothing is dropped and the law
// decides. With the cut, ~2 candidates of a 3D row reach the law, and the
// walk's instructions per candidate bound the general law as they bound
// the uniform one (PERF.md section 6). The uniform law takes no cut: its
// overlap is a subtraction and a product after the square root. The plain
// mirror, which the CPU tests hold to the law, is ops/contact.py
// `cull_reach` and `certainly_breaks`.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

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

// The general law's cull (see the note at the top): the relative slack of
// the cut and the row radii (um) for which its argument is made.
constexpr float kCullSlack = 1.0f + 1.0f / 4096.0f;
constexpr float kCullMinRadius = 1e-12f;
constexpr float kCullMaxRadius = 1e12f;

// The row's reach ri + b_i (um), one `powf` per row; +inf (no candidate is
// dropped) outside the radii the argument covers or for a non-finite ri.
__device__ __forceinline__ float cull_reach(const PairLaw& law, float ri) {
  if (!(ri >= kCullMinRadius && ri <= kCullMaxRadius)) return CUDART_INF_F;
  return ri + fabsf(law.break_d) * law.scale_c * powf(ri / 1e6f, 1.0f / 3.0f) * 1e6f;
}

// Whether the general law certainly breaks the pair of a row of reach
// `reach` and a candidate of radius rj at squared distance dist2: a load,
// the squared distance and this cut instead of the law's `powf` and two
// divisions. False for rj <= 0 and for any NaN.
__device__ __forceinline__ bool certainly_breaks(float reach, float rj, float dist2) {
  const float cut = (reach + rj) * kCullSlack;
  return rj > 0.f && dist2 > cut * cut;
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
