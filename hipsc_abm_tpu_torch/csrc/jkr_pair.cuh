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

// One eligible pair (row `me`, candidate `c`, offset (dx, dy, dz) = me - c,
// squared distance dist2). Returns whether the bond survives; a survivor's
// force on the row agent is added to (fx, fy, fz).
__device__ __forceinline__ bool jkr_pair(const PairLaw& law, const float4& me,
                                         const float4& c, float dx, float dy,
                                         float dz, float dist2, float& fx,
                                         float& fy, float& fz) {
  const float mag = dist2 > 0.f ? sqrtf(dist2) : 0.f;
  float d, fmag;
  if (law.uniform) {
    d = (law.two_r - mag) * law.inv_scale;
    fmag = 0.f;
    if (d > law.break_d) {
      const float f = ((-0.0204f * d + 0.4942f) * d + 1.0801f) * d - 1.324f;
      fmag = f * law.fpre;
    }
  } else {
    const float ri = me.w, rj = c.w;
    const float overlap = (ri + rj - mag) / 1e6f;
    const float r_hat = (ri * rj) / (1e6f * fmaxf(ri + rj, 1e-12f));
    const float scale = r_hat > 0.f ? law.scale_c * powf(r_hat, 1.0f / 3.0f) : 0.f;
    d = overlap / fmaxf(scale, 1e-30f);
    fmag = 0.f;
    if (d > law.break_d) {
      const float dc = fminf(fmaxf(d, -1e8f), 1e8f);
      const float f = ((-0.0204f * dc + 0.4942f) * dc + 1.0801f) * dc - 1.324f;
      fmag = f * law.pi_f * law.adhesion * r_hat;
    }
  }
  if (!(d > law.break_d)) return false;  // the bond breaks: no force, no entry
  if (mag > 0.f) {
    fx += fmag * (dx / mag);
    fy += fmag * (dy / mag);
    fz += fmag * (dz / mag);
  }
  return true;
}

}  // namespace hipsc
