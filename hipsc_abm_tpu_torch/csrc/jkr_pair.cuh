// The JKR pair law shared by the contact kernels (contact.cu, contact_mask.cu).
//
// Same physics as hipsc_abm_tpu/ops/jkr.py `_pair_jkr` and the Pallas
// kernels' `_pair_keep` (hipsc_abm_tpu/ops/pallas_contact.py): the
// nondimensional overlap d of a candidate pair decides survival (d >
// break_d); a survivor pulls or pushes the row agent along the pair normal
// with the JKR force polynomial. The float32 operations are those of the
// plain mirrors in ops/jkr.py, which are the JAX package's as XLA:CPU
// compiles them (ops/xla_f32.py); the library is built with --fmad=false,
// so the only FMAs are the __fmaf_rn written here, each where XLA:CPU's
// backend fuses one. The constants arrive rounded to float32 by the Python
// wrappers (`ops.contact.pair_law_args`), and the products XLA folds are
// formed here in float32 as it forms them.
//
// Two forms. The uniform law (`law.uniform == 1`: every radius equal, as
// when growth is off) is the TPU kernels' fast path as XLA:CPU compiles
// their interpreted bodies: the squared distance fma(dz, dz, fma(dx, dx,
// dy dy)), inv = XLA's rsqrt (the x86 `rsqrtps` estimate, a table of 2048
// 12-bit values the caller passes, refined by two Newton steps with FMAs),
// d0 = fma(-dist2, inv, 2r) (mag = dist2 inv fused away), d = d0 inv_scale,
// the cubic fused with its first coefficient folded into c3 = -0.0204
// inv_scale, and the force w (dx, dy, dz) with w = (f fpre) inv. The
// general law (`law.uniform == 0`: per-pair radii, as growth makes them) is
// `_pair_jkr` as XLA:CPU compiles it: the squared distance fma(dz, dz,
// fma(dy, dy, dx dx)), mag = sqrtf (correctly rounded), the overlap times
// float32(1e-6), the reduced radius r_hat, its cube root by glibc's `powf`
// (`powf_glibc`, glibc_powf.cuh: XLA:CPU calls glibc's, and the plain
// versions mirror it, ops/xla_f32.py `powf`), two divisions, the cubic
// fused and pi adhesion folded. Both laws give the plain versions' bits.
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
// divisions correctly rounded, the law's cube root glibc's powf, within 1
// ulp of the true cube root, the cut's CUDA's powf, within 2 ulp, a few
// products and FMAs) errs by some 1e-6 relative, so a culled pair's
// computed d is below -|break_d| by ~2^-12 of it, hundreds of times any
// rounding (one ulp of d near the break is ~2.5e-8 um of distance). The
// cut is a conservative filter that need not match the law bit for bit:
// `cull_reach` keeps CUDA's `powf` (the plain cut, ops/contact.py
// `cull_reach`, PyTorch's float32 `pow`), and a reach off by a few ulps
// moves it by ~1e-7 relative, far inside the slack, so the argument holds
// for any cube root within a few ulps on either side. The argument needs a
// row radius in [kCullMinRadius, kCullMaxRadius] (no overflow or underflow
// in r_hat) and a positive candidate radius; elsewhere nothing is dropped
// and the law decides. With the cut, ~2 candidates of a 3D row reach the
// law, and the walk's instructions per candidate bound the general law as
// they bound the uniform one (PERF.md section 6). The uniform law takes no
// cut: its overlap is a subtraction and a product after the square root.
// The plain mirror, which the CPU tests hold to the law, is
// ops/contact.py `cull_reach` and `certainly_breaks`.
//
// The kernels add a row's kept forces in the TPU kernels' grouping
// (group_sum.cuh `GroupSum3`): `jkr_force` gives one survivor's term.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "glibc_powf.cuh"

namespace hipsc {

struct PairLaw {
  float radius2;      // fresh-contact radius squared
  float break_d;      // bond-break threshold on the nondimensional overlap
  int uniform;        // 1: every radius equals `two_r / 2` (fast path)
  float two_r;        // uniform path: r_i + r_j
  float inv_scale;    // uniform path: 1 / (1e6 * overlap scale)
  float fpre;         // force prefactor: uniform path pi adhesion r_hat, general path pi adhesion
  float scale_c;      // general path: ((pi * adhesion_const) / e_hat)^(2/3)
  const int* rsqrt_tab;  // the rsqrtps estimates (ops/xla_f32.py)
};

// XLA:CPU's float32 rsqrt of a positive normal x (ops/xla_f32.py `rsqrt`):
// the table's 12-bit estimate under the exponent 126 - floor(e / 2), then
// twice y = fma(y * -0.5, fma(y, x * y, -1), y).
__device__ __forceinline__ float rsqrt_xla(float x, const int* __restrict__ tab) {
  const int bits = __float_as_int(x);
  const int e = ((bits >> 23) & 255) - 127;
  const int index = ((e & 1) << 10) | ((bits >> 13) & 1023);
  float y = __int_as_float(((126 - (e >> 1)) << 23) | (__ldg(tab + index) << 11));
#pragma unroll
  for (int k = 0; k < 2; ++k)
    y = __fmaf_rn(__fmul_rn(y, -0.5f), __fmaf_rn(y, __fmul_rn(x, y), -1.0f), y);
  return y;
}

// The pair's squared distance, (dx, dy, dz) = me - c, as XLA:CPU forms the
// TPU kernels' dx dx + dy dy + dz dz: fma(dz, dz, fma(dx, dx, dy dy)) (dz =
// 0 in 2D).
__device__ __forceinline__ float pair_dist2(float dx, float dy, float dz) {
  return __fmaf_rn(dz, dz, __fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
}

// The pair law in two parts, so that a kernel can drop a pair that breaks
// before it asks whether the pair is eligible (a breaking pair gives no
// force and no entry, bonded or not). `jkr_overlap` computes the
// nondimensional overlap `d` (the pair survives iff d > break_d) and what
// the force reuses; `jkr_force` adds a survivor's force on the row agent to
// a run's sum.
struct PairOverlap {
  float d;      // nondimensional overlap
  float inv;    // 1 / |me - c| (XLA's rsqrt), 0 at distance 0
  float d0;     // uniform path: 2r - dist2 inv (d = d0 inv_scale)
  float r_hat;  // general path: reduced radius (m)
};

__device__ __forceinline__ PairOverlap jkr_overlap(const PairLaw& law,
                                                   const float4& me,
                                                   const float4& c,
                                                   float dist2) {
  PairOverlap o;
  o.inv = dist2 > 0.f ? rsqrt_xla(dist2, law.rsqrt_tab) : 0.f;
  if (law.uniform) {
    o.d0 = __fmaf_rn(-dist2, o.inv, law.two_r);
    o.d = __fmul_rn(o.d0, law.inv_scale);
    o.r_hat = 0.f;
  } else {
    const float ri = me.w, rj = c.w;
    const float radii = __fadd_rn(ri, rj);
    // (ri + rj - dist2 inv) times the float32 reciprocal of 1e6
    const float overlap = __fmul_rn(__fmaf_rn(-dist2, o.inv, radii), 1.0f / 1e6f);
    o.r_hat = __fdiv_rn(__fmul_rn(ri, rj), __fmul_rn(fmaxf(radii, 1e-12f), 1e6f));
    const float scale = __fmul_rn(powf_glibc(o.r_hat, 1.0f / 3.0f), law.scale_c);
    o.d = __fdiv_rn(overlap, fmaxf(scale, 1e-30f));
    o.d0 = 0.f;
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

// The uniform law's cut: the squared distance beyond which it certainly
// breaks a pair. d = (2r - mag) inv_scale > break_d needs mag < 2r -
// break_d / inv_scale (the reach); the kernels' mag = dist2 * inv carries
// XLA's rsqrt, within ~2^-22 of 1 / sqrt(dist2) after its Newton steps, and
// d rounds a few times more, so a pair with sqrt(dist2) beyond the reach
// widened by kCullSlack (2^-12, ~2.5e-3 um at these radii) has a computed d
// below break_d by ~2^-12 of the reach: it breaks, bonded or not, and gives
// no force, entry or bit, so dropping it before its rsqrt changes no
// output. +inf (no cut) where the reach is not positive.
__device__ __forceinline__ float uniform_cut2(const PairLaw& law) {
  const float reach = law.two_r - law.break_d / law.inv_scale;
  if (!(reach > 0.f)) return CUDART_INF_F;
  const float cut = reach * kCullSlack;
  return cut * cut;
}

// Whether the general law certainly breaks the pair of a row of reach
// `reach` and a candidate of radius rj at squared distance dist2: a load,
// the squared distance and this cut instead of the law's `powf` and two
// divisions. False for rj <= 0 and for any NaN.
__device__ __forceinline__ bool certainly_breaks(float reach, float rj, float dist2) {
  const float cut = (reach + rj) * kCullSlack;
  return rj > 0.f && dist2 > cut * cut;
}

// A survivor's force (o.d > law.break_d) on the row agent, (tx, ty, tz);
// (dx, dy, dz) = me - c.
__device__ __forceinline__ void jkr_force(const PairLaw& law,
                                          const PairOverlap& o, float dx,
                                          float dy, float dz, float& tx,
                                          float& ty, float& tz) {
  float w;
  if (law.uniform) {
    const float d = o.d;
    const float c3 = __fmul_rn(-0.0204f, law.inv_scale);
    const float f = __fmaf_rn(d, __fmaf_rn(d, __fmaf_rn(o.d0, c3, 0.4942f), 1.0801f),
                              -1.324f);
    w = __fmul_rn(__fmul_rn(f, law.fpre), o.inv);
  } else {
    const float d = o.d;
    const float f = __fmaf_rn(d, __fmaf_rn(d, __fmaf_rn(d, -0.0204f, 0.4942f), 1.0801f),
                              -1.324f);
    w = __fmul_rn(__fmul_rn(__fmul_rn(f, law.fpre), o.r_hat), o.inv);
  }
  tx = __fmul_rn(w, dx);
  ty = __fmul_rn(w, dy);
  tz = __fmul_rn(w, dz);
}

// One eligible pair (row `me`, candidate `c`, offset (dx, dy, dz) = me - c,
// squared distance dist2). Returns whether the bond survives, and a
// survivor's force on the row agent in (tx, ty, tz).
__device__ __forceinline__ bool jkr_pair(const PairLaw& law, const float4& me,
                                         const float4& c, float dx, float dy,
                                         float dz, float dist2, float& tx,
                                         float& ty, float& tz) {
  const PairOverlap o = jkr_overlap(law, me, c, dist2);
  if (!(o.d > law.break_d)) return false;  // the bond breaks: no force, no entry
  jkr_force(law, o, dx, dy, dz, tx, ty, tz);
  return true;
}

}  // namespace hipsc
