// glibc 2.36's powf (its __powf_fma, which XLA:CPU calls for a float32
// `pow` on an x86-64 machine with FMA), bit for bit on the card.
//
// The general pair law's cube root (jkr_pair.cuh `jkr_overlap`) is the JAX
// package's `r_hat ** (1/3)`, which XLA:CPU compiles to a call of glibc's
// powf; CUDA's powf is within 2 ulp of it and rounds otherwise. This is
// the plain mirror's twin (ops/xla_f32.py `powf`), each operation of the
// object code (`objdump -d` of libm.so.6's __powf_fma) in float64 with its
// rounding fixed: __dmul_rn / __dadd_rn / __dsub_rn where it rounds once,
// __fma_rn where vfmadd*sd fuses (the library is built with --fmad=false,
// so nothing else fuses). The tables are libm's __powf_log2_data (16
// entries) and __exp2f_data (32), in global memory read through the
// read-only cache: a warp's threads index them apart, which constant
// memory would serialise.
//
// Domain: positive finite x and a y for which |y log2 x| < 126 (the cube
// root's, for every positive finite float); other inputs fall back to
// CUDA's powf, which gives the IEEE special values glibc gives (0, inf,
// NaN).

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace hipsc {

// 1 / c and log2(c) of the log2 table's 16 subintervals
static __device__ const double kPowfInvc[16] = {
    0x1.661ec79f8f3bep+0, 0x1.571ed4aaf883dp+0, 0x1.49539f0f010bp+0,
    0x1.3c995b0b80385p+0, 0x1.30d190c8864a5p+0, 0x1.25e227b0b8eap+0,
    0x1.1bb4a4a1a343fp+0, 0x1.12358f08ae5bap+0, 0x1.0953f419900a7p+0, 0x1p+0,
    0x1.e608cfd9a47acp-1, 0x1.ca4b31f026aap-1,  0x1.b2036576afce6p-1,
    0x1.9c2d163a1aa2dp-1, 0x1.886e6037841edp-1, 0x1.767dcf5534862p-1};
static __device__ const double kPowfLogc[16] = {
    -0x1.efec65b963019p-2, -0x1.b0b6832d4fca4p-2, -0x1.7418b0a1fb77bp-2,
    -0x1.39de91a6dcf7bp-2, -0x1.01d9bf3f2b631p-2, -0x1.97c1d1b3b7afp-3,
    -0x1.2f9e393af3c9fp-3, -0x1.960cbbf788d5cp-4, -0x1.a6f9db6475fcep-5, 0x0p+0,
    0x1.338ca9f24f53dp-4,  0x1.476a9543891bap-3,  0x1.e840b4ac4e4d2p-3,
    0x1.40645f0c6651cp-2,  0x1.88e9c2c1b9ff8p-2,  0x1.ce0a44eb17bccp-2};
// 2^(i / 32) as float64 bits less i << 47
static __device__ const unsigned long long kExp2fTable[32] = {
    0x3ff0000000000000ull, 0x3fefd9b0d3158574ull, 0x3fefb5586cf9890full, 0x3fef9301d0125b51ull,
    0x3fef72b83c7d517bull, 0x3fef54873168b9aaull, 0x3fef387a6e756238ull, 0x3fef1e9df51fdee1ull,
    0x3fef06fe0a31b715ull, 0x3feef1a7373aa9cbull, 0x3feedea64c123422ull, 0x3feece086061892dull,
    0x3feebfdad5362a27ull, 0x3feeb42b569d4f82ull, 0x3feeab07dd485429ull, 0x3feea47eb03a5585ull,
    0x3feea09e667f3bcdull, 0x3fee9f75e8ec5f74ull, 0x3feea11473eb0187ull, 0x3feea589994cce13ull,
    0x3feeace5422aa0dbull, 0x3feeb737b0cdc5e5ull, 0x3feec49182a3f090ull, 0x3feed503b23e255dull,
    0x3feee89f995ad3adull, 0x3feeff76f2fb5e47ull, 0x3fef199bdd85529cull, 0x3fef3720dcef9069ull,
    0x3fef5818dcfba487ull, 0x3fef7c97337b9b5full, 0x3fefa4afa2a490daull, 0x3fefd0765b6e4540ull};

__device__ __forceinline__ float powf_glibc(float x, float y) {
  if (!(x > 0.f && x < CUDART_INF_F)) return powf(x, y);
  unsigned ix = __float_as_uint(x);
  if (ix < 0x00800000u) {  // subnormal: x 2^23, exponent less 23
    ix = __float_as_uint(__fmul_rn(x, 0x1p23f)) & 0x7fffffffu;
    ix -= 23u << 23;
  }
  // log2(x) = log2(z / c) + log2(c) + k, z in the subinterval of c
  const unsigned tmp = ix - 0x3f330000u;
  const int i = (tmp >> 19) & 15;
  const unsigned top = tmp & 0xff800000u;
  const double z = (double)__uint_as_float(ix - top);
  const int k = (int)top >> 23;
  const double r = __fma_rn(z, __ldg(kPowfInvc + i), -1.0);
  const double y0 = __dadd_rn((double)k, __ldg(kPowfLogc + i));
  const double p = __fma_rn(r, 0x1.ec70a6ca7baddp-2, -0x1.7154748bef6c8p-1);
  const double r2 = __dmul_rn(r, r);
  const double q = __fma_rn(r2, p, __fma_rn(r, 0x1.71547652ab82bp+0, y0));
  const double logx = __fma_rn(__fma_rn(r, 0x1.27616c9496e0bp-2, -0x1.71969a075c67ap-2),
                               __dmul_rn(r2, r2), q);
  // 2^(y log2 x) = 2^(k / 32) 2^r, |r| <= 1 / 64
  const double ylogx = __dmul_rn((double)y, logx);
  const double kd = __dadd_rn(ylogx, 0x1.8p+47);
  const unsigned long long ki = __double_as_longlong(kd);
  const double rr = __dsub_rn(ylogx, __dsub_rn(kd, 0x1.8p+47));
  const double s = __longlong_as_double(__ldg(kExp2fTable + (ki & 31)) + (ki << 47));
  const double poly = __fma_rn(__fma_rn(rr, 0x1.c6af84b912394p-5, 0x1.ebfce50fac4f3p-3),
                               __dmul_rn(rr, rr), __fma_rn(rr, 0x1.62e42ff0c52d6p-1, 1.0));
  return __double2float_rn(__dmul_rn(poly, s));
}

}  // namespace hipsc
