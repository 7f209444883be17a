// The substep's update: Stokes integration, the move probe and the next
// substep's drift test in one launch.
//
// Replaces no TPU kernel. The JAX engine leaves this elementwise update to
// XLA, which fuses it into its step; in eager PyTorch it was ~24 launches per
// substep (the Stokes update ~13, the move probe ~5, the drift test ~6,
// counted from the code), and the update's fused multiply-add cannot be had
// from eager PyTorch on the card at all. The arithmetic is that of
// ops/integrate.py `update_plain`, the JAX package's step as XLA:CPU
// compiles it (ops/xla_f32.py): friction r * fric (fric folded into one
// float32 constant), v = (F_jkr + F_mot) / friction, the new location
// fma(v * dt, 1e6, loc), or fma(v, dt * 1e6, loc) where XLA saw dt as a
// literal (`folded`, the scan's first substep), clamped to [0, size], dead
// rows kept; squared norms as fma(d2, d2, fma(d1, d1, d0 * d0)). The
// library is built with --fmad=false, so the FMAs are exactly the
// __fmaf_rn written here.
//
// Per row i (one thread): the new location, |new - loc|^2 over the rows
// `counted` (or alive, when counted is null) and |new - ref|^2 over the
// same rows, ref being where the window was built. The two maxima go to
// `scratch` (16 bytes, zero before the launch) as int bits: a max of
// non-negative floats through their bits is exact and does not depend on
// the order of the CTAs. The last CTA to finish (a ticket in the scratch)
// writes the flag drift^2 > threshold as its fourth word. So nothing is
// allocated or read on the host, and the launch can sit in a CUDA graph.
// Given `xyzr`, it also writes every row's packed (x, y, z, r), the new
// location beside the radius, for the next substep's contact launch: the
// rows ops/jkr.py `pack_physics` gives, dead rows included, without a
// PyTorch concatenation of its own.
//
// What bounds it on the card: bytes. A row reads 3 locations, the radius,
// 6 force components, liveness (and the counted flag), 3 reference
// coordinates and writes 3 locations (and the 16-byte packed row): ~65
// (~81) bytes per row, ~6.5 MB at 100k rows, ~2 us at 3.35 TB/s; at that
// size the launch itself is most of it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // rows per CTA

__device__ __forceinline__ float sq3(float d0, float d1, float d2) {
  return __fmaf_rn(d2, d2, __fmaf_rn(d1, d1, __fmul_rn(d0, d0)));
}

__device__ __forceinline__ float block_max(float v, float* smem) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? smem[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

__global__ void __launch_bounds__(kThreads) update_kernel(
    const float* __restrict__ loc, const float* __restrict__ rad,
    const float* __restrict__ force, const float* __restrict__ mot,
    const unsigned char* __restrict__ alive, const unsigned char* __restrict__ counted,
    const float* __restrict__ ref, const float* __restrict__ size,
    float* __restrict__ out, float4* __restrict__ xyzr, int* __restrict__ scratch, int C,
    float fric, float step, int folded, float threshold) {
  __shared__ float smem[2][kThreads / 32];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float move2 = 0.f, drift2 = 0.f;
  if (i < C) {
    const bool a = alive[i] != 0;
    const float r = rad[i];
    const float friction = r > 0.f ? __fmul_rn(r, fric) : 1.f;
    float nl[3], dm[3], dr[3];
    for (int d = 0; d < 3; ++d) {
      const float l = loc[3 * i + d];
      const float v = __fdiv_rn(__fadd_rn(force[3 * i + d], mot[3 * i + d]), friction);
      float n = folded ? __fmaf_rn(v, step, l) : __fmaf_rn(__fmul_rn(v, step), 1e6f, l);
      n = n > 0.f ? n : 0.f;
      n = fminf(n, size[d]);
      n = a ? n : l;
      out[3 * i + d] = n;
      nl[d] = n;
      dm[d] = __fsub_rn(n, l);
      dr[d] = __fsub_rn(n, ref[3 * i + d]);
    }
    if (xyzr != nullptr) xyzr[i] = make_float4(nl[0], nl[1], nl[2], r);
    const bool c = counted ? counted[i] != 0 : a;
    if (c) {
      move2 = sq3(dm[0], dm[1], dm[2]);
      drift2 = sq3(dr[0], dr[1], dr[2]);
    }
  }
  move2 = block_max(move2, smem[0]);
  drift2 = block_max(drift2, smem[1]);
  if (threadIdx.x == 0) {
    atomicMax(scratch + 0, __float_as_int(move2));
    atomicMax(scratch + 1, __float_as_int(drift2));
    __threadfence();
    const unsigned ticket = atomicAdd(reinterpret_cast<unsigned*>(scratch + 2), 1u);
    if (ticket == gridDim.x - 1) {
      const float worst = __int_as_float(atomicMax(scratch + 1, 0));
      scratch[3] = worst > threshold ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" int hipsc_update(const void* loc, const void* rad, const void* force,
                            const void* mot, const void* alive, const void* counted,
                            const void* ref, const void* size, void* out, void* xyzr,
                            void* scratch, int C, float fric, float step, int folded,
                            float threshold, void* stream) {
  if (C <= 0) return (int)cudaErrorInvalidValue;
  update_kernel<<<(C + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)loc, (const float*)rad, (const float*)force, (const float*)mot,
      (const unsigned char*)alive, (const unsigned char*)counted, (const float*)ref,
      (const float*)size, (float*)out, (float4*)xyzr, (int*)scratch, C, fric, step, folded,
      threshold);
  return (int)cudaGetLastError();
}
