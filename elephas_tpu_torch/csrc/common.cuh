// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel computes in f32 whatever its storage type, as the TPU
// kernels it replaces do (f32 accumulators over bf16 or f32 operands).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace etpu {

// The masking sentinel of the JAX package (ops/pallas_attention.py
// NEG_INF): finite, so a fully masked row stays NaN-free.
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The softmax weights enter the P.V product in the value dtype, as the
// TPU kernels' ``p.astype(v.dtype)`` does; the row sum keeps f32.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Whether some pair of query rows [q_lo, q_hi] and key rows [k_lo, k_hi]
// (local indices) is unmasked on global positions: the TPU kernels'
// `diag_reached` and the window's band test. Uniform over a CTA.
__device__ __forceinline__ bool rows_meet(int q_lo, int q_hi, int k_lo,
                                          int k_hi, int q_offset,
                                          int k_offset, int causal,
                                          int window) {
  bool live = !causal || k_offset + k_lo <= q_offset + q_hi;
  if (window > 0) live = live && k_offset + k_hi > q_offset + q_lo - window;
  return live;
}

// Whether every such pair is unmasked by the causal and window rules
// (ragged lengths are the caller's to check): such a tile needs no
// per-element mask.
__device__ __forceinline__ bool rows_all_valid(int q_lo, int q_hi, int k_lo,
                                               int k_hi, int q_offset,
                                               int k_offset, int causal,
                                               int window) {
  bool all = !causal || k_offset + k_hi <= q_offset + q_lo;
  if (window > 0) all = all && k_offset + k_lo > q_offset + q_hi - window;
  return all;
}

// Element validity: key and query in range, causal and window on global
// positions.
__device__ __forceinline__ bool pair_valid(int ql, int kl, int Sq, int Sk,
                                           int q_offset, int k_offset,
                                           int causal, int window) {
  const int qg = q_offset + ql, kg = k_offset + kl;
  bool ok = ql < Sq && kl < Sk;
  if (causal) ok = ok && kg <= qg;
  if (window > 0) ok = ok && kg > qg - window;
  return ok;
}

// Rows [r0, r0 + n) of a (rows, D) f32 matrix -> a shared-memory tile
// with row stride LD, zero past `limit` rows, one element per thread
// step over NT threads.
template <int D, int LD, int NT>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int r0, int n, int limit) {
  for (int i = threadIdx.x; i < n * D; i += NT) {
    const int r = i / D, c = i % D;
    dst[r * LD + c] = r0 + r < limit ? src[(size_t)(r0 + r) * D + c] : 0.f;
  }
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace etpu
