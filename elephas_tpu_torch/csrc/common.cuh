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

// The heads of a group (the head-dim-128 forward's work order): as many
// as keep `bytes_per_head` of operands each within 16 MB of the 50 MB
// L2, at least one.
inline int l2_group(long long bytes_per_head, int heads) {
  const long long fit =
      (16ll << 20) / (bytes_per_head > 0 ? bytes_per_head : 1);
  return static_cast<int>(fit < 1 ? 1 : fit < heads ? fit : heads);
}

// The current device's SM count, looked up once per device.
inline cudaError_t multiprocessors(int* count) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    err = cudaDeviceGetAttribute(&cached[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *count = cached[dev];
  return cudaSuccess;
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
