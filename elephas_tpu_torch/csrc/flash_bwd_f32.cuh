// The f32 flash backward's entries (flash_bwd_f32.cu), called by the C
// interface of flash_bwd.cu for f32 operands. Shapes and arguments are
// those of `etpu_flash_bwd_dq` and `etpu_flash_bwd_dkv`; each returns
// cudaGetLastError() after its launch, or cudaErrorInvalidValue for what
// it does not take.
#pragma once

#include <cuda_runtime.h>

namespace etpu {

cudaError_t f32_bwd_dq(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse,
                       const float* delta, float* dq, int B, int H, int KVH,
                       int Sq, int Sk, int hd, int q_offset, int k_offset,
                       int causal, int window, float scale,
                       cudaStream_t stream);

// At head dims 40-256 `plan` (`chunks` rows on the device) sets one CTA
// a chunk, and `partials` takes the chunks of the k tiles it splits;
// without a plan one CTA takes a k tile whole. At 8-32 both are ignored.
cudaError_t f32_bwd_dkv(const float* q, const float* k, const float* v,
                        const float* dout, const float* lse,
                        const float* delta, float* dk, float* dv,
                        const int* plan, int chunks, float* partials, int B,
                        int H, int KVH, int Sq, int Sk, int hd, int q_offset,
                        int k_offset, int causal, int window, float scale,
                        cudaStream_t stream);

}  // namespace etpu
