// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_kernel` in
// elephas_tpu/ops/paged_attention.py (launched by
// `paged_decode_attention`): single-position (S=1) attention read
// straight from the block pool through per-row block tables, with no
// gathered copy of the cache. Online softmax in f32 across the row's
// blocks; blocks past `pos` or wholly outside the sliding window are
// never read; GQA shares each kv head's block among its query group;
// optional ALiBi slopes.
//
// Design. One CTA of 128 threads owns one (row, kv head). It reads its
// own `pos[b]` and `tables[b, j]` (no scalar prefetch on Hopper), then
// loops j over the live blocks only, from the window's first block to
// `pos / block_size`. Each (block_size, D) K and V block is staged in
// shared memory as f32; the CTA computes the groups x block_size
// scores, runs the online-softmax update per query head, and folds the
// block into an f32 (groups, D) accumulator in shared memory. An
// inactive slot (pos 0, a table of zeros) reads only the scratch block
// 0, which the engine never allocates, so it cannot fault.
//
// What bounds it on the H100. Decode reads every live K/V byte once
// for ~4 * groups flops per element, far below the card's ~295
// flops-per-byte balance point: it is bound by bytes. At the serving
// shapes (block 16, head_dim 64, groups 1) each block is 4 KB of bf16
// K+V per CTA, so this simple design waits on one load latency per
// block with four barriers around it; a split-K (flash-decoding) grid
// with several blocks in flight per CTA is the next step.
#include "common.cuh"

namespace {

using namespace etpu;

constexpr int THREADS = 128;

inline size_t paged_smem_bytes(int G, int bs, int D) {
  // Ks[bs][D+1], Vs[bs][D], Qs[G][D], Sc[G][bs], Acc[G][D], M/L/Corr[G]
  return sizeof(float) * ((size_t)bs * (D + 1) + (size_t)bs * D +
                          (size_t)G * D + (size_t)G * bs + (size_t)G * D +
                          3 * (size_t)G);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                        const T* __restrict__ vpool,
                        const int* __restrict__ tables,
                        const int* __restrict__ pos,
                        const float* __restrict__ slopes, T* __restrict__ out,
                        int H, int KVH, int bs, int D, int MB, int window,
                        float scale) {
  const int G = H / KVH;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + bs * (D + 1);
  float* Qs = Vs + bs * D;
  float* Sc = Qs + G * D;
  float* Acc = Sc + G * bs;
  float* M = Acc + G * D;
  float* L = M + G;
  float* Corr = L + G;

  const int b = blockIdx.x;
  const int n = blockIdx.y;  // kv head; query heads n*G .. n*G+G-1
  const int tid = threadIdx.x;
  const int p = pos[b];
  const int* row_table = tables + (size_t)b * MB;

  for (int i = tid; i < G * D; i += THREADS) {
    Qs[i] = to_f32(q[((size_t)b * H + n * G) * D + i]);
    Acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    M[g] = kNegInf;
    L[g] = 0.f;
  }

  const int j_hi = min(p / bs, MB - 1);
  for (int j = 0; j <= j_hi; ++j) {
    // blocks wholly before the window are never read (uniform over the
    // CTA); blocks past pos are outside the loop bound
    if (window > 0 && !(j * bs + bs - 1 > p - window)) continue;
    const size_t base = ((size_t)row_table[j] * KVH + n) * bs * D;
    __syncthreads();  // the previous block's Ks/Vs/Sc reads are done
    for (int i = tid; i < bs * D; i += THREADS) {
      Ks[(i / D) * (D + 1) + i % D] = to_f32(kpool[base + i]);
      Vs[i] = to_f32(vpool[base + i]);
    }
    __syncthreads();

    for (int i = tid; i < G * bs; i += THREADS) {
      const int g = i / bs, t = i % bs;
      const int kpos = j * bs + t;
      float s = 0.f;
      for (int d = 0; d < D; ++d)
        s = fmaf(Qs[g * D + d], Ks[t * (D + 1) + d], s);
      s *= scale;
      if (slopes != nullptr) s -= slopes[n * G + g] * (float)(p - kpos);
      const bool valid =
          kpos <= p && (window <= 0 || kpos > p - window);
      Sc[i] = valid ? s : kNegInf;
    }
    __syncthreads();

    for (int g = tid; g < G; g += THREADS) {
      float mx = kNegInf;
      for (int t = 0; t < bs; ++t) mx = fmaxf(mx, Sc[g * bs + t]);
      const float m_new = fmaxf(M[g], mx);
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) {
        const int kpos = j * bs + t;
        const bool valid =
            kpos <= p && (window <= 0 || kpos > p - window);
        const float e = valid ? expf(Sc[g * bs + t] - m_new) : 0.f;
        sum += e;
        Sc[g * bs + t] = round_to<T>(e);
      }
      const float corr = expf(M[g] - m_new);
      L[g] = L[g] * corr + sum;
      M[g] = m_new;
      Corr[g] = corr;
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D, d = i % D;
      float a = Acc[i] * Corr[g];
      for (int t = 0; t < bs; ++t) a = fmaf(Sc[g * bs + t], Vs[t * D + d], a);
      Acc[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < G * D; i += THREADS) {
    const float denom = fmaxf(L[i / D], 1e-30f);
    out[((size_t)b * H + n * G) * D + i] = from_f32<T>(Acc[i] / denom);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kpool, const void* vpool,
                   const int* tables, const int* pos, const float* slopes,
                   void* out, int B, int H, int KVH, int bs, int D, int MB,
                   int window, float scale, cudaStream_t stream) {
  const size_t smem = paged_smem_bytes(H / KVH, bs, D);
  auto kernel = paged_decode_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, KVH);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kpool),
      static_cast<const T*>(vpool), tables, pos, slopes,
      static_cast<T*>(out), H, KVH, bs, D, MB, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q (B, H, D); k_pool/v_pool (NB, KVH, bs, D); out (B, H, D), all
// contiguous and of one type (is_bf16 ? bf16 : f32); tables (B, MB) and
// pos (B,) int32; slopes (H,) f32 or null. window <= 0 means no sliding
// window. Every table entry a row reaches (j <= pos / bs) must be a valid
// block id. Returns cudaGetLastError() after the launch.
extern "C" int etpu_paged_decode(const void* q, const void* kpool,
                                 const void* vpool, const void* tables,
                                 const void* pos, const void* slopes,
                                 void* out, int B, int H, int KVH, int bs,
                                 int D, int MB, int window, float scale,
                                 int is_bf16, void* stream) {
  if (B == 0) return cudaSuccess;
  if (KVH <= 0 || H % KVH || bs <= 0 || MB <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* t = static_cast<const int*>(tables);
  auto* ps = static_cast<const int*>(pos);
  auto* sl = static_cast<const float*>(slopes);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, kpool, vpool, t, ps, sl, out, B, H, KVH,
                                 bs, D, MB, window, scale, s);
  return launch<float>(q, kpool, vpool, t, ps, sl, out, B, H, KVH, bs, D, MB,
                       window, scale, s);
}
