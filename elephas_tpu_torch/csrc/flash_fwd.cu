// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` in
// elephas_tpu/ops/pallas_attention.py (launched by `_fwd`): the
// flash-attention-2 forward with f32 online softmax, causal and
// sliding-window masks with whole-tile skipping, ragged lengths, GQA
// through the kv-row map, and global q/k offsets for ring hops. It
// returns O and the per-row logsumexp; a fully masked row gets O = 0
// and LSE ~ -1e30, so a cross-hop merge weights it to zero.
//
// Design. One CTA owns one (batch*head, 64-row q tile). The TPU's
// sequential kv grid axis becomes a loop inside the CTA over 64-row K/V
// tiles staged in shared memory; tiles wholly above the causal diagonal
// or below the window are skipped before any load. Ragged edges are
// masked in the kernel (zero-filled tiles, `k < Sk` validity), never
// padded in device memory. Two bodies share that structure:
//
// - bf16 (the working type): 4 warps, each owning 16 query rows. Q.K^T
//   and P.V run on the tensor cores as 16x16x16 WMMA products (bf16 in,
//   f32 accumulate, as the TPU kernel's MXU dots). Each warp stores its
//   16x64 score block to shared memory; lane pairs own one row each for
//   the online softmax and the f32 O accumulator (half the head dim per
//   lane), and fold in each tile's P.V block from shared memory, since
//   a WMMA accumulator's row layout is opaque.
// - f32: 256 threads on the CUDA cores, each holding a 4x4 block of the
//   64x64 score tile and a 4x(D/16) block of O in registers; row max and
//   sum reduce over the 16 lanes sharing a row with warp shuffles.
//
// What bounds it on the H100. At head_dim 64 a (q, k) pair costs 4*D
// flops and each operand row is read once per 64-row tile, so the loop
// is bound by operations. The bf16 body reaches the tensor cores through
// mma.sync-class WMMA at 16x16x16, staged through shared memory with
// plain loads and a barrier per tile: far from the 989 TFLOP/s bound.
// wgmma over TMA-staged tiles, with the softmax kept in registers, is
// the next step.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using namespace etpu;

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 x 16 threads, each 4 rows x 4 columns

template <int D>
constexpr size_t flash_smem_bytes() {
  // Qs[BQ][D+1], Ks[BK][D+1], Vs[BK][D], Ps[BQ][BK+1]; the +1 pads keep
  // the lanes of a warp on distinct banks in the inner products
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int H, int KVH, int Sq, int Sk,
                     int q_offset, int k_offset, int causal, int window,
                     float scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int RC = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * (D + 1);
  float* Vs = Ks + BK * (D + 1);
  float* Ps = Vs + BK * D;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int h = bh % H;
  // GQA: query row bh = b*H + h reads kv row b*KVH + h / (H / KVH)
  const int kv_row = (bh / H) * KVH + h / (H / KVH);
  const T* qp = q + (size_t)bh * Sq * D;
  const T* kp = k + (size_t)kv_row * Sk * D;
  const T* vp = v + (size_t)kv_row * Sk * D;

  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3 of the tile
  const int tx = tid % 16;  // columns tx + 16*j

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    Qs[r * (D + 1) + c] =
        q0 + r < Sq ? to_f32(qp[(size_t)(q0 + r) * D + c]) : 0.f;
  }

  float m[4], l[4], acc[4][RC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = etpu::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < RC; ++j) acc[i][j] = 0.f;
  }

  const int nk = (Sk + BK - 1) / BK;
  for (int kj = 0; kj < nk; ++kj) {
    const int k0 = kj * BK;
    // whole-tile skip on global positions (the same predicate as the
    // TPU kernel's `diag_reached`); uniform over the CTA
    bool live = !causal || (k_offset + k0 <= q_offset + q0 + BQ - 1);
    if (window > 0) live = live && (k_offset + k0 + BK - 1 > q_offset + q0 - window);
    if (!live) continue;

    __syncthreads();  // the previous tile's Ks/Vs/Ps reads are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < Sk;
      Ks[r * (D + 1) + c] = in ? to_f32(kp[(size_t)(k0 + r) * D + c]) : 0.f;
      Vs[i] = in ? to_f32(vp[(size_t)(k0 + r) * D + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qg = q_offset + q0 + ty * 4 + i;  // global query position
      bool valid[4];
      float mx = etpu::kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kl = k0 + tx + 16 * j;  // local key row
        const int kg = k_offset + kl;
        valid[j] = kl < Sk;
        if (causal) valid[j] = valid[j] && kg <= qg;
        if (window > 0) valid[j] = valid[j] && kg > qg - window;
        s[i][j] = valid[j] ? s[i][j] * scale : etpu::kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        Ps[(ty * 4 + i) * (BK + 1) + tx + 16 * j] = etpu::round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off, 16);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < RC; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < RC; ++j) {
        const float vv = Vs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + ((size_t)bh * Sq + r) * D;
#pragma unroll
    for (int j = 0; j < RC; ++j)
      orow[tx + 16 * j] = etpu::from_f32<T>(acc[i][j] / denom);
    if (tx == 0) lse[(size_t)bh * Sq + r] = m[i] + logf(denom);
  }
}

// ------------------------------------------------------ bf16, WMMA body
namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;               // each warp owns 16 query rows
constexpr int WTHREADS = 32 * WARPS;

template <int D>
struct WmmaLayout {
  // bf16 row strides pad by 8 elements (16 bytes): rows stay 16-byte
  // aligned for vector stores and 32-byte aligned at every 16-row
  // fragment, and consecutive rows shift banks
  static constexpr int LDQ = D + 8;              // Qs, Ks, Vs
  static constexpr int LDP = BK + 8;             // Ps
  static constexpr int LDS = (D > BK ? D : BK) + 4;  // f32 scratch
  static constexpr size_t bytes =
      sizeof(bf16) * ((size_t)(BQ + 2 * BK) * LDQ + (size_t)BQ * LDP) +
      sizeof(float) * (size_t)WARPS * 16 * LDS;
};

template <int D>
__global__ void __launch_bounds__(WTHREADS)
    flash_fwd_wmma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, int H, int KVH, int Sq,
                          int Sk, int q_offset, int k_offset, int causal,
                          int window, float scale) {
  static_assert(D % 16 == 0 && BK == 64, "tile shape");
  using L = WmmaLayout<D>;
  constexpr int KD = D / 16;       // fragments along the head dim
  constexpr int OC = D / 2;        // O columns per lane
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * L::LDQ;
  bf16* Vs = Ks + BK * L::LDQ;
  bf16* Ps = Vs + BK * L::LDQ;
  float* Sc = reinterpret_cast<float*>(Ps + BQ * L::LDP);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* Sw = Sc + warp * 16 * L::LDS;   // this warp's 16-row scratch
  bf16* Pw = Ps + warp * 16 * L::LDP;
  const int rl = lane >> 1;              // this lane's row in the warp
  const int half = lane & 1;             // which half of the row it owns
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int h = bh % H;
  // GQA: query row bh = b*H + h reads kv row b*KVH + h / (H / KVH)
  const int kv_row = (bh / H) * KVH + h / (H / KVH);
  const bf16* kp = k + (size_t)kv_row * Sk * D;
  const bf16* vp = v + (size_t)kv_row * Sk * D;
  const int qrow = q0 + warp * 16 + rl;  // this lane's local query row
  const int qg = q_offset + qrow;

  stage_rows<D, L::LDQ, WTHREADS>(Qs, q + (size_t)bh * Sq * D, q0, BQ, Sq);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[KD];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    wmma::load_matrix_sync(qf[kk], Qs + warp * 16 * L::LDQ + kk * 16,
                           L::LDQ);

  float m = kNegInf, l = 0.f, acc[OC];
#pragma unroll
  for (int j = 0; j < OC; ++j) acc[j] = 0.f;

  const int nk = (Sk + BK - 1) / BK;
  for (int kj = 0; kj < nk; ++kj) {
    const int k0 = kj * BK;
    bool live = !causal || (k_offset + k0 <= q_offset + q0 + BQ - 1);
    if (window > 0) live = live && (k_offset + k0 + BK - 1 > q_offset + q0 - window);
    if (!live) continue;

    __syncthreads();  // every warp is done with the previous K/V tile
    stage_rows<D, L::LDQ, WTHREADS>(Ks, kp, k0, BK, Sk);
    stage_rows<D, L::LDQ, WTHREADS>(Vs, vp, k0, BK, Sk);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
            kf;
        wmma::load_matrix_sync(kf, Ks + n * 16 * L::LDQ + kk * 16, L::LDQ);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(Sw + n * 16, sf, L::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax: the lane pair (rl, half) owns row rl, 32 columns each
    const float* srow = Sw + rl * L::LDS + half * 32;
    float sv[32];
    unsigned valid = 0u;
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int kl = k0 + half * 32 + c;  // local key row
      const int kg = k_offset + kl;
      bool ok = kl < Sk;
      if (causal) ok = ok && kg <= qg;
      if (window > 0) ok = ok && kg > qg - window;
      sv[c] = ok ? srow[c] * scale : kNegInf;
      valid |= (ok ? 1u : 0u) << c;
      mx = fmaxf(mx, sv[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    float rs = 0.f;
    bf16* prow = Pw + rl * L::LDP + half * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p = (valid >> c) & 1u ? expf(sv[c] - m_new) : 0.f;
      rs += p;
      prow[c] = __float2bfloat16(p);  // P enters P.V in bf16, as on the TPU
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    const float corr = expf(m - m_new);
    l = l * corr + rs;
    m = m_new;
    __syncwarp();  // P written, S read: the scratch takes the P.V block

    // this tile's P.V for the warp's 16 rows, into the scratch
#pragma unroll
    for (int dn = 0; dn < KD; ++dn) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::fill_fragment(of, 0.f);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, Pw + kk * 16, L::LDP);
        wmma::load_matrix_sync(vf, Vs + kk * 16 * L::LDQ + dn * 16, L::LDQ);
        wmma::mma_sync(of, pf, vf, of);
      }
      wmma::store_matrix_sync(Sw + dn * 16, of, L::LDS, wmma::mem_row_major);
    }
    __syncwarp();
    const float* pv = Sw + rl * L::LDS + half * OC;
#pragma unroll
    for (int j = 0; j < OC; ++j) acc[j] = fmaf(acc[j], corr, pv[j]);
    __syncwarp();  // the scratch is read before the next tile's S lands
  }

  if (qrow < Sq) {
    const float denom = fmaxf(l, 1e-30f);
    bf16* orow = o + ((size_t)bh * Sq + qrow) * D + half * OC;
#pragma unroll
    for (int j = 0; j < OC; ++j) orow[j] = __float2bfloat16(acc[j] / denom);
    if (half == 0) lse[(size_t)bh * Sq + qrow] = m + logf(denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int KVH, int Sq, int Sk,
                   int q_offset, int k_offset, int causal, int window,
                   float scale, cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  if constexpr (std::is_same_v<T, bf16>) {
    constexpr size_t smem = WmmaLayout<D>::bytes;
    auto kernel = flash_fwd_wmma_kernel<D>;
    cudaError_t err = etpu::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, WTHREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, H, KVH,
        Sq, Sk, q_offset, k_offset, causal, window, scale);
  } else {
    constexpr size_t smem = flash_smem_bytes<D>();
    auto kernel = flash_fwd_kernel<T, D>;
    cudaError_t err = etpu::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, H, KVH, Sq, Sk,
        q_offset, k_offset, causal, window, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, float* lse, int B, int H, int KVH, int Sq,
                       int Sk, int q_offset, int k_offset, int causal,
                       int window, float scale, cudaStream_t stream) {
  switch (D) {
    // only the head dim the checked-in configs use; add cases as a
    // configuration needs them
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, H, KVH, Sq, Sk, q_offset,
                           k_offset, causal, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Sq, D), k/v (B, KVH, Sk, D), o (B, H, Sq, D), all contiguous
// and of one type (is_bf16 ? bf16 : f32; bf16 q/k/v 16-byte aligned);
// lse (B, H, Sq) f32. window <= 0 means no sliding window. Returns
// cudaGetLastError() after the launch.
extern "C" int etpu_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int H, int KVH,
                              int Sq, int Sk, int D, int q_offset,
                              int k_offset, int causal, int window,
                              float scale, int is_bf16, void* stream) {
  if (B * H == 0 || Sq == 0) return cudaSuccess;
  if (KVH <= 0 || H % KVH) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  if (is_bf16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, l, B, H, KVH, Sq, Sk,
                                     q_offset, k_offset, causal, window,
                                     scale, s);
  return dispatch_d<float>(D, q, k, v, o, l, B, H, KVH, Sq, Sk, q_offset,
                           k_offset, causal, window, scale, s);
}

extern "C" const char* etpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
