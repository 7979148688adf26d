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
// What bounds it on the H100. Decode reads every live K/V byte once
// for ~4 * groups flops per element, far below the card's ~295
// flops-per-byte balance point: it is bound by bytes. At the serving
// shape (B 8, 16 kv heads, block 16, head_dim 64, positions 64-576) the
// live K/V is 11 MB, 3.3 us at 3.35 TB/s; only many loads in flight
// on every SM come near that.
//
// Design, bf16 at head_dim 64 with groups 1, 2 or 4 (the working type;
// flash-decoding):
// - Split-K. The grid is (splits, KVH, B): split s owns table entries
//   [s*L, s*L + L) of its row, L from the wrapper (from max_blocks and
//   the shape, never from pos: reading pos back to the host would cost
//   more than the kernel). Each CTA reads its own pos[b] and clips its
//   run to the row's live blocks, from the window's first block to
//   pos / bs; a CTA with nothing live exits before any other read, so
//   no table entry past pos / bs is ever read (entries past the row's
//   allocation are not valid block ids).
// - Loads in flight. Each 16-byte chunk of a (block, kv head) K or V
//   slab (bs x 64 contiguous bf16) is copied by one thread with
//   cp.async into a 4-stage ring in shared memory, 4 blocks ahead of the
//   math. The thread that copies a chunk is the only one that reads it,
//   so the loop has no barrier: cp.async.wait_group alone orders it.
// - Math on every thread. 8 lanes x 16 bytes hold one key row; a warp
//   scores 4 keys at once (8-term dot products, then shuffles inside
//   each 8-lane group), for all G query heads of the kv head on the same
//   loaded row. Each 8-lane group keeps its own online softmax in f32
//   (in base 2, one ex2 per key: the larger of the old max and the new
//   score gets weight 1) and its 8 columns of the accumulator; P enters
//   P.V cast to bf16 (the TPU kernel's `p.astype(v.dtype)`), the row sum
//   stays f32. At the end the 16 groups merge: shuffles inside a warp,
//   then the 4 warps through shared memory, in a fixed order.
// - Merge. One split writes acc / max(l, 1e-30) as the output. With
//   more, each writes its (m, l, acc[64]) in f32 to a workspace the
//   wrapper allocates, and a second small kernel (one warp per query
//   head) takes the live splits in index order: m* = max m_i, l = sum
//   l_i 2^(m_i - m*), o = sum acc_i 2^(m_i - m*) / max(l, 1e-30); a split
//   with no valid key (m = -inf) weighs 0. No atomics: two launches give
//   the same bits.
//
// f32 (and bf16 at other head dims, group sizes or unaligned operands):
// one CTA of 128 threads per (row, kv head) loops over the live blocks,
// staging each K and V block in shared memory as f32 with four barriers
// a block.
#include "common.cuh"
#include "hopper.cuh"

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

// --------------------------------------- bf16 split-K (flash-decoding)
namespace split {

using bf16 = __nv_bfloat16;
constexpr int D = 64;
constexpr int THREADS = 128;  // 16 groups of 8 lanes, one key row each
constexpr int STAGES = 4;     // blocks in flight per CTA
constexpr int REC = D + 2;    // workspace record: m (base 2), l, acc[D]

// The row's live blocks [j_lo, j_hi] (empty when j_lo > j_hi): j*bs <=
// pos, and with a window j*bs + bs - 1 > pos - window, as the TPU
// kernel's `live`.
__device__ __forceinline__ void live_blocks(int p, int window, int bs,
                                            int MB, int& j_lo, int& j_hi) {
  j_hi = min(p / bs, MB - 1);
  j_lo = 0;
  if (window > 0) {
    const int t = p - window - bs + 1;
    j_lo = t < 0 ? 0 : t / bs + 1;
  }
}

__device__ __forceinline__ void bf16x8_to_f32(const uint4& u,
                                              float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The weight of an online-softmax state of maximum m (base 2) against a
// joint maximum of several; a state with no valid key (-inf) weighs 0.
__device__ __forceinline__ float weight(float m, float m_joint) {
  return m == -INFINITY ? 0.f : exp2_ftz(m - m_joint);
}

inline size_t smem_bytes(int G, int bs) {
  // the K and V ring, then the 4 warps' (m, l, acc[D]) per query head
  return (size_t)STAGES * 2 * bs * D * sizeof(bf16) +
         sizeof(float) * 4 * (size_t)G * REC;
}

template <int G>
__global__ void __launch_bounds__(THREADS)
    paged_split_kernel(const bf16* __restrict__ q,
                       const bf16* __restrict__ kpool,
                       const bf16* __restrict__ vpool,
                       const int* __restrict__ tables,
                       const int* __restrict__ pos,
                       const float* __restrict__ slopes,
                       bf16* __restrict__ out, float* __restrict__ ws,
                       int H, int KVH, int bs, int MB, int L, int window,
                       float scale_log2) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // [stage][K|V][bs][D]
  float* part = reinterpret_cast<float*>(smem_raw + (size_t)STAGES * 2 *
                                                        bs * D * sizeof(bf16));

  const int s = blockIdx.x, n = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c = tid % 8;   // the thread's 16-byte chunk: columns 8c..8c+7
  const int rg = tid / 8;  // its key rows: rg, rg + 16, ...
  const int p = pos[b];
  int j_lo, j_hi;
  live_blocks(p, window, bs, MB, j_lo, j_hi);
  const int j0 = max(s * L, j_lo), j1 = min(s * L + L - 1, j_hi);
  const size_t orow = (size_t)b * H + n * G;  // first query head's row
  if (j0 > j1) {
    // nothing of this split is live; alone (one split) it still owns the
    // output, which is then 0 as in the generic body
    if (nsplit == 1)
      for (int i = tid; i < G * D; i += THREADS)
        out[orow * D + i] = __float2bfloat16(0.f);
    return;
  }
  const int* row_table = tables + (size_t)b * MB;
  const size_t slab = (size_t)bs * D;

  // this thread's chunks of block jj into ring stage st (a group per
  // block, empty past the run, so wait_group counts blocks)
  auto issue = [&](int jj, int st) {
    if (jj <= j1) {
      const size_t base = ((size_t)row_table[jj] * KVH + n) * slab;
      bf16* ks = ring + (size_t)st * 2 * slab;
      for (int r = rg; r < bs; r += 16) {
        const size_t off = (size_t)r * D + c * 8;
        cp_async_16(ks + off, kpool + base + off);
        cp_async_16(ks + slab + off, vpool + base + off);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < STAGES; ++i) issue(j0 + i, i);

  // q (pre-scaled into base 2), the ALiBi slopes in base 2, and the
  // group's online-softmax state for each of the G query heads
  float qf[G][8], sl2[G], m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint4 u =
        *reinterpret_cast<const uint4*>(q + (orow + g) * D + c * 8);
    bf16x8_to_f32(u, qf[g]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      qf[g][i] *= scale_log2;
      acc[g][i] = 0.f;
    }
    sl2[g] = slopes != nullptr ? slopes[n * G + g] * kLog2e : 0.f;
    m[g] = -INFINITY;
    l[g] = 0.f;
  }

  for (int jj = j0, it = 0; jj <= j1; ++jj, ++it) {
    const int st = it % STAGES;
    cp_async_wait<STAGES - 1>();  // this thread's chunks of block jj
    const bf16* ks = ring + (size_t)st * 2 * slab;
    for (int r0 = 0; r0 < bs; r0 += 16) {
      // every lane runs the shuffles; rows past bs weigh nothing
      const int r = r0 + rg;
      const bool in = r < bs;
      float kf[8], vf[8];
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      bf16x8_to_f32(in ? *reinterpret_cast<const uint4*>(ks + r * D + c * 8)
                       : zero, kf);
      bf16x8_to_f32(in ? *reinterpret_cast<const uint4*>(ks + slab + r * D +
                                                         c * 8)
                       : zero, vf);
      const int kpos = jj * bs + r;
      const bool valid =
          in && kpos <= p && (window <= 0 || kpos > p - window);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float sc = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) sc = fmaf(qf[g][i], kf[i], sc);
        sc += __shfl_xor_sync(0xffffffffu, sc, 1);
        sc += __shfl_xor_sync(0xffffffffu, sc, 2);
        sc += __shfl_xor_sync(0xffffffffu, sc, 4);
        if (!valid) continue;  // uniform over the 8-lane group
        sc -= sl2[g] * (float)(p - kpos);
        // one ex2 a key: the larger of the running max and the score
        // weighs 1, the other 2^-(their distance); from m = -inf the
        // correction is 0
        const float diff = sc - m[g];
        const float e = exp2_ftz(-fabsf(diff));
        const bool up = diff > 0.f;
        const float corr = up ? e : 1.f, pr = up ? 1.f : e;
        m[g] = up ? sc : m[g];
        l[g] = fmaf(l[g], corr, pr);
        const float pv = round_to<bf16>(pr);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[g][i] = fmaf(acc[g][i], corr,
                                                     pv * vf[i]);
      }
    }
    issue(jj + STAGES, st);  // refill the stage this thread just read
  }
  cp_async_wait<0>();

  // merge the 4 groups of each warp (lanes ^8, ^16), then the 4 warps
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int o = 8; o <= 16; o *= 2) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mj = fmaxf(m[g], mo);
      const float wa = weight(m[g], mj), wb = weight(mo, mj);
      l[g] = l[g] * wa + lo * wb;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][i], o);
        acc[g][i] = acc[g][i] * wa + ao * wb;
      }
      m[g] = mj;
    }
  if (lane < 8) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float* rec = part + (warp * G + g) * REC;
      if (lane == 0) {
        rec[0] = m[g];
        rec[1] = l[g];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) rec[2 + c * 8 + i] = acc[g][i];
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float mj = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) mj = fmaxf(mj, part[(w * G + g) * REC]);
    float ls = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float* rec = part + (w * G + g) * REC;
      const float wt = weight(rec[0], mj);
      ls += rec[1] * wt;
      a += rec[2 + d] * wt;
    }
    if (nsplit == 1) {
      out[(orow + g) * D + d] = __float2bfloat16(a / fmaxf(ls, 1e-30f));
    } else {
      float* rec = ws + ((orow + g) * nsplit + s) * REC;
      if (d == 0) {
        rec[0] = mj;
        rec[1] = ls;
      }
      rec[2 + d] = a;
    }
  }
}

// One warp per (row, query head): the live splits' records in index
// order -> the output.
__global__ void __launch_bounds__(128)
    paged_merge_kernel(const float* __restrict__ ws,
                       const int* __restrict__ pos, bf16* __restrict__ out,
                       int B, int H, int bs, int MB, int L, int nsplit,
                       int window) {
  const int w = (blockIdx.x * 128 + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= B * H) return;
  int j_lo, j_hi;
  live_blocks(pos[w / H], window, bs, MB, j_lo, j_hi);
  const float* recs = ws + (size_t)w * nsplit * REC;
  const int s_lo = j_lo / L, s_hi = j_lo > j_hi ? s_lo - 1 : j_hi / L;
  float mj = -INFINITY;
  for (int s = s_lo; s <= s_hi; ++s) mj = fmaxf(mj, recs[s * REC]);
  float ls = 0.f, a0 = 0.f, a1 = 0.f;
  for (int s = s_lo; s <= s_hi; ++s) {
    const float* rec = recs + s * REC;
    const float wt = weight(rec[0], mj);
    ls += rec[1] * wt;
    a0 += rec[2 + lane] * wt;
    a1 += rec[2 + 32 + lane] * wt;
  }
  const float denom = fmaxf(ls, 1e-30f);
  out[(size_t)w * D + lane] = __float2bfloat16(a0 / denom);
  out[(size_t)w * D + 32 + lane] = __float2bfloat16(a1 / denom);
}

template <int G>
cudaError_t launch_g(const void* q, const void* kpool, const void* vpool,
                     const int* tables, const int* pos, const float* slopes,
                     void* out, float* ws, int B, int H, int KVH, int bs,
                     int MB, int L, int window, float scale,
                     cudaStream_t stream) {
  const int nsplit = (MB + L - 1) / L;
  const size_t smem = smem_bytes(G, bs);
  auto kernel = paged_split_kernel<G>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(nsplit, KVH, B), THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kpool),
      static_cast<const bf16*>(vpool), tables, pos, slopes,
      static_cast<bf16*>(out), ws, H, KVH, bs, MB, L, window,
      scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  paged_merge_kernel<<<(B * H + 3) / 4, 128, 0, stream>>>(
      ws, pos, static_cast<bf16*>(out), B, H, bs, MB, L, nsplit, window);
  return cudaGetLastError();
}

// Whether the split body takes this call: bf16 rows of 64, a group
// size it is instantiated for, 16-byte aligned operands, and a
// workspace whenever there is more than one split.
bool takes(int H, int KVH, int D_, int MB, int L, const void* q,
           const void* kpool, const void* vpool, const void* ws) {
  const int G = H / KVH;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(kpool) |
                         reinterpret_cast<uintptr_t>(vpool);
  return D_ == D && (G == 1 || G == 2 || G == 4) && L > 0 &&
         (bits & 15) == 0 && (ws != nullptr || L >= MB);
}

cudaError_t launch(const void* q, const void* kpool, const void* vpool,
                   const int* tables, const int* pos, const float* slopes,
                   void* out, float* ws, int B, int H, int KVH, int bs,
                   int MB, int L, int window, float scale,
                   cudaStream_t stream) {
  switch (H / KVH) {
    case 1:
      return launch_g<1>(q, kpool, vpool, tables, pos, slopes, out, ws, B,
                         H, KVH, bs, MB, L, window, scale, stream);
    case 2:
      return launch_g<2>(q, kpool, vpool, tables, pos, slopes, out, ws, B,
                         H, KVH, bs, MB, L, window, scale, stream);
    default:
      return launch_g<4>(q, kpool, vpool, tables, pos, slopes, out, ws, B,
                         H, KVH, bs, MB, L, window, scale, stream);
  }
}

}  // namespace split

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
// block id. The bf16 split body (see the note at the top) runs splits of
// `split_blocks` table entries and, with more than one split, needs
// `workspace`: B * H * ceil(MB / split_blocks) * (D + 2) floats; other
// calls ignore both. Returns cudaGetLastError() after the last launch.
extern "C" int etpu_paged_decode(const void* q, const void* kpool,
                                 const void* vpool, const void* tables,
                                 const void* pos, const void* slopes,
                                 void* out, int B, int H, int KVH, int bs,
                                 int D, int MB, int window, float scale,
                                 int is_bf16, void* workspace,
                                 int split_blocks, void* stream) {
  if (B == 0) return cudaSuccess;
  if (KVH <= 0 || H % KVH || bs <= 0 || MB <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* t = static_cast<const int*>(tables);
  auto* ps = static_cast<const int*>(pos);
  auto* sl = static_cast<const float*>(slopes);
  auto* ws = static_cast<float*>(workspace);
  if (is_bf16 && split::takes(H, KVH, D, MB, split_blocks, q, kpool, vpool,
                              ws))
    return split::launch(q, kpool, vpool, t, ps, sl, out, ws, B, H, KVH, bs,
                         MB, split_blocks, window, scale, s);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, kpool, vpool, t, ps, sl, out, B, H, KVH,
                                 bs, D, MB, window, scale, s);
  return launch<float>(q, kpool, vpool, t, ps, sl, out, B, H, KVH, bs, D, MB,
                       window, scale, s);
}
