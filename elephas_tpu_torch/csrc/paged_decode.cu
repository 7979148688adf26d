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
// What bounds it on the H100. Decode reads every live K/V element once
// for about 4 * G flops (G query heads per kv head: a dot product and a
// P.V term each), far below the card's ~295 flops-per-byte balance
// point: it is bound by bytes, so the tensor cores have nothing to do.
// At the serving shapes (B 8, block 16, positions 64-576; 16 kv heads
// at D 64, or Mistral-7B's 8 kv heads over 32 query heads at D 128)
// the live K/V is about 11 MB, 3.3 us at 3.35 TB/s; only many loads in
// flight on every SM come near that.
//
// Two bodies; the wrapper (ops/paged_attention.py `paged_body`) picks
// one and passes it in `body`, and a call the chosen body cannot take
// fails (cudaErrorInvalidValue) instead of running the other.
//
// The split body: bf16 at every head dim D that is a multiple of 8 from
// 16 to 256, with groups of 1, 2, 4 or 8 (the working type;
// flash-decoding), templated on a body width W and G. D runs the body
// of the smallest W >= D of 16, 32, 64, 128 and 256 (the flash kernels'
// `with_head_dim`), D at run time: Phi-3-mini's 96 and Phi-2's 80 on W
// 128, 136-256 (Gemma-2B's 256) on W 256.
// - Split-K. The grid is (splits, KVH, B): split s owns table entries
//   [s*L, s*L + L) of its row, L from the wrapper (`split_blocks`, from
//   max_blocks and the shape, never from pos: reading pos back to the
//   host would cost more than the kernel). Each CTA reads its own pos[b]
//   and clips its run to the row's live blocks, from the window's first
//   block to pos / bs; a CTA with nothing live exits before any other
//   read, so no table entry past pos / bs is ever read (entries past
//   the row's allocation are not valid block ids). The run's table
//   entries are staged in shared memory once (one barrier), so no copy
//   waits on a table read.
// - Lanes per key row from W. A bf16 row of the body is W / 8 chunks of
//   16 bytes: LANES = 32 lanes (a warp) hold a row at W 256, 16 at 128,
//   8 at 64, 4 at 32, 2 at 16, so one pass of a CTA's THREADS (128; 256
//   at groups of 8) covers THREADS / LANES key rows: 4, 8, 16, 32 or 64
//   at 128 threads. A thread whose chunk lies past the head dim (c >= D
//   / 8: chunks 12-15 at D 96) issues no copy, holds zeros in q, K and V
//   and adds 0 to the shuffle sums; pool rows stay D wide. The run's
//   rows are taken as one sequence (row i at position j0 * bs + i, in
//   table entry j0 + i / bs), so at small W one pass spans several
//   blocks (four of 16 at W 16) and every thread has a row whatever the
//   block size.
// - Loads in flight. A ring stage in shared memory holds one pass: its
//   K rows then its V rows, W columns apart, 4 KB at 128 threads and 8
//   KB at 256. Each thread copies the two 16-byte chunks it will read
//   (cp.async), STAGES passes ahead of the math, at least 64 rows: at
//   128 threads 16 stages at W 256 and 8 at W 128 (64 and 32 KB), 4
//   below (16 KB); at 256 threads 8 at W 256 (64 KB), 4 below. The
//   thread that copies a chunk is the only one that reads it, so the
//   loop has no barrier: cp.async.wait_group alone orders it.
// - Math on every thread. A row's LANES lanes take 8-term dot products
//   for all G query heads of the kv head on the same loaded row and sum
//   them with log2(LANES) levels of shuffles, each level over all G
//   scores at once (G independent chains, not G in a row). Each row
//   group keeps its own online softmax in f32 (base 2, one ex2 per key:
//   the larger of the old max and the new score gets weight 1) and its
//   8 columns of the accumulator (qf[G][8] and acc[G][8] a thread at
//   every W); P enters P.V cast to bf16 (the TPU kernel's
//   `p.astype(v.dtype)`), the row sum stays f32. At the end the row
//   groups merge: shuffles inside a warp, then the warps through shared
//   memory in a fixed order, each head's warp weights computed once:
//   their (m, l, acc[W]) records reuse the ring's bytes after one
//   barrier, so a CTA holds the larger of the two (at W 256 and G 8 the
//   8 warps' records, 66 KB, against a 64 KB ring) and the run's table
//   entries.
// - Groups of 8. qf[8][8] and acc[8][8] alone are 128 floats a thread,
//   the whole budget of 4 CTAs of 128 threads an SM
//   (`__launch_bounds__(128, 4)`: 128 registers), so G 8 takes a CTA of
//   its own: 256 threads, one CTA an SM, up to 255 registers a thread
//   (ptxas takes 246-254 and spills nothing; chip_smoke's build line
//   reports each instantiation). At Gemma-2B's decode step (B 8, one kv
//   head) only 47-72 CTAs are live, so 8 warps a CTA halve each CTA's
//   passes against 4; where CTAs are many (Llama-2-70B's 8 kv heads) one
//   CTA of 8 warps an SM keeps as many warps as two of 4. Chosen over
//   two CTAs of 4 heads each (every K/V row read twice, the second from
//   L2) and over mma.sync with the 8 heads padded to 16 rows (half of
//   every product wasted, and a layout unlike the lane-per-chunk
//   softmax of the other groups): the bytes stay read once.
// - Merge. One split writes acc / max(l, 1e-30) as the output. With
//   more, each writes its (m, l, acc[D]) in f32 (`ws_record`: D + 2
//   floats) to a workspace the wrapper allocates, and a second small
//   kernel (one warp per query head and 32 columns, so D 256 at B 8 x H
//   8 gets 512 warps, not 64) reduces the live splits' m and l across
//   its lanes in a fixed tree, then sums each column over the splits in
//   index order: m* = max m_i, l = sum l_i 2^(m_i - m*), o = sum acc_i
//   2^(m_i - m*) / max(l, 1e-30); a split with no valid key (m = -inf)
//   weighs 0. No atomics: two launches give the same bits.
//
// The general body: f32 at any D, and bf16 where the split body does
// not reach: D 8, head dims that are not multiples of 8 (or above 256),
// groups outside {1, 2, 4, 8}. One CTA of 128 threads per (row, kv
// head) loops over the live blocks, staging each K and V block in
// shared memory as f32 with four barriers a block. It stays for f32
// because f32 is the parity path, held within 1e-4 of the plain
// version, not the type any timed path serves in: a split body for it
// would double the variants above (a 16-byte chunk holds 4 f32, so the
// lane layout differs) for no path that waits on it. f32 is also the
// only type the `examples/http_serving.py` d 16 engine runs, so that
// engine stays on this body.
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

// The layout at body width W and groups of G (see the note at the top):
// THREADS threads a CTA (128 at G <= 4, 4 CTAs an SM; 256 at G 8, one
// CTA an SM), LANES lanes of 16 bytes hold a key row of up to W columns,
// a pass of the CTA covers ROWS rows, a ring stage holds one pass (K
// rows, then V rows, W columns apart: 4 KB at 128 threads, 8 KB at 256),
// STAGES passes are in flight (at least 64 rows), and a warp's record in
// shared memory is (m, l, acc[W]).
template <int W, int G>
struct Layout {
  static constexpr int THREADS = G >= 8 ? 256 : 128;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int LANES = W / 8;
  static constexpr int ROWS = THREADS / LANES;
  static constexpr int STAGES = ROWS >= 16 ? 4 : 64 / ROWS;
  static constexpr int STAGE = 2 * ROWS * W;  // bf16 elements
  static constexpr int REC = W + 2;
  static_assert(LANES >= 2 && LANES <= 32 && ROWS * LANES == THREADS,
                "a key row is 2 to 32 chunks of 16 bytes");
};

// A split's record in the workspace, at head dim D: (m, l, acc[D]) in
// f32. The wrapper sizes the workspace by the same formula
// (ops/paged_attention.py `paged_decode_attention`).
__host__ __device__ __forceinline__ int ws_record(int D) { return D + 2; }

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

// The K/V ring, and after the last pass in the same bytes the warps'
// (m, l, acc[W]) per query head and each head's warp weights, m and l;
// then the run's table entries.
template <int W, int G>
__host__ __device__ constexpr size_t ring_bytes() {
  using Lay = Layout<W, G>;
  const size_t ring = (size_t)Lay::STAGES * Lay::STAGE * sizeof(bf16);
  const size_t part =
      sizeof(float) * (size_t)G * (Lay::WARPS * Lay::REC + Lay::WARPS + 2);
  return ring > part ? ring : part;
}

template <int W, int G>
inline size_t smem_bytes(int L) {
  return ring_bytes<W, G>() + sizeof(int) * L;
}

// 4 CTAs of 128 threads an SM for groups of up to 4 (up to 128
// registers a thread; G 4 takes about 126); one CTA of 256 threads for
// groups of 8, whose qf[8][8] and acc[8][8] alone are 128 floats a
// thread (up to 255 registers), so ptxas never trades a spill for
// occupancy
template <int W, int G>
__global__ void __launch_bounds__(Layout<W, G>::THREADS, G >= 8 ? 1 : 4)
    paged_split_kernel(const bf16* __restrict__ q,
                       const bf16* __restrict__ kpool,
                       const bf16* __restrict__ vpool,
                       const int* __restrict__ tables,
                       const int* __restrict__ pos,
                       const float* __restrict__ slopes,
                       bf16* __restrict__ out, float* __restrict__ ws,
                       int H, int KVH, int bs, int D, int MB, int L,
                       int window, float scale_log2) {
  using Lay = Layout<W, G>;
  constexpr int THREADS = Lay::THREADS, WARPS = Lay::WARPS;
  constexpr int LANES = Lay::LANES, ROWS = Lay::ROWS;
  constexpr int STAGES = Lay::STAGES, REC = Lay::REC;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // [stage][K|V][ROWS][W]
  float* part = reinterpret_cast<float*>(smem_raw);  // after the loop
  int* tbl = reinterpret_cast<int*>(smem_raw + ring_bytes<W, G>());

  const int s = blockIdx.x, n = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c = tid % LANES;   // the thread's 16-byte chunk: columns 8c..
  const int rg = tid / LANES;  // its row of each pass
  // a chunk past the head dim (D < W) is never copied or read: its
  // thread holds zeros and adds 0 to every shuffle sum
  const bool has = c < D / 8;
  const int p = pos[b];
  int j_lo, j_hi;
  live_blocks(p, window, bs, MB, j_lo, j_hi);
  const int j0 = max(s * L, j_lo), j1 = min(s * L + L - 1, j_hi);
  const size_t orow = (size_t)b * H + n * G;  // first query head's row
  if (j0 > j1) {
    // nothing of this split is live; alone (one split) it still owns the
    // output, which is then 0 as in the general body
    if (nsplit == 1)
      for (int i = tid; i < G * D; i += THREADS)
        out[orow * D + i] = __float2bfloat16(0.f);
    return;
  }
  const int nblk = j1 - j0 + 1;
  const int rows = nblk * bs;  // the run's key rows: row i at j0*bs + i
  for (int i = tid; i < nblk; i += THREADS)
    tbl[i] = tables[(size_t)b * MB + j0 + i];
  __syncthreads();
  const size_t slab = (size_t)bs * D;

  // this thread's chunk of pass t into ring stage st (a group per pass,
  // empty past the run, so wait_group counts passes)
  auto issue = [&](int t, int st) {
    const int i = t * ROWS + rg;
    if (has && i < rows) {
      const int jb = i / bs, r = i - jb * bs;
      const size_t src =
          ((size_t)tbl[jb] * KVH + n) * slab + (size_t)r * D + c * 8;
      bf16* dst = ring + st * Lay::STAGE + rg * W + c * 8;
      cp_async_16(dst, kpool + src);
      cp_async_16(dst + ROWS * W, vpool + src);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < STAGES; ++t) issue(t, t);

  // q (pre-scaled into base 2), the ALiBi slopes in base 2, and the row
  // group's online-softmax state for each of the G query heads
  float qf[G][8], sl2[G], m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (has) u = *reinterpret_cast<const uint4*>(q + (orow + g) * D + c * 8);
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

  const int passes = (rows + ROWS - 1) / ROWS;
  for (int t = 0; t < passes; ++t) {
    const int st = t % STAGES;
    cp_async_wait<STAGES - 1>();  // this thread's chunks of pass t
    // every lane runs the shuffles; rows past the run weigh nothing
    const int i = t * ROWS + rg;
    const bool in = i < rows;
    const bf16* kr = ring + st * Lay::STAGE + rg * W + c * 8;
    uint4 ku = make_uint4(0u, 0u, 0u, 0u), vu = ku;
    if (in && has) {
      ku = *reinterpret_cast<const uint4*>(kr);
      vu = *reinterpret_cast<const uint4*>(kr + ROWS * W);
    }
    float kf[8], vf[8];
    bf16x8_to_f32(ku, kf);
    bf16x8_to_f32(vu, vf);
    const int kpos = j0 * bs + i;
    const bool valid =
        in && kpos <= p && (window <= 0 || kpos > p - window);
    // the G scores, each shuffle level over all G at once (G independent
    // chains in flight, not G chains one after another)
    float sc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sc[g] = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) sc[g] = fmaf(qf[g][e], kf[e], sc[g]);
    }
#pragma unroll
    for (int o = 1; o < LANES; o *= 2)
#pragma unroll
      for (int g = 0; g < G; ++g)
        sc[g] += __shfl_xor_sync(0xffffffffu, sc[g], o);
    if (valid) {  // uniform over the row's lanes
      const float dist = (float)(p - kpos);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float s2 = sc[g] - sl2[g] * dist;
        // one ex2 a key: the larger of the running max and the score
        // weighs 1, the other 2^-(their distance); from m = -inf the
        // correction is 0
        const float diff = s2 - m[g];
        const float e = exp2_ftz(-fabsf(diff));
        const bool up = diff > 0.f;
        const float corr = up ? e : 1.f, pr = up ? 1.f : e;
        m[g] = up ? s2 : m[g];
        l[g] = fmaf(l[g], corr, pr);
        const float pv = round_to<bf16>(pr);
#pragma unroll
        for (int x = 0; x < 8; ++x)
          acc[g][x] = fmaf(acc[g][x], corr, pv * vf[x]);
      }
    }
    issue(t + STAGES, st);  // refill the stage this thread just read
  }
  cp_async_wait<0>();

  // merge the row groups of each warp (lanes ^LANES .. ^16), then the
  // warps through the ring's bytes, once every warp is past the loop
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int o = LANES; o < 32; o *= 2) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mj = fmaxf(m[g], mo);
      const float wa = weight(m[g], mj), wb = weight(mo, mj);
      l[g] = l[g] * wa + lo * wb;
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][x], o);
        acc[g][x] = acc[g][x] * wa + ao * wb;
      }
      m[g] = mj;
    }
  __syncthreads();
  if (lane < LANES) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float* rec = part + (warp * G + g) * REC;
      if (lane == 0) {
        rec[0] = m[g];
        rec[1] = l[g];
      }
#pragma unroll
      for (int x = 0; x < 8; ++x) rec[2 + c * 8 + x] = acc[g][x];
    }
  }
  __syncthreads();
  // each head's joint maximum, its warps' weights and its row sum, once:
  // wts[g] = (weight of warp 0 .. WARPS - 1, m, l)
  float* wts = part + WARPS * G * REC;
  if (tid < G) {
    float* wt = wts + tid * (WARPS + 2);
    float mj = -INFINITY, ls = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      mj = fmaxf(mj, part[(w * G + tid) * REC]);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float* rec = part + (w * G + tid) * REC;
      wt[w] = weight(rec[0], mj);
      ls += rec[1] * wt[w];
    }
    wt[WARPS] = mj;
    wt[WARPS + 1] = ls;
  }
  __syncthreads();
  const int wrec = ws_record(D);
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i - g * D;
    const float* wt = wts + g * (WARPS + 2);
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      a += part[(w * G + g) * REC + 2 + d] * wt[w];
    if (nsplit == 1) {
      out[(orow + g) * D + d] =
          __float2bfloat16(a / fmaxf(wt[WARPS + 1], 1e-30f));
    } else {
      float* rec = ws + ((orow + g) * nsplit + s) * wrec;
      if (d == 0) {
        rec[0] = wt[WARPS];
        rec[1] = wt[WARPS + 1];
      }
      rec[2 + d] = a;
    }
  }
}

// One warp per (row, query head, 32 columns): the live splits' records
// -> the output. The lanes read the splits' (m, l) side by side (lane i
// split s_lo + i, then + 32, ...) and reduce them in a fixed tree, so
// every warp of a head finds the same weights; then each lane sums its
// column (32 * slice + lane, if below D) over the splits in index order,
// eight splits' loads in flight at a time.
__global__ void __launch_bounds__(128)
    paged_merge_kernel(const float* __restrict__ ws,
                       const int* __restrict__ pos, bf16* __restrict__ out,
                       int B, int H, int D, int bs, int MB, int L,
                       int nsplit, int window) {
  const int slices = (D + 31) / 32;
  const int w = (blockIdx.x * 128 + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= B * H * slices) return;
  const int bh = w / slices, col = (w - bh * slices) * 32 + lane;
  const int wrec = ws_record(D);
  int j_lo, j_hi;
  live_blocks(pos[bh / H], window, bs, MB, j_lo, j_hi);
  const float* recs = ws + (size_t)bh * nsplit * wrec;
  const int s_lo = j_lo / L, s_hi = j_lo > j_hi ? s_lo - 1 : j_hi / L;
  float mj = -INFINITY;
  for (int s = s_lo + lane; s <= s_hi; s += 32)
    mj = fmaxf(mj, recs[s * wrec]);
#pragma unroll
  for (int o = 16; o > 0; o /= 2)
    mj = fmaxf(mj, __shfl_xor_sync(0xffffffffu, mj, o));
  float ls = 0.f;
  for (int s = s_lo + lane; s <= s_hi; s += 32)
    ls += recs[s * wrec + 1] * weight(recs[s * wrec], mj);
#pragma unroll
  for (int o = 16; o > 0; o /= 2)
    ls += __shfl_xor_sync(0xffffffffu, ls, o);
  if (col >= D) return;
  float a = 0.f;
#pragma unroll 8
  for (int s = s_lo; s <= s_hi; ++s) {
    const float* rec = recs + s * wrec;
    a += rec[2 + col] * weight(rec[0], mj);
  }
  out[(size_t)bh * D + col] = __float2bfloat16(a / fmaxf(ls, 1e-30f));
}

template <int W, int G>
cudaError_t launch_wg(const void* q, const void* kpool, const void* vpool,
                      const int* tables, const int* pos,
                      const float* slopes, void* out, float* ws, int B,
                      int H, int KVH, int bs, int D, int MB, int L,
                      int window, float scale, cudaStream_t stream) {
  const int nsplit = (MB + L - 1) / L;
  const size_t smem = smem_bytes<W, G>(L);
  auto kernel = paged_split_kernel<W, G>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(nsplit, KVH, B), Layout<W, G>::THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kpool),
      static_cast<const bf16*>(vpool), tables, pos, slopes,
      static_cast<bf16*>(out), ws, H, KVH, bs, D, MB, L, window,
      scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  const int warps = B * H * ((D + 31) / 32);
  paged_merge_kernel<<<(warps + 3) / 4, 128, 0, stream>>>(
      ws, pos, static_cast<bf16*>(out), B, H, D, bs, MB, L, nsplit, window);
  return cudaGetLastError();
}

// Whether the split body can take this call (the wrapper's
// `paged_body` mirrors it): bf16 rows at a head dim that is a multiple
// of 8 from 16 to 256 and groups of 1, 2, 4 or 8, 16-byte aligned
// operands, and a workspace whenever there is more than one split.
bool takes(int H, int KVH, int D, int MB, int L, const void* q,
           const void* kpool, const void* vpool, const void* ws) {
  const int G = H / KVH;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(kpool) |
                         reinterpret_cast<uintptr_t>(vpool);
  return D >= 16 && takes_head_dim(D) &&
         (G == 1 || G == 2 || G == 4 || G == 8) && L > 0 &&
         (bits & 15) == 0 && (ws != nullptr || L >= MB);
}

cudaError_t launch(const void* q, const void* kpool, const void* vpool,
                   const int* tables, const int* pos, const float* slopes,
                   void* out, float* ws, int B, int H, int KVH, int bs,
                   int D, int MB, int L, int window, float scale,
                   cudaStream_t stream) {
  // the flash kernels' switch: D runs the body of the smallest width
  // W >= D, its chunks past D idle
  return with_head_dim(D, [&](auto w) {
    constexpr int Wc = decltype(w)::value;
    switch (H / KVH) {
      case 1:
        return launch_wg<Wc, 1>(q, kpool, vpool, tables, pos, slopes, out,
                                ws, B, H, KVH, bs, D, MB, L, window, scale,
                                stream);
      case 2:
        return launch_wg<Wc, 2>(q, kpool, vpool, tables, pos, slopes, out,
                                ws, B, H, KVH, bs, D, MB, L, window, scale,
                                stream);
      case 4:
        return launch_wg<Wc, 4>(q, kpool, vpool, tables, pos, slopes, out,
                                ws, B, H, KVH, bs, D, MB, L, window, scale,
                                stream);
      case 8:
        return launch_wg<Wc, 8>(q, kpool, vpool, tables, pos, slopes, out,
                                ws, B, H, KVH, bs, D, MB, L, window, scale,
                                stream);
      default:
        return cudaErrorInvalidValue;
    }
  });
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
// block id. `body` is the wrapper's choice (see the note at the top):
// 1 the split body, which runs splits of `split_blocks` table entries
// and, with more than one split, needs `workspace`: B * H *
// ceil(MB / split_blocks) * (D + 2) floats (`split::ws_record`); 0
// the general body, which
// ignores both. A call the chosen body cannot take returns
// cudaErrorInvalidValue and launches nothing. Returns cudaGetLastError()
// after the last launch.
extern "C" int etpu_paged_decode(const void* q, const void* kpool,
                                 const void* vpool, const void* tables,
                                 const void* pos, const void* slopes,
                                 void* out, int B, int H, int KVH, int bs,
                                 int D, int MB, int window, float scale,
                                 int is_bf16, int body, void* workspace,
                                 int split_blocks, void* stream) {
  if (B == 0) return cudaSuccess;
  if (KVH <= 0 || H % KVH || bs <= 0 || MB <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* t = static_cast<const int*>(tables);
  auto* ps = static_cast<const int*>(pos);
  auto* sl = static_cast<const float*>(slopes);
  auto* ws = static_cast<float*>(workspace);
  if (body == 1) {
    if (!is_bf16 || !split::takes(H, KVH, D, MB, split_blocks, q, kpool,
                                  vpool, ws))
      return cudaErrorInvalidValue;
    return split::launch(q, kpool, vpool, t, ps, sl, out, ws, B, H, KVH, bs,
                         D, MB, split_blocks, window, scale, s);
  }
  if (body != 0) return cudaErrorInvalidValue;
  if (is_bf16)
    return launch<__nv_bfloat16>(q, kpool, vpool, t, ps, sl, out, B, H, KVH,
                                 bs, D, MB, window, scale, s);
  return launch<float>(q, kpool, vpool, t, ps, sl, out, B, H, KVH, bs, D, MB,
                       window, scale, s);
}
