// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` in
// elephas_tpu/ops/pallas_attention.py (launched by `_fwd`): the
// flash-attention-2 forward with f32 online softmax, causal and
// sliding-window masks with whole-tile skipping, ragged lengths, GQA
// through the kv-row map, and global q/k offsets for ring hops. It
// returns O and the per-row logsumexp (natural log); a fully masked row
// gets O = 0 and LSE ~ -1e30, so a cross-hop merge weights it to zero.
//
// Design. The TPU's sequential kv grid axis becomes a loop inside the
// CTA over K/V tiles; tiles wholly above the causal diagonal or below
// the window are skipped before any load. Ragged edges are masked in
// the kernel, never padded in device memory. Both bodies are
// instantiated at widths 16, 32, 64, 128 and 256 (hopper.cuh
// `with_head_dim`), and a head dim d that is a multiple of 8 up to 256
// runs the body of the smallest width W >= d: 16, 32 and 64 are the head
// dims of the repo's configurations, 128 that of most published LMs
// (Llama-2-7B, Mistral-7B, Llama-3-8B), 256 that of Gemma-2B and -7B and
// GPT-J, and 96 (Phi-3-mini), 80 (Phi-2) or 72 (DiT-XL/2) run on the W
// 128 body, 136-248 on W 256, 40 (Stable Diffusion 1.x) on W 64, 8 on W
// 16. The tensor maps hold d: TMA reads each row's d columns
// and fills the tile's columns d .. W - 1 with zeros, the products run
// at W unchanged (zero columns add nothing to S and give zero columns
// of O), and the store writes O's first d columns; the f32 body loads
// zeros past d and stores none of them. The bodies:
//
// - bf16 (the working type) at width 64 (`flash_fwd_wgmma_kernel`): one
//   CTA per (batch*head, 128-row q tile), CTAs of the last q tiles (the
//   most live tiles under causal masking) scheduled first. One producer
//   warp issues TMA loads: Q once, then the live 128-row K and V tiles
//   into a 4-stage ring of shared memory guarded by full/empty
//   mbarriers; TMA zero-fills rows past each head's length. A tile row
//   is the body's 2*W bytes in the swizzle of that width (128, 64 or 32
//   bytes at W 64, 32, 16: hopper.cuh `Rows`). Two consumer warpgroups
//   of 64 query rows compute S = Q K^T with wgmma m64n128k16 (D/16 k
//   steps) from shared memory, run the online softmax on the wgmma
//   accumulator in registers (each row on the 4 threads of a quad; one
//   FMA and exp2 per score; the per-element mask only on tiles that hold
//   a masked pair), pack P to bf16 in registers (the TPU kernel's
//   `p.astype(v.dtype)`) and feed it as the register A operand of O +=
//   P V (m64nDk16, V MN-major). O stays in registers across the loop,
//   and leaves through a swizzled shared tile in 16-byte stores.
// - bf16 at widths 16 and 32 (`flash_fwd_narrow_kernel`): the same tiles,
//   products, softmax and store, shaped for what bounds these widths, the
//   softmax. Its exp2 runs on the special-function units, about 3.9 T a
//   second on an H100 SXM5 (Shah et al., 2024, FlashAttention-3): the 67.2 M
//   causal (q, k) pairs of B 8 x H 16 x S 1024 take 0.017 ms there, where
//   the bytes and the tensor cores' operations take 0.0102 ms at d 32 and
//   0.0052 at d 16. So the CTA is 16 warps, a producer warpgroup at 24
//   registers and three consumer warpgroups at 160 (`setmaxnreg`; 512
//   threads launch at 128): three consumer warps a scheduler, where the
//   width-64 body has two, to hide the softmax's dependent latencies. A q
//   tile is 192 rows, 64 a warpgroup; K and V (128-key tiles, 4-8 KB) sit in
//   4-stage rings with full and empty barriers of their own, Q in a ring of
//   two. Each warpgroup walks its own run of the q tile's live K/V tiles (it
//   releases the tiles its rows do not meet once they land, so a warpgroup
//   of rows past the length does no products) and issues tile j's S with
//   tile j-1's P V, running j's softmax (4 max and sum chains a row, the
//   scale folded into the exp2's FMA, the two-compare mask only on tiles
//   that hold a masked pair) while P V is in flight. Every product is issued
//   unconditionally (one in flight where two paths meet makes ptxas
//   serialize every wgmma, C7515). The warpgroups run free: turns on named
//   barriers, as at width 128, would alternate the softmaxes, and at these
//   widths the softmax is the bound (a build with turns ran 15% slower at B
//   8: PERF.md). The schedule goes by shape, as at width 256: where the q
//   tiles fill at most one wave of the SMs (`tpu_model_lm_d32`'s B 16 x H 8
//   x S 128: 128), one CTA a q tile, heaviest first; where they fill more (B
//   8 x H 16 x S 1024: 768), persistent, one CTA an SM over pairs of q
//   tiles, the t-th heaviest with the t-th lightest, a ragged last tile (S
//   1024 leaves 64 rows) ranked by its rows x live tiles
//   (`narrow_ragged_rank`). Every head's K and V fit in L2 at these widths
//   (16.8 MB at d 32, B 8), so heads are not grouped. A q tile's O leaves
//   through a staging tile while the next tile's first S runs.
// - bf16 at width 128 (`flash_fwd_pingpong_kernel`): the same tiles,
//   products, softmax and store, each 256-byte row two 64-column blocks
//   of the 128-byte swizzle (P V one m64n64k16 per block). What bounds
//   it is registers: O (64 f32 a thread), S of a 128-key tile (64) and
//   P (32) do not fit the 168 a thread that a 288- or 384-thread CTA
//   gets. So the CTA is 12 warps: a producer warpgroup, whose warps drop
//   to 24 registers (`setmaxnreg`), and two consumer warpgroups that
//   rise to 240 (hopper.cuh). K and V sit in 2-stage rings of 32 KB
//   tiles with full and empty barriers of their own, so S starts when K
//   lands and K is released once S is done, V once P V is; Q in a ring
//   of two, so the next q tile's Q lands while this one runs. Three
//   producer warps load Q, K and V, each walking the work on its own
//   (one loader did not fit in 24 registers). A consumer issues tile
//   j's S and tile j-1's P V in one turn and runs j's softmax while P V
//   is still in flight (wait_group 1). The turns alternate between the
//   two warpgroups on named barriers (ping-pong): the tensor cores run
//   one warpgroup's products while the other does its softmax. Both
//   take a turn on each live tile, whether their own rows meet it or
//   not, so the turns always pair up. The softmax keeps 4 independent
//   max and sum chains a row; the mask is two compares per score
//   against each row's run of valid keys. The kernel is persistent, one
//   CTA per SM (225 KB of shared memory): each walks work items, a pair
//   of q tiles of one head (the t-th heaviest and the t-th lightest, so
//   every item holds the same work under causal masking), in groups of
//   heads whose K and V fit in L2. A q tile's O leaves through a staging
//   tile of its own while the next tile's first S runs, so neither a
//   CTA's start nor its store leaves the tensor cores idle. The
//   producer and consumers wait without a watchdog and warp 9 watches
//   the CTA (hopper.cuh `mbar_wait_spin`). ptxas: 168 registers at
//   launch, no spill.
// - bf16 at width 256 (`flash_fwd_w256_kernel`): the width-128
//   body's design. Each 512-byte row is four 64-column blocks of the
//   128-byte swizzle, S = Q K^T 16 k steps, P V one m64n64k16 per block.
//   O for a warpgroup's 64 rows at 256 columns is 128 f32 a thread, so
//   K/V tiles are 64 keys: S of a 64-key tile (32 f32) and the packed P
//   of the tile before (16) fit beside O in the consumers' 240 registers
//   where a 128-key tile's (64 and 32) would not. The same turns on named
//   barriers, the same S(j) with P V(j-1) in flight, the same three
//   loaders and watchdog warp. Shared memory: a 64-row Q tile for each
//   warpgroup (32 KB each), released by that warpgroup's last S of the q
//   tile, so the next q tile's rows land while it finishes; K and V in
//   2-stage rings of 32 KB tiles; and a 16 KB O staging tile for each
//   warpgroup: 225 KB. A second Q slot or a whole O staging tile (64 KB
//   each for the CTA's 128 rows) would pass the 227 KB, so O leaves in
//   two 128-column halves through the staging tile (`store_rows_w256`),
//   right after the q tile's last P V, while the other warpgroup's
//   products run. (Holding O for the next tile's first S, as at width
//   128, or storing bf16 pairs straight from the accumulator, took ptxas
//   past the consumers' 240 registers: it spilled.) The schedule goes
//   by shape: where the q tiles (128 rows a head) fill at most one wave
//   of the SMs (`lm_d256`'s B 2 x H 8 x S 1024: 128), one CTA a q tile,
//   heaviest first; where they fill more (B 8: 1024), persistent, one CTA
//   an SM over pairs of q tiles in groups of heads whose K and V fit in
//   L2 (`fwd_item`), as at width 128.
// - f32 at widths 64-256: 256 threads on the CUDA cores, each holding a
//   4x4 block of the 64x64 score tile and a 4x(D/16) block of O in
//   registers; row max and sum reduce over the 16 lanes sharing a row
//   with warp shuffles. At width 256 its four tiles take 209 KB of
//   shared memory.
// - f32 at widths 16 and 32 (`flash_fwd_f32_narrow_kernel`, below): a
//   warp a strip of 16 query rows walking only its live keys, operands by
//   cp.async in one round trip, 3xTF32 products on the tensor cores
//   (f32_narrow.cuh says why).
//
// At a head dim below its body's width W the tensor cores also multiply
// the filled zeros: W / d times the work at d, 1.33x at 96, 1.6x at 80,
// 1.78x at 72, 1.88x at 136 (on W 256). Bytes read from device memory
// stay those of d.
//
// What bounds it on the H100. A (q, k) pair costs 4*D flops and each
// operand row is read once per tile, so at head_dim 64 and 128 the loop
// is bound by operations (989 TFLOP/s in bf16). At 32 and 16 the products
// shrink with D while the softmax's FMA and exp2 per score do not, so
// the special-function units bound them (the narrow body, above). At D
// 64, within one consumer warpgroup the two products and the softmax run
// in sequence, and the second warpgroup and the ring's prefetch are what
// overlap them; at D 128 the turns and the in-flight P V do. At D 128
// and S 1024 a head's work is small (36 (q tile, K/V tile) steps under
// causal masking): K and V read again from HBM by each of a head's 8 q
// tiles, or a CTA's start and its store, cost as much as the softmax,
// which is why that body groups heads for L2 and persists. At D 256 a
// (q, k) pair costs 1024 flops against the softmax's same FMA and exp2,
// so the tensor cores bound it more than at 128; its turns put one
// warpgroup's softmax under the other's products, and at more than one
// wave of q tiles its persistence puts a CTA's start and a q tile's store
// under products too. Each 64-key tile brings 64 KB of K and V into the
// SM for 128 x 64 pairs: 128 flops a byte read from L2.
#include <type_traits>

#include "common.cuh"
#include "f32_narrow.cuh"
#include "hopper.cuh"

namespace etpu::f32n {

// ------------------------------------- f32 at widths 16 and 32: strips
// The design is f32_narrow.cuh's. A warp's strip is 16 query rows of one
// head; per step of 8 keys it forms the scores, runs the online softmax on
// the C fragments (a row's max over its quad: 2 shuffle steps; the
// exponent one exp2 of an FMA with the scale and log2 e folded in), and
// adds P V. The row sums stay per lane until the end.
template <int W>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd_f32_narrow_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                float* __restrict__ o,
                                float* __restrict__ lse, int BH,
                                FastDiv group, int Sq, int Sk, int hd,
                                int q_offset, int k_offset, int causal,
                                int window, float scale_log2) {
  Strip<W> strip;  // the warp's strip (fwd)
  using Smem = FwdSmem<W>;
  constexpr int L = LD<W>;
  extern __shared__ __align__(16) float smem_n[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // a CTA's warps take one strip of kWarps query heads; blockIdx.y counts
  // strips from a head's last, so the heaviest are scheduled first
  const int bh = blockIdx.x * kWarps + warp;
  if (bh >= BH) return;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * ROWS;
  // GQA: query row bh = b*H + h reads kv row b*KVH + h / group, which is
  // bh / group (H = KVH * group)
  const int kv_row = group(bh);
  const float* qp = q + (size_t)bh * Sq * hd;
  const float* kp = k + (size_t)kv_row * Sk * hd;
  const float* vp = v + (size_t)kv_row * Sk * hd;
  float* Qs = smem_n + warp * Smem::floats;
  float* ring = Qs + Smem::strip;  // stage slot s: K, then V

  // the lane's two rows' runs of keys, and the strip's walk
  int2 run[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    run[r] = key_run(r0 + g + 8 * r, Sq, Sk, q_offset, k_offset, causal,
                     window);
  const Walk<> walk(
      key_run(r0, Sq, Sk, q_offset, k_offset, causal, window),
      key_run(min(r0 + ROWS, Sq) - 1, Sq, Sk, q_offset, k_offset, causal,
              window));

  // one round trip: Q with the first stage, every stage the ring holds
  // issued before the first wait
  load_rows<W>(Qs, qp, r0, ROWS, Sq, hd, lane);
  auto issue = [&](int s) {
    if (s < walk.stages) {
      float* slot = ring + (s % STAGES) * 2 * Smem::tile;
      const int n = walk.steps(s) * STEP;
      load_rows<W>(slot, kp, walk.row(s), n, Sk, hd, lane);
      load_rows<W>(slot + Smem::tile, vp, walk.row(s), n, Sk, hd, lane);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES; ++s) issue(s);

  // m in log2 units of the scaled scores; l per lane until the end
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[W / 8][4];
#pragma unroll
  for (int n = 0; n < W / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int s = 0; s < walk.stages; ++s) {
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    if (s == 0) load_strip<W>(strip, Qs, g, t);
    const float* Ks = ring + (s % STAGES) * 2 * Smem::tile;
    const float* Vs = Ks + Smem::tile;
    const int k0 = walk.row(s);
    // one online-softmax update a step; each step waits on the one
    // before (the running max, the accumulators), so the loop stays rolled
#pragma unroll 1
    for (int j = 0; j < walk.steps(s); ++j) {
      float sc[4], mx[2] = {-INFINITY, -INFINITY}, corr[2];
      dots<W>(sc, strip, Ks + j * STEP * L, g, t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * STEP + 2 * t + (e & 1);
        const int2 rr = run[e / 2];
        if (key < rr.x || key > rr.y) sc[e] = -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], sc[e]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // the scale is positive: the scaled max is the max scaled
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int n = 0; n < W / 8; ++n) acc[n][e] *= corr[e / 2];
        // a masked score is -inf: exp2 gives 0
        sc[e] = exp2f(fmaf(sc[e], scale_log2, -m[e / 2]));
        l[e / 2] += sc[e];
      }
      accum<W>(acc, sc, Vs + j * STEP * L, g, t);
    }
    __syncwarp();  // the slot's last reads are done: refill it
    issue(s + STAGES);
  }
  cp_async_wait<0>();  // no copy outlives the warp (a strip of no step)

  // a fully masked row keeps O = 0 and LSE = -1e30 + log(1e-30)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r0 + g + 8 * r;
    if (row >= Sq) continue;
    // one reciprocal a row and the fast log: the IEEE division's and
    // logf's slow-path branches would order the row's chain (2^-22
    // relative here, far inside the 1e-4 tolerances)
    const float denom = fmaxf(l[r], 1e-30f);
    const float inv = __fdividef(1.f, denom);
    float* orow = o + ((size_t)bh * Sq + row) * hd;
#pragma unroll
    for (int n = 0; n < W / 8; ++n)
      if (8 * n < hd)
        *reinterpret_cast<float2*>(orow + 8 * n + 2 * t) = make_float2(
            acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    if (t == 0)
      lse[(size_t)bh * Sq + row] =
          (m[r] > kNegInf ? m[r] * kLn2 : kNegInf) + __logf(denom);
  }
}

}  // namespace etpu::f32n

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

// The launch bounds ask for one resident CTA per SM, no more: under
// the default ptxas held the D 32 instance to 64 registers and spilled.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int H, int KVH, int Sq, int Sk,
                     int hd, int q_offset, int k_offset, int causal,
                     int window, float scale) {
  // D is the body's width, hd <= D the head dim (columns past it are
  // zeros in shared memory)
  static_assert(D % 16 == 0, "the body's width must be a multiple of 16");
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
  const T* qp = q + (size_t)bh * Sq * hd;
  const T* kp = k + (size_t)kv_row * Sk * hd;
  const T* vp = v + (size_t)kv_row * Sk * hd;

  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3 of the tile
  const int tx = tid % 16;  // columns tx + 16*j

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    Qs[r * (D + 1) + c] = q0 + r < Sq && c < hd
                              ? to_f32(qp[(size_t)(q0 + r) * hd + c])
                              : 0.f;
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
      const bool in = k0 + r < Sk && c < hd;
      Ks[r * (D + 1) + c] = in ? to_f32(kp[(size_t)(k0 + r) * hd + c]) : 0.f;
      Vs[i] = in ? to_f32(vp[(size_t)(k0 + r) * hd + c]) : 0.f;
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
    T* orow = o + ((size_t)bh * Sq + r) * hd;
#pragma unroll
    for (int j = 0; j < RC; ++j)
      if (tx + 16 * j < hd)
        orow[tx + 16 * j] = etpu::from_f32<T>(acc[i][j] / denom);
    if (tx == 0) lse[(size_t)bh * Sq + r] = m[i] + logf(denom);
  }
}

// ------------------------------------------ bf16: wgmma over TMA tiles
using bf16 = __nv_bfloat16;

constexpr int WQ = 128;             // query rows per CTA: 2 warpgroups x 64
constexpr int STAGES = 4;           // K/V tiles in flight
constexpr int WTHREADS = 2 * 128 + 32;  // 2 consumer warpgroups + producer

template <int D>
struct WgmmaLayout {
  static constexpr int WK = 128;  // key rows per K/V tile
  // Q, the K ring, the V ring, then the barriers: qfull, kfull[STAGES],
  // vfull[STAGES], empty[STAGES]; +1024 for alignment: 144 KB at D 64
  // (16 KB tiles). (The other widths have bodies of their own: `Narrow`
  // and `PingPong` below.)
  static constexpr uint32_t row = Rows<D>::bytes;   // bytes of a whole row
  static constexpr uint32_t atom = Rows<D>::atom;   // ... in one block
  static constexpr uint32_t tile = WK * row;  // one K or V tile
  static constexpr uint32_t q = 0, k = WQ * row, v = k + STAGES * tile,
                            bars = v + STAGES * tile;
  static constexpr size_t bytes = bars + (1 + 3 * STAGES) * 8 + 1024;
};

// The 64 x (2N) score tile of one warpgroup's rows against one K tile
// (N accumulator registers a thread) is masked per element only where it
// can hold a masked pair: keys past Sk, the causal diagonal, the
// window's lower edge.
template <int N>
__device__ __forceinline__ void mask_scores(float (&s)[N], int qrow, int k0,
                                            int Sq, int Sk, int q_offset,
                                            int k_offset, int causal,
                                            int window) {
  const int l = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int kl = k0 + 8 * (i / 4) + 2 * (l % 4) + i % 2;
    if (!pair_valid(qrow + 8 * ((i / 2) % 2), kl, Sq, Sk, q_offset,
                    k_offset, causal, window))
      s[i] = -INFINITY;
  }
}

// mask_scores for the head-dim-128 body: each row's valid keys are one
// run (from the window's lower edge to the causal diagonal, below Sk),
// so an element costs two compares against its row's bounds, taken
// relative to this thread's first column. Rows past Sq are left as they
// are: nothing of theirs is stored.
template <int N>
__device__ __forceinline__ void mask_rows(float (&s)[N], int qrow, int k0,
                                          int Sk, int q_offset,
                                          int k_offset, int causal,
                                          int window) {
  constexpr int kOpen = 1 << 30;
  const int c0 = k0 + 2 * (threadIdx.x % 4);  // this thread's first key
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qk = q_offset + qrow + 8 * r - k_offset - c0;  // diagonal
    hi[r] = min(Sk - 1 - c0, causal ? qk : kOpen);
    lo[r] = window > 0 ? qk - window + 1 : -kOpen;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = 8 * (i / 4) + i % 2, r = (i / 2) % 2;
    if (c < lo[r] || c > hi[r]) s[i] = -INFINITY;
  }
}

// Whether a warpgroup's rows [wq0, wq0 + 63] against the K tile at k0
// need mask_scores.
template <int WK>
__device__ __forceinline__ bool tile_masked(int wq0, int k0, int Sk,
                                            int q_offset, int k_offset,
                                            int causal, int window) {
  return k0 + WK > Sk || !rows_all_valid(wq0, wq0 + 63, k0, k0 + WK - 1,
                                         q_offset, k_offset, causal,
                                         window);
}

// S = Q K^T, one warpgroup's 64 rows (block 0 of the QR-row Q tile at
// `qdesc`: 128 rows, or the 256 body's 64) x the WK keys of `ktile`: D/16
// k16 steps, S overwritten.
template <int D, int WK, int QR = WQ>
__device__ __forceinline__ void issue_scores(float (&s)[WK / 2],
                                             uint64_t qdesc,
                                             const uint8_t* ktile) {
  const uint64_t kdesc = desc_sw<D>(ktile);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<WK>(s, desc_k<D, QR>(qdesc, kk), desc_k<D, WK>(kdesc, kk), kk);
}

// O += P V: P as the bf16 A fragments of WK/16 k steps (the TPU kernel's
// p.astype(v.dtype)), V MN-major from `vtile`.
template <int D, int WK>
__device__ __forceinline__ void issue_values(float (&o)[D / 2],
                                             const uint32_t (&pa)[WK / 16][4],
                                             const uint8_t* vtile) {
  const uint64_t vdesc = desc_sw<D>(vtile);
#pragma unroll
  for (int kk = 0; kk < WK / 16; ++kk)
    wgmma_rs_rows<D, WK>(o, pa[kk], vdesc, kk);
}

// One tile's online softmax in the base-2 domain on the accumulator
// layout: this thread's 2 rows x N/2 columns, a row spanning the 4
// threads of a quad (the max reduces with shuffles over lanes ^1 and
// ^2). The scores become the weights in place; the running max `m` and
// this thread's partial row sums `lsum` move on (the quad's partial sums
// meet at the end), and `corr` is the factor O's rows take. With C > 1
// each row's max and sum run as C independent chains over its 8-column
// groups, met at the end of the tile, so their latency overlaps (the
// sum then adds in another order).
template <int N, int C = 1>
__device__ __forceinline__ void online_softmax(float (&s)[N], float (&m)[2],
                                               float (&lsum)[2],
                                               float (&corr)[2],
                                               float scale_log2) {
  float mx[2][C];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) mx[r][c] = -INFINITY;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float& x = mx[(i / 2) % 2][(i / 4) % C];
    x = fmaxf(x, s[i]);
  }
  float mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int c = 1; c < C; ++c) mx[r][0] = fmaxf(mx[r][0], mx[r][c]);
    float x = mx[r][0];
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    const float m_new = fmaxf(m[r], x * scale_log2);
    // a row with nothing unmasked yet subtracts 0: exp2(-inf) = 0
    mu[r] = m_new == -INFINITY ? 0.f : m_new;
    corr[r] = exp2_ftz(m[r] - mu[r]);
    m[r] = m_new;
    lsum[r] *= corr[r];
  }
  if constexpr (C == 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int r = (i / 2) % 2;
      s[i] = exp2_ftz(fmaf(s[i], scale_log2, -mu[r]));
      lsum[r] += s[i];
    }
  } else {
    float sum[2][C];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) sum[r][c] = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int r = (i / 2) % 2;
      s[i] = exp2_ftz(fmaf(s[i], scale_log2, -mu[r]));
      sum[r][(i / 4) % C] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int c = 1; c < C; ++c) sum[r][0] += sum[r][c];
      lsum[r] += sum[r][0];
    }
  }
}

// O (a warpgroup's 64 rows) through its 64 rows of a 128-row staging
// tile in shared memory (`Ow`, block 0) to 16-byte stores of each row's
// first hd columns, and the LSE in natural-log units: kNegInf for a row
// with nothing unmasked (O = 0 there).
template <int D>
__device__ __forceinline__ void store_rows(float (&oacc)[D / 2],
                                           const float (&m)[2],
                                           float (&lsum)[2], uint8_t* Ow,
                                           bf16* o, float* lse, int bh,
                                           int wq0, int qrow, int Sq,
                                           int hd, int wg) {
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 1);
    lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 2);
    inv[r] = 1.f / fmaxf(lsum[r], 1e-30f);
  }
  acc_to_tile<D, WQ>(oacc, inv[0], inv[1], Ow);
  wg_barrier(1 + wg);
  tile_to_rows<D, WQ>(Ow, o + ((size_t)bh * Sq + wq0) * hd, Sq - wq0, hd);
  if (threadIdx.x % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qrow + 8 * r;
      if (row < Sq)
        lse[(size_t)bh * Sq + row] =
            m[r] == -INFINITY ? kNegInf
                              : m[r] * kLn2 + logf(fmaxf(lsum[r], 1e-30f));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(WTHREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           bf16* __restrict__ o, float* __restrict__ lse,
                           int BH, int H, int KVH, int Sq, int Sk, int hd,
                           int q_offset, int k_offset, int causal,
                           int window, float scale_log2) {
  static_assert(D == 64, "widths 16 and 32 run flash_fwd_narrow_kernel, "
                         "128 flash_fwd_pingpong_kernel");
  using L = WgmmaLayout<D>;
  constexpr uint32_t TILE = L::tile;
  constexpr int WK = L::WK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* Qs = sm + L::q;
  uint8_t* Ks = sm + L::k;
  uint8_t* Vs = sm + L::v;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* kfull = qfull + 1;
  uint64_t* vfull = kfull + STAGES;
  uint64_t* empty = vfull + STAGES;

  // heaviest first: the CTAs of the last q tiles (the most live K/V
  // tiles under causal masking) get the lowest block ids
  const int nqt = (Sq + WQ - 1) / WQ;
  const int q0 = (nqt - 1 - (int)blockIdx.x / BH) * WQ;
  const int bh = blockIdx.x % BH;
  const int h = bh % H;
  // GQA: query row bh = b*H + h reads kv row b*KVH + h / (H / KVH)
  const int kv_row = (bh / H) * KVH + h / (H / KVH);
  const int q_last = min(q0 + WQ, Sq) - 1;
  const int nk = (Sk + WK - 1) / WK;

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 8) {
    // ---- producer: Q once, then the live K/V tiles through the ring
    if (lane == 0) {
      mbar_expect_tx(qfull, WQ * L::row);
      tma_load_tile<D, WQ>(Qs, &tq, qfull, q0, bh);
      int s = 0;
      uint32_t phase = 0;
      for (int kj = 0; kj < nk; ++kj) {
        const int k0 = kj * WK;
        if (!rows_meet(q0, q_last, k0, min(k0 + WK, Sk) - 1, q_offset,
                       k_offset, causal, window))
          continue;
        mbar_wait(&empty[s], phase ^ 1);
        mbar_expect_tx(&kfull[s], TILE);
        tma_load_tile<D, WK>(Ks + s * TILE, &tk, &kfull[s], k0, kv_row);
        mbar_expect_tx(&vfull[s], TILE);
        tma_load_tile<D, WK>(Vs + s * TILE, &tv, &vfull[s], k0, kv_row);
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows wq0 .. wq0 + 63
    const int wg = warp / 4;
    const int wq0 = q0 + 64 * wg;
    const int qrow = wq0 + 16 * (warp % 4) + lane / 4;  // and qrow + 8
    uint8_t* Qw = Qs + wg * 64 * L::atom;  // its rows in block 0
    const uint64_t qdesc = desc_sw<D>(Qw);
    float oacc[D / 2], m[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;

    mbar_wait(qfull, 0);
    int s = 0;
    uint32_t phase = 0;
    for (int kj = 0; kj < nk; ++kj) {
      const int k0 = kj * WK;
      const int k_last = min(k0 + WK, Sk) - 1;
      if (!rows_meet(q0, q_last, k0, k_last, q_offset, k_offset, causal,
                     window))
        continue;
      // S = Q K^T: 64 rows x WK keys, D/16 k16 steps over the head dim
      float sacc[WK / 2];
      mbar_wait(&kfull[s], phase);
      wgmma_fence();
      issue_scores<D, WK>(sacc, qdesc, Ks + s * TILE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(sacc);

      if (tile_masked<WK>(wq0, k0, Sk, q_offset, k_offset, causal, window))
        mask_scores(sacc, qrow, k0, Sq, Sk, q_offset, k_offset, causal,
                    window);
      float corr[2];
      online_softmax(sacc, m, lsum, corr, scale_log2);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) oacc[i] *= corr[(i / 2) % 2];

      // O += P V with P in bf16 registers and V MN-major from the ring
      uint32_t pa[WK / 16][4];
#pragma unroll
      for (int kk = 0; kk < WK / 16; ++kk) pack_a(sacc, kk, pa[kk]);
      mbar_wait(&vfull[s], phase);
      wgmma_fence();
      issue_values<D, WK>(oacc, pa, Vs + s * TILE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(oacc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
    // O through this warpgroup's Q rows: read by nothing after its last
    // product
    store_rows<D>(oacc, m, lsum, Qw, o, lse, bh, wq0, qrow, Sq, hd, wg);
  }
}

// ---------------------------------- bf16 at width 128: ping-pong consumers
struct PingPong {
  static constexpr int D = 128;
  static constexpr int WK = 128;     // key rows per K/V tile
  static constexpr int STAGES = 2;   // K/V tiles in flight
  static constexpr int QSTAGES = 2;  // Q tiles: this q tile's and the next
  static constexpr int CHAINS = 4;   // the softmax's max and sum chains
  // the consumers' turns: named barrier TURN + w is warpgroup w's (1 and
  // 2 are wg_barrier's)
  static constexpr int TURN = 3;
  // the Q ring (32 KB tiles), O's staging tile (32 KB), the K ring, the
  // V ring (32 KB tiles), then the barriers: qfull[QSTAGES],
  // qempty[QSTAGES], kfull[STAGES], vfull[STAGES], kempty[STAGES],
  // vempty[STAGES], done; +1024 for alignment: 225 KB of the 227
  static constexpr uint32_t row = Rows<D>::bytes, atom = Rows<D>::atom;
  static constexpr uint32_t tile = WK * row, qtile = WQ * row;
  static constexpr uint32_t q = 0, o = QSTAGES * qtile, k = o + qtile,
                            v = k + STAGES * tile, bars = v + STAGES * tile;
  static constexpr uint32_t qfull = bars, qempty = bars + 8 * QSTAGES,
                            kfull = qempty + 8 * QSTAGES,
                            vfull = kfull + 8 * STAGES,
                            kempty = vfull + 8 * STAGES,
                            vempty = kempty + 8 * STAGES,
                            done = vempty + 8 * STAGES;
  static constexpr size_t bytes = done + 8 + 1024;
};

// One q tile of a persistent body's work: a 128-row q tile of one head,
// or none.
struct FwdItem {
  int q0, bh, kv_row;
  int kj0, n;  // its live K/V tiles, kj0 .. kj0 + n - 1
};

// Half `half` of work item w, over K/V tiles of WK keys (128 in the
// head-dim-128 body, 64 in the 256 one). An item is a pair of q tiles of
// one head, the t-th heaviest and the t-th lightest (t and nqt - 1 - t
// from the heaviest), so under causal masking every item holds the same
// work and items dealt round-robin to the CTAs balance. The heads go in
// groups of `group` (common.cuh l2_group: their K and V fit in L2), each
// group's `per` items consecutive, the group's heads side by side at
// each pair. An odd middle tile has no partner (q0 = -1). (With `group`
// every head and `per` nqt times the heads, half 0 alone walks the q
// tiles one an item, heaviest first: the 256 body's one-wave schedule.)
// The live K/V tiles of query rows q0 .. q_last (those rows_meet admits,
// WK keys a tile) are one run, kj0 .. kj0 + n - 1; returns n. The causal
// rule drops tiles from the end, the window's from the start, and below
// the ragged last tile the window's test on a tile's last key is (kj +
// 1) * WK - 1 > b. In closed form and unsigned where it divides: the
// loaders run this in 24 registers. (Host code uses it too.)
template <int WK>
__host__ __device__ __forceinline__ int live_tiles(int q0, int q_last,
                                                   int Sk, int q_offset,
                                                   int k_offset, int causal,
                                                   int window, int& kj0) {
  const int nk = (Sk + WK - 1) / WK;
  int hi = nk - 1, lo = 0;
  if (causal) {
    const int a = q_offset + q_last - k_offset;  // the last key allowed
    const int t = a < 0 ? -1 : (int)((unsigned)a / WK);
    hi = t < hi ? t : hi;
  }
  if (window > 0) {
    const int b = q_offset + q0 - window - k_offset;  // keys <= b out
    lo = b + 1 <= 0 ? 0 : (int)((unsigned)(b + 1) / WK);
    if (Sk - 1 <= b && nk - 2 < hi) hi = nk - 2;
  }
  kj0 = lo;
  return hi - lo + 1 > 0 ? hi - lo + 1 : 0;
}

template <int WK>
__device__ __forceinline__ FwdItem fwd_item(int w, int half, int per,
                                            int BH, int grp, int group,
                                            int Sq, int Sk, int q_offset,
                                            int k_offset, int causal,
                                            int window) {
  const int nqt = (Sq + WQ - 1) / WQ;
  const unsigned g = (unsigned)w / per, r = (unsigned)w - g * per;
  const unsigned gh = min(group, BH - (int)g * group);  // heads in g
  const unsigned p = r / gh;
  FwdItem x;
  x.bh = g * group + (r - p * gh);
  // GQA: query row bh = b*H + h reads kv row b*KVH + h / grp = bh / grp
  x.kv_row = (unsigned)x.bh / (unsigned)grp;
  const int t = half ? nqt - 1 - (int)p : (int)p;
  x.q0 = half && t == (int)p ? -1 : (nqt - 1 - t) * WQ;
  const int q_last = min(x.q0 + WQ, Sq) - 1;
  const int n = live_tiles<WK>(x.q0, q_last, Sk, q_offset, k_offset, causal,
                               window, x.kj0);
  x.n = x.q0 < 0 ? 0 : n;
  return x;
}

// Persistent: one CTA per SM walks items blockIdx.x, + gridDim.x, ...,
// each item's two q tiles in turn; the next q tile's Q lands in the Q
// ring's other slot while this one runs, so its first products follow
// this tile's last P V at once and overlap its store.
__global__ void __launch_bounds__(kWideThreads, 1)
    flash_fwd_pingpong_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              bf16* __restrict__ o, float* __restrict__ lse,
                              int BH, int grp, int Sq, int Sk, int hd,
                              int q_offset, int k_offset, int causal,
                              int window, float scale_log2, int group,
                              int per, int items) {
  using L = PingPong;
  constexpr int D = L::D, WK = L::WK, STAGES = L::STAGES;
  constexpr uint32_t TILE = L::tile;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* Qs = sm + L::q;
  uint8_t* Os = sm + L::o;
  uint8_t* Ks = sm + L::k;
  uint8_t* Vs = sm + L::v;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(sm + L::qfull);
  uint64_t* qempty = reinterpret_cast<uint64_t*>(sm + L::qempty);
  uint64_t* kfull = reinterpret_cast<uint64_t*>(sm + L::kfull);
  uint64_t* vfull = reinterpret_cast<uint64_t*>(sm + L::vfull);
  uint64_t* kempty = reinterpret_cast<uint64_t*>(sm + L::kempty);
  uint64_t* vempty = reinterpret_cast<uint64_t*>(sm + L::vempty);
  uint64_t* done = reinterpret_cast<uint64_t*>(sm + L::done);

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::QSTAGES; ++s) {
      mbar_init(&qfull[s], 1);
      mbar_init(&qempty[s], 8);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&kempty[s], 8);
      mbar_init(&vempty[s], 8);
    }
    mbar_init(done, 8);  // lane 0 of each consumer warp, at its end
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = warp_index(), lane = threadIdx.x % 32;
  if (warp >= 8) {
    // ---- producer warpgroup: every warp gives its registers back
    // first; warp 9 is the CTA's watchdog; lane 0 of warps 8, 10 and 11
    // loads Q, K and V, each walking the items on its own: Q of each q
    // tile with a live K/V tile into its slot once the consumers' last S
    // of the tile before in that slot is done, K and V of the live tiles
    // into their own rings (K is released after S, V after P V, a turn
    // later). The rings run on across items: `r` counts what the warp
    // loaded. Three loaders with no state in common fit in 24 registers
    // where one did not.
    setmaxnreg_dec<kProducerRegs>();
    // shared addresses as offsets from one 32-bit base
    const uint32_t b = smem_u32(sm);
    if (warp == 9) {
      cta_watchdog(done);
    } else if (warp == 8) {
      if (lane == 0) {
        int r = 0;
        for (int w = blockIdx.x; w < items; w += gridDim.x) {
          for (int half = 0; half < 2; ++half) {
            const FwdItem x = fwd_item<WK>(w, half, per, BH, grp, group, Sq,
                                       Sk, q_offset, k_offset, causal,
                                       window);
            if (x.n == 0) continue;
            const uint32_t s = r % L::QSTAGES;
            mbar_wait_spin(b + L::qempty + 8 * s,
                           ((r / L::QSTAGES) & 1) ^ 1);
            mbar_expect_tx(b + L::qfull + 8 * s, L::qtile);
            tma_load_tile<D, WQ>(b + L::q + s * L::qtile, &tq,
                                 b + L::qfull + 8 * s, x.q0, x.bh);
            ++r;
          }
        }
      }
    } else if (lane == 0) {
      // one ring, K's or V's (each call with its own map, a constant
      // address: no register holds it)
      auto load_ring = [&](const CUtensorMap* map, uint32_t tiles,
                           uint32_t full, uint32_t empty) {
        int r = 0;
        for (int w = blockIdx.x; w < items; w += gridDim.x) {
          for (int half = 0; half < 2; ++half) {
            const FwdItem x = fwd_item<WK>(w, half, per, BH, grp, group, Sq,
                                       Sk, q_offset, k_offset, causal,
                                       window);
            for (int j = 0; j < x.n; ++j, ++r) {
              const uint32_t s = r % STAGES;
              mbar_wait_spin(empty + 8 * s, ((r / STAGES) & 1) ^ 1);
              mbar_expect_tx(full + 8 * s, TILE);
              tma_load_tile<D, WK>(tiles + s * TILE, map, full + 8 * s,
                                   (x.kj0 + j) * WK, x.kv_row);
            }
          }
        }
      };
      if (warp == 10)
        load_ring(&tk, b + L::k, b + L::kfull, b + L::kempty);
      else
        load_ring(&tv, b + L::v, b + L::vfull, b + L::vempty);
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows wq0 .. wq0 + 63 of
    // each item
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = warp / 4;
    uint8_t* Ow = Os + wg * 64 * L::atom;  // its rows in block 0
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // Turns: a warpgroup issues its products only between its
    // consumers_barrier(TURN + wg) and its consumers_arrive on the
    // other's, so the tensor cores run one warpgroup's products while
    // the other does its softmax. Both take n + 1 turns a q tile (its n
    // live K/V tiles, whether or not their own rows meet them);
    // warpgroup 0 goes first, on warpgroup 1's opening arrive, and
    // takes that of warpgroup 1's last turn at the very end, so every
    // barrier ends balanced.
    if (wg == 1) consumers_arrive(L::TURN);
    int r = 0, qi = 0;
    // A q tile's O waits in registers for its store until the next
    // tile's first S is in flight (`pend`: its head, rows, max and sums).
    float oacc[D / 2], pm[2], psum[2];
    bool pend = false;
    int pbh = 0, pwq0 = 0, pqrow = 0;
    auto store_pending = [&]() {
      if (!pend) return;
      // the staging rows are free once the last store's reads are done
      wg_barrier(1 + wg);
      store_rows<D>(oacc, pm, psum, Ow, o, lse, pbh, pwq0, pqrow, Sq, hd,
                    wg);
      pend = false;
    };
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      for (int half = 0; half < 2; ++half) {
        const FwdItem x = fwd_item<WK>(w, half, per, BH, grp, group, Sq, Sk,
                                   q_offset, k_offset, causal, window);
        if (x.q0 < 0) continue;
        const int wq0 = x.q0 + 64 * wg;
        const int qrow = wq0 + 16 * (warp % 4) + lane / 4;  // and qrow + 8
        float m[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f};
        if (x.n > 0) {
          const int n = x.n;
          uint32_t pa[WK / 16][4];
          float corr[2];
          const int qs = qi % L::QSTAGES;  // the q tile's Q slot
          // its rows of the slot, block 0
          const uint64_t qdesc =
              desc_sw<D>(Qs + qs * L::qtile + wg * 64 * L::atom);
          mbar_wait_spin(&qfull[qs], (qi / L::QSTAGES) & 1);
          ++qi;
          {
            // tile 0: S alone, the last q tile's store under it
            const int s = r % STAGES, k0 = x.kj0 * WK;
            float sacc[WK / 2];
            mbar_wait_spin(&kfull[s], (r / STAGES) & 1);
            consumers_barrier(L::TURN + wg);
            wgmma_fence();
            issue_scores<D, WK>(sacc, qdesc, Ks + s * TILE);
            wgmma_commit();
            consumers_arrive(L::TURN + (wg ^ 1));
            store_pending();
#pragma unroll
            for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
            wgmma_wait<0>();
            fence_operands(sacc);
            release(&kempty[s]);
            if (n == 1) release(&qempty[qs]);  // the q tile's last S
            if (tile_masked<WK>(wq0, k0, Sk, q_offset, k_offset, causal,
                                window))
              mask_rows(sacc, qrow, k0, Sk, q_offset, k_offset, causal,
                        window);
            online_softmax<WK / 2, L::CHAINS>(sacc, m, lsum, corr,
                                              scale_log2);  // O is 0 yet
#pragma unroll
            for (int kk = 0; kk < WK / 16; ++kk) pack_a(sacc, kk, pa[kk]);
          }
          for (int j = 1; j < n; ++j) {
            // S of tile j and P V of tile j - 1 in one turn; the softmax
            // of j runs while P V is still in flight
            const int s = (r + j) % STAGES, sp = (r + j - 1) % STAGES;
            const int k0 = (x.kj0 + j) * WK;
            float sacc[WK / 2];
            mbar_wait_spin(&kfull[s], ((r + j) / STAGES) & 1);
            mbar_wait_spin(&vfull[sp], ((r + j - 1) / STAGES) & 1);
            consumers_barrier(L::TURN + wg);
            wgmma_fence();
            issue_scores<D, WK>(sacc, qdesc, Ks + s * TILE);
            wgmma_commit();
            issue_values<D, WK>(oacc, pa, Vs + sp * TILE);
            wgmma_commit();
            consumers_arrive(L::TURN + (wg ^ 1));
            wgmma_wait<1>();
            fence_operands(sacc);
            release(&kempty[s]);
            if (j == n - 1) release(&qempty[qs]);
            if (tile_masked<WK>(wq0, k0, Sk, q_offset, k_offset, causal,
                                window))
              mask_rows(sacc, qrow, k0, Sk, q_offset, k_offset, causal,
                        window);
            online_softmax<WK / 2, L::CHAINS>(sacc, m, lsum, corr,
                                              scale_log2);
            wgmma_wait<0>();
            fence_operands(oacc);
            fence_operands(pa);
            release(&vempty[sp]);
#pragma unroll
            for (int i = 0; i < D / 2; ++i) oacc[i] *= corr[(i / 2) % 2];
#pragma unroll
            for (int kk = 0; kk < WK / 16; ++kk) pack_a(sacc, kk, pa[kk]);
          }
          // the last tile's P V
          const int sp = (r + n - 1) % STAGES;
          mbar_wait_spin(&vfull[sp], ((r + n - 1) / STAGES) & 1);
          consumers_barrier(L::TURN + wg);
          wgmma_fence();
          issue_values<D, WK>(oacc, pa, Vs + sp * TILE);
          wgmma_commit();
          consumers_arrive(L::TURN + (wg ^ 1));
          wgmma_wait<0>();
          fence_operands(oacc);
          release(&vempty[sp]);
          r += n;
        } else {
          // no live tile: O = 0
          store_pending();
#pragma unroll
          for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
        }
        pend = true;
        pbh = x.bh;
        pwq0 = wq0;
        pqrow = qrow;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          pm[i] = m[i];
          psum[i] = lsum[i];
        }
      }
    }
    store_pending();
    if (wg == 0) consumers_barrier(L::TURN);
    release(done);
  }
}

// ------------------------------------------------- bf16 at width 256
struct Wide256 {
  static constexpr int D = 256;
  static constexpr int WK = 64;      // key rows per K/V tile
  static constexpr int QR = 64;      // query rows of a warpgroup's Q tile
  static constexpr int STAGES = 2;   // K/V tiles in flight
  static constexpr int CHAINS = 4;   // the softmax's max and sum chains
  // the consumers' turns: named barrier TURN + w is warpgroup w's
  static constexpr int TURN = 3;
  // each warpgroup's Q tile (64 rows, 32 KB), the K ring, the V ring (32
  // KB tiles), each warpgroup's O staging tile (64 rows of 128 columns,
  // 16 KB), then the barriers: qfull[2], qempty[2] (one each a
  // warpgroup), kfull[STAGES], vfull[STAGES], kempty[STAGES],
  // vempty[STAGES], done; +1024 for alignment: 225 KB of the 227
  static constexpr uint32_t row = Rows<D>::bytes;
  static constexpr uint32_t tile = WK * row, qtile = QR * row;
  static constexpr uint32_t otile = QR * Rows<128>::bytes;
  static constexpr uint32_t q = 0, k = 2 * qtile, v = k + STAGES * tile,
                            o = v + STAGES * tile, bars = o + 2 * otile;
  static constexpr uint32_t qfull = bars, qempty = qfull + 16,
                            kfull = qempty + 16,
                            vfull = kfull + 8 * STAGES,
                            kempty = vfull + 8 * STAGES,
                            vempty = kempty + 8 * STAGES,
                            done = vempty + 8 * STAGES;
  static constexpr size_t bytes = done + 8 + 1024;
  static_assert(bytes <= 232448, "at most 227 KB of shared memory");
};

// Columns 128H .. 128H + 127 of a warpgroup's 64 x 256 accumulator, row
// r scaled by `lo` or `hi` as in acc_to_tile, as bf16 into a 64-row tile
// of 128-column rows (two blocks of the 128-byte swizzle).
template <int H>
__device__ __forceinline__ void acc_half_to_tile(const float (&d)[128],
                                                 float lo, float hi,
                                                 uint8_t* tile) {
  const int t = threadIdx.x % 128, l = t % 32;
  const int r = 16 * (t / 32) + l / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * (16 * H + j) + 2 * h;
      const float s = h ? hi : lo;
      *reinterpret_cast<uint32_t*>(tile + swz<128, 64>(r + 8 * h, j) +
                                   (l % 4) * 4) =
          pack_bf16(d[i] * s, d[i + 1] * s);
    }
}

// store_rows at width 256: O leaves in two 128-column halves through the
// warpgroup's 16 KB staging tile `Ow` (a whole 64 x 256 tile would not
// fit beside the rings), each half's rows stored with 16-byte stores of
// their columns below hd.
__device__ __forceinline__ void store_rows_w256(float (&oacc)[128],
                                                const float (&m)[2],
                                                float (&lsum)[2],
                                                uint8_t* Ow, bf16* o,
                                                float* lse, int bh, int wq0,
                                                int qrow, int Sq, int hd,
                                                int wg) {
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 1);
    lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 2);
    inv[r] = 1.f / fmaxf(lsum[r], 1e-30f);
  }
  bf16* dst = o + ((size_t)bh * Sq + wq0) * hd;
  // the staging rows are free once the last store's reads are done
  wg_barrier(1 + wg);
  acc_half_to_tile<0>(oacc, inv[0], inv[1], Ow);
  wg_barrier(1 + wg);
  tile_to_rows<128, 64>(Ow, dst, Sq - wq0, 128, hd);
  wg_barrier(1 + wg);
  acc_half_to_tile<1>(oacc, inv[0], inv[1], Ow);
  wg_barrier(1 + wg);
  tile_to_rows<128, 64>(Ow, dst + 128, Sq - wq0, hd - 128, hd);
  if (threadIdx.x % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qrow + 8 * r;
      if (row < Sq)
        lse[(size_t)bh * Sq + row] =
            m[r] == -INFINITY ? kNegInf
                              : m[r] * kLn2 + logf(fmaxf(lsum[r], 1e-30f));
    }
  }
}

// The head-dim-128 body's design at width 256 (see the note at the top):
// persistent over pairs of q tiles where the q tiles outnumber the SMs
// (`halves` 2), else one q tile a CTA, heaviest first (`halves` 1, with
// `group` and `per` as fwd_item says).
__global__ void __launch_bounds__(kWideThreads, 1)
    flash_fwd_w256_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          bf16* __restrict__ o, float* __restrict__ lse,
                          int BH, int grp, int Sq, int Sk, int hd,
                          int q_offset, int k_offset, int causal,
                          int window, float scale_log2, int group, int per,
                          int items, int halves) {
  using L = Wide256;
  constexpr int D = L::D, WK = L::WK, STAGES = L::STAGES;
  constexpr uint32_t TILE = L::tile;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* Qs = sm + L::q;
  uint8_t* Ks = sm + L::k;
  uint8_t* Vs = sm + L::v;
  uint8_t* Os = sm + L::o;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(sm + L::qfull);
  uint64_t* qempty = reinterpret_cast<uint64_t*>(sm + L::qempty);
  uint64_t* kfull = reinterpret_cast<uint64_t*>(sm + L::kfull);
  uint64_t* vfull = reinterpret_cast<uint64_t*>(sm + L::vfull);
  uint64_t* kempty = reinterpret_cast<uint64_t*>(sm + L::kempty);
  uint64_t* vempty = reinterpret_cast<uint64_t*>(sm + L::vempty);
  uint64_t* done = reinterpret_cast<uint64_t*>(sm + L::done);

  if (threadIdx.x == 0) {
    for (int w = 0; w < 2; ++w) {
      mbar_init(&qfull[w], 1);
      mbar_init(&qempty[w], 4);  // lane 0 of each warp of warpgroup w
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&kempty[s], 8);  // lane 0 of each consumer warp
      mbar_init(&vempty[s], 8);
    }
    mbar_init(done, 8);  // lane 0 of each consumer warp, at its end
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = warp_index(), lane = threadIdx.x % 32;
  if (warp >= 8) {
    // ---- producer warpgroup: every warp gives its registers back
    // first; warp 9 is the CTA's watchdog; lane 0 of warps 8, 10 and 11
    // loads Q, K and V, each walking the items on its own: a q tile's two
    // 64-row Q tiles, each into its warpgroup's slot once that
    // warpgroup's last S of the tile before is done; K and V of the live
    // tiles into their own rings (K released after S, V after P V, a
    // turn later)
    setmaxnreg_dec<kProducerRegs>();
    const uint32_t b = smem_u32(sm);
    if (warp == 9) {
      cta_watchdog(done);
    } else if (warp == 8) {
      if (lane == 0) {
        int r = 0;
        for (int w = blockIdx.x; w < items; w += gridDim.x) {
          for (int half = 0; half < halves; ++half) {
            const FwdItem x = fwd_item<WK>(w, half, per, BH, grp, group,
                                           Sq, Sk, q_offset, k_offset,
                                           causal, window);
            if (x.n == 0) continue;
            for (int g = 0; g < 2; ++g) {
              mbar_wait_spin(b + L::qempty + 8 * g, (r & 1) ^ 1);
              mbar_expect_tx(b + L::qfull + 8 * g, L::qtile);
              tma_load_tile<D, L::QR>(b + L::q + g * L::qtile, &tq,
                                      b + L::qfull + 8 * g,
                                      x.q0 + L::QR * g, x.bh);
            }
            ++r;
          }
        }
      }
    } else if (lane == 0) {
      auto load_ring = [&](const CUtensorMap* map, uint32_t tiles,
                           uint32_t full, uint32_t empty) {
        int r = 0;
        for (int w = blockIdx.x; w < items; w += gridDim.x) {
          for (int half = 0; half < halves; ++half) {
            const FwdItem x = fwd_item<WK>(w, half, per, BH, grp, group,
                                           Sq, Sk, q_offset, k_offset,
                                           causal, window);
            for (int j = 0; j < x.n; ++j, ++r) {
              const uint32_t s = r % STAGES;
              mbar_wait_spin(empty + 8 * s, ((r / STAGES) & 1) ^ 1);
              mbar_expect_tx(full + 8 * s, TILE);
              tma_load_tile<D, WK>(tiles + s * TILE, map, full + 8 * s,
                                   (x.kj0 + j) * WK, x.kv_row);
            }
          }
        }
      };
      if (warp == 10)
        load_ring(&tk, b + L::k, b + L::kfull, b + L::kempty);
      else
        load_ring(&tv, b + L::v, b + L::vfull, b + L::vempty);
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows wq0 .. wq0 + 63 of
    // each q tile, in its own Q slot
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = warp / 4;
    const uint64_t qdesc = desc_sw<D>(Qs + wg * L::qtile);
    uint8_t* Ow = Os + wg * L::otile;
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // Turns as in flash_fwd_pingpong_kernel: both warpgroups take n + 1
    // turns a q tile, warpgroup 0 first.
    if (wg == 1) consumers_arrive(L::TURN);
    int r = 0, qi = 0;
    float oacc[D / 2];
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      for (int half = 0; half < halves; ++half) {
        const FwdItem x = fwd_item<WK>(w, half, per, BH, grp, group, Sq, Sk,
                                       q_offset, k_offset, causal, window);
        if (x.q0 < 0) continue;
        const int wq0 = x.q0 + L::QR * wg;
        const int qrow = wq0 + 16 * (warp % 4) + lane / 4;  // and qrow + 8
        float m[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f};
        if (x.n > 0) {
          const int n = x.n;
          uint32_t pa[WK / 16][4];
          float corr[2];
          mbar_wait_spin(&qfull[wg], qi & 1);
          ++qi;
          {
            // tile 0: S alone
            const int s = r % STAGES, k0 = x.kj0 * WK;
            float sacc[WK / 2];
            mbar_wait_spin(&kfull[s], (r / STAGES) & 1);
            consumers_barrier(L::TURN + wg);
            wgmma_fence();
            issue_scores<D, WK, L::QR>(sacc, qdesc, Ks + s * TILE);
            wgmma_commit();
            consumers_arrive(L::TURN + (wg ^ 1));
#pragma unroll
            for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
            wgmma_wait<0>();
            fence_operands(sacc);
            release(&kempty[s]);
            if (n == 1) release(&qempty[wg]);  // the q tile's last S
            if (tile_masked<WK>(wq0, k0, Sk, q_offset, k_offset, causal,
                                window))
              mask_rows(sacc, qrow, k0, Sk, q_offset, k_offset, causal,
                        window);
            online_softmax<WK / 2, L::CHAINS>(sacc, m, lsum, corr,
                                              scale_log2);  // O is 0 yet
#pragma unroll
            for (int kk = 0; kk < WK / 16; ++kk) pack_a(sacc, kk, pa[kk]);
          }
          for (int j = 1; j < n; ++j) {
            // S of tile j and P V of tile j - 1 in one turn; the softmax
            // of j runs while P V is still in flight
            const int s = (r + j) % STAGES, sp = (r + j - 1) % STAGES;
            const int k0 = (x.kj0 + j) * WK;
            float sacc[WK / 2];
            mbar_wait_spin(&kfull[s], ((r + j) / STAGES) & 1);
            mbar_wait_spin(&vfull[sp], ((r + j - 1) / STAGES) & 1);
            consumers_barrier(L::TURN + wg);
            wgmma_fence();
            issue_scores<D, WK, L::QR>(sacc, qdesc, Ks + s * TILE);
            wgmma_commit();
            issue_values<D, WK>(oacc, pa, Vs + sp * TILE);
            wgmma_commit();
            consumers_arrive(L::TURN + (wg ^ 1));
            wgmma_wait<1>();
            fence_operands(sacc);
            release(&kempty[s]);
            if (j == n - 1) release(&qempty[wg]);
            if (tile_masked<WK>(wq0, k0, Sk, q_offset, k_offset, causal,
                                window))
              mask_rows(sacc, qrow, k0, Sk, q_offset, k_offset, causal,
                        window);
            online_softmax<WK / 2, L::CHAINS>(sacc, m, lsum, corr,
                                              scale_log2);
            wgmma_wait<0>();
            fence_operands(oacc);
            fence_operands(pa);
            release(&vempty[sp]);
#pragma unroll
            for (int i = 0; i < D / 2; ++i) oacc[i] *= corr[(i / 2) % 2];
#pragma unroll
            for (int kk = 0; kk < WK / 16; ++kk) pack_a(sacc, kk, pa[kk]);
          }
          // the last tile's P V
          const int sp = (r + n - 1) % STAGES;
          mbar_wait_spin(&vfull[sp], ((r + n - 1) / STAGES) & 1);
          consumers_barrier(L::TURN + wg);
          wgmma_fence();
          issue_values<D, WK>(oacc, pa, Vs + sp * TILE);
          wgmma_commit();
          consumers_arrive(L::TURN + (wg ^ 1));
          wgmma_wait<0>();
          fence_operands(oacc);
          release(&vempty[sp]);
          r += n;
        } else {
          // no live tile: O = 0
#pragma unroll
          for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
        }
        // O out at once, while the other warpgroup's products run (held
        // in registers for the next q tile's first S, as at width 128, it
        // took ptxas past the 240 registers: it spilled)
        store_rows_w256(oacc, m, lsum, Ow, o, lse, x.bh, wq0, qrow, Sq, hd,
                        wg);
      }
    }
    if (wg == 0) consumers_barrier(L::TURN);
    release(done);
  }
}

// ------------------------------------------- bf16 at widths 16 and 32
struct Narrow {
  static constexpr int WG = 3;          // consumer warpgroups
  static constexpr int QT = 64 * WG;    // query rows of a q tile: 192
  static constexpr int WK = 128;        // key rows per K/V tile
  static constexpr int STAGES = 4;      // K/V tiles in flight
  static constexpr int QSTAGES = 2;     // Q tiles: this q tile's and the next
  static constexpr int CHAINS = 4;      // the softmax's max and sum chains
  static constexpr int THREADS = 128 * (WG + 1);  // and a producer warpgroup
  // 512 threads launch at 128 registers each; the producer warpgroup
  // drops to 24 and the three consumer warpgroups rise to 160
  static constexpr uint32_t kProducerRegs = 24, kConsumerRegs = 160;
  static_assert(128 * kProducerRegs + 128 * WG * kConsumerRegs <=
                    65536,
                "the consumers ask for no more than the producer frees");
};

// The Q ring (192-row tiles), O's staging tile (192 rows), the K ring,
// the V ring (128-row tiles), then the barriers: qfull[QSTAGES],
// qempty[QSTAGES], kfull[STAGES], vfull[STAGES], kempty[STAGES],
// vempty[STAGES], done; +1024 for alignment: 101 KB at W 32, 51 KB at 16.
template <int D>
struct NarrowLayout : Narrow {
  static constexpr uint32_t row = Rows<D>::bytes, atom = Rows<D>::atom;
  static constexpr uint32_t tile = WK * row, qtile = QT * row;
  static constexpr uint32_t q = 0, o = QSTAGES * qtile, k = o + qtile,
                            v = k + STAGES * tile, bars = v + STAGES * tile;
  static constexpr uint32_t qfull = bars, qempty = bars + 8 * QSTAGES,
                            kfull = qempty + 8 * QSTAGES,
                            vfull = kfull + 8 * STAGES,
                            kempty = vfull + 8 * STAGES,
                            vempty = kempty + 8 * STAGES,
                            done = vempty + 8 * STAGES;
  static constexpr size_t bytes = done + 8 + 1024;
};

// Half `half` of work item w of the narrow body: a 192-row q tile of head
// bh = w % BH, or none (q0 = -1). A head's q tiles go by rank, heaviest
// first: the full tiles from the last (under causal masking the later
// rows meet more K/V tiles), and a ragged last tile, whose fewer rows
// make it lighter, at rank `ragged` (narrow_ragged_rank). With `halves`
// 2 item w pairs rank p = w / BH with rank nqt - 1 - p, so items hold
// about equal work and dealt round-robin to the CTAs balance (an odd
// middle tile has no partner); with `halves` 1 an item is the q tile of
// rank p, heaviest first.
__device__ __forceinline__ FwdItem narrow_item(int w, int half, int BH,
                                               int grp, int Sq, int Sk,
                                               int q_offset, int k_offset,
                                               int causal, int window,
                                               int ragged) {
  constexpr int QT = Narrow::QT;
  const int nqt = (Sq + QT - 1) / QT;
  const unsigned p = (unsigned)w / (unsigned)BH;
  FwdItem x;
  x.bh = w - (int)p * BH;
  x.kv_row = (unsigned)x.bh / (unsigned)grp;
  const int rank = half ? nqt - 1 - (int)p : (int)p;
  const int t = rank == ragged ? nqt - 1
                : rank < ragged ? nqt - 2 - rank
                                : nqt - 1 - rank;
  x.q0 = half && rank == (int)p ? -1 : t * QT;
  const int n = live_tiles<Narrow::WK>(x.q0, min(x.q0 + QT, Sq) - 1, Sk,
                                       q_offset, k_offset, causal, window,
                                       x.kj0);
  x.n = x.q0 < 0 ? 0 : n;
  return x;
}

// The rank of a head's ragged last q tile (fewer than 192 rows) among
// its q tiles, heaviest first: the number of full tiles whose rows x
// live K/V tiles outweigh its own (0 where every tile is full).
inline int narrow_ragged_rank(int Sq, int Sk, int q_offset, int k_offset,
                              int causal, int window) {
  constexpr int QT = Narrow::QT, WK = Narrow::WK;
  const int nqt = (Sq + QT - 1) / QT, last = (nqt - 1) * QT;
  if (Sq - last == QT) return 0;
  int kj0, rank = 0;
  const long long weight =
      (long long)(Sq - last) * live_tiles<WK>(last, Sq - 1, Sk, q_offset,
                                              k_offset, causal, window, kj0);
  for (int t = 0; t < nqt - 1; ++t)
    rank += (long long)QT * live_tiles<WK>(t * QT, t * QT + QT - 1, Sk,
                                           q_offset, k_offset, causal,
                                           window, kj0) > weight;
  return rank;
}

// The bf16 body at widths 16 and 32 (see the note at the top): a
// producer warpgroup and three consumer warpgroups of 64 query rows,
// each walking its own run of the q tile's live K/V tiles, S(j) issued
// with P V(j-1) in flight; one CTA a q tile (`halves` 1) or persistent
// over pairs of q tiles (`halves` 2), `items` work items as narrow_item
// deals them.
template <int D>
__global__ void __launch_bounds__(Narrow::THREADS, 1)
    flash_fwd_narrow_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            bf16* __restrict__ o, float* __restrict__ lse,
                            int BH, int grp, int Sq, int Sk, int hd,
                            int q_offset, int k_offset, int causal,
                            int window, float scale_log2, int items,
                            int halves, int ragged) {
  static_assert(D == 16 || D == 32, "the narrow body is 16 or 32 wide");
  using L = NarrowLayout<D>;
  constexpr int WK = L::WK, STAGES = L::STAGES, QS = L::QSTAGES,
                WG = L::WG;
  constexpr uint32_t TILE = L::tile;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* Qs = sm + L::q;
  uint8_t* Os = sm + L::o;
  uint8_t* Ks = sm + L::k;
  uint8_t* Vs = sm + L::v;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(sm + L::qfull);
  uint64_t* qempty = reinterpret_cast<uint64_t*>(sm + L::qempty);
  uint64_t* kfull = reinterpret_cast<uint64_t*>(sm + L::kfull);
  uint64_t* vfull = reinterpret_cast<uint64_t*>(sm + L::vfull);
  uint64_t* kempty = reinterpret_cast<uint64_t*>(sm + L::kempty);
  uint64_t* vempty = reinterpret_cast<uint64_t*>(sm + L::vempty);
  uint64_t* done = reinterpret_cast<uint64_t*>(sm + L::done);

  if (threadIdx.x == 0) {
    // lane 0 of each consumer warp arrives at the empty barriers
    for (int s = 0; s < QS; ++s) {
      mbar_init(&qfull[s], 1);
      mbar_init(&qempty[s], 4 * WG);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&kempty[s], 4 * WG);
      mbar_init(&vempty[s], 4 * WG);
    }
    mbar_init(done, 4 * WG);  // each consumer warp, at its end
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = warp_index(), lane = threadIdx.x % 32;
  if (warp >= 4 * WG) {
    // ---- producer warpgroup, as at width 128: every warp gives its
    // registers back first; its second warp is the CTA's watchdog; lane
    // 0 of the others loads Q (each q tile with a live K/V tile into its
    // slot once every consumer's last S of the tile before in that slot
    // is done), K and V (the live tiles into their own rings), each
    // walking the items on its own
    setmaxnreg_dec<L::kProducerRegs>();
    const uint32_t b = smem_u32(sm);
    const int role = warp - 4 * WG;
    if (role == 1) {
      cta_watchdog(done);
    } else if (role == 0) {
      if (lane == 0) {
        int r = 0;
        for (int w = blockIdx.x; w < items; w += gridDim.x) {
          for (int half = 0; half < halves; ++half) {
            const FwdItem x = narrow_item(w, half, BH, grp, Sq, Sk,
                                          q_offset, k_offset, causal,
                                          window, ragged);
            if (x.n == 0) continue;
            const uint32_t s = r % QS;
            mbar_wait_spin(b + L::qempty + 8 * s, ((r / QS) & 1) ^ 1);
            mbar_expect_tx(b + L::qfull + 8 * s, L::qtile);
            tma_load_tile<D, L::QT>(b + L::q + s * L::qtile, &tq,
                                    b + L::qfull + 8 * s, x.q0, x.bh);
            ++r;
          }
        }
      }
    } else if (lane == 0) {
      auto load_ring = [&](const CUtensorMap* map, uint32_t tiles,
                           uint32_t full, uint32_t empty) {
        int r = 0;
        for (int w = blockIdx.x; w < items; w += gridDim.x) {
          for (int half = 0; half < halves; ++half) {
            const FwdItem x = narrow_item(w, half, BH, grp, Sq, Sk,
                                          q_offset, k_offset, causal,
                                          window, ragged);
            for (int j = 0; j < x.n; ++j, ++r) {
              const uint32_t s = r % STAGES;
              mbar_wait_spin(empty + 8 * s, ((r / STAGES) & 1) ^ 1);
              mbar_expect_tx(full + 8 * s, TILE);
              tma_load_tile<D, WK>(tiles + s * TILE, map, full + 8 * s,
                                   (x.kj0 + j) * WK, x.kv_row);
            }
          }
        }
      };
      if (role == 2)
        load_ring(&tk, b + L::k, b + L::kfull, b + L::kempty);
      else
        load_ring(&tv, b + L::v, b + L::vfull, b + L::vempty);
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows wq0 .. wq0 + 63 of
    // each q tile
    setmaxnreg_inc<L::kConsumerRegs>();
    const int wg = warp / 4;
    uint8_t* Ow = Os + wg * 64 * L::atom;  // its rows of the staging tile
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // ring tile t, which this warpgroup's rows do not meet: released
    // once it has landed (an arrival before would count toward the
    // slot's last use)
    auto pass = [&](int t) {
      const int s = t % STAGES;
      const uint32_t ph = (t / STAGES) & 1;
      mbar_wait_spin(&kfull[s], ph);
      release(&kempty[s]);
      mbar_wait_spin(&vfull[s], ph);
      release(&vempty[s]);
    };
    int r = 0, qi = 0;
    // A q tile's O waits in registers for its store until the next
    // tile's first S is in flight (`pend`: its head, rows, max and sums)
    float oacc[D / 2], pm[2], psum[2];
    bool pend = false;
    int pbh = 0, pwq0 = 0, pqrow = 0;
    auto store_pending = [&]() {
      if (!pend) return;
      // the staging rows are free once the last store's reads are done
      wg_barrier(1 + wg);
      store_rows<D>(oacc, pm, psum, Ow, o, lse, pbh, pwq0, pqrow, Sq, hd,
                    wg);
      pend = false;
    };
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      for (int half = 0; half < halves; ++half) {
        const FwdItem x = narrow_item(w, half, BH, grp, Sq, Sk, q_offset,
                                      k_offset, causal, window, ragged);
        if (x.q0 < 0) continue;
        const int wq0 = x.q0 + 64 * wg;
        const int qrow = wq0 + 16 * (warp % 4) + lane / 4;  // and qrow + 8
        float m[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f};
        if (x.n > 0) {
          const int qs = qi % QS;  // the q tile's Q slot
          const uint64_t qdesc =
              desc_sw<D>(Qs + qs * L::qtile + wg * 64 * L::atom);
          mbar_wait_spin(&qfull[qs], (qi / QS) & 1);
          ++qi;
          // this warpgroup's run of the q tile's live tiles, tiles a ..
          // a + n - 1 of them; a warpgroup whose rows lie past Sq meets
          // none
          int kj0 = x.kj0;
          const int n =
              wq0 < Sq ? live_tiles<WK>(wq0, min(wq0 + 64, Sq) - 1, Sk,
                                        q_offset, k_offset, causal, window,
                                        kj0)
                       : 0;
          const int a = n > 0 ? kj0 - x.kj0 : 0;
          for (int j = 0; j < a; ++j) pass(r + j);
          if (n > 0) {
            const int r0 = r + a;
            uint32_t pa[WK / 16][4];
            float corr[2];
            {
              // its first tile: S alone, the last q tile's store under it
              const int s = r0 % STAGES, k0 = (x.kj0 + a) * WK;
              float sacc[WK / 2];
              mbar_wait_spin(&kfull[s], (r0 / STAGES) & 1);
              wgmma_fence();
              issue_scores<D, WK>(sacc, qdesc, Ks + s * TILE);
              wgmma_commit();
              store_pending();
#pragma unroll
              for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
              wgmma_wait<0>();
              fence_operands(sacc);
              release(&kempty[s]);
              if (n == 1) release(&qempty[qs]);  // its last S of the tile
              if (tile_masked<WK>(wq0, k0, Sk, q_offset, k_offset, causal,
                                  window))
                mask_rows(sacc, qrow, k0, Sk, q_offset, k_offset, causal,
                          window);
              online_softmax<WK / 2, L::CHAINS>(sacc, m, lsum, corr,
                                                scale_log2);  // O is 0 yet
#pragma unroll
              for (int kk = 0; kk < WK / 16; ++kk) pack_a(sacc, kk, pa[kk]);
            }
            for (int j = 1; j < n; ++j) {
              // S of tile j and P V of tile j - 1 issued together; the
              // softmax of j runs while P V is still in flight
              const int t = r0 + j, s = t % STAGES, sp = (t - 1) % STAGES;
              const int k0 = (x.kj0 + a + j) * WK;
              float sacc[WK / 2];
              mbar_wait_spin(&kfull[s], (t / STAGES) & 1);
              mbar_wait_spin(&vfull[sp], ((t - 1) / STAGES) & 1);
              wgmma_fence();
              issue_scores<D, WK>(sacc, qdesc, Ks + s * TILE);
              wgmma_commit();
              issue_values<D, WK>(oacc, pa, Vs + sp * TILE);
              wgmma_commit();
              wgmma_wait<1>();
              fence_operands(sacc);
              release(&kempty[s]);
              if (j == n - 1) release(&qempty[qs]);
              if (tile_masked<WK>(wq0, k0, Sk, q_offset, k_offset, causal,
                                  window))
                mask_rows(sacc, qrow, k0, Sk, q_offset, k_offset, causal,
                          window);
              online_softmax<WK / 2, L::CHAINS>(sacc, m, lsum, corr,
                                                scale_log2);
              wgmma_wait<0>();
              fence_operands(oacc);
              fence_operands(pa);
              release(&vempty[sp]);
#pragma unroll
              for (int i = 0; i < D / 2; ++i) oacc[i] *= corr[(i / 2) % 2];
#pragma unroll
              for (int kk = 0; kk < WK / 16; ++kk) pack_a(sacc, kk, pa[kk]);
            }
            // its last tile's P V
            const int t = r0 + n - 1, sp = t % STAGES;
            mbar_wait_spin(&vfull[sp], (t / STAGES) & 1);
            wgmma_fence();
            issue_values<D, WK>(oacc, pa, Vs + sp * TILE);
            wgmma_commit();
            wgmma_wait<0>();
            fence_operands(oacc);
            release(&vempty[sp]);
          } else {
            // its rows meet no tile: O = 0
            release(&qempty[qs]);
            store_pending();
#pragma unroll
            for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
          }
          for (int j = a + n; j < x.n; ++j) pass(r + j);
          r += x.n;
        } else {
          // no live tile: O = 0
          store_pending();
#pragma unroll
          for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
        }
        pend = true;
        pbh = x.bh;
        pwq0 = wq0;
        pqrow = qrow;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          pm[i] = m[i];
          psum[i] = lsum[i];
        }
      }
    }
    store_pending();
    release(done);
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, float* lse, int B, int H, int KVH, int Sq,
                         int Sk, int hd, int q_offset, int k_offset,
                         int causal, int window, float scale,
                         cudaStream_t stream) {
  // with Sk == 0 no K/V tile is loaded; the maps still need an extent
  const void* kp = Sk > 0 ? k : q;
  const void* vp = Sk > 0 ? v : q;
  const int krows = Sk > 0 ? Sk : Sq, kslabs = Sk > 0 ? B * KVH : B * H;
  CUtensorMap tq, tk, tv;
  // the Q tile: a warpgroup's 64 rows at width 256, three warpgroups' 192
  // at 16 and 32, else 128; the K/V tile: 64 rows at width 256, else 128
  constexpr int QR = D == 256 ? Wide256::QR : D <= 32 ? Narrow::QT : WQ;
  constexpr int WK = D == 256 ? Wide256::WK : 128;
  static_assert(WgmmaLayout<64>::WK == 128 && PingPong::WK == 128 &&
                    Narrow::WK == 128,
                "tiles");
  cudaError_t err = encode_rows_map<D>(&tq, q, hd, Sq, B * H, QR);
  if (err == cudaSuccess)
    err = encode_rows_map<D>(&tk, kp, hd, krows, kslabs, WK);
  if (err == cudaSuccess)
    err = encode_rows_map<D>(&tv, vp, hd, krows, kslabs, WK);
  if (err != cudaSuccess) return err;
  const int nqt = (Sq + WQ - 1) / WQ;
  const int grid = nqt * (B * H);
  if constexpr (D == 256) {
    constexpr size_t smem = Wide256::bytes;
    err = allow_smem(flash_fwd_w256_kernel, smem);
    if (err != cudaSuccess) return err;
    int sms = 0;
    err = multiprocessors(&sms);
    if (err != cudaSuccess) return err;
    // The schedule by shape: where the q tiles fill at most one wave, one
    // a CTA, heaviest first (pairing them would idle half the SMs);
    // else persistent over pairs of q tiles in groups of heads whose K
    // and V fit in L2, as at width 128.
    const bool paired = grid > sms;
    const int pairs = (Sq + 2 * WQ - 1) / (2 * WQ);
    const int group = paired ? l2_group(4ll * hd * Sk, B * H) : B * H;
    const int per = paired ? group * pairs : grid;
    const int items = paired ? pairs * B * H : grid;
    flash_fwd_w256_kernel<<<min(items, sms), kWideThreads, smem, stream>>>(
        tq, tk, tv, static_cast<bf16*>(o), lse, B * H, H / KVH, Sq, Sk, hd,
        q_offset, k_offset, causal, window, scale * kLog2e, group, per,
        items, paired ? 2 : 1);
  } else if constexpr (D == 128) {
    constexpr size_t smem = PingPong::bytes;
    err = allow_smem(flash_fwd_pingpong_kernel, smem);
    if (err != cudaSuccess) return err;
    // a head's K and V: Sk rows of 2 * hd bytes each
    const int group = l2_group(4ll * hd * Sk, B * H);
    // persistent: one CTA per SM, at most one per item
    int sms = 0;
    err = multiprocessors(&sms);
    if (err != cudaSuccess) return err;
    // work items (pairs of q tiles of a head), and those of one group
    const int pairs = (Sq + 2 * WQ - 1) / (2 * WQ), items = pairs * B * H;
    flash_fwd_pingpong_kernel<<<min(items, sms), kWideThreads, smem,
                                stream>>>(
        tq, tk, tv, static_cast<bf16*>(o), lse, B * H, H / KVH, Sq, Sk, hd,
        q_offset, k_offset, causal, window, scale * kLog2e, group,
        group * pairs, items);
  } else if constexpr (D <= 32) {
    constexpr size_t smem = NarrowLayout<D>::bytes;
    auto kernel = flash_fwd_narrow_kernel<D>;
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    int sms = 0;
    err = multiprocessors(&sms);
    if (err != cudaSuccess) return err;
    // The schedule by shape, as at width 256: where the 192-row q tiles
    // fill at most one wave, one a CTA, heaviest first; else persistent,
    // one CTA an SM over pairs of q tiles (every head's K and V fit in L2
    // at these widths: no groups of heads)
    const int nqt = (Sq + Narrow::QT - 1) / Narrow::QT;
    const bool paired = nqt * B * H > sms;
    const int items = (paired ? (nqt + 1) / 2 : nqt) * B * H;
    kernel<<<min(items, sms), Narrow::THREADS, smem, stream>>>(
        tq, tk, tv, static_cast<bf16*>(o), lse, B * H, H / KVH, Sq, Sk, hd,
        q_offset, k_offset, causal, window, scale * kLog2e, items,
        paired ? 2 : 1,
        narrow_ragged_rank(Sq, Sk, q_offset, k_offset, causal, window));
  } else {
    constexpr size_t smem = WgmmaLayout<D>::bytes;
    err = allow_smem(flash_fwd_wgmma_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    flash_fwd_wgmma_kernel<D><<<grid, WTHREADS, smem, stream>>>(
        tq, tk, tv, static_cast<bf16*>(o), lse, B * H, H, KVH, Sq, Sk, hd,
        q_offset, k_offset, causal, window, scale * kLog2e);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int KVH, int Sq, int Sk, int hd,
                   int q_offset, int k_offset, int causal, int window,
                   float scale, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16>) {
    return launch_wgmma<D>(q, k, v, o, lse, B, H, KVH, Sq, Sk, hd, q_offset,
                           k_offset, causal, window, scale, stream);
  } else if constexpr (D <= 32) {
    // f32 at widths 16 and 32: a warp a strip of 16 query rows
    constexpr size_t smem = f32n::FwdSmem<D>::bytes;
    auto kernel = f32n::flash_fwd_f32_narrow_kernel<D>;
    cudaError_t err = etpu::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((B * H + f32n::kWarps - 1) / f32n::kWarps,
                    (Sq + f32n::ROWS - 1) / f32n::ROWS);
    kernel<<<grid, f32n::kWarps * 32, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, B * H,
        f32n::FastDiv::of(H / KVH), Sq, Sk, hd, q_offset, k_offset, causal,
        window, scale * kLog2e);
    return cudaGetLastError();
  } else {
    const dim3 grid((Sq + BQ - 1) / BQ, B * H);
    constexpr size_t smem = flash_smem_bytes<D>();
    auto kernel = flash_fwd_kernel<T, D>;
    cudaError_t err = etpu::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, H, KVH, Sq, Sk,
        hd, q_offset, k_offset, causal, window, scale);
    return cudaGetLastError();
  }
}

}  // namespace

// q (B, H, Sq, hd), k/v (B, KVH, Sk, hd), o (B, H, Sq, hd), all
// contiguous and of one type (is_bf16 ? bf16 : f32; bf16 q/k/v 16-byte
// aligned); lse (B, H, Sq) f32. hd is a multiple of 8 from 8 to 256 (any
// other returns cudaErrorInvalidValue). window <= 0 means no sliding
// window. Returns cudaGetLastError() after the launch.
extern "C" int etpu_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int H, int KVH,
                              int Sq, int Sk, int hd, int q_offset,
                              int k_offset, int causal, int window,
                              float scale, int is_bf16, void* stream) {
  if (B * H == 0 || Sq == 0) return cudaSuccess;
  if (KVH <= 0 || H % KVH) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  return etpu::with_head_dim(hd, [&](auto w) {
    constexpr int W = decltype(w)::value;
    return is_bf16 ? launch<bf16, W>(q, k, v, o, l, B, H, KVH, Sq, Sk, hd,
                                     q_offset, k_offset, causal, window,
                                     scale, s)
                   : launch<float, W>(q, k, v, o, l, B, H, KVH, Sq, Sk, hd,
                                      q_offset, k_offset, causal, window,
                                      scale, s);
  });
}

extern "C" const char* etpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
