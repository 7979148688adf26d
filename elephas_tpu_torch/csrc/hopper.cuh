// Hopper (sm_90a) building blocks for the port's hand-written kernels.
//
// Small inline-PTX wrappers, each named after what it wraps:
// - TMA: `tma_load_3d` is `cp.async.bulk.tensor.3d` from a tensor map
//   into shared memory, completing on an mbarrier's transaction count;
//   `encode_rows_map` (host) builds the map of a (slabs, rows, D) bf16
//   tensor with `cuTensorMapEncodeTiled`, fetched through the runtime's
//   driver entry point, so the library links against no libcuda.
// - mbarrier: `mbar_init` (`mbarrier.init`), `fence_barrier_init`
//   (`fence.mbarrier_init`), `mbar_expect_tx`
//   (`mbarrier.arrive.expect_tx`: arrive and expect that many bytes),
//   `mbar_arrive` (`mbarrier.arrive`), `mbar_wait`
//   (`mbarrier.try_wait.parity` in a loop: returns once the phase of
//   the given parity has completed). The loop is a watchdog: after
//   about 4 s by `%globaltimer` it executes `trap`, so a phase that can
//   never complete (a wrong parity, a producer that skips a tile its
//   consumers still wait for) aborts the kernel instead of hanging the
//   card. The error ("unspecified launch failure") surfaces at the
//   next synchronising call on the stream and leaves the CUDA context
//   unusable: the process has to exit.
// - wgmma: `wgmma_fence` / `wgmma_commit` / `wgmma_wait<N>`
//   (`wgmma.fence`, `commit_group`, `wait_group`), `fence_operands`
//   (keeps the compiler from touching accumulator registers across an
//   asynchronous product), `wgmma_ss_n64` / `wgmma_ss_n128` (m64nNk16
//   bf16 -> f32, A and B from shared memory) and `wgmma_rs_tb<N>`
//   (m64nNk16 for N = 16, 32, 64: A from registers, B MN-major from
//   shared memory).
// - cp.async: `cp_async_16` (`cp.async.cg.shared.global`, 16 bytes from
//   device memory into shared memory, bypassing L1), `cp_async_commit`
//   and `cp_async_wait<N>` (`cp.async.commit_group` / `wait_group`:
//   returns once at most N of this thread's groups are in flight; the
//   finished copies are then visible to this thread).
// - Tiles of head_dim D: a bf16 row is 2*D bytes (128 at D 64, 64 at D
//   32, 32 at D 16) and lies in the swizzle of its own width, which TMA
//   writes (CU_TENSOR_MAP_SWIZZLE_128B / 64B / 32B) and wgmma reads
//   (`desc_sw<D>`: the 64-bit shared-memory matrix descriptor; `swz<D>`:
//   the byte offset of a 16-byte chunk under that swizzle).
// - `with_head_dim` (host): the one switch over the head dims the flash
//   kernels are instantiated for.
// - `wg_barrier` (`bar.sync id, 128`): one warpgroup's named barrier.
// - `exp2_ftz` (`ex2.approx.ftz.f32`): the softmax's exponential.
// - Accumulator helpers on the documented wgmma D layout (thread t of a
//   warpgroup holds, for each 8-column group j, rows 16*(t/32) + (t%32)/4
//   and that + 8 at columns 8j + 2*(t%4) and + 1): `pack_a` turns the
//   16 columns of one k step into the bf16 A fragment of an RS product,
//   `acc_to_tile<D>` stores a 64 x D accumulator as bf16 into a swizzled
//   shared tile, and `tile_to_rows<D>` copies such a tile out to device
//   memory with 16-byte stores, dropping rows past a limit.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace etpu {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The bf16 tiles of head_dim D: one row is 2*D bytes, stored in the
// swizzle of that width (TMA and wgmma agree on it). The swizzle XORs
// address bits 7.. into the 16-byte chunk index (bits 4..): 3 bits at
// 128-byte rows (chunk c of row r at c ^ (r % 8)), 2 at 64-byte rows (c
// ^ (r / 2 % 4)), 1 at 32-byte rows (c ^ (r / 4 % 2)); the pattern
// repeats every 8 rows, 1024, 512 or 256 bytes.
template <int D>
struct Rows {
  static_assert(D == 16 || D == 32 || D == 64,
                "the bf16 tiles take head_dim 16, 32 or 64");
  static constexpr int bytes = 2 * D;
  // the wgmma descriptor's layout type: 1 = 128B, 2 = 64B, 3 = 32B
  static constexpr uint64_t layout = D == 64 ? 1 : D == 32 ? 2 : 3;
  // the same swizzle as TMA names it
  static constexpr CUtensorMapSwizzle tma_swizzle =
      D == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
      : D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                : CU_TENSOR_MAP_SWIZZLE_32B;
};

// The head dims the flash kernels are instantiated for, in one place
// (SUPPORTED_HEAD_DIMS in ops/flash_attention.py names the same set):
// calls f(std::integral_constant<int, D>{}) and returns its result, or
// cudaErrorInvalidValue at any other head dim.
template <typename F>
inline cudaError_t with_head_dim(int D, F&& f) {
  switch (D) {
    case 16:
      return f(std::integral_constant<int, 16>{});
    case 32:
      return f(std::integral_constant<int, 32>{});
    case 64:
      return f(std::integral_constant<int, 64>{});
    default:
      return cudaErrorInvalidValue;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Dynamic shared memory rounded up to 1024 bytes: the widest swizzle
// repeats every 8 rows (1024 bytes) and both TMA and wgmma apply it on
// address bits, so every tile starts on such a boundary (every tile here
// is a multiple of 8 rows, so a tile after it does too).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// ------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// The low 32 bits of the global nanosecond timer.
__device__ __forceinline__ uint32_t globaltimer_lo() {
  uint32_t t;
  asm volatile("mov.u32 %0, %%globaltimer_lo;\n" : "=r"(t));
  return t;
}

// A wait longer than this traps (see mbar_wait): no phase of these
// kernels legitimately takes more than a millisecond.
constexpr uint32_t kWaitTrapNs = 4000000000u;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const uint32_t t0 = globaltimer_lo();
  uint32_t tries = 0;
  while (!mbar_try_wait(addr, parity)) {
    // every 1024 tries, check the clock (32-bit differences wrap
    // correctly across the timer's low word)
    if ((++tries & 1023u) == 0 && globaltimer_lo() - t0 > kWaitTrapNs)
      __trap();
  }
}

// ------------------------------------------------------------------ TMA
// The box at coordinates (c0, c1, c2) = (column, row, slab) of `map`
// into shared memory at `dst`; completes `bytes` on `bar`. Rows past the
// map's row extent arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// ------------------------------------------------------------- cp.async
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------- wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of a shared tile of head_dim-D rows (2*D bytes) in the
// swizzle of that width: start address >> 4 (bits 0-13); leading and
// stride byte offsets (bits 16-29, 32-45) both 8 rows (2*D*8 bytes) >>
// 4, the step between 8-row groups (the leading offset is unused by
// every product here: a K-major k16 step stays inside one row, an
// MN-major operand is one swizzle width, D columns, wide); layout type
// (bits 62-63) from `Rows<D>`. A K-major operand steps along K by 32
// bytes (+2), an MN-major one by 16 rows (+2*D).
template <int D>
__device__ __forceinline__ uint64_t desc_sw(const void* tile) {
  constexpr uint64_t group = 8 * Rows<D>::bytes;
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFFu) >> 4) |
         ((group >> 4) << 16) | ((group >> 4) << 32) |
         (Rows<D>::layout << 62);
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a swizzled tile
// of head_dim-D rows (the tile starts on a 1024-byte boundary).
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  constexpr int kRow = Rows<D>::bytes;
  const int off = row * kRow + chunk * 16;
  return off ^ (((off >> 7) & (kRow / 16 - 1)) << 4);
}

// D (64 x 64, f32) (+)= A (64 x 16) . B (16 x 64), bf16 in, both from
// shared memory K-major (no transpose); scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 128, f32) (+)= A (64 x 16) . B (16 x 128), bf16 in, both from
// shared memory K-major (no transpose); scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16) . B (16 x 64), bf16 in: A from
// registers (the fragment `pack_a` makes), B from shared memory stored
// MN-major (N contiguous), so its transpose bit is set.
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// The same at N = 32 (head_dim 32): D 64 x 32.
__device__ __forceinline__ void wgmma_rs_n32_tb(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// The same at N = 16 (head_dim 16): D 64 x 16.
__device__ __forceinline__ void wgmma_rs_n16_tb(float (&d)[8],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x N) += A (64 x 16, registers) . B (16 x N, MN-major), for the
// products whose N is the head dim.
template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  if constexpr (N == 64)
    wgmma_rs_n64_tb(d, a, desc_b);
  else if constexpr (N == 32)
    wgmma_rs_n32_tb(d, a, desc_b);
  else
    wgmma_rs_n16_tb(d, a, desc_b);
}

// ---------------------------------------------------- warpgroup sync
// Barrier `id` (1..15; 0 is __syncthreads) over the 128 threads of one
// warpgroup.
__device__ __forceinline__ void wg_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// ---------------------------------------------------------------- math
// 2^x as one MUFU instruction (`ex2.approx.ftz.f32`): a result below
// 2^-126 flushes to 0, which no softmax weight here can tell from its
// neighbours; exp2f would add a range fix-up around the same instruction.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------- accumulator <-> fragments
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of k step `kk` (accumulator columns 16kk .. 16kk+15)
// for an RS product: for 16-bit A the wgmma A layout is the D layout of
// those columns, two values per register.
template <int R>
__device__ __forceinline__ void pack_a(const float (&d)[R], int kk,
                                       uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// A 64 x D f32 accumulator, row r scaled by `lo` (rows 16w + t%32/4)
// or `hi` (those + 8), as bf16 into a 64-row tile of head_dim-D rows in
// their swizzle (`swz<D>`): at D 64 a warp's stores hit 32 distinct
// banks.
template <int D>
__device__ __forceinline__ void acc_to_tile(const float (&d)[D / 2],
                                            float lo, float hi,
                                            uint8_t* tile) {
  const int t = threadIdx.x % 128, l = t % 32;
  const int r = 16 * (t / 32) + l / 4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      const float s = h ? hi : lo;
      *reinterpret_cast<uint32_t*>(tile + swz<D>(row, j) + (l % 4) * 4) =
          pack_bf16(d[4 * j + 2 * h] * s, d[4 * j + 2 * h + 1] * s);
    }
}

// The warpgroup's swizzled 64-row tile -> rows [0, limit) of `dst` (D
// bf16 per row), 16 bytes per store, D/8 threads to a row.
template <int D>
__device__ __forceinline__ void tile_to_rows(const uint8_t* tile,
                                             __nv_bfloat16* dst, int limit) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  const int t = threadIdx.x % 128;
#pragma unroll
  for (int i = 0; i < 64 * kChunks / 128; ++i) {
    const int idx = t + 128 * i, row = idx / kChunks, c = idx % kChunks;
    if (row < limit)
      *reinterpret_cast<uint4*>(dst + (size_t)row * D + c * 8) =
          *reinterpret_cast<const uint4*>(tile + swz<D>(row, c));
  }
}

// ------------------------------------------------------ host: tensor maps
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a contiguous (slabs, rows, D) bf16 tensor as dims (D, rows,
// slabs), boxes of D x box_rows x 1 in the swizzle of `Rows<D>`; rows
// past `rows` of a slab read as zeros. `base` must be 16-byte aligned.
template <int D>
inline cudaError_t encode_rows_map(CUtensorMap* map, const void* base,
                                   int rows, int slabs, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t row_bytes = Rows<D>::bytes;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)slabs};
  const cuuint64_t strides[2] = {row_bytes, (cuuint64_t)rows * row_bytes};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         Rows<D>::tma_swizzle,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace etpu
