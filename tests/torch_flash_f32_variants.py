"""Where the f32 flash bodies spend their time: timing-only builds of a
tree's f32 bodies.

For each variant the script copies TREE's ``elephas_tpu_torch`` into
``TREE/build/variants_f32/<variant>/``, rewrites its kernel sources
there (``base`` leaves them as they are),
builds the copy with the package's own ``_kernels.build`` and, in a
process of its own, reports:

- ptxas's registers for each f32 body (``-Xptxas -v``) and its resident
  CTAs a SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, through
  a probe appended to each copied source), with the CTA's threads;
- the device ms of the f32 calls (causal, cold L2, median of 20:
  ``chip_smoke.device_ms``): ``flash_forward`` and ``flash_dkv`` (and
  ``flash_dq`` where the tree has a dQ strip body) at head dims 16 and 32
  on the two shapes the main path runs the strip bodies at:
  ``speculative_example``'s training and distillation steps (B 8 x H 4 x
  S 32) and ``forward_d16``'s forward (B 4 x H 4 x S 96); and, where the
  tree has the tensor-core bodies of widths 64-256, ``flash_dq`` and
  ``flash_dkv`` on the four shapes of the f32 checks that run them
  (``chip_smoke.F32_WIDE_TIMED``).

The variants other than ``base`` time a changed body (``empty``,
``loads_only``, ``no_exchange`` and ``fwd_no_tail`` compute wrong
outputs); none is kept:

- ``empty``: each f32 body returns at entry: the floor of a launch and
  its events under this timer;
- ``loads_only``: the operands staged into shared memory as the body
  stages them, no products, the outputs stored (zeros or what is left);
- ``ffma`` (the strip design only): the products on the CUDA cores
  (FFMA over the same strips, stages and walk) instead of the tensor
  cores' 3xTF32;
- ``warps1``, ``warps2``, ``warps4`` (the strip designs): the strip
  bodies' warps a CTA (a warp a strip);
- ``strips1``, ``strips2``, ``strips8`` (the tensor-core design): the
  wide bodies' strips a CTA (``Wide::NS``; 8 only at width 64, 2 at most
  at 256, where more do not fit shared memory), their CTA's warps being
  the strips times the warps a strip; ``dq256_strips2``: dQ's at width
  256 alone at 2 (1 in the tree);
- ``tile16``, ``tile32`` (the tensor-core design): the rows of the wide
  bodies' streamed tiles (``Wide::TILE``, and the dK/dV plan's q tiles
  with them);
- ``no_exchange`` (the tensor-core design): the strip's warps do not add
  their partial S and dP (no store, barrier or load);
- ``no_dots``, ``no_accum``, ``no_exp`` (the tensor-core design): a
  step without its products S and dP (``dots``), without the gradient
  products (``accum_n``), or with the exponential left out of P;
- ``chains4`` (the tensor-core design): ``dots`` with two sums each of
  the big and the small terms, by k chunk parity (chains half as long);
- ``unroll2`` (the tensor-core design): the wide bodies' loop over a
  stage's steps unrolled by 2, as against rolled;
- ``unroll8`` (the strip design only): the copy loop and the loop over
  a stage's steps unrolled by 8, as against rolled;
- ``split_rna`` (the strip design only): each operand's TF32 parts
  rounded by ``cvt.rna.tf32.f32`` instead of cut;
- ``fwd_no_tail`` (the strip design only): the forward stores nothing
  (no division, log or store after the walk);
- ``timeline`` (the strip design only): the bodies as they are, with
  lane 0 of every strip's warp stamping ``clock64()`` at the phases of
  its walk; after one cold call each the script reports every phase's
  SM cycles (median and max over the warps): the loads issued, the wait
  for the first stage, the products to the last stage's end, the ring
  drained, the stores.

``--warm`` times without the flush, so each call finds the L2 warm (its
operands and its code). ptxas's stack frame and spill line is reported
for each body.

The rewrites name the text of each design's f32 bodies (``PATTERNS``):
``tensor_cores``, the backward of ``csrc/flash_bwd_f32.cu`` (strips at
widths 16 and 32 for the forward, dQ and dK/dV, and CTAs of strips at
64-256 for dQ and dK/dV); ``strips``, the forward's and dK/dV's strips
of ``csrc/f32_narrow.cuh`` alone, dK/dV's in ``csrc/flash_bwd.cu``; and
``cuda_cores``, the 256-thread CUDA-core bodies over 64 x 64 tiles that
ran these widths before them. The first whose kernels the sources
define is the tree's design; a variant a design does not have is
reported as such. It needs the card. Run the
variants in one call, so they share a card:

    python tests/torch_flash_f32_variants.py [--warm] [--variants base,empty,loads_only] [TREE]
"""
import json
import os
import re
import shutil
import subprocess
import sys

FWD, BWD = "flash_fwd.cu", "flash_bwd.cu"
F32B = "flash_bwd_f32.cu"

# The timeline variant: lane 0 of each strip's warp writes clock64() at
# six points (entry; the loads issued; the first stage landed; the last
# stage's products done; the ring drained; the stores issued) into a
# per-file device array that the script reads back after one call.
NSTAMP = 8192
STAMPS = (f"static __device__ long long f32n_clock[{NSTAMP}][6];\n")


def _stamp(k, indent="  "):
    at = "(blockIdx.y * gridDim.x + blockIdx.x) * kWarps + warp"
    return (f"{indent}if (lane == 0 && {at} < {NSTAMP}) f32n_clock[{at}][{k}]"
            f" = clock64();\n")


def _stamp_reader(part):
    return (f"\n// timing-only clock stamps (tests/torch_flash_f32_variants.py)"
            f"\nextern \"C\" int etpu_stamps_{part}(long long* out, int n, "
            f"int clear) {{\n  if (clear) {{\n    static long long zeros[{NSTAMP}]"
            f"[6];\n    return cudaMemcpyToSymbol(etpu::f32n::f32n_clock, zeros,"
            f" sizeof(zeros));\n  }}\n  return cudaMemcpyFromSymbol(out, "
            f"etpu::f32n::f32n_clock, sizeof(long long) * 6 * n);\n}}\n")


# The strip design's CUDA-core build (`ffma`): the same strips, stages
# and walk, the products by FFMA over rows read from shared memory, P's
# row gathered from the quad by shuffles. Each entry is the body of the
# function of that name in csrc/f32_narrow.cuh.
FFMA_BODIES = {
    "load_strip": """  constexpr int L = LD<W>;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < W; c += 4) {
      const float4 x =
          *reinterpret_cast<const float4*>(tile + (g + 8 * r) * L + c);
      s.row[r][c] = x.x;
      s.row[r][c + 1] = x.y;
      s.row[r][c + 2] = x.z;
      s.row[r][c + 3] = x.w;
    }""",
    "dots": """  constexpr int L = LD<W>;
#pragma unroll
  for (int e = 0; e < 4; ++e) s[e] = 0.f;
#pragma unroll
  for (int c = 0; c < W; c += 4) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float4 x =
          *reinterpret_cast<const float4*>(tile + (2 * t + j) * L + c);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float& acc = s[2 * r + j];
        acc = fmaf(a.row[r][c], x.x, acc);
        acc = fmaf(a.row[r][c + 1], x.y, acc);
        acc = fmaf(a.row[r][c + 2], x.z, acc);
        acc = fmaf(a.row[r][c + 3], x.w, acc);
      }
    }
  }""",
    "accum": """  constexpr int L = LD<W>;
  float pr[2][8];
  const int quad = (threadIdx.x % 32) & ~3;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pr[e / 2][2 * u + e % 2] = __shfl_sync(0xffffffffu, p[e], quad + u);
#pragma unroll
  for (int j = 0; j < STEP; ++j)
#pragma unroll
    for (int n = 0; n < W / 8; ++n) {
      const float2 x =
          *reinterpret_cast<const float2*>(tile + j * L + 8 * n + 2 * t);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        acc[n][2 * r] = fmaf(pr[r][j], x.x, acc[n][2 * r]);
        acc[n][2 * r + 1] = fmaf(pr[r][j], x.y, acc[n][2 * r + 1]);
      }
    }"""}


def _body(name, text, file="f32_narrow.cuh"):
    """A rewrite of the body of `name` in csrc/f32_narrow.cuh (or
    ``file``)."""
    return (file,
            f"re:(__device__ __forceinline__ void {name}\\(.*?\\{{\\n).*?"
            f"(\\n}}\\n)", f"\\g<1>{text}\\g<2>", 1)


def _per_dim(file, frag, dims=(16, 32)):
    return {d: (file, frag.format(d=d)) for d in dims}


def _probe_per_dim(kernel, threads, smem, dims=(16, 32)):
    return {d: (kernel.format(d=d), threads.format(d=d), smem.format(d=d))
            for d in dims}


# the tensor-core design's wide bodies (widths 64-256)
WIDE_DIMS = (64, 128, 256)
# the plan geometry of ops/flash_attention.py that the wide bodies' rows
# set: {width: (k tile rows, q tile rows, CTAs an SM)}
PLAN_TABLE = ("../ops/flash_attention.py",
              "_F32_WIDE = {64: (64, 64, 2), 128: (64, 64, 1), "
              "256: (32, 32, 1)}")


def _geometry(ns, tile, ns_dq=None):
    """Rewrites of the wide bodies' strips a CTA (``ns``: width -> NS;
    dQ's ``ns_dq``, by default the same) and streamed tile rows
    (``tile``: width -> TILE), the dK/dV plan's rows with them."""
    def pick(m):
        return f"W == 256 ? {m[256]} : W == 128 ? {m[128]} : {m[64]}"
    table = ", ".join(f"{w}: ({16 * ns[w]}, {tile[w]}, {1 + (w == 64)})"
                      for w in WIDE_DIMS)
    return [
        (F32B, "re:using DqWide = Wide<W, [^;]*>;",
         f"using DqWide = Wide<W, {pick(ns_dq or ns)}>;", 1),
        (F32B, "re:using DkvWide = Wide<W, [^;]*>;",
         f"using DkvWide = Wide<W, {pick(ns)}>;", 1),
        (F32B, "static constexpr int TILE = W == 256 ? 32 : 64;",
         f"static constexpr int TILE = {pick(tile)};", 1),
        (PLAN_TABLE[0], PLAN_TABLE[1], f"_F32_WIDE = {{{table}}}", 1)]


# `dots` with two sums each of the big and the small terms, by k chunk
# parity (chains half as long)
CHAINS4 = """  float big[2][4] = {}, small[2][4] = {};
#pragma unroll
  for (int kc = 0; kc < W / 8; ++kc) {
    const float* p = tile + g * L + kc * 8 + t;
    uint32_t h0, l0, h1, l1;
    split(p[0], h0, l0);
    split(p[4], h1, l1);
    mma(small[kc & 1], a.lo[kc], h0, h1);
    mma(small[kc & 1], a.hi[kc], l0, l1);
    mma(big[kc & 1], a.hi[kc], h0, h1);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    s[e] = (big[0][e] + big[1][e]) + (small[0][e] + small[1][e]);"""
BASE_NS = {64: 4, 128: 4, 256: 2}
BASE_NS_DQ = {64: 4, 128: 4, 256: 1}
BASE_TILE = {64: 64, 128: 64, 256: 32}


# The f32 bodies of a design: their mangled names, the instantiations
# and launch shapes the occupancy probe asks about (kernel, threads,
# shared bytes), and for each variant the rewrites, (file, old, new,
# count) each, or a regular expression (file, pattern, new, count) where
# ``old`` starts with "re:".
PATTERNS = {
    "tensor_cores": {
        "kernels": {
            "fwd": _per_dim(FWD, "flash_fwd_f32_narrow_kernelILi{d}E"),
            "dq": {**_per_dim(F32B, "flash_dq_f32_narrow_kernelILi{d}E"),
                   **_per_dim(F32B, "flash_dq_f32_wide_kernelILi{d}E",
                              WIDE_DIMS)},
            "dkv": {**_per_dim(F32B, "flash_dkv_f32_narrow_kernelILi{d}E"),
                    **_per_dim(F32B, "flash_dkv_f32_wide_kernelILi{d}E",
                               WIDE_DIMS)}},
        "probe": {
            "fwd": _probe_per_dim(
                "etpu::f32n::flash_fwd_f32_narrow_kernel<{d}>",
                "etpu::f32n::kWarps * 32", "etpu::f32n::FwdSmem<{d}>::bytes"),
            "dq": {**_probe_per_dim(
                "etpu::f32n::flash_dq_f32_narrow_kernel<{d}>",
                "etpu::f32n::kWarps * 32", "etpu::f32n::DqSmem<{d}>::bytes"),
                   **_probe_per_dim(
                "etpu::f32w::flash_dq_f32_wide_kernel<{d}>",
                "etpu::f32w::DqWide<{d}>::THREADS",
                "etpu::f32w::DqWide<{d}>::dq_bytes", WIDE_DIMS)},
            "dkv": {**_probe_per_dim(
                "etpu::f32n::flash_dkv_f32_narrow_kernel<{d}>",
                "etpu::f32n::kWarps * 32", "etpu::f32n::DkvSmem<{d}>::bytes"),
                    **_probe_per_dim(
                "etpu::f32w::flash_dkv_f32_wide_kernel<{d}>",
                "etpu::f32w::DkvWide<{d}>::THREADS",
                "etpu::f32w::DkvWide<{d}>::dkv_bytes", WIDE_DIMS)}},
        "wide": True,
        "empty": [
            (FWD, "  Strip<W> strip;  // the warp's strip (fwd)\n",
             "  if (W > 0) return;\n  Strip<W> strip;\n", 1),
            (F32B, "  Strip<W> strip;  // the warp's strip (dkv)\n",
             "  if (W > 0) return;\n  Strip<W> strip;\n", 1),
            (F32B, "  Strip<W> qstrip, ostrip;  // the warp's strip of Q "
                   "and of dO\n",
             "  if (W > 0) return;\n  Strip<W> qstrip, ostrip;\n", 1),
            *((F32B, f"  using G = {g}<W>;\n",
               f"  using G = {g}<W>;\n  if (W > 0) return;\n", 1)
              for g in ("DqWide", "DkvWide"))],
        "loads_only": [
            _body("dots", "  s[0] = s[1] = s[2] = s[3] = 0.f;"),
            _body("accum_n", "")],
        **{f"warps{n}": [("f32_narrow.cuh", "re:constexpr int kWarps = \\d;",
                          f"constexpr int kWarps = {n};", 1)]
           for n in (1, 2, 4)},
        "strips1": _geometry({64: 1, 128: 1, 256: 1}, BASE_TILE),
        "strips2": _geometry({64: 2, 128: 2, 256: 2}, BASE_TILE),
        "strips8": _geometry({64: 8, 128: 4, 256: 2}, BASE_TILE),
        "dq256_strips2": _geometry(BASE_NS, BASE_TILE,
                                   {64: 4, 128: 4, 256: 2}),
        "tile16": _geometry(BASE_NS, {64: 16, 128: 16, 256: 16}, BASE_NS_DQ),
        "tile32": _geometry(BASE_NS, {64: 32, 128: 32, 256: 32}, BASE_NS_DQ),
        "no_exchange": [_body("exchange", "", F32B)],
        "no_dots": [_body("dots", "  s[0] = s[1] = s[2] = s[3] = 0.f;")],
        "no_accum": [_body("accum_n", "")],
        "no_exp": [
            (F32B, "exp2f(fmaf(sc[e], scale_log2, -lse2[e / 2]))",
             "fmaf(sc[e], scale_log2, -lse2[e / 2])", 2),
            (F32B, "exp2f(fmaf(st[e], scale_log2, -lx * kLog2e))",
             "fmaf(st[e], scale_log2, -lx * kLog2e)", 2)],
        "chains4": [_body("dots", CHAINS4)],
        "unroll2": [
            (F32B, "#pragma unroll 1\n    for (int j = 0; j < walk.steps(s); "
                   "++j) {\n      const int kj",
             "#pragma unroll 2\n    for (int j = 0; j < walk.steps(s); "
             "++j) {\n      const int kj", 1),
            (F32B, "#pragma unroll 1\n    for (int j = 0; j < TILE / STEP; "
                   "++j) {",
             "#pragma unroll 2\n    for (int j = 0; j < TILE / STEP; ++j) {",
             1)]},
    "strips": {
        "kernels": {"fwd": _per_dim(FWD, "flash_fwd_f32_narrow_kernelILi{d}E"),
                    "dkv": _per_dim(BWD,
                                    "flash_dkv_f32_narrow_kernelILi{d}E")},
        "probe": {"fwd": _probe_per_dim(
                      "etpu::f32n::flash_fwd_f32_narrow_kernel<{d}>",
                      "etpu::f32n::kWarps * 32",
                      "etpu::f32n::FwdSmem<{d}>::bytes"),
                  "dkv": _probe_per_dim(
                      "etpu::f32n::flash_dkv_f32_narrow_kernel<{d}>",
                      "etpu::f32n::kWarps * 32",
                      "etpu::f32n::DkvSmem<{d}>::bytes")},
        "empty": [
            (FWD, "  Strip<W> strip;  // the warp's strip (fwd)\n",
             "  if (W > 0) return;\n  Strip<W> strip;\n", 1),
            (BWD, "  Strip<W> strip;  // the warp's strip (dkv)\n",
             "  if (W > 0) return;\n  Strip<W> strip;\n", 1)],
        "loads_only": [
            _body("dots", "  s[0] = s[1] = s[2] = s[3] = 0.f;"),
            _body("accum", "")],
        "ffma": [
            ("f32_narrow.cuh", "  uint32_t hi[W / 8][4], lo[W / 8][4];\n",
             "  uint32_t hi[W / 8][4], lo[W / 8][4];\n  float row[2][W];\n",
             1),
            *(_body(name, text) for name, text in FFMA_BODIES.items())],
        **{f"warps{n}": [("f32_narrow.cuh", "re:constexpr int kWarps = \\d;",
                          f"constexpr int kWarps = {n};", 1)]
           for n in (1, 2, 4)},
        "unroll8": [
            ("f32_narrow.cuh", "#pragma unroll 1\n  for (int i = lane; "
             "i < n * CH; i += 32)", "#pragma unroll 8\n  for (int i = lane; "
             "i < n * CH; i += 32)", 1),
            (FWD, "#pragma unroll 1\n    for (int j = 0; j < walk.steps(s); "
             "++j)", "#pragma unroll 8\n    for (int j = 0; j < "
             "walk.steps(s); ++j)", 1),
            (BWD, "#pragma unroll 1\n    for (int j = 0; j < steps; ++j)",
             "#pragma unroll 8\n    for (int j = 0; j < steps; ++j)", 1)],
        "split_rna": [
            ("f32_narrow.cuh",
             "  hi = __float_as_uint(x) & 0xffffe000u;\n"
             "  lo = __float_as_uint(x - __uint_as_float(hi));\n",
             '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));\n'
             '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : '
             '"f"(x - __uint_as_float(hi)));\n', 1)],
        "fwd_no_tail": [
            (FWD, "re:  // a fully masked row keeps O = 0 and LSE = -1e30 \\+ "
                  "log\\(1e-30\\)\n.*?(?=\n}\n)", "", 1)],
        "timeline": [
            rewrite for file, run, strip_wait, part in (
                (FWD, "s", "    if (s == 0) load_strip<W>(strip, Qs, g, t);\n",
                 "fwd"),
                (BWD, "u", "    if (u == 0) {\n", "dkv"))
            for rewrite in (
                (file, "namespace etpu::f32n {\n",
                 "namespace etpu::f32n {\n" + STAMPS, 1),
                (file, f"  if (b{'h' if part == 'fwd' else 'kv'} >= "
                       f"B{'H' if part == 'fwd' else 'KV'}) return;\n",
                 f"  if (b{'h' if part == 'fwd' else 'kv'} >= "
                 f"B{'H' if part == 'fwd' else 'KV'}) return;\n" + _stamp(0),
                 1),
                (file, f"  for (int {run} = 0; {run} < STAGES; ++{run}) "
                       f"issue({run});\n",
                 f"  for (int {run} = 0; {run} < STAGES; ++{run}) "
                 f"issue({run});\n" + _stamp(1), 1),
                (file, strip_wait, f"    if ({run} == 0) " + _stamp(2).strip()
                 + "\n" + strip_wait, 1),
                (file, "    __syncwarp();  // the slot's last reads are done",
                 _stamp(3, "    ") + "    __syncwarp();  // the slot's last "
                 "reads are done", 1),
                (file, "  cp_async_wait<0>();  // no copy outlives the warp "
                       "(a strip of no step)\n",
                 "  cp_async_wait<0>();\n" + _stamp(4), 1),
                (file, "\n}\n\n}  // namespace etpu::f32n",
                 "\n" + _stamp(5) + "}\n\n}  // namespace etpu::f32n", 1))]},
    "cuda_cores": {
        "kernels": {"fwd": _per_dim(FWD, "flash_fwd_kernelIfLi{d}E"),
                    "dkv": _per_dim(BWD, "flash_dkv_f32_kernelILi{d}E")},
        "probe": {"fwd": _probe_per_dim("flash_fwd_kernel<float, {d}>",
                                        "THREADS", "flash_smem_bytes<{d}>()"),
                  "dkv": _probe_per_dim("flash_dkv_f32_kernel<{d}>",
                                        "THREADS", "F32Layout<{d}>::bytes")},
        "empty": [
            (FWD, "  constexpr int RC = D / 16;  // accumulator columns per "
                  "thread\n",
             "  constexpr int RC = D / 16;\n  if (D > 0) return;\n", 1),
            (BWD, "  float *Ks = sm.a, *Vs = sm.b, *Qs = sm.c, *dOs = sm.d;\n",
             "  float *Ks = sm.a, *Vs = sm.b, *Qs = sm.c, *dOs = sm.d;\n"
             "  if (D > 0) return;\n", 1)],
        "loads_only": [
            # the forward: the tile's products and softmax go, the staging
            # of Q, K and V and the stores stay
            (FWD, r"re:    float s\[4\]\[4\];\n.*?(?=  }\n\n#pragma unroll\n"
                  r"  for \(int i = 0; i < 4; \+\+i\) \{\n    const int r = "
                  r"q0 \+ ty \* 4 \+ i;)", "", 1),
            # dK/dV: the same for each (query head, q tile) step
            (BWD, r"re:      // S\^T and dP\^T: key rows ty\*RI \+ i against "
                  r"query rows tx \+ 16\*j\n.*?accumulate<D>\(dk_acc, sm\.ds, "
                  r"Qs, ty, tx\);   // dK \+= dS\^T Q\n", "", 1)]},
}

# name: (B, H, S), head dim 16 or 32, causal
SHAPES = {"speculative_example": (8, 4, 32), "forward_d16": (4, 4, 96)}


def design_of(csrc):
    """The PATTERNS entry whose kernels the sources in ``csrc`` define."""
    sources = {}
    for name in (FWD, BWD, F32B):
        path = os.path.join(csrc, name)
        if os.path.exists(path):
            with open(path) as f:
                sources[name] = f.read()
    for design, p in PATTERNS.items():
        if all(frag.split("ILi")[0].split("IfLi")[0]
               in sources.get(file, "")
               for per_dim in p["kernels"].values()
               for file, frag in per_dim.values()):
            return design
    raise SystemExit("no f32 design of PATTERNS in this tree")


def prepare(tree, variant):
    """The variant's copy of the package; returns (copy root, design), or
    (None, design) where the design has no such variant."""
    design = design_of(os.path.join(tree, "elephas_tpu_torch", "csrc"))
    p = PATTERNS[design]
    if variant != "base" and variant not in p:
        return None, design
    root = os.path.join(tree, "build", "variants_f32", variant)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    shutil.copytree(os.path.join(tree, "elephas_tpu_torch"),
                    os.path.join(root, "elephas_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = os.path.join(root, "elephas_tpu_torch", "csrc")
    for file, old, new, count in ([] if variant == "base" else p[variant]):
        path = os.path.join(csrc, file)
        with open(path) as f:
            src = f.read()
        if old.startswith("re:"):
            src, found = re.subn(old[3:], new, src, flags=re.S)
        else:
            found = src.count(old)
            src = src.replace(old, new)
        if found != count:
            raise SystemExit(f"{variant}: {found} matches of {old!r} in "
                             f"{file}, expected {count}")
        with open(path, "w") as f:
            f.write(src)
    if variant == "timeline":
        for part in ("fwd", "dkv"):
            with open(os.path.join(csrc, p["kernels"][part][16][0]),
                      "a") as f:
                f.write(_stamp_reader(part))
    # an occupancy probe for each body, in the file that defines it (the
    # kernels live in anonymous namespaces); case i is the i-th width
    for part, per_dim in p["probe"].items():
        file = p["kernels"][part][16][0]
        cases = "".join(
            f"    case {i}: {{\n"
            f"      auto k = {kernel};\n"
            f"      cudaError_t e = etpu::allow_smem(k, {smem});\n"
            f"      if (e != cudaSuccess) return e;\n"
            f"      *threads = {threads};\n"
            f"      return cudaOccupancyMaxActiveBlocksPerMultiprocessor("
            f"blocks, k, {threads}, {smem});\n"
            f"    }}\n"
            for i, (kernel, threads, smem) in enumerate(per_dim.values()))
        with open(os.path.join(csrc, file), "a") as f:
            f.write(f"\n// timing-only probe (tests/torch_flash_f32_variants"
                    f".py)\nextern \"C\" int etpu_probe_{part}(int kind, int* "
                    f"blocks, int* threads) {{\n  switch (kind) {{\n{cases}"
                    f"    default: return cudaErrorInvalidValue;\n  }}\n}}\n")
    return root, design


def stamps(lib, part, fn, flush):
    """One cold call of ``fn`` under the timeline variant: each phase's
    SM cycles (median and max over the strips' warps)."""
    import ctypes

    import torch

    read = getattr(lib, f"etpu_stamps_{part}")
    read.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    torch.cuda.synchronize()
    assert read(None, 0, 1) == 0
    if flush is not None:
        flush.zero_()
    fn()
    torch.cuda.synchronize()
    n = NSTAMP
    buf = (ctypes.c_longlong * (6 * n))()
    assert read(ctypes.addressof(buf), n, 0) == 0
    rows = [buf[6 * w:6 * w + 6] for w in range(n)]
    rows = [r for r in rows if r[0] and r[5]]
    phases = ("issue", "wait", "products", "drain", "tail", "total")
    out = {}
    for j, ph in enumerate(phases):
        vals = sorted((r[5] - r[0]) if ph == "total"
                      else (r[j + 1] - r[j]) if r[j + 1] else 0 for r in rows)
        out[ph] = {"median": vals[len(vals) // 2], "max": vals[-1]}
    out["warps"] = len(rows)
    return out


def run_variant(tree, root, design, warm, timeline):
    """In this process (the copy first on sys.path): build, probe, time."""
    sys.path[:0] = [root, tree]
    import ctypes

    import torch

    import chip_smoke
    from elephas_tpu_torch.ops import _kernels
    from elephas_tpu_torch.ops.flash_attention import (flash_dkv, flash_dq,
                                                       flash_forward,
                                                       flash_forward_plain)

    report = _kernels.build(force=True)
    lib = _kernels.library()
    kernels = PATTERNS[design]["kernels"]
    regs, frames, cur = {}, {}, None
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            cur = next((f"{part}_d{d}" for part, per_dim in kernels.items()
                        for d, (_, frag) in per_dim.items() if frag in ln),
                       None)
        elif cur and "stack frame" in ln:
            frames[cur] = ln.strip()
        elif cur and "Used" in ln and "registers" in ln:
            regs[cur] = int(ln.split("Used ")[1].split()[0])
            cur = None
    spills = [ln.strip() for ln in report.splitlines()
              if "spill" in ln and "0 bytes spill stores, 0 bytes spill "
              "loads" not in ln]
    resident = {}
    for part in kernels:
        fn = getattr(lib, f"etpu_probe_{part}")
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int)]
        for kind, d in enumerate(kernels[part]):
            n, threads = ctypes.c_int(0), ctypes.c_int(0)
            _kernels.check(fn(kind, ctypes.byref(n), ctypes.byref(threads)),
                           f"occupancy of {part} d {d}")
            resident[f"{part}_d{d}"] = {"ctas": n.value,
                                        "threads": threads.value}
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = None if warm else torch.empty(128 * 2 ** 20, dtype=torch.uint8,
                                          device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    # (label, (B, H, KVH, S, window), head dim, parts): the strip shapes,
    # then the wide bodies' (the f32 checks' shapes) where the tree has
    # them
    cases = [(f"{name}_d{d}", (b, h, h, s, None), d,
              [part for part in ("fwd", "dq", "dkv") if part in kernels])
             for name, (b, h, s) in SHAPES.items() for d in (16, 32)]
    if PATTERNS[design].get("wide"):
        cases += [(path, (b, h, kvh, s, window), d, ["dq", "dkv"])
                  for path, (d, b, h, kvh, s, window)
                  in chip_smoke.F32_WIDE_TIMED.items()]
    times = {}
    for label, (b, h, kvh, s, window), d, parts in cases:
        q, g = (torch.randn((b, h, s, d), generator=gen, device="cuda")
                for _ in range(2))
        k, v = (torch.randn((b, kvh, s, d), generator=gen, device="cuda")
                for _ in range(2))
        o, lse = flash_forward_plain(q, k, v, causal=True, window=window)
        delta = (g * o).sum(-1)
        args = (q, k, v, g, lse, delta, 0, 0, True, window)
        calls = {"fwd": lambda: flash_forward(q, k, v, causal=True,
                                              window=window),
                 "dq": lambda: flash_dq(*args),
                 "dkv": lambda: flash_dkv(*args)}
        calls = {part: calls[part] for part in parts}
        times[label] = {part: chip_smoke.device_ms(fn, flush)
                        for part, fn in calls.items()}
        if timeline:
            times[label]["cycles"] = {
                part: stamps(lib, part, fn, flush)
                for part, fn in calls.items() if part != "dq"}
        del q, k, v, g, o, lse, delta, args, calls
    return {"design": design, "warm_l2": warm, "registers": regs,
            "stack": frames, "spills": spills,
            "resident": resident, "device_ms": times,
            "card": chip_smoke.nvidia_smi()}


def main() -> None:
    args = sys.argv[1:]
    if "--run" in args:
        # the child: --run VARIANT ROOT DESIGN TREE WARM
        _, variant, root, design, tree, warm = args
        print(json.dumps({"variant": variant, **run_variant(
            tree, root, design, warm == "1", variant == "timeline")}),
            flush=True)
        return
    warm = "--warm" in args
    if warm:
        args.remove("--warm")
    variants = ["base", "empty", "loads_only"]
    if "--variants" in args:
        i = args.index("--variants")
        variants = args[i + 1].split(",")
        del args[i:i + 2]
    tree = os.path.abspath(args[0] if args else os.path.join(
        os.path.dirname(os.path.abspath(__file__)), os.pardir))
    for variant in variants:
        root, design = prepare(tree, variant)
        if root is None:
            print(json.dumps({"variant": variant, "design": design,
                              "skipped": "no such variant of this design"}),
                  flush=True)
            continue
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--run", variant,
             root, design, tree, str(int(warm))], capture_output=True,
            text=True)
        if out.returncode:
            sys.stderr.write(out.stdout + out.stderr)
            raise SystemExit(f"variant {variant} failed")
        print(out.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
