"""Where the narrow flash backward bodies spend their time: timing-only
builds of a tree's dQ and dK/dV kernels at head dims 16 and 32.

For each variant the script copies TREE's ``elephas_tpu_torch`` into
``TREE/build/variants/<variant>/``, rewrites ``csrc/flash_bwd.cu`` there
(``base`` leaves it as it is), builds it with the package's own
``_kernels.build`` and, in a process of its own, reports:

- ptxas's registers for each narrow dQ and dK/dV body (``-Xptxas -v``)
  and their resident CTAs a SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``,
  through a probe appended to the copy's source);
- the device ms of ``flash_dq`` and ``flash_dkv`` (bf16, causal, cold L2,
  median of 20: ``chip_smoke.device_ms``) at B 8 x H 16 x S 1024, d 32
  and d 16, and at ``tpu_model_lm_d32``'s fit shape (B 16 x H 8 x S 128,
  d 32).

The variants other than ``base`` compute wrong gradients; they exist to
be timed and are never kept:

- ``fma``: each exp2 of P replaced by one FMA;
- ``no_elementwise``: P = S and dS = dP, no exp2, no mask, no scale (the
  packs to bf16 and the products stay).

The rewrites name the text of each design's narrow bodies
(``PATTERNS``); a tree whose source matches none of them says so. It
needs the card. Run the variants in one call, so they share a card:

    python tests/torch_flash_bwd_variants.py [--variants base,fma,no_elementwise] [TREE]
"""
import json
import os
import re
import shutil
import subprocess
import sys

# The narrow bodies of a design: the kernels' mangled names, the
# template instantiations and the launch shapes the occupancy probe
# asks about (kernel, threads, shared bytes), and for each variant the
# rewrites, (old, new, count) each. "narrow": three consumer warpgroups
# and a producer warpgroup on 192-row tiles (flash_*_narrow_kernel);
# "wgmma_d64": the width-64 bodies instantiated at 16 and 32, the design
# before it. The first whose kernels a source defines is its design.
NARROW_FMA = "fmaf(fmaf(st[i{}], scale_log2, -{}), 0.5f, 0.5f)"
PATTERNS = {
    "narrow": {
        "kernels": {"dq": "flash_dq_narrow_kernelILi{d}E",
                    "dkv": "flash_dkv_narrow_kernelILi{d}E"},
        "probe": {"dq": ("nb::flash_dq_narrow_kernel<{d}>", "nb::THREADS",
                         "nb::Layout<{d}>::bytes"),
                  "dkv": ("nb::flash_dkv_narrow_kernel<{d}>", "nb::THREADS",
                          "nb::Layout<{d}>::bytes")},
        "fma": [
            ("st[i] = exp2_ftz(fmaf(st[i], scale_log2, -lx));",
             "st[i] = " + NARROW_FMA.format("", "lx") + ";", 1),
            ("st[i + 1] = exp2_ftz(fmaf(st[i + 1], scale_log2, -ly));",
             "st[i + 1] = " + NARROW_FMA.format(" + 1", "ly") + ";", 1),
            ("st[i] = exp2_ftz(fmaf(st[i], scale_log2, -lse2[(i / 2) % 2]));",
             "st[i] = " + NARROW_FMA.format("", "lse2[(i / 2) % 2]") + ";",
             1)],
        "no_elementwise": [
            ("st[i] = exp2_ftz(fmaf(st[i], scale_log2, -lx));",
             "st[i] = st[i];", 1),
            ("st[i + 1] = exp2_ftz(fmaf(st[i + 1], scale_log2, -ly));",
             "st[i + 1] = st[i + 1];", 1),
            ("              if (q0 + STEP > Sq || wk0 + 64 > Sk ||",
             "              if (false && (q0 + STEP > Sq || wk0 + 64 > Sk) "
             "&&", 1),
            ("dpt[i] = st[i] * (dpt[i] - de.x) * scale;",
             "dpt[i] = dpt[i];", 1),
            ("dpt[i + 1] = st[i + 1] * (dpt[i + 1] - de.y) * scale;",
             "dpt[i + 1] = dpt[i + 1];", 1),
            ("st[i] = exp2_ftz(fmaf(st[i], scale_log2, -lse2[(i / 2) % 2]));",
             "st[i] = st[i];", 1),
            ("            if (wq0 + 64 > Sq || k0 + STEP > Sk ||",
             "            if (false && (wq0 + 64 > Sq || k0 + STEP > Sk) &&",
             1),
            ("              st[i] = st[i] * (dpt[i] - dl[(i / 2) % 2]) * "
             "scale;", "              st[i] = dpt[i];", 1)]},
    "wgmma_d64": {
        "kernels": {"dq": "flash_dq_wgmma_kernelILi{d}E",
                    "dkv": "flash_dkv_wgmma_kernelILi{d}E"},
        "probe": {"dq": ("dq::flash_dq_wgmma_kernel<{d}>",
                         "dq::Layout<{d}>::THREADS",
                         "dq::Layout<{d}>::bytes"),
                  "dkv": ("dkv::flash_dkv_wgmma_kernel<{d}>",
                          "dkv::Layout<{d}>::THREADS",
                          "dkv::Layout<{d}>::bytes")},
        "fma": [
            ("float p0 = exp2_ftz(fmaf(st[i], scale_log2, -ls.x));",
             "float p0 = fmaf(fmaf(st[i], scale_log2, -ls.x), 0.5f, "
             "0.5f);", 1),
            ("float p1 = exp2_ftz(fmaf(st[i + 1], scale_log2, -ls.y));",
             "float p1 = fmaf(fmaf(st[i + 1], scale_log2, -ls.y), 0.5f, "
             "0.5f);", 1),
            ("          float p = exp2_ftz(fmaf(st[i], scale_log2, "
             "-lse2[r]));",
             "          float p = fmaf(fmaf(st[i], scale_log2, "
             "-lse2[r]), 0.5f, 0.5f);", 1)],
        "no_elementwise": [
            ("float p0 = exp2_ftz(fmaf(st[i], scale_log2, -ls.x));",
             "float p0 = st[i];", 1),
            ("float p1 = exp2_ftz(fmaf(st[i + 1], scale_log2, -ls.y));",
             "float p1 = st[i + 1];", 1),
            ("              if (masked) {", "              if (false) {",
             1),
            ("pack_bf16(p0 * (dpt[i] - de.x) * scale,\n"
             "                            p1 * (dpt[i + 1] - de.y) * "
             "scale);",
             "pack_bf16(dpt[i], dpt[i + 1]);", 1),
            ("          float p = exp2_ftz(fmaf(st[i], scale_log2, "
             "-lse2[r]));\n          if (masked) {",
             "          float p = st[i];\n          if (false) {", 1),
            ("pack_bf16(st[i] * (dpt[i] - d) * scale,\n"
             "                                   st[i + 1] * (dpt[i + 1] "
             "- d) * scale);",
             "pack_bf16(dpt[i], dpt[i + 1]);", 1)]},
}

# name: (B, H, KVH, S, d), causal
SHAPES = {"b8_d32": (8, 16, 16, 1024, 32), "b8_d16": (8, 16, 16, 1024, 16),
          "path_d32": (16, 8, 8, 128, 32)}


def design_of(source):
    """The PATTERNS entry whose kernels the source defines."""
    for name, p in PATTERNS.items():
        if all(re.search(p["kernels"][k].split("ILi")[0], source)
               for k in p["kernels"]):
            return name
    raise SystemExit("no narrow backward design of PATTERNS in this tree")


def prepare(tree, variant):
    """The variant's copy of the package; returns (copy root, design)."""
    root = os.path.join(tree, "build", "variants", variant)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    shutil.copytree(os.path.join(tree, "elephas_tpu_torch"),
                    os.path.join(root, "elephas_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(root, "elephas_tpu_torch", "csrc", "flash_bwd.cu")
    with open(path) as f:
        src = f.read()
    design = design_of(src)
    p = PATTERNS[design]
    for old, new, count in ([] if variant == "base" else p[variant]):
        found = src.count(old)
        if found != count:
            raise SystemExit(f"{variant}: {found} matches of {old!r}, "
                             f"expected {count}")
        src = src.replace(old, new)
    cases = []
    for part, (kernel, threads, smem) in p["probe"].items():
        for i, d in enumerate((16, 32)):
            kind = 2 * (part == "dkv") + i
            cases.append(
                f"    case {kind}: {{\n"
                f"      auto k = {kernel.format(d=d)};\n"
                f"      cudaError_t e = etpu::allow_smem(k, "
                f"{smem.format(d=d)});\n"
                f"      if (e != cudaSuccess) return e;\n"
                f"      return cudaOccupancyMaxActiveBlocksPerMultiprocessor("
                f"blocks, k, {threads.format(d=d)}, {smem.format(d=d)});\n"
                f"    }}\n")
    src += ("\n// timing-only probe (tests/torch_flash_bwd_variants.py)\n"
            "extern \"C\" int etpu_probe_occupancy(int kind, int* blocks) "
            "{\n  switch (kind) {\n" + "".join(cases) +
            "    default: return cudaErrorInvalidValue;\n  }\n}\n")
    with open(path, "w") as f:
        f.write(src)
    return root, design


def run_variant(tree, root, design):
    """In this process (the copy first on sys.path): build, probe, time."""
    sys.path[:0] = [root, tree]
    import ctypes

    import torch

    import chip_smoke
    from elephas_tpu_torch.ops import _kernels
    from elephas_tpu_torch.ops.flash_attention import (flash_dkv, flash_dq,
                                                       flash_forward_plain)

    report = _kernels.build(force=True)
    lib = _kernels.library()
    kernels = PATTERNS[design]["kernels"]
    regs, cur = {}, None
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            cur = ln.split("'")[1]
        elif cur and "Used" in ln and "registers" in ln:
            for part, frag in kernels.items():
                for d in (16, 32):
                    if frag.format(d=d) in cur:
                        regs[f"{part}_d{d}"] = int(
                            ln.split("Used ")[1].split()[0])
    spills = [ln.strip() for ln in report.splitlines()
              if "spill" in ln and "0 bytes spill stores, 0 bytes spill "
              "loads" not in ln]
    lib.etpu_probe_occupancy.argtypes = [ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_int)]
    resident = {}
    for kind, name in enumerate(("dq_d16", "dq_d32", "dkv_d16", "dkv_d32")):
        n = ctypes.c_int(0)
        _kernels.check(lib.etpu_probe_occupancy(kind, ctypes.byref(n)),
                       f"occupancy of {name}")
        resident[name] = n.value
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    times = {}
    for name, (b, h, kvh, s, d) in SHAPES.items():
        q, g = (torch.randn((b, h, s, d), generator=gen, device="cuda")
                .bfloat16() for _ in range(2))
        k, v = (torch.randn((b, kvh, s, d), generator=gen, device="cuda")
                .bfloat16() for _ in range(2))
        o, lse = flash_forward_plain(q, k, v, causal=True)
        delta = (g.float() * o.float()).sum(-1)
        args = (q, k, v, g, lse, delta, 0, 0, True, None)
        times[name] = {
            "dq": chip_smoke.device_ms(lambda: flash_dq(*args), flush),
            "dkv": chip_smoke.device_ms(lambda: flash_dkv(*args), flush)}
    return {"design": design, "registers": regs, "spills": spills,
            "resident_ctas": resident, "device_ms": times,
            "card": chip_smoke.nvidia_smi()}


def main() -> None:
    args = sys.argv[1:]
    if "--run" in args:
        # the child: --run VARIANT ROOT DESIGN TREE
        _, variant, root, design, tree = args
        print(json.dumps({"variant": variant,
                          **run_variant(tree, root, design)}), flush=True)
        return
    variants = ["base", "fma", "no_elementwise"]
    if "--variants" in args:
        i = args.index("--variants")
        variants = args[i + 1].split(",")
        del args[i:i + 2]
    tree = os.path.abspath(args[0] if args else os.path.join(
        os.path.dirname(os.path.abspath(__file__)), os.pardir))
    for variant in variants:
        root, design = prepare(tree, variant)
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--run", variant,
             root, design, tree], capture_output=True, text=True)
        if out.returncode:
            sys.stderr.write(out.stdout + out.stderr)
            raise SystemExit(f"variant {variant} failed")
        print(out.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
