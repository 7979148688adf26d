"""Build and load the port's hand-written CUDA kernels.

The kernels live in ``elephas_tpu_torch/csrc/*.cu`` behind a plain C
interface. At first use on a machine with ``nvcc`` they are compiled for
Hopper (``sm_90a``), one ``nvcc`` process per source, all started
together, then linked into ``build/elephas_tpu_torch/
libetpu_torch_kernels.so`` at the repository root and loaded with
``ctypes``. A library newer than every source is reused.

Nothing here runs at import: the CPU test suite imports every module of
the package on a machine with no ``nvcc`` and no card.
"""
import ctypes
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["library", "build", "check", "cuda_tool", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "elephas_tpu_torch"
LIB_PATH = BUILD_DIR / "libetpu_torch_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return str(path)


def cuda_tool(name: str) -> str:
    """The path of a CUDA toolkit program (``cuobjdump``, ...) beside
    ``nvcc``."""
    path = Path(_nvcc()).parent / name
    if not path.exists():
        raise RuntimeError(f"{name} not found beside nvcc")
    return str(path)


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(src.stat().st_mtime > built
               for src in CSRC.iterdir() if src.suffix in (".cu", ".cuh"))


def build(force: bool = False) -> str:
    """Compile and link the kernel library; returns the compiler's
    resource report (``-Xptxas -v``: registers, shared memory, spills
    per kernel), empty when an up-to-date library was reused."""
    if not force and not _stale():
        return ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    procs = []
    for src in sources:
        obj = BUILD_DIR / (src.stem + ".o")
        cmd = [nvcc, *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    report, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        report.append(f"== {src.name}\n{out}")
        if proc.returncode:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n"
                           + "\n".join(report))
    # link to a private name, then rename: a concurrent loader never sees
    # a half-written library
    tmp = LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", str(tmp),
         *(str(obj) for _, obj, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise RuntimeError(f"linking the kernel library failed:\n"
                           f"{link.stdout}")
    os.replace(tmp, LIB_PATH)
    return "\n".join(report)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(LIB_PATH))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.etpu_flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                       i, i, i, f, i, p]
        lib.etpu_flash_fwd.restype = i
        # q, k, v, dout, lse, delta, dq | B H KVH Sq Sk D qo ko causal
        # window | scale | is_bf16 | stream
        lib.etpu_flash_bwd_dq.argtypes = [p] * 7 + [i] * 10 + [f, i, p]
        lib.etpu_flash_bwd_dq.restype = i
        # q, k, v, dout, lse, delta, dk, dv, plan | chunks | partials |
        # B H KVH Sq Sk D qo ko causal window | scale | is_bf16 | stream
        lib.etpu_flash_bwd_dkv.argtypes = ([p] * 9 + [i, p] + [i] * 10
                                           + [f, i, p])
        lib.etpu_flash_bwd_dkv.restype = i
        # partials, plan | rows | dk, dv | Sk hd krows | is_bf16 | stream
        lib.etpu_flash_dkv_reduce.argtypes = [p, p, i, p, p, i, i, i, i, p]
        lib.etpu_flash_dkv_reduce.restype = i
        # q, k_pool, v_pool, tables, pos, slopes, out | B H KVH bs D MB
        # window | scale | is_bf16 body | workspace | split_blocks |
        # stream
        lib.etpu_paged_decode.argtypes = [p] * 7 + [i] * 7 + [f, i, i, p,
                                                              i, p]
        lib.etpu_paged_decode.restype = i
        lib.etpu_error_string.argtypes = [i]
        lib.etpu_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise when a kernel entry point reported a CUDA error."""
    if err:
        msg = library().etpu_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")
