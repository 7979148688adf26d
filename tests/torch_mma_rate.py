"""The card's rate for the instructions the f32 flash bodies are made of.

Builds a small CUDA library (``nvcc`` into ``build/mma_rate/``) of
loops that issue one instruction kind over independent accumulators,
each warp on its own registers, and times each with CUDA events at a
grid of a few CTAs an SM (the best of 5 calls), printing one JSON line:
the rate in TFLOP/s for

- ``mma_tf32``: ``mma.sync.aligned.m16n8k8`` TF32 in, f32 out (2048
  flops each), the 3xTF32 bodies' product;
- ``mma_bf16``: ``mma.sync.aligned.m16n8k16`` bf16 in, f32 out (4096
  flops each);
- ``ffma``: f32 fused multiply-adds on the CUDA cores (2 flops each);

at 1, 2, 4 and 8 warps a scheduler (CTAs of 128 threads, 1-8 of them an
SM), with the card's name and power limit. A script, not a test: it
needs the card.

    python tests/torch_mma_rate.py
"""
import ctypes
import json
import os
import subprocess

import torch

SOURCE = r'''
#include <cstdint>
#include <cuda_runtime.h>

constexpr int ACC = 8;  // independent accumulators a warp

__global__ void loop_tf32(float* out, int iters) {
  uint32_t a[4], b0 = threadIdx.x * 3u, b1 = threadIdx.x * 5u;
  for (int i = 0; i < 4; ++i) a[i] = (threadIdx.x + i) * 0x3f800000u;
  float c[ACC][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < ACC; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  float s = 0.f;
  for (int j = 0; j < ACC; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void loop_bf16(float* out, int iters) {
  uint32_t a[4], b0 = threadIdx.x * 3u, b1 = threadIdx.x * 5u;
  for (int i = 0; i < 4; ++i) a[i] = (threadIdx.x + i) * 0x3f803f80u;
  float c[ACC][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < ACC; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  float s = 0.f;
  for (int j = 0; j < ACC; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void loop_ffma(float* out, int iters) {
  float x = threadIdx.x * 1e-3f, y = 1.0001f, c[4 * ACC] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 4 * ACC; ++j) c[j] = fmaf(x, y, c[j]);
  float s = 0.f;
  for (int j = 0; j < 4 * ACC; ++j) s += c[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int launch(int kind, float* out, int iters, int blocks,
                      int threads, cudaStream_t stream) {
  auto k = kind == 0 ? loop_tf32 : kind == 1 ? loop_bf16 : loop_ffma;
  k<<<blocks, threads, 0, stream>>>(out, iters);
  return cudaGetLastError();
}
'''

# kind: (name, flops a thread an iteration)
KINDS = {0: ("mma_tf32", 8 * 2048 / 32), 1: ("mma_bf16", 8 * 4096 / 32),
         2: ("ffma", 32 * 2)}


def build():
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, "build", "mma_rate")
    os.makedirs(root, exist_ok=True)
    src, lib = os.path.join(root, "mma_rate.cu"), os.path.join(
        root, "libmma_rate.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib, src],
                   check=True)
    so = ctypes.CDLL(lib)
    so.launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return so


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_mma_rate needs a CUDA device")
    so = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters, threads = 4096, 128
    out = torch.empty(sms * 8 * threads, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rates = {}
    for kind, (name, flops) in KINDS.items():
        for per_sm in (1, 2, 4, 8):  # CTAs of 4 warps: warps a scheduler
            blocks = sms * per_sm
            best = None
            for _ in range(5):
                start, stop = (torch.cuda.Event(enable_timing=True)
                               for _ in range(2))
                start.record()
                assert so.launch(kind, out.data_ptr(), iters, blocks,
                                 threads, stream) == 0
                stop.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(stop)
                best = ms if best is None else min(best, ms)
            total = flops * iters * blocks * threads
            rates.setdefault(name, {})[f"warps_a_scheduler_{per_sm}"] = (
                total / (best * 1e-3) / 1e12)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps({"card": smi, "sms": sms, "tflops": rates}), flush=True)


if __name__ == "__main__":
    main()
