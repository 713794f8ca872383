"""Probe: the latency and rate of wgmma.mma_async m64nNk16 (bf16 in, f32
accumulate) and m64nNk8 (TF32 in, f32 accumulate), A from registers, B
from shared memory without swizzle, on this card: the instructions the
channel mixes of `csrc/denoiser_wg.cu` (bf16) and of
`csrc/denoiser_wg_f32.cu` (TF32, three per product) run on.

Builds a kernel that issues only wgmmas: per round, `chains` independent
accumulators of N channels each take `depth` dependent wgmmas, then the
warpgroup commits and (`wait`) waits for them, as the kernel does per
pair of 16-channel chunks; one persistent block per SM with 1 or 4
warpgroups.  Prints the cycles per round and per wgmma, and the TFLOP/s.
One chain of one warpgroup gives the latency of a dependent step; more
chains and warpgroups the rate the channel mixes can reach.  Needs a CUDA
device.

    python -m mocodad_tpu_torch.tools.perf.probe_wgmma_rate
"""

from __future__ import annotations

import ctypes
import sys

import torch

from mocodad_tpu_torch.device import resolve_device
from mocodad_tpu_torch.tools.perf.common import card_line
from mocodad_tpu_torch.tools.perf.probe_tc_phases import build_variant

SOURCE = r'''
#include <cuda_runtime.h>
#include <stdint.h>
#define WG_D(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
#define WG_IN "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
template <int NT>
__device__ __forceinline__ void wgmma(float (&d)[NT][4],
                                      const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (NT == 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : WG_D(0) : WG_IN);
  } else if constexpr (NT == 2) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, "
        "1, 0;\n}\n"
        : WG_D(0), WG_D(1) : WG_IN);
  } else if constexpr (NT == 4) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : WG_D(0), WG_D(1), WG_D(2), WG_D(3) : WG_IN);
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : WG_D(0), WG_D(1), WG_D(2), WG_D(3), WG_D(4), WG_D(5), WG_D(6),
          WG_D(7) : WG_IN);
  }
}
template <int NT>
__device__ __forceinline__ void wgmma_tf32(float (&d)[NT][4],
                                      const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (NT == 2) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : WG_D(0), WG_D(1)
        : WG_IN);
  } else if constexpr (NT == 4) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : WG_D(0), WG_D(1), WG_D(2), WG_D(3)
        : WG_IN);
  } else if constexpr (NT == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : WG_D(0), WG_D(1), WG_D(2), WG_D(3), WG_D(4), WG_D(5),
          WG_D(6), WG_D(7)
        : WG_IN);
  } else {
    static_assert(NT == 16, "wgmma of 16, 32, 64 or 128 output channels");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : WG_D(0), WG_D(1), WG_D(2), WG_D(3), WG_D(4), WG_D(5),
          WG_D(6), WG_D(7), WG_D(8), WG_D(9), WG_D(10), WG_D(11),
          WG_D(12), WG_D(13), WG_D(14), WG_D(15)
        : WG_IN);
  }
}

template <int NT, int CH, int DEPTH, bool WAIT, bool TF32>
__global__ void __launch_bounds__(512, 1)
wg_loop(float* out, int iters, long long* cycles) {
  __shared__ __align__(128) uint16_t b[16 * 128 * 2];
  for (int i = threadIdx.x; i < 16 * 128 * 2; i += blockDim.x)
    b[i] = TF32 ? (i & 1 ? 0x3f80 : 0) : 0x3c00;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(&b[0]));
  const uint64_t desc = static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
                        (static_cast<uint64_t>(128 >> 4) << 16) |
                        (static_cast<uint64_t>(256 >> 4) << 32);
  float d[CH][NT][4] = {};
  uint32_t a[4];
  for (int i = 0; i < 4; ++i) a[i] = TF32 ? 0x3f800000u : 0x3c003c00u;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < DEPTH; ++k)
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if constexpr (TF32)
          wgmma_tf32<NT>(d[c], a, desc);
        else
          wgmma<NT>(d[c], a, desc);
      }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (WAIT) asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  const long long t1 = clock64();
  float s = 0.f;
  for (int c = 0; c < CH; ++c)
    for (int j = 0; j < NT; ++j) s += d[c][j][0] + d[c][j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}
#define CASE(id, NT, CH, DEPTH, WAIT) CASE_T(id, NT, CH, DEPTH, WAIT, false)
#define CASE_T(id, NT, CH, DEPTH, WAIT, TF32)                              \
  case id: wg_loop<NT, CH, DEPTH, WAIT, TF32><<<blocks, warps * 32>>>(      \
      out, iters, cycles); break;
extern "C" int wgmma_rate_run(int id, int warps, int iters, float* out,
                              long long* cycles, int blocks) {
  switch (id) {
    CASE(0, 8, 1, 6, true)
    CASE(1, 4, 2, 6, true)
    CASE(2, 2, 4, 6, true)
    CASE(3, 8, 1, 6, false)
    CASE(4, 2, 1, 6, true)
    CASE(5, 1, 2, 6, true)
    CASE(6, 2, 1, 6, false)
    CASE(7, 4, 1, 6, true)
    CASE(8, 2, 2, 6, true)
    CASE_T(9, 2, 1, 6, true, true)
    CASE_T(10, 4, 1, 6, true, true)
    CASE_T(11, 8, 1, 6, true, true)
    CASE_T(12, 16, 1, 6, true, true)
    CASE_T(13, 4, 1, 24, true, true)
    CASE_T(14, 8, 1, 24, true, true)
    CASE_T(15, 16, 1, 12, true, true)
    CASE_T(16, 8, 2, 12, true, true)
    CASE_T(17, 4, 2, 12, true, true)
    CASE_T(18, 8, 4, 6, true, true)
    default: return -1;
  }
  return static_cast<int>(cudaDeviceSynchronize());
}
'''
# (id: N per wgmma, chains, dependent wgmmas per chain per round, wait
# each round, K per wgmma: 16 bf16 or 8 TF32 values)
CASES = {0: (64, 1, 6, True, 16), 1: (32, 2, 6, True, 16),
         2: (16, 4, 6, True, 16), 3: (64, 1, 6, False, 16),
         4: (16, 1, 6, True, 16), 5: (8, 2, 6, True, 16),
         6: (16, 1, 6, False, 16), 7: (32, 1, 6, True, 16),
         8: (16, 2, 6, True, 16),
         # TF32 m64nNk8, as csrc/denoiser_wg_f32.cu's rounds issue them: a
         # chain of 6 (a k-step with a residual mix) or of 24 (4 k-steps)
         # into one accumulator, then a wait
         9: (16, 1, 6, True, 8), 10: (32, 1, 6, True, 8),
         11: (64, 1, 6, True, 8), 12: (128, 1, 6, True, 8),
         13: (32, 1, 24, True, 8), 14: (64, 1, 24, True, 8),
         15: (128, 1, 12, True, 8),
         # the same 24 as two or four independent chains
         16: (64, 2, 12, True, 8), 17: (32, 2, 12, True, 8),
         18: (64, 4, 6, True, 8)}


def main(argv=None) -> int:
    dev = resolve_device('cuda')
    print(card_line(), flush=True)
    lib = build_variant('probe_wgmma_rate', SOURCE)
    run = lib.wgmma_rate_run
    run.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    run.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(sms * 512, device=dev)
    cycles = torch.empty(sms, dtype=torch.int64, device=dev)
    iters = 2000
    for cid, (n, chains, depth, wait, k) in CASES.items():
        for warps in (4, 16):
            args = (cid, warps, iters, out.data_ptr(), cycles.data_ptr(), sms)
            if run(*args):
                raise RuntimeError('wgmma probe launch failed')
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            if run(*args):
                raise RuntimeError('wgmma probe launch failed')
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            per_round = float(cycles.float().mean()) / iters
            wgmmas = chains * depth
            flop = 2 * 64 * n * k * wgmmas * iters * (warps // 4) * sms
            print(f'[wgmma] {"bf16" if k == 16 else "tf32"} n={n} k={k} '
                  f'chains={chains} depth={depth} wait={wait} '
                  f'warpgroups={warps // 4} cycles_per_round={per_round:.1f} '
                  f'cycles_per_wgmma={per_round / wgmmas:.1f} '
                  f'tflops={flop / ms / 1e9:.1f}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
