"""Probe: the latency and rate of wgmma.mma_async m64nNk16 (bf16 in, f32
accumulate, A from registers, B from shared memory without swizzle) on
this card, the instruction `csrc/denoiser_wg.cu`'s channel mixes run on.

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
template <int NT, int CH, int DEPTH, bool WAIT>
__global__ void __launch_bounds__(512, 1)
wg_loop(float* out, int iters, long long* cycles) {
  __shared__ __align__(128) uint16_t b[16 * 64];
  for (int i = threadIdx.x; i < 16 * 64; i += blockDim.x) b[i] = 0x3c00;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(&b[0]));
  const uint64_t desc = static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
                        (static_cast<uint64_t>(128 >> 4) << 16) |
                        (static_cast<uint64_t>(256 >> 4) << 32);
  float d[CH][NT][4] = {};
  uint32_t a[4];
  for (int i = 0; i < 4; ++i) a[i] = 0x3c003c00u;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < DEPTH; ++k)
#pragma unroll
      for (int c = 0; c < CH; ++c) wgmma<NT>(d[c], a, desc);
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
#define CASE(id, NT, CH, DEPTH, WAIT)                                      \
  case id: wg_loop<NT, CH, DEPTH, WAIT><<<blocks, warps * 32>>>(            \
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
    default: return -1;
  }
  return static_cast<int>(cudaDeviceSynchronize());
}
'''
# (id: N per wgmma, chains, dependent wgmmas per chain per round, wait
# each round)
CASES = {0: (64, 1, 6, True), 1: (32, 2, 6, True), 2: (16, 4, 6, True),
         3: (64, 1, 6, False), 4: (16, 1, 6, True), 5: (8, 2, 6, True),
         6: (16, 1, 6, False), 7: (32, 1, 6, True), 8: (16, 2, 6, True)}


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
    for cid, (n, chains, depth, wait) in CASES.items():
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
            flop = 2 * 64 * n * 16 * wgmmas * iters * (warps // 4) * sms
            print(f'[wgmma] n={n} chains={chains} depth={depth} wait={wait} '
                  f'warpgroups={warps // 4} cycles_per_round={per_round:.1f} '
                  f'cycles_per_wgmma={per_round / wgmmas:.1f} '
                  f'tflops={flop / ms / 1e9:.1f}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
