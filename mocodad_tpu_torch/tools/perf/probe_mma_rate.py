"""Probe: the rate and latency of mma.sync.m16n8k8 in TF32 on this card,
the instruction every product of `csrc/denoiser_tc_f32.cu` runs on.

Builds a kernel that issues only MMAs, `chains` independent accumulators
per warp, one persistent block per SM, and prints the cycles per MMA per
SM sub-partition (four per SM) and the TFLOP/s for 4, 8 and 16 warps per
block and 1-8 chains.  One chain of one warp per sub-partition gives the
latency; many give the issue rate the tensor-core kernel can reach.  Needs
a CUDA device.

    python -m mocodad_tpu_torch.tools.perf.probe_mma_rate
"""

from __future__ import annotations

import ctypes
import sys

import torch

from mocodad_tpu_torch.device import resolve_device
from mocodad_tpu_torch.tools.perf.probe_tc_phases import build_variant

SOURCE = r'''
#include <cuda_runtime.h>
#include <stdint.h>
template <int CH>
__global__ void mma_loop(float* out, int iters, long long* cycles) {
  float d[CH][4] = {};
  uint32_t a[4], b0 = threadIdx.x, b1 = threadIdx.x * 3;
  for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * (i + 1);
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CH; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  const long long t1 = clock64();
  float s = 0.f;
  for (int c = 0; c < CH; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}
extern "C" int mma_rate_run(int chains, int warps, int iters, float* out,
                            long long* cycles, int blocks) {
  switch (chains) {
    case 1: mma_loop<1><<<blocks, warps * 32>>>(out, iters, cycles); break;
    case 2: mma_loop<2><<<blocks, warps * 32>>>(out, iters, cycles); break;
    case 4: mma_loop<4><<<blocks, warps * 32>>>(out, iters, cycles); break;
    case 8: mma_loop<8><<<blocks, warps * 32>>>(out, iters, cycles); break;
    default: return -1;
  }
  return static_cast<int>(cudaDeviceSynchronize());
}
'''
FLOP_PER_MMA = 2 * 16 * 8 * 8


def probe(iters: int = 4096) -> dict:
    """{(warps, chains): (cycles per MMA per sub-partition, TFLOP/s)}."""
    dev = resolve_device('cuda')
    lib = build_variant('mma_rate', SOURCE)
    run = lib.mma_rate_run
    run.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2 + [ctypes.c_int]
    run.restype = ctypes.c_int
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(blocks * 1024, device=dev)
    cycles = torch.empty(blocks, dtype=torch.int64, device=dev)
    result = {}
    for warps in (4, 8, 16):
        for chains in (1, 2, 4, 8):
            if run(chains, warps, 64, out.data_ptr(), cycles.data_ptr(),
                   blocks):
                raise RuntimeError('the MMA loop failed')
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(chains, warps, iters, out.data_ptr(), cycles.data_ptr(),
                blocks)
            end.record()
            torch.cuda.synchronize()
            mmas = iters * chains * warps           # per SM
            per = float(cycles.double().mean()) / (mmas / 4)
            tflops = FLOP_PER_MMA * mmas * blocks / start.elapsed_time(end) \
                / 1e9
            result[(warps, chains)] = (per, tflops)
            print(f'warps {warps:2d}, chains per warp {chains}: {per:.2f} '
                  f'cycles per MMA per sub-partition, {tflops:.1f} TFLOP/s',
                  flush=True)
    return result


def main() -> int:
    probe()
    return 0


if __name__ == '__main__':
    sys.exit(main())
