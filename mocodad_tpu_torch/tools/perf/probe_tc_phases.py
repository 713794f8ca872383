"""Probe: where a tile's time goes inside the tensor-core denoiser
(`csrc/denoiser_tc.cu`, B1 at bfloat16).

Writes a copy of the source with clock64() counters around each phase of
a tile (the loads of x and silu_emb, the embeddings, every op, the store)
and, inside the ST-GCNN layers, around warp 0's MMA chunk loops and
epilogues; builds it with nvcc beside the package's builds; runs one call
at N = 51,200 rows on the flagship U-Net (weights from a seed) and prints
thread 0's cycles per tile for each phase, averaged over every block's
tiles.  Thread 0 (warp 0) always has a unit of work and arrives last at
each barrier, so an op's cycles are its critical path.  The counters
themselves add a little; the probe also prints the instrumented call's
ms beside the plain build's.  Needs a CUDA device.

    python -m mocodad_tpu_torch.tools.perf.probe_tc_phases [--n N]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

from mocodad_tpu_torch.device import resolve_device
from mocodad_tpu_torch.ops import build
from mocodad_tpu_torch.ops import pallas_unet as P
from mocodad_tpu_torch.tools.perf.common import (N_ROWS, flagship_fold,
                                                 fold_inputs, time_ms)

N_SLOTS = 64
# counter slots: op k at 2k (its barrier) and 2k + 1 (thread 0's work)
LOAD, STORE, CHUNKS, EPILOGUES, EMBED = 40, 41, 44, 45, 46

# (anchor in csrc/denoiser_tc.cu, text that replaces it)
PATCHES = (
    ('namespace mocodad_tc {\nnamespace {\n',
     'namespace mocodad_tc {\n__device__ unsigned long long g_prof[64];\n'
     'namespace {\n'),
    ('    load_tile(tid, sm, t, x, semb, n, n0);',
     '    long long tl = clock64();\n'
     '    load_tile(tid, sm, t, x, semb, n, n0);\n'
     '    if (tid == 0) atomicAdd(&g_prof[40], (unsigned long long)'
     '(clock64() - tl));'),
    ('    embed_all(tid, sm, t);',
     '    long long te = clock64();\n'
     '    embed_all(tid, sm, t);\n'
     '    if (tid == 0) atomicAdd(&g_prof[46], (unsigned long long)'
     '(clock64() - te));'),
    ('      cp_async_wait_all();\n'
     '      __syncthreads();   // this op\'s constants and the last op\'s '
     'output',
     '      long long t0 = clock64();\n'
     '      cp_async_wait_all();\n'
     '      __syncthreads();\n'
     '      long long t1 = clock64();\n'
     '      if (tid == 0) atomicAdd(&g_prof[2 * op], (unsigned long long)'
     '(t1 - t0));'),
    ('      run_op(tid, sm, t, ops + op * O_LEN, wbuf[buf]);',
     '      run_op(tid, sm, t, ops + op * O_LEN, wbuf[buf]);\n'
     '      if (tid == 0) atomicAdd(&g_prof[2 * op + 1], (unsigned long long)'
     '(clock64() - t1));'),
    ('    __syncthreads();\n    store_tile(tid, sm, t, eps, n, n0);',
     '    long long ts = clock64();\n'
     '    __syncthreads();\n'
     '    store_tile(tid, sm, t, eps, n, n0);\n'
     '    if (tid == 0) atomicAdd(&g_prof[41], (unsigned long long)'
     '(clock64() - ts));'),
    ('  for (int u = warp; u < kRows * mt * ns; u += kWarps) {',
     '  long long ta = clock64();\n'
     '  for (int u = warp; u < kRows * mt * ns; u += kWarps) {'),
    ('    // epilogue: (+ f), + bias, PReLU',
     '    long long tb = clock64();\n'
     '    if (warp == 0 && lane == 0) atomicAdd(&g_prof[44], '
     '(unsigned long long)(tb - ta));\n'
     '    // epilogue: (+ f), + bias, PReLU'),
    ('            p < tvo ? pack(acc[j][2 * h], acc[j][2 * h + 1]) : 0u;\n'
     '      }\n    }\n',
     '            p < tvo ? pack(acc[j][2 * h], acc[j][2 * h + 1]) : 0u;\n'
     '      }\n    }\n'
     '    if (warp == 0 && lane == 0) atomicAdd(&g_prof[45], '
     '(unsigned long long)(clock64() - tb));\n'
     '    ta = clock64();\n'),
)
READER = '''
extern "C" int mocodad_probe_read(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, mocodad_tc::g_prof,
                                         sizeof(unsigned long long) * 64);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned long long zero[64] = {0};
  return static_cast<int>(cudaMemcpyToSymbol(mocodad_tc::g_prof, zero,
                                             sizeof(zero)));
}
'''


def instrumented_source() -> str:
    """csrc/denoiser_tc.cu with the counters; raises if the source no
    longer has an anchor the probe patches."""
    with open(os.path.join(build.CSRC_DIR, 'denoiser_tc.cu')) as f:
        src = f.read()
    for anchor, text in PATCHES:
        if src.count(anchor) != 1:
            raise RuntimeError(f'denoiser_tc.cu changed: the probe finds '
                               f'{src.count(anchor)} copies of {anchor!r}')
        src = src.replace(anchor, text)
    return src + READER


def build_instrumented() -> ctypes.CDLL:
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(build.BUILD_DIR, 'denoiser_tc_phases.cu')
    so = os.path.join(build.BUILD_DIR, 'libdenoiser_tc_phases.so')
    with open(cu, 'w') as f:
        f.write(instrumented_source())
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, '-I', build.CSRC_DIR,
                    '-o', so, cu], check=True)
    return ctypes.CDLL(so)


def probe(n: int = N_ROWS, seed: int = 0) -> dict:
    """Cycles per tile of each phase; prints one line each."""
    dev = resolve_device('cuda')
    folded = flagship_fold(dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    x, semb = fold_inputs(folded, n, g)
    xb = x.bfloat16()
    out = torch.empty_like(xb)
    plan = P.tc_plan(folded, dev)
    lib = build_instrumented()
    launch = P.bind(lib, P.DENOISER_BF16.symbol, 5, 2)
    read = lib.mocodad_probe_read
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int

    def call():
        err = launch(xb.data_ptr(), semb.data_ptr(), plan.blob.data_ptr(),
                     plan.table.data_ptr(), out.data_ptr(), n,
                     plan.smem_bytes, P.current_stream(dev))
        if err:
            raise RuntimeError(f'instrumented launch failed: {err}')

    counts = (ctypes.c_ulonglong * N_SLOTS)()
    call()                                   # warm-up, then one counted call
    torch.cuda.synchronize()
    read(counts)
    call()
    torch.cuda.synchronize()
    if read(counts):
        raise RuntimeError('reading the counters failed')
    tiles = -(-n // P.TC_ROWS)
    c = np.array(counts[:], np.float64) / tiles
    names = [P.GCN_LAYERS[i] if kind == 0 else P.JOINT_LAYERS[i]
             for kind, i, _, _ in P.layer_sequence(folded)]
    result = {'ops': {}, 'load': c[LOAD], 'store': c[STORE],
              'embed': c[EMBED], 'gcn_chunk_loops': c[CHUNKS],
              'gcn_epilogues': c[EPILOGUES]}
    for k, name in enumerate(names):
        result['ops'][name] = (c[2 * k], c[2 * k + 1])
        print(f'{name:6s} barrier {c[2 * k]:8.0f}  work {c[2 * k + 1]:8.0f} '
              f'cycles per tile', flush=True)
    total = sum(b + w for b, w in result['ops'].values()) + c[LOAD] + \
        c[STORE] + c[EMBED]
    joint = sum(result['ops'][nm][1] for nm in P.JOINT_LAYERS)
    result.update(total=total, joint_ops=joint)
    print(f'per tile: loads {c[LOAD]:.0f}, embeddings {c[EMBED]:.0f}, '
          f'store {c[STORE]:.0f}; ST-GCNN MMA chunk loops {c[CHUNKS]:.0f}, '
          f'their epilogues {c[EPILOGUES]:.0f}; joint ops {joint:.0f}; '
          f'total {total:.0f} cycles', flush=True)
    result['ms'] = time_ms(call)
    result['plain_build_ms'] = time_ms(
        lambda: P.DENOISER_BF16(xb, semb, folded))
    print(f'instrumented {result["ms"]:.4f} ms, uninstrumented '
          f'{result["plain_build_ms"]:.4f} ms per call at N={n}',
          flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--n', type=int, default=N_ROWS)
    args = ap.parse_args(argv)
    probe(args.n)
    return 0


if __name__ == '__main__':
    sys.exit(main())
