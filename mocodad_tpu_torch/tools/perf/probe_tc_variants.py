"""Probe: same-call build variants of the bfloat16 tensor-core kernels
(`csrc/denoiser_tc.cu` B1, `denoiser_tc_dma.cu` B3, `denoiser_tc_grouped.cu`
B2), which share their op code (`csrc/denoiser_tc_body.cuh`).

Each kernel is built as it ships and as variants of its source: the op
code behind a `__noinline__` call (`noinline`: it gets a register budget of
its own, and the tile loop's live values are saved around each op instead
of spilled inside the MMA loops), or 12 warps per block instead of 16
(`warps12`: up to 168 registers a thread).  All builds start together, one
nvcc each, with ptxas's register and spill report printed; each variant is
checked against the shipped build (the same arithmetic, so the same bits)
and all are timed in turns (a b c c b a per round) at N = 51,200 rows on
the flagship U-Net (weights from a seed).  Needs a CUDA device.

    python -m mocodad_tpu_torch.tools.perf.probe_tc_variants [--n N]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

from mocodad_tpu_torch.device import resolve_device
from mocodad_tpu_torch.ops import build
from mocodad_tpu_torch.ops import dma_unet as D
from mocodad_tpu_torch.ops import grouped_unet as G
from mocodad_tpu_torch.ops import pallas_unet as P
from mocodad_tpu_torch.tools.perf.common import (N_ROWS, flagship_fold,
                                                 fold_inputs, time_ms)
from mocodad_tpu_torch.tools.perf.probe_tc_phases import inline_headers

# per kernel: (source, the op call in its tile loop, a fresh wrapper, the
# entry point, its pointer and int arguments)
KERNELS = {
    'b1_bf16': ('denoiser_tc.cu', '      run_op<false>(',
                P.TensorCoreDenoiserKernel, 'mocodad_denoiser_tc_launch', 5,
                3),
    'b3_bf16': ('denoiser_tc_dma.cu', '      run_op<false>(',
                D.TensorCoreDmaKernel, 'mocodad_dma_tc_launch', 5, 3),
    'b2': ('denoiser_tc_grouped.cu', '      run_op<true>(',
           G.TensorCoreGroupedKernel, 'mocodad_grouped_tc_launch', 7, 3),
}
VARIANTS = ('shipped', 'noinline', 'warps12')
KERNEL_LOOP = '// ---- the kernel'
APART = '''// the op code behind a call of its own (probe_tc_variants.py)
template <bool kRoundG>
__device__ __noinline__ void run_op_apart(int tid, char* sm, const int* t,
                                          const int* d, const char* wb,
                                          int rows) {
  run_op<kRoundG>(tid, sm, t, d, wb, rows);
}

'''
WARPS = 'constexpr int kWarps = 16;'


def variant_source(kernel: str, variant: str) -> str:
    """The kernel's source (headers inlined) as `variant` builds it."""
    name, call = KERNELS[kernel][:2]
    with open(os.path.join(build.CSRC_DIR, name)) as f:
        src = inline_headers(f.read())
    anchors = {'shipped': (), 'noinline': (KERNEL_LOOP, call),
               'warps12': (WARPS,)}[variant]
    for anchor in anchors:
        if src.count(anchor) != 1:
            raise RuntimeError(f'{name} changed: {src.count(anchor)} copies '
                               f'of {anchor!r}')
    if variant == 'noinline':
        src = src.replace(KERNEL_LOOP, APART + KERNEL_LOOP)
        src = src.replace(call, call.replace('run_op<', 'run_op_apart<'))
    elif variant == 'warps12':
        src = src.replace(WARPS, 'constexpr int kWarps = 12;')
    return src


def build_variants(pairs):
    """Every (kernel, variant) source built at once, one nvcc each, into
    build/; prints ptxas's report of each kernel function; returns the
    loaded libraries."""
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    running = []
    for kernel, variant in pairs:
        stem = f'{kernel}_{variant}'
        cu = os.path.join(build.BUILD_DIR, f'variant_{stem}.cu')
        so = os.path.join(build.BUILD_DIR, f'libvariant_{stem}.so')
        with open(cu, 'w') as f:
            f.write(variant_source(kernel, variant))
        cmd = [build._nvcc(), '-Xptxas=-v', *build.NVCC_FLAGS, '-o', so, cu]
        running.append((kernel, variant, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for kernel, variant, so, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for {kernel} {variant}:\n{log}')
        report = [ln.strip() for ln in log.splitlines()
                  if 'registers' in ln or 'spill' in ln]
        print(f'{kernel} {variant}: ' + '; '.join(report), flush=True)
        libs[(kernel, variant)] = ctypes.CDLL(so)
    return libs


def compare(n: int = N_ROWS, seed: int = 0, rounds: int = 2) -> dict:
    """ms per call of every (kernel, variant), timed in turns per kernel."""
    dev = resolve_device('cuda')
    folded = flagship_fold(dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    x, semb = fold_inputs(folded, n, g)
    args = {'b1_bf16': (x.bfloat16(), semb),
            'b3_bf16': (x, semb),
            'b2': (x.bfloat16(), semb.bfloat16())}
    pairs = [(k, v) for k in KERNELS for v in VARIANTS]
    libs = build_variants(pairs)
    times = {}
    for kernel, (_, _, wrapper, symbol, n_ptrs, n_ints) in KERNELS.items():
        calls, want = {}, None
        for variant in VARIANTS:
            w = wrapper()
            w._fn = P.bind(libs[(kernel, variant)], symbol, n_ptrs, n_ints)
            out = w(*args[kernel], folded)
            torch.cuda.synchronize()
            if want is None:
                want = out
            elif not torch.equal(out, want):
                raise RuntimeError(f'{kernel} {variant} differs from the '
                                   f'shipped build')
            calls[variant] = (lambda w=w: w(*args[kernel], folded))
        order = list(VARIANTS) + list(reversed(VARIANTS))
        ts = {v: [] for v in VARIANTS}
        for _ in range(rounds):
            for v in order:
                ts[v].append(time_ms(calls[v]))
        for v in VARIANTS:
            print(f'{kernel} {v}: ' + ' / '.join(f'{t:.4f}' for t in ts[v]) +
                  f' ms per call at N={n}', flush=True)
            times[(kernel, v)] = ts[v]
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--n', type=int, default=N_ROWS)
    ap.add_argument('--rounds', type=int, default=2)
    args = ap.parse_args(argv)
    compare(args.n, rounds=args.rounds)
    return 0


if __name__ == '__main__':
    sys.exit(main())
