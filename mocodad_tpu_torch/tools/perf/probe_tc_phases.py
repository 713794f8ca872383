"""Probe: where a tile's time goes inside a tensor-core denoiser (B1 at
bfloat16: `csrc/denoiser_wg.cu`, the main path's, and `csrc/denoiser_tc.cu`,
its mma.sync yardstick; at float32 as 3xTF32: `csrc/denoiser_wg_f32.cu`,
the main path's, and `csrc/denoiser_tc_f32.cu`, its mma.sync yardstick).

Writes a copy of the source with clock64() counters around each phase of
a tile (the loads of x and silu_emb, the embeddings, every op, the store)
and, inside the ST-GCNN layers, around warp 0's MMA chunk loops and
epilogues (and, except in the mma.sync float32 kernel, the graph mixes
inside the loops: the channel mixes are the rest of the loops); builds it
with nvcc beside the package's builds; runs one call at N = 51,200 rows
on the flagship U-Net (weights from a seed) and prints thread 0's cycles
per tile for each phase, averaged over every block's tiles.  Both kernels
of a dtype run in one process, the breakdown per kernel: graph mixes,
channel mixes, joint re-scalings, epilogues, staging and barriers (the
wait for each op's constants and the barrier before it; at float32 on
wgmma, for each record of a run), loads, embeddings and the store.
Thread 0 (warp 0) always has a unit of work and arrives last at each
barrier, so an op's cycles are its critical path.  A counter reads the
clock when an MMA has been issued, not when its result lands: a wait for
results counts where the next instruction needs them.  The counters
themselves add a little; the probe also prints the instrumented call's ms
beside the plain build's.  With `--variants` (float32) it then builds the
wgmma kernel for other warp counts, widest wgmmas and rounds
(WG32_VARIANTS), and the mma.sync kernel for other warp counts, chunk
widths and joint routes (VARIANTS: warps per block, input channels per
graph-mix chunk, the joint re-scalings as dense 3xTF32 products or on
the FMA units), each checked and timed in turns in the same call.  Needs
a CUDA device.

    python -m mocodad_tpu_torch.tools.perf.probe_tc_phases \
        [--dtype bfloat16|float32] [--n N] [--variants]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
from unittest import mock

import numpy as np
import torch

from mocodad_tpu_torch.device import resolve_device
from mocodad_tpu_torch.ops import build
from mocodad_tpu_torch.ops import pallas_unet as P
from mocodad_tpu_torch.tools.perf.common import (N_ROWS, flagship_fold,
                                                 fold_inputs, time_ms)

N_SLOTS = 64
# counter slots: op k at 2k (its barrier) and 2k + 1 (thread 0's work)
LOAD, STORE, CHUNKS, EPILOGUES, EMBED, GRAPH = 40, 41, 44, 45, 46, 47


def _patches(namespace: str, load: str, embed: str, wait: str, run: str,
             units: str, epilogue: str, stored: str, graph: str = ''):
    """(anchor, replacement) pairs for a source whose namespace, tile load,
    embedding call, wait for an op's constants, op call, ST-GCNN unit loop,
    start and end of the ST-GCNN epilogue and (optional) graph mix call
    differ; `epilogue` may be `stored` (an epilogue in one call)."""
    one = epilogue == stored
    start = ('    long long tb = clock64();\n'
             '    if (warp == 0 && lane == 0) atomicAdd(&g_prof[44], '
             '(unsigned long long)(tb - ta));\n')
    end = ('    if (warp == 0 && lane == 0) atomicAdd(&g_prof[45], '
           '(unsigned long long)(clock64() - tb));\n'
           '    ta = clock64();\n')
    timed = ((graph,
              '      long long tg = clock64();\n' + graph +
              '\n      if (warp == 0 && lane == 0) atomicAdd(&g_prof[47], '
              '(unsigned long long)(clock64() - tg));'),) if graph else ()
    return timed + (
        (f'namespace {namespace} {{\nnamespace {{\n',
         f'namespace {namespace} {{\n'
         '__device__ unsigned long long g_prof[64];\nnamespace {\n'),
        (load,
         '    long long tl = clock64();\n'
         f'{load}\n'
         '    if (tid == 0) atomicAdd(&g_prof[40], (unsigned long long)'
         '(clock64() - tl));'),
        (embed,
         '    long long te = clock64();\n'
         f'{embed}\n'
         '    if (tid == 0) atomicAdd(&g_prof[46], (unsigned long long)'
         '(clock64() - te));'),
        (wait,
         '      long long t0 = clock64();\n'
         f'{wait}\n'
         '      long long t1 = clock64();\n'
         '      if (tid == 0) atomicAdd(&g_prof[2 * op], (unsigned long long)'
         '(t1 - t0));'),
        (run,
         f'{run}\n'
         '      if (tid == 0) atomicAdd(&g_prof[2 * op + 1], '
         '(unsigned long long)(clock64() - t1));'),
        ('    __syncthreads();\n    store_tile<kRows>(tid, sm, t, eps, n, n0);',
         '    long long ts = clock64();\n'
         '    __syncthreads();\n'
         '    store_tile<kRows>(tid, sm, t, eps, n, n0);\n'
         '    if (tid == 0) atomicAdd(&g_prof[41], (unsigned long long)'
         '(clock64() - ts));'),
        (units, '  long long ta = clock64();\n' + units),
    ) + (((stored, start + stored + '\n' + end),) if one else
         ((epilogue, start + epilogue), (stored, stored + end)))


# B1 at float32 on wgmma: an op is a run of records (next_record waits for
# each, its time kept per block in g_wait and moved to the run's barrier
# slot), and warp 0's graph mixes, chunk rounds and epilogues in gcn_record
# and gcn_run
WG32_PATCHES = (
    ('namespace mocodad_wg32 {\nnamespace {\n',
     'namespace mocodad_wg32 {\n'
     '__device__ unsigned long long g_prof[64];\n'
     '__shared__ unsigned long long g_wait;\nnamespace {\n'),
    ('    asm volatile("cp.async.wait_group 0;\\n" ::: "memory");\n'
     '    __syncthreads();     // this tile\'s x and silu_emb have arrived\n'
     '    load_tile<kRows>(tid, sm, t, n, n0);',
     '    long long tl = clock64();\n'
     '    asm volatile("cp.async.wait_group 0;\\n" ::: "memory");\n'
     '    __syncthreads();     // this tile\'s x and silu_emb have arrived\n'
     '    load_tile<kRows>(tid, sm, t, n, n0);\n'
     '    if (tid == 0) atomicAdd(&g_prof[40], (unsigned long long)'
     '(clock64() - tl));'),
    ('    embed_all<kRows>(tid, sm, t, blob);',
     '    long long te = clock64();\n'
     '    embed_all<kRows>(tid, sm, t, blob);\n'
     '    if (tid == 0) atomicAdd(&g_prof[46], (unsigned long long)'
     '(clock64() - te));'),
    ('    for (int op = 0; op < nops;)\n'
     '      op += run_op<kRows>(pp, tid, sm, t, ops, op, nops, more, blob);',
     '    for (int op = 0, run_i = 0; op < nops; ++run_i) {\n'
     '      const unsigned long long w0 = g_wait;\n'
     '      long long t1 = clock64();\n'
     '      op += run_op<kRows>(pp, tid, sm, t, ops, op, nops, more, blob);\n'
     '      if (tid == 0) {\n'
     '        const unsigned long long w = g_wait - w0;\n'
     '        atomicAdd(&g_prof[2 * run_i], w);\n'
     '        atomicAdd(&g_prof[2 * run_i + 1], (unsigned long long)'
     '(clock64() - t1) - w);\n'
     '      }\n'
     '    }'),
    ('  mbar_wait(pp.bar[pp.buf], pp.parity >> pp.buf & 1);\n'
     '  pp.parity ^= 1u << pp.buf;\n'
     '  __syncthreads();',
     '  long long tw = clock64();\n'
     '  mbar_wait(pp.bar[pp.buf], pp.parity >> pp.buf & 1);\n'
     '  pp.parity ^= 1u << pp.buf;\n'
     '  __syncthreads();\n'
     '  if (tid == 0) g_wait += clock64() - tw;'),
    ('    if (live) graph_mix<JT>(g, gs, kf, f, in_st, mi, c, ks, mask, lane);',
     '    long long tg = clock64();\n'
     '    if (live) graph_mix<JT>(g, gs, kf, f, in_st, mi, c, ks, mask, lane);\n'
     '    if (warp == 0 && lane == 0) atomicAdd(&g_prof[47], '
     '(unsigned long long)(clock64() - tg));'),
    ('  for (int c = c0; c < c1; c += 8 * JT) {',
     '  long long ta = clock64();\n'
     '  for (int c = c0; c < c1; c += 8 * JT) {'),
    ('    wg_wait_all();\n    keep<NT>(acc);\n  }\n}',
     '    wg_wait_all();\n    keep<NT>(acc);\n  }\n'
     '  if (warp == 0 && lane == 0) atomicAdd(&g_prof[44], '
     '(unsigned long long)(clock64() - ta));\n}'),
    ('    if (v < units && u.live)\n      gcn_epilogue<NT>(',
     '    long long tb = clock64();\n'
     '    if (v < units && u.live)\n      gcn_epilogue<NT>('),
    ('                       u.m0, u.part * NT * 8, lane);',
     '                       u.m0, u.part * NT * 8, lane);\n'
     '    if (warp == 0 && lane == 0) atomicAdd(&g_prof[45], '
     '(unsigned long long)(clock64() - tb));'),
    ('    __syncthreads();\n    store_tile<kRows>(tid, sm, t, eps, n, n0);',
     '    long long ts = clock64();\n'
     '    __syncthreads();\n'
     '    store_tile<kRows>(tid, sm, t, eps, n, n0);\n'
     '    if (tid == 0) atomicAdd(&g_prof[41], (unsigned long long)'
     '(clock64() - ts));'),
)

# builds of csrc/denoiser_wg_f32.cu: (warps per block, widest wgmma in
# 8-channel tiles, most k-steps of 8 input channels per round); the first
# is the shipped build
WG32_VARIANTS = ((8, 16, 4), (8, 8, 4), (12, 8, 2))


# per source: (file, namespace, patches)
SOURCES = {
    'wg32': ('denoiser_wg_f32.cu', 'mocodad_wg32', WG32_PATCHES),
    'mma': ('denoiser_tc.cu', 'mocodad_tc', _patches(
        'mocodad_tc', '    load_tile<kRows>(tid, sm, t, x, semb, n, n0);',
        '    embed_all<kRows>(tid, sm, t, kRows);',
        '      cp_async_wait_all();\n'
        '      __syncthreads();   // this op\'s constants and the last op\'s '
        'output',
        '      run_op<false>(tid, sm, t, ops + op * O_LEN, wbuf[buf], '
        'kRows);',
        '  for (int u = warp; u < rows * mt * ns; u += kWarps) {',
        '    // epilogue: (+ f), + bias, PReLU',
        '            p < tvo ? pack(acc[j][2 * h], acc[j][2 * h + 1]) : 0u;\n'
        '      }\n    }\n',
        '      graph_mix(g, k_base, k_st, f_base, in_st, m0, c0, ks, lane);')),
    'wg': ('denoiser_wg.cu', 'mocodad_wg', _patches(
        'mocodad_wg', '    load_tile<kRows>(tid, sm, t, x, semb, n, n0);',
        '    embed_all<kRows>(tid, sm, t, kRows);',
        '      mbar_wait(bar[buf], parity >> buf & 1);\n'
        '      parity ^= 1u << buf;\n'
        '      __syncthreads();   // this op\'s constants and the last op\'s '
        'output',
        '      wg_run_op<kRows>(tid, sm, t, ops + op * O_LEN, wbuf[buf], '
        'kRows);',
        '  for (int v = warp >> 2; v < groups * ns; v += kGroups) {',
        '    if (live) store_gcn<NT>(acc, sm, t, d, wb, row, r, m0, o0, lane, '
        'res);',
        '    if (live) store_gcn<NT>(acc, sm, t, d, wb, row, r, m0, o0, lane, '
        'res);',
        '      graph_mix_k<KS>(g[0], kf, mask, f_base, in_st, c0, lane);\n'
        '      if (nc == 2)\n'
        '        graph_mix_k<KS>(g[1], kf, mask, f_base, in_st, c0 + 16, '
        'lane);')),
    'f32': ('denoiser_tc_f32.cu', 'mocodad_tc32', _patches(
        'mocodad_tc32',
        '    asm volatile("cp.async.wait_group 0;\\n" ::: "memory");\n'
        '    __syncthreads();     // this tile\'s x and silu_emb have arrived\n'
        '    load_tile<kRows>(tid, sm, t, n, n0);',
        '    embed_all<kRows>(tid, sm, t, blob);',
        '      mbar_wait(buf ? bar[1] : bar[0], parity >> buf & 1);\n'
        '      parity ^= 1u << buf;\n'
        '      __syncthreads();   // this op\'s constants and the last op\'s '
        'output',
        '      run_op<kRows>(tid, sm, t, ops + op * O_LEN, '
        'sm + (buf ? wb1 : wb0));',
        '  for (int u = warp; u < kRows * mt * ns; u += kWarps) {',
        '    // epilogue: (+ f), + bias, PReLU',
        '                    : make_float2(0.f, 0.f);\n      }\n    }\n')),
}
READER = '''
extern "C" int mocodad_probe_read(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, NAMESPACE::g_prof,
                                         sizeof(unsigned long long) * 64);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned long long zero[64] = {0};
  return static_cast<int>(cudaMemcpyToSymbol(NAMESPACE::g_prof, zero,
                                             sizeof(zero)));
}
'''


def inline_headers(src: str) -> str:
    """`src` with each `#include "<name>.cuh"` replaced by that header's
    text from csrc/, so that anchors in a shared header are patched in
    this kernel's copy of its code only."""
    def text(m):
        with open(os.path.join(build.CSRC_DIR, m.group(1))) as f:
            return f.read()
    return re.sub(r'#include "(\w+\.cuh)"\n', text, src)


def instrumented_source(which: str = 'wg') -> str:
    """The source (`which`: 'wg', 'mma' or 'f32') with the counters; raises
    if it no longer has an anchor the probe patches."""
    name, namespace, patches = SOURCES[which]
    with open(os.path.join(build.CSRC_DIR, name)) as f:
        src = inline_headers(f.read())
    for anchor, text in patches:
        if src.count(anchor) != 1:
            raise RuntimeError(f'{name} changed: the probe finds '
                               f'{src.count(anchor)} copies of {anchor!r}')
        src = src.replace(anchor, text)
    return src + READER.replace('NAMESPACE', namespace)


# nvcc's output for each variant this process built
VARIANT_LOGS = {}


def build_variant(stem: str, src: str, flags=()) -> ctypes.CDLL:
    """`src` built with nvcc (the package's flags plus `flags`) into
    build/lib<stem>.so, beside the package's builds; nvcc's output in
    VARIANT_LOGS[stem]."""
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(build.BUILD_DIR, f'{stem}.cu')
    so = os.path.join(build.BUILD_DIR, f'lib{stem}.so')
    with open(cu, 'w') as f:
        f.write(src)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, *flags, '-I',
                           build.CSRC_DIR, '-o', so, cu],
                          capture_output=True, text=True)
    VARIANT_LOGS[stem] = proc.stdout + proc.stderr
    if proc.returncode:
        raise RuntimeError(f'nvcc failed on {stem}:\n{VARIANT_LOGS[stem]}')
    return ctypes.CDLL(so)


def ptxas_summary(log: str) -> str:
    """The most registers and spill bytes of any kernel in ptxas's -v
    output, and how many wgmma warnings (C75xx) it gave, by code."""
    regs = [int(v) for v in re.findall(r'Used (\d+) registers', log)]
    spills = [int(v) for v in re.findall(r'(\d+) bytes spill stores', log)]
    codes = re.findall(r'\((C75\d\d)\)', log)
    counts = {c: codes.count(c) for c in sorted(set(codes))}
    return (f'registers={max(regs, default=0)} '
            f'spill_bytes={max(spills, default=0)} '
            f'wgmma_warnings={counts}')


def _setup(which: str, n: int, seed: int, warps: int = P.TC32_WARPS):
    """(kernel wrapper, x, silu_emb, plan, folded) on the card, the plan
    for a build of `warps` warps (float32 on mma.sync)."""
    dev = resolve_device('cuda')
    folded = flagship_fold(dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    x, semb = fold_inputs(folded, n, g)
    if which == 'wg':
        return P.DENOISER_BF16, x.bfloat16(), semb, P.wg_plan(folded, dev), \
            folded
    if which == 'mma':
        return P.DENOISER_BF16_MMA, x.bfloat16(), semb, \
            P.tc_plan(folded, dev), folded
    if which == 'wg32':
        return P.DENOISER, x, semb, P.wg32_plan(folded, dev), folded
    return P.DENOISER_F32_MMA, x, semb, P.tc32_plan(folded, dev, warps), \
        folded


def _caller(lib, kernel, x, semb, plan, n):
    launch = P.bind(lib, kernel.symbol, 5, 3)
    out = torch.empty_like(x)

    def call():
        err = launch(x.data_ptr(), semb.data_ptr(), plan.blob.data_ptr(),
                     plan.table.data_ptr(), out.data_ptr(), n, plan.rows,
                     plan.smem_bytes, P.current_stream(x.device))
        if err:
            raise RuntimeError(f'probe launch failed: {err}')
    return call, out


def probe(n: int = N_ROWS, seed: int = 0, which: str = 'wg') -> dict:
    """Cycles per tile of each phase of one kernel ('wg', 'mma', 'wg32' or
    'f32'); prints one line each."""
    kernel, x, semb, plan, folded = _setup(which, n, seed)
    lib = build_variant(f'{os.path.splitext(SOURCES[which][0])[0]}_phases',
                        instrumented_source(which))
    call, _ = _caller(lib, kernel, x, semb, plan, n)
    read = lib.mocodad_probe_read
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    counts = (ctypes.c_ulonglong * N_SLOTS)()
    call()                                   # warm-up, then one counted call
    torch.cuda.synchronize()
    read(counts)
    call()
    torch.cuda.synchronize()
    if read(counts):
        raise RuntimeError('reading the counters failed')
    rows = plan.rows
    tiles = -(-n // rows)
    c = np.array(counts[:], np.float64) / tiles
    _, ops = _records(plan, which)
    names = _op_names(folded, ops, which)
    result = {'ops': {}, 'load': c[LOAD], 'store': c[STORE],
              'embed': c[EMBED], 'gcn_chunk_loops': c[CHUNKS],
              'gcn_epilogues': c[EPILOGUES]}
    for k, name in enumerate(names):
        result['ops'][name] = (c[2 * k], c[2 * k + 1])
        print(f'[{which}] {name:8s} barrier {c[2 * k]:8.0f}  work '
              f'{c[2 * k + 1]:8.0f} cycles per tile', flush=True)
    total = sum(b + w for b, w in result['ops'].values()) + c[LOAD] + \
        c[STORE] + c[EMBED]
    joint = sum(w for nm, (_, w) in result['ops'].items()
                if nm in P.JOINT_LAYERS)
    barriers = sum(b for b, _ in result['ops'].values())
    result.update(total=total, joint_ops=joint, barriers=barriers)
    graph = ''
    if which in ('wg', 'mma', 'wg32'):
        result.update(graph_mixes=c[GRAPH],
                      channel_mixes=c[CHUNKS] - c[GRAPH])
        graph = (f' (graph mixes {c[GRAPH]:.0f}, channel mixes '
                 f'{c[CHUNKS] - c[GRAPH]:.0f})')
    print(f'[{which}] per tile of {rows} rows: loads {c[LOAD]:.0f}, '
          f'embeddings {c[EMBED]:.0f}, store {c[STORE]:.0f}; ST-GCNN MMA '
          f'chunk loops {c[CHUNKS]:.0f}{graph}, their epilogues '
          f'{c[EPILOGUES]:.0f}; joint ops {joint:.0f}; staging and '
          f'barriers {barriers:.0f}; total {total:.0f} cycles', flush=True)
    result['ms'] = time_ms(call)
    result['plain_build_ms'] = time_ms(lambda: kernel(x, semb, folded))
    print(f'[{which}] instrumented {result["ms"]:.4f} ms, uninstrumented '
          f'{result["plain_build_ms"]:.4f} ms per call at N={n}',
          flush=True)
    return result


def _records(plan, which):
    header, op = {'wg': (P.TC_HEADER, P.WG_OP), 'mma': (P.TC_HEADER, P.TC_OP),
                  'f32': (P.TC32_HEADER, P.TC32_OP),
                  'wg32': (P.WG32_HEADER, P.WG32_OP)}[which]
    table = plan.table.cpu().numpy()
    nh, no = len(header), len(op)
    h = dict(zip(header, table[:nh]))
    return h, [dict(zip(op, table[nh + i * no:nh + (i + 1) * no]))
               for i in range(h['nops'])]


def _op_names(folded, ops, which):
    """One name per op record (per run of records at float32 on wgmma):
    the layer, with its first output channel for a part of a layer's C_out
    (its first output position for a later run)."""
    seq = iter(P.layer_sequence(folded))
    names = []
    if which == 'wg32':
        k = 0
        while k < len(ops):
            o = ops[k]
            if o['p0'] == 0:
                kind, i, _, _ = next(seq)
                name = P.GCN_LAYERS[i] if kind == 0 else P.JOINT_LAYERS[i]
            names.append(f'{name}@p{o["p0"]}' if o['p0'] else name)
            k += o['nrec']
        return names
    for o in ops:
        part = which == 'f32' and o['c0'] > 0
        if not part:
            kind, i, _, _ = next(seq)
            name = P.GCN_LAYERS[i] if kind == 0 else P.JOINT_LAYERS[i]
        names.append(f'{name}@{o["c0"]}' if part else name)
    return names


# the float32 kernel's chunk of C_in per graph mix: the dispatch in run_op,
# and what replaces it for a build that takes 16 or 64 channels where C_in
# allows
CHUNK_DISPATCH = '  if (tab(d, O_CI) % 32 == 0)\n'
CHUNK_SOURCES = {16: '  if (false)\n', 32: CHUNK_DISPATCH,
                 64: '  if (tab(d, O_CI) % 64 == 0)\n'
                     '    gcn_units<8, kRows>(sm, t, d, wb, warp, lane);\n'
                     '  else if (tab(d, O_CI) % 32 == 0)\n'}
# the joint re-scalings on the FMA units over their T diagonal (V_out x
# V_in) blocks, in place of the kernel's dense 3xTF32 graph mix; the plan
# for it comes from `joint_fma_plan`
JOINT_MMA = ('// One joint re-scaling: h = D f as a graph mix',
             "// Every layer's embedding for the tile's rows")
JOINT_FMA = r"""constexpr int kJW = 4;           // output joints per thread

// One joint re-scaling on the FMA units: h = D f over D's T diagonal
// (V_out x V_in) blocks, then h * rs + rt and, with a skip, + skip; 0 past
// T*V.  A thread takes (row, frame t, kJW output joints, 4 channels): each
// 16-byte load of f serves kJW outputs, D's entries are broadcasts.
template <int kRows>
__device__ __forceinline__ void joint_op(int tid, char* sm, const int* t,
                                         const int* d, const char* wb) {
  const int row0 = tab(t, H_ROW0), rb = tab(t, H_ROW_BYTES);
  const int cs = tab(d, O_CI), tvo = tab(d, O_TVO), mt = tab(d, O_MT);
  const int vi = tab(d, O_KS), vo = tab(d, O_NT);   // joint_fma_plan
  const int in_off = tab(d, O_IN), in_st = tab(d, O_IN_STRIDE);
  const int out_off = tab(d, O_OUT), out_st = tab(d, O_OUT_STRIDE);
  const int skip_off = tab(d, O_SKIP), skip_st = tab(d, O_SKIP_STRIDE);
  const float* blk = reinterpret_cast<const float*>(wb + tab(d, O_K));
  const float* rs = reinterpret_cast<const float*>(wb + tab(d, O_RS));
  const float* rt = reinterpret_cast<const float*>(wb + tab(d, O_RT));
  const int q4 = cs / 4, tdim = tvo / vo, wg = (vo + kJW - 1) / kJW;
  // positions past T*V up to the 16-row tile: zeros
  for (int i = tid; i < kRows * (mt * 16 - tvo) * q4; i += kThreads) {
    const int c = i % q4 * 4, rp = i / q4;
    const int p = tvo + rp % (mt * 16 - tvo), r = rp / (mt * 16 - tvo);
    *reinterpret_cast<float4*>(reinterpret_cast<float*>(
        sm + row0 + r * rb + out_off) + p * out_st + c) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = tid; i < kRows * tdim * wg * q4; i += kThreads) {
    const int c = i % q4 * 4, rest = i / q4;
    const int w0 = rest % wg * kJW, tt = rest / wg % tdim;
    const int r = rest / (wg * tdim);
    char* row = sm + row0 + r * rb;
    const float* dr = blk + (tt * vo + w0) * vi;
    const float* f = reinterpret_cast<const float*>(row + in_off) +
                     tt * vi * in_st + c;
    float4 h[kJW];
#pragma unroll
    for (int q = 0; q < kJW; ++q) h[q] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int v = 0; v < vi; ++v) {
      const float4 a = *reinterpret_cast<const float4*>(f + v * in_st);
#pragma unroll
      for (int q = 0; q < kJW; ++q) {
        // rows past V_out read the next block's (or padding), unused
        const float k = w0 + q < vo ? dr[q * vi + v] : 0.f;
        h[q].x = fmaf(k, a.x, h[q].x);
        h[q].y = fmaf(k, a.y, h[q].y);
        h[q].z = fmaf(k, a.z, h[q].z);
        h[q].w = fmaf(k, a.w, h[q].w);
      }
    }
#pragma unroll
    for (int q = 0; q < kJW; ++q) {
      if (w0 + q >= vo) break;
      const int p = tt * vo + w0 + q;
      const float s = rs[p], b = rt[p];
      float4 y = make_float4(h[q].x * s + b, h[q].y * s + b,
                             h[q].z * s + b, h[q].w * s + b);
      if (skip_off >= 0) {
        const float4 k = *reinterpret_cast<const float4*>(
            reinterpret_cast<const float*>(row + skip_off) + p * skip_st + c);
        y.x += k.x;
        y.y += k.y;
        y.z += k.z;
        y.w += k.w;
      }
      *reinterpret_cast<float4*>(reinterpret_cast<float*>(row + out_off) +
                                 p * out_st + c) = y;
    }
  }
}

"""
VARIANTS = ((12, 32, 'mma'), (8, 32, 'mma'), (12, 16, 'mma'),
            (8, 64, 'mma'), (12, 32, 'fma'))


def variant_source(chunk: int, joints: str = 'mma') -> str:
    """csrc/denoiser_tc_f32.cu with chunks of `chunk` input channels and
    the joint re-scalings on the tensor cores or (`joints='fma'`) the FMA
    units."""
    with open(os.path.join(build.CSRC_DIR, 'denoiser_tc_f32.cu')) as f:
        src = f.read()
    if src.count(CHUNK_DISPATCH) != 1 or \
            any(src.count(m) != 1 for m in JOINT_MMA):
        raise RuntimeError('denoiser_tc_f32.cu changed: the variants do not '
                           'find the chunk dispatch or the joint op')
    src = src.replace(CHUNK_DISPATCH, CHUNK_SOURCES[chunk])
    if joints == 'fma':
        a0, a1 = src.index(JOINT_MMA[0]), src.index(JOINT_MMA[1])
        src = src[:a0] + JOINT_FMA + src[a1:]
    return src


def joint_blocks(d2: torch.Tensor, t_dim: int) -> np.ndarray:
    """A joint re-scaling's (TVo, TVi) operator as its T diagonal (V_out,
    V_in) blocks; raises unless it is zero outside them."""
    d = d2.detach().cpu().float().numpy()
    vo, vi = d.shape[0] // t_dim, d.shape[1] // t_dim
    blocks = np.stack([d[t * vo:(t + 1) * vo, t * vi:(t + 1) * vi]
                       for t in range(t_dim)])
    rest = d.copy()
    for t in range(t_dim):
        rest[t * vo:(t + 1) * vo, t * vi:(t + 1) * vi] = 0
    if rest.any():
        raise ValueError('a joint re-scaling is not block-diagonal over T')
    return blocks


def joint_fma_plan(plan: P.TcPlan, folded) -> P.TcPlan:
    """`plan` with each joint re-scaling's constants, for JOINT_FMA, as its
    T diagonal blocks and its affine, appended to the blob; the joint
    records point at them and carry V_in in `ks`, V_out in `nt`."""
    dev = plan.blob.device
    h, ops = _records(plan, 'f32')
    blob = plan.blob.cpu().numpy()
    table = plan.table.cpu().numpy().copy()
    nh, no = len(P.TC32_HEADER), len(P.TC32_OP)
    joints, parts, size = iter(folded.joint), [blob], blob.size
    t_dim = folded.n_frames
    for k, o in enumerate(ops):
        if o['kind'] != 1:
            continue
        j, b = next(joints), P._Blob()
        fields = dict(k=b.add(joint_blocks(j.d2, t_dim)),
                      rs=b.vec(j.rs, 16 * o['mt']),
                      rt=b.vec(j.rt, 16 * o['mt']), blob=size,
                      blob_bytes=b.size, ks=o['tvi'] // t_dim,
                      nt=o['tvo'] // t_dim)
        for name, value in fields.items():
            table[nh + k * no + P.TC32_OP.index(name)] = value
        parts += b.parts
        size += b.size
    return P.TcPlan(blob=torch.from_numpy(np.concatenate(parts)).to(dev),
                    table=torch.from_numpy(table).to(dev),
                    smem_bytes=plan.smem_bytes, rows=plan.rows)


def compare_variants(variants=VARIANTS, n: int = N_ROWS, seed: int = 0,
                     rounds: int = 2) -> dict:
    """ms per call of the float32 kernel built for each (warps, chunk
    channels, joint route) in `variants`, each with its own plan, checked
    against the plain version and timed in turns (a b .. b a per round) in
    one process."""
    calls, want = {}, None
    for w, chunk, joints in variants:
        kernel, x, semb, plan, folded = _setup('f32', n, seed, w)
        if want is None:
            want = P.denoise_reference(x, semb, folded)
        if joints == 'fma':
            plan = joint_fma_plan(plan, folded)
        lib = build_variant(f'denoiser_tc_f32_w{w}_c{chunk}_{joints}',
                            variant_source(chunk, joints),
                            (f'-DTC32_WARPS={w}',))
        call, out = _caller(lib, kernel, x, semb, plan, n)
        call()
        torch.cuda.synchronize()
        d = (out - want).abs()
        ok = bool((d <= 1e-5 + 1e-4 * want.abs()).all())
        print(f'warps {w}, chunks of {chunk}, joints on {joints}: max |diff| '
              f'{float(d.max()):.3e} from the plain version, ok={ok}',
              flush=True)
        if not ok:
            raise RuntimeError(f'the ({w}, {chunk}, {joints}) build disagrees')
        calls[(w, chunk, joints)] = call
    times = {v: [] for v in variants}
    order = list(variants) + list(reversed(variants))
    for _ in range(rounds):
        for v in order:
            times[v].append(time_ms(calls[v]))
    for (w, chunk, joints), ts in times.items():
        print(f'warps {w}, chunks of {chunk}, joints on {joints}: ' +
              ' / '.join(f'{t:.4f}' for t in ts) + f' ms per call at N={n}',
              flush=True)
    return times


# the lines of csrc/denoiser_wg_f32.cu that a build of WG32_VARIANTS
# rewrites: warps per block, the body of the widest wgmma, k-steps per round
WG32_WARPS_LINE = 'constexpr int kWarps = 8;'
WG32_WIDE_CASE = ('    case 16:\n'
                  '      return jt == 1 ? RUN(16, 1) : RUN(16, 2);\n')
WG32_RUN_CALL = 'gcn_run<NT, JT, kRows>('


def wg32_variant_source(variant: tuple) -> str:
    """csrc/denoiser_wg_f32.cu built for (warps per block, widest wgmma in
    8-channel tiles, most k-steps per round): the shipped values give the
    source as it stands; raises if it no longer has a line this rewrites."""
    w, nt, jt = variant
    with open(os.path.join(build.CSRC_DIR, 'denoiser_wg_f32.cu')) as f:
        src = f.read()
    for anchor in (WG32_WARPS_LINE, WG32_WIDE_CASE, WG32_RUN_CALL):
        if src.count(anchor) != 1:
            raise RuntimeError(f'denoiser_wg_f32.cu changed: the variants '
                               f'find {src.count(anchor)} copies of '
                               f'{anchor!r}')
    src = src.replace(WG32_WARPS_LINE, f'constexpr int kWarps = {w};')
    if nt < 16:
        src = src.replace(WG32_WIDE_CASE, '')
    if jt < 4:
        src = src.replace(WG32_RUN_CALL,
                          f'gcn_run<NT, (JT < {jt} ? JT : {jt}), kRows>(')
    return src


def wg32_variant_plan(folded, variant: tuple, dev) -> P.TcPlan:
    """The plan for a build of WG32_VARIANTS: the package's planner with
    the variant's warpgroups per block and wgmma widths."""
    w, nt, _ = variant
    tiles = tuple(t for t in P.WG32_UNIT_TILES if t <= nt)
    with mock.patch.multiple(P, WG32_GROUPS=w // 4, WG32_UNIT_TILES=tiles):
        return P.pack_for_wg32_kernel(folded).to(dev)


def compare_wg32_variants(variants=WG32_VARIANTS, n: int = N_ROWS,
                          seed: int = 0, rounds: int = 1) -> dict:
    """ms per call of the float32 wgmma kernel built for each (warps,
    widest wgmma, k-steps per round) in `variants`, each with its own plan,
    with ptxas's registers, spills and wgmma warnings, checked against the
    plain version and timed in turns (a b .. b a per round) in one process
    beside the mma.sync kernel."""
    dev = resolve_device('cuda')
    folded = flagship_fold(dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    x, semb = fold_inputs(folded, n, g)
    want = P.denoise_reference(x, semb, folded)
    calls = {'mma': lambda: P.DENOISER_F32_MMA(x, semb, folded)}
    for variant in variants:
        w, nt, jt = variant
        stem = 'denoiser_wg_f32_' + '_'.join(map(str, variant))
        lib = build_variant(stem, wg32_variant_source(variant),
                            ('-Xptxas=-v',))
        plan = wg32_variant_plan(folded, variant, dev)
        call, out = _caller(lib, P.DENOISER, x, semb, plan, n)
        call()
        torch.cuda.synchronize()
        d = (out - want).abs()
        ok = bool((d <= 1e-5 + 1e-4 * want.abs()).all())
        print(f'[wg32_variant] warps={w} max_nt={nt} max_jt={jt} '
              f'records={int(plan.table[0])} {ptxas_summary(VARIANT_LOGS[stem])} '
              f'max_abs_err={float(d.max()):.3e} ok={ok}', flush=True)
        if not ok:
            raise RuntimeError(f'the {variant} build disagrees')
        calls[variant] = call
    times = {v: [] for v in calls}
    order = list(calls) + list(reversed(list(calls)))
    for _ in range(rounds):
        for v in order:
            times[v].append(time_ms(calls[v]))
    for v, ts in times.items():
        print(f'[wg32_variant] {v}: ' + ' / '.join(f'{t:.4f}' for t in ts) +
              f' ms per call at N={n}', flush=True)
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--dtype', choices=('bfloat16', 'float32'),
                    default='bfloat16')
    ap.add_argument('--n', type=int, default=N_ROWS)
    ap.add_argument('--variants', action='store_true',
                    help='float32: also time the builds of WG32_VARIANTS and '
                         'the mma.sync kernel\'s warp and chunk variants')
    args = ap.parse_args(argv)
    if args.dtype == 'bfloat16':
        for which in ('wg', 'mma'):
            probe(args.n, which=which)
        return 0
    for which in ('wg32', 'f32'):
        probe(args.n, which=which)
    if args.variants:
        compare_wg32_variants(n=args.n)
        compare_variants(n=args.n)
    return 0


if __name__ == '__main__':
    sys.exit(main())
