"""Probe: the layer-grouped denoiser (B2, five kernels, bfloat16
intermediates in device memory) on the tensor cores, beside its FMA design
and the fused B1 at bfloat16 on the tensor cores, the design B2 splits
into groups.

Counterpart of the JAX repository's `tools/perf/probe_grouped_pallas.py`
(:221-270): build B2's kernels, check them against B1 at the same compute
dtype on 2,048 rows, and time one forward of each at N = 51,200 rows (one
flagship batch, 1024 windows x 50 samples), in the same run: B2 on the
tensor cores (`GROUPED`), its FMA design (`GROUPED_FMA`) and B1 bfloat16 on
the tensor cores whose op code B2 splits (`DENOISER_BF16_MMA`, the
mma.sync kernel).  Then each group's ms (CUDA events
around each launch, the median over the timed forwards) beside the
activation bytes it moves (its inputs and silu_emb read once, its outputs
written once) and the MMAs it issues (`grouped_unet.mmas_per_row`), with
B1's MMAs and rate for comparison.  Weights are the flagship U-Net's, from
a seed.  Needs a CUDA device.

    python -m mocodad_tpu_torch.tools.perf.probe_grouped_pallas [--n N]
"""

from __future__ import annotations

import argparse
import statistics
import sys

import torch

from mocodad_tpu_torch.device import resolve_device
from mocodad_tpu_torch.ops import grouped_unet as G
from mocodad_tpu_torch.ops import pallas_unet as P
from mocodad_tpu_torch.tools.perf.common import (N_ROWS, REPEATS,
                                                 flagship_fold, fold_inputs,
                                                 rel_errors, time_ms)

N_PARITY = 2048
# B2 is not B1's function: it rounds the graph-mixed g to bfloat16 where
# B1 keeps it float32.  The two stay within a few bfloat16 roundings of
# each other; this bound only catches a broken kernel.
PARITY_MAX_REL = 5e-2


def group_bytes(folded: P.FoldedDenoiser, plan: G.TcGroupedPlan,
                n: int) -> list:
    """Bytes of activations each group moves at N rows: its inputs and
    silu_emb read once, its outputs written once, all bfloat16."""
    shapes = {'x': (folded.c_in, folded.gcn[0].k2.shape[0])}
    out = []
    for g in plan.groups:
        shapes.update(zip(g.spec.outs, g.out_shapes))
        elems = folded.embedding_dim + sum(
            c * tv for nm in g.spec.ins + g.spec.outs
            for c, tv in [shapes[nm]])
        out.append(2 * n * elems)
    return out


def probe(n: int = N_ROWS, repeats: int = REPEATS, seed: int = 0) -> dict:
    """Parity, ms per forward of B2 (tensor cores and FMA) and B1 bf16 on
    the tensor cores, and each group's ms; prints one line each.
    `forwards` counts the calls of `GROUPED`, which launches 5 each."""
    dev = resolve_device('cuda')
    folded = flagship_fold(dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    x, semb = fold_inputs(folded, N_PARITY, g)
    xb, sb = x.bfloat16(), semb.bfloat16()
    got = G.GROUPED(xb, sb, folded)
    forwards = 1
    want = P.DENOISER_BF16_MMA(xb, sb.float(), folded)
    torch.cuda.synchronize()
    err, max_rel, mean_rel = rel_errors(got, want)
    print(f'parity vs B1 bf16 at N={N_PARITY}: max|d| {err:.5f} '
          f'(max rel {max_rel:.2e}, mean rel {mean_rel:.2e}; out std '
          f'{float(want.float().std()):.3f})', flush=True)
    if not (torch.isfinite(got.float()).all() and max_rel <= PARITY_MAX_REL):
        raise RuntimeError('the grouped kernels disagree with B1')

    x, semb = fold_inputs(folded, n, g)
    xb, sb, s32 = x.bfloat16(), semb.bfloat16(), semb.bfloat16().float()
    ms = time_ms(lambda: G.GROUPED(xb, sb, folded), repeats)
    forwards += 2 + repeats
    fma_ms = time_ms(lambda: G.GROUPED_FMA(xb, sb, folded), repeats)
    b1_ms = time_ms(lambda: P.DENOISER_BF16_MMA(xb, s32, folded), repeats)
    plan = G.grouped_tc_plan(folded, dev)
    rows = [gp.rows for gp in plan.groups]
    print(f'grouped, tensor cores (5 kernels, rows per tile {rows}): '
          f'{ms:.4f} ms per forward at N={n}', flush=True)
    print(f'grouped, FMA design: {fma_ms:.4f} ms; B1 bf16, tensor cores '
          f'(1 kernel): {b1_ms:.4f} ms; grouped / B1 {ms / b1_ms:.3f}',
          flush=True)

    per_group = [[] for _ in plan.groups]
    for _ in range(repeats):
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(len(plan.groups) + 1)]
        G.GROUPED(xb, sb, folded, events=events)
        forwards += 1
        torch.cuda.synchronize()
        for k in range(len(plan.groups)):
            per_group[k].append(events[k].elapsed_time(events[k + 1]))
    group_ms = [statistics.median(t) for t in per_group]
    nbytes = group_bytes(folded, plan, n)
    mmas = [G.mmas_per_row(P.tc_ops(folded, *gp.spec.ops, gp.rows,
                                    round_g=True)[0], gp.rows, busiest=False)
            for gp in plan.groups]
    b1_mmas = G.mmas_per_row(P.tc_ops(folded)[0], P.TC_ROWS, busiest=False,
                             round_g=False)
    for gp, t, b, m in zip(plan.groups, group_ms, nbytes, mmas):
        print(f'  {gp.spec.name} ({gp.rows} rows per tile): {t:.4f} ms, '
              f'{b / 1e6:.1f} MB of activations ({b / t / 1e9:.3f} TB/s), '
              f'{m:.0f} MMAs per row ({m * n / t / 1e6:.2f} G MMA/s)',
              flush=True)
    print(f'  B1 bf16: {b1_mmas:.0f} MMAs per row '
          f'({b1_mmas * n / b1_ms / 1e6:.2f} G MMA/s); B2 '
          f'{sum(mmas):.0f} ({sum(mmas) * n / sum(group_ms) / 1e6:.2f} G '
          f'MMA/s over the groups\' time)', flush=True)
    return dict(ms=ms, fma_ms=fma_ms, b1_ms=b1_ms, max_abs_err=err,
                max_rel=max_rel, mean_rel=mean_rel, rows=rows,
                group_ms=group_ms, group_bytes=nbytes, forwards=forwards)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--n', type=int, default=N_ROWS)
    ap.add_argument('--repeats', type=int, default=REPEATS)
    args = ap.parse_args(argv)
    probe(args.n, args.repeats)
    return 0


if __name__ == '__main__':
    sys.exit(main())
