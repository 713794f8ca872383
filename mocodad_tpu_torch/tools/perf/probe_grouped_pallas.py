"""Probe: the layer-grouped denoiser (B2, five kernels, bfloat16
intermediates in device memory) against the fused B1 at bfloat16 in its
FMA design (`csrc/denoiser.cu`), the design B2 splits into groups.

Counterpart of the JAX repository's `tools/perf/probe_grouped_pallas.py`
(:221-270): build B2's kernels, check them against B1 at the same compute
dtype on 2,048 rows, and time one forward of each at N = 51,200 rows (one
flagship batch, 1024 windows x 50 samples), in the same run.  Weights are
the flagship U-Net's, from a seed.  Needs a CUDA device.

    python -m mocodad_tpu_torch.tools.perf.probe_grouped_pallas [--n N]
"""

from __future__ import annotations

import argparse
import sys

import torch

from mocodad_tpu_torch.device import resolve_device
from mocodad_tpu_torch.ops import grouped_unet as G
from mocodad_tpu_torch.ops import pallas_unet as P
from mocodad_tpu_torch.tools.perf.common import (N_ROWS, REPEATS,
                                                 flagship_fold, fold_inputs,
                                                 rel_errors, time_ms)

N_PARITY = 2048
# B2 is not B1's function: it also rounds the graph-mixed g to bfloat16.
# The two stay within a few bfloat16 roundings of each other; this bound
# only catches a broken kernel.
PARITY_MAX_REL = 5e-2


def probe(n: int = N_ROWS, repeats: int = REPEATS, seed: int = 0) -> dict:
    """Parity and ms per forward of B2 and B1-bf16; prints one line each."""
    dev = resolve_device('cuda')
    folded = flagship_fold(dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    x, semb = fold_inputs(folded, N_PARITY, g)
    xb, sb = x.bfloat16(), semb.bfloat16()
    got = G.GROUPED(xb, sb, folded)
    want = P.DENOISER_BF16_FMA(xb, sb.float(), folded)
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
    b1_ms = time_ms(lambda: P.DENOISER_BF16_FMA(xb, s32, folded), repeats)
    nsub = [gp.nsub for gp in G.grouped_plan(folded, dev).groups]
    print(f'grouped (5 kernels, sub-tiles per block {nsub}): {ms:.4f} ms '
          f'per forward at N={n}', flush=True)
    print(f'B1 bf16, FMA design (1 kernel): {b1_ms:.4f} ms per forward '
          f'at N={n}; '
          f'grouped / B1 {ms / b1_ms:.3f}', flush=True)
    return dict(ms=ms, b1_ms=b1_ms, max_abs_err=err, max_rel=max_rel,
                mean_rel=mean_rel, nsub=nsub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--n', type=int, default=N_ROWS)
    ap.add_argument('--repeats', type=int, default=REPEATS)
    args = ap.parse_args(argv)
    probe(args.n, args.repeats)
    return 0


if __name__ == '__main__':
    sys.exit(main())
