"""Probe: the DMA-pipelined denoiser (B3, one persistent block per SM that
prefetches its next tile) on the tensor cores, beside its FMA design and
the fused B1 on the tensor cores at the same compute dtype, whose body B3
runs.

Counterpart of the JAX repository's `tools/perf/probe_dma_pipeline.py`
(:241-322): build B3, check it against B1 at the same compute dtype on
2,048 rows, and time one forward of each at N = 51,200 rows (one flagship
batch, 1024 windows x 50 samples), in the same run: B3 on the tensor cores
(`DMA_PIPELINED` at bfloat16, `DMA_PIPELINED_F32` at float32), its FMA
design (`DMA_PIPELINED_FMA`, `DMA_PIPELINED_F32_FMA`) and B1 on the tensor
cores whose op code B3 runs (`DENOISER_BF16_MMA`, the mma.sync kernel,
and `DENOISER`).  Weights are the flagship U-Net's,
from a seed.  Needs a CUDA device.

    python -m mocodad_tpu_torch.tools.perf.probe_dma_pipeline \
        [--dtype bfloat16|float32] [--n N]
"""

from __future__ import annotations

import argparse
import sys

import torch

from mocodad_tpu_torch.device import resolve_device
from mocodad_tpu_torch.ops import dma_unet as D
from mocodad_tpu_torch.ops import pallas_unet as P
from mocodad_tpu_torch.tools.perf.common import (N_ROWS, REPEATS,
                                                 flagship_fold, fold_inputs,
                                                 rel_errors, time_ms)

N_PARITY = 2048
# float32: B3 is B1's 3xTF32 kernel on B1's plan, so it matches B1 to the
# bit; the bound (the JAX probe's, :295) allows for a build that
# contracts differently.  bfloat16: B1 rounds eps to bfloat16 and B3 keeps
# it float32, so they differ by up to half a bfloat16 step per element.
PARITY_MEAN_REL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}
DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def probe(dtype: torch.dtype = torch.bfloat16, n: int = N_ROWS,
          repeats: int = REPEATS, seed: int = 0) -> dict:
    """Parity and ms per forward of B3 (tensor cores and FMA) and B1 on the
    tensor cores at `dtype`; prints one line each.  `forwards` counts the
    calls of the tensor-core B3, which launches 1 each."""
    dev = resolve_device('cuda')
    folded = flagship_fold(dev, seed)
    kernel, fma = {torch.bfloat16: (D.DMA_PIPELINED, D.DMA_PIPELINED_FMA),
                   torch.float32: (D.DMA_PIPELINED_F32,
                                   D.DMA_PIPELINED_F32_FMA)}[dtype]
    b1 = {torch.bfloat16: P.DENOISER_BF16_MMA,
          torch.float32: P.DENOISER}[dtype]
    name = str(dtype)[6:]
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    x, semb = fold_inputs(folded, N_PARITY, g)
    x = x.to(dtype).float()            # B1 at bfloat16 takes bfloat16 x
    got = kernel(x, semb, folded)
    want = b1(x.to(dtype), semb, folded)
    torch.cuda.synchronize()
    err, max_rel, mean_rel = rel_errors(got, want)
    print(f'parity vs B1 {name} at N={N_PARITY}: max|d| {err:.3e} '
          f'(max rel {max_rel:.2e}, mean rel {mean_rel:.2e})', flush=True)
    if not (torch.isfinite(got).all() and mean_rel <= PARITY_MEAN_REL[dtype]):
        raise RuntimeError('the DMA-pipelined kernel disagrees with B1')

    x, semb = fold_inputs(folded, n, g)
    xb = x.to(dtype)
    ms = time_ms(lambda: kernel(x, semb, folded), repeats)
    fma_ms = time_ms(lambda: fma(x, semb, folded), repeats)
    b1_ms = time_ms(lambda: b1(xb, semb, folded), repeats)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f'DMA-pipelined {name}, tensor cores ({sms} persistent blocks): '
          f'{ms:.4f} ms per forward at N={n}; its FMA design {fma_ms:.4f} '
          f'ms', flush=True)
    print(f'B1 {name}, tensor cores: {b1_ms:.4f} ms per forward at N={n}; '
          f'DMA / B1 {ms / b1_ms:.3f}', flush=True)
    return dict(ms=ms, fma_ms=fma_ms, b1_ms=b1_ms, max_abs_err=err,
                max_rel=max_rel, mean_rel=mean_rel, forwards=3 + repeats)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--dtype', choices=sorted(DTYPES), default='bfloat16')
    ap.add_argument('--n', type=int, default=N_ROWS)
    ap.add_argument('--repeats', type=int, default=REPEATS)
    args = ap.parse_args(argv)
    probe(DTYPES[args.dtype], args.n, args.repeats)
    return 0


if __name__ == '__main__':
    sys.exit(main())
