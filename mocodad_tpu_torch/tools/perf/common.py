"""What the probe scripts and `chip_smoke.py` share: the flagship fold on the
card from a seed, seeded fold inputs, CUDA-event timing and error
statistics."""

from __future__ import annotations

import statistics
from typing import Callable, Tuple

import torch

from mocodad_tpu_torch.config import flagship_config
from mocodad_tpu_torch.models.mocodad import MoCoDADModel, seeded_state
from mocodad_tpu_torch.ops.pallas_unet import FoldedDenoiser

N_ROWS = 1024 * 50          # one flagship batch: 1024 windows x 50 samples
REPEATS = 20


def flagship_fold(device: torch.device, seed: int = 0) -> FoldedDenoiser:
    """The flagship U-Net's folded constants, weights from `seed`."""
    model = MoCoDADModel(flagship_config())
    net = seeded_state(model.build_net(), seed=seed).to(device).eval()
    return model.fold(net)


def fold_inputs(folded: FoldedDenoiser, n: int, generator: torch.Generator
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float32 x (C_in, T*V, N) and silu(emb) (E, N) on the generator's
    device."""
    dev = generator.device
    tva = folded.gcn[0].k2.shape[0]
    x = torch.randn((folded.c_in, tva, n), generator=generator, device=dev)
    semb = torch.nn.functional.silu(torch.randn(
        (folded.embedding_dim, n), generator=generator, device=dev))
    return x, semb


def time_ms(fn: Callable[[], object], repeats: int = REPEATS) -> float:
    """Median ms of one call, CUDA events around each of `repeats` calls
    after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_errors(got: torch.Tensor, want: torch.Tensor
               ) -> Tuple[float, float, float]:
    """(max |got - want|, that over max |want|, mean |got - want| over
    mean |want|), in float32."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    return (float(diff.max()), float(diff.max() / want.abs().max()),
            float(diff.mean() / want.abs().mean()))
