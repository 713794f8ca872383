"""What the probe scripts, `bench_torch.py` and `chip_smoke.py` share: the
card's name and power limit, the flagship fold on the card from a seed,
seeded fold inputs, injected chain noise, the chain through B1's plain
version, CUDA-event timing and error statistics."""

from __future__ import annotations

import contextlib
import statistics
import subprocess
from typing import Callable, List, Tuple

import torch

from mocodad_tpu_torch.config import flagship_config
from mocodad_tpu_torch.models import mocodad as M
from mocodad_tpu_torch.models.mocodad import MoCoDADModel, seeded_state
from mocodad_tpu_torch.ops.pallas_unet import (FoldedDenoiser,
                                               denoise_reference)

N_ROWS = 1024 * 50          # one flagship batch: 1024 windows x 50 samples
REPEATS = 20

# The eval chain through B1 against the chain through its plain version (or
# the module forwards) on the same noise.  float32: the kernel sums in
# another order and the 9-step chain carries that forward (c1 > 1 at every
# step), and 'best' may pick another of two near-equal samples; both stay
# far below the per-window loss spread
PATH_RTOL, PATH_ATOL = 1e-4, 1e-5
# bfloat16 on both sides at the same rounding points: a float32 sum taken
# in another order that lands near a rounding boundary rounds the other
# way (2^-8 relative), and later layers carry the flip forward.  So max
# |diff| within 3 % of max |want| and, tighter, mean |diff| within 0.1 % of
# mean |want| (the float32 function is about 0.25 % away on that mean).
BF16_MAX_REL, BF16_MEAN_REL = 3e-2, 1e-3

# Training: a step on the card against the same step elsewhere (the CPU, or
# eager steps against a CUDA graph's), float32 on both sides.  Adam's first
# steps are about lr x sign(g), so an element whose gradient is below the
# rounding of its sum steps the other way on one side.  So each step's loss
# within 1e-4 (card against CPU: measured 8.6e-6, NVIDIA H100 80GB HBM3,
# 700 W), and step 1's (before any update) within 1e-5 where both run on
# the card; after n steps no parameter further apart than n steps each way
# (a bias-corrected Adam step is at most about 1.01 lr in the first steps:
# 10 % of margin on top), and the mean |diff| over the parameters within
# 2 % of a step.  The biases of the 1x1 convs that feed a train-mode
# BatchNorm have a true gradient of 0 (their steps are noise on both
# sides) and are left out of the mean.
TRAIN_LOSS_RTOL, GRAPH_STEP1_RTOL = 1e-4, 1e-5
TRAIN_PARAM_MEAN = 2e-5
TRAIN_STEP_MAX = 1.1      # the largest Adam step, in units of lr
BN_FED_BIASES = ('tcn.0.bias', 'residual.0.bias', 'block.0.bias')


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


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


def device_noise(n_steps: int, n_coords: int, tc: int, v: int,
                 device='cuda'):
    """noise_fn for run_inference: each batch's gaussians drawn on `device`
    from a per-batch seed, so two runs see the same noise."""
    def fn(batch_idx: int, n_rows: int):
        g = torch.Generator(device=device).manual_seed(1000 + batch_idx)
        x0 = torch.randn((n_rows, n_coords, tc, v), generator=g,
                         device=device)
        zs = torch.randn((n_steps, n_rows, n_coords, tc, v), generator=g,
                         device=device)
        return x0, zs
    return fn


@contextlib.contextmanager
def plain_denoiser():
    """Route the generation chain through B1's plain version, at the
    chain's compute dtype, for a comparison run only."""
    saved = M.denoise
    M.denoise = lambda x, s, f: denoise_reference(x, s, f,
                                                  compute_dtype=x.dtype)
    try:
        yield
    finally:
        M.denoise = saved


def device_busy(events, t0: float = float('-inf'),
                t1: float = float('inf')) -> Tuple[float, int]:
    """(µs, kernels): the union of the device's busy intervals (kernels,
    copies, sets) between t0 and t1 µs in a torch.profiler chrome trace's
    `traceEvents`, and the kernels among them.  A union, not a sum: a
    trace may list a CUDA graph's kernels more than once."""
    device = sorted(
        (max(e['ts'], t0), min(e['ts'] + e['dur'], t1), e['cat'])
        for e in events
        if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset')
        and e['ts'] < t1 and e['ts'] + e['dur'] > t0)
    busy, end = 0.0, t0
    for a, b, _ in device:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy, sum(c == 'kernel' for _, _, c in device)


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


def in_turns(*fns: Callable[[], object], repeats: int = REPEATS
             ) -> List[float]:
    """ms per call of each of `fns` timed in turns in one process (a b ..
    b a, `time_ms` each time): the mean of each one's two readings."""
    order = list(range(len(fns)))
    ms = [[] for _ in fns]
    for i in order + order[::-1]:
        ms[i].append(time_ms(fns[i], repeats))
    return [sum(m) / len(m) for m in ms]


def rel_errors(got: torch.Tensor, want: torch.Tensor
               ) -> Tuple[float, float, float]:
    """(max |got - want|, that over max |want|, mean |got - want| over
    mean |want|), in float32."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    return (float(diff.max()), float(diff.max() / want.abs().max()),
            float(diff.mean() / want.abs().mean()))
