"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line:
  1. card      nvidia-smi's name and power limit, torch and CUDA versions;
  2. build     the denoiser kernel (csrc/denoiser.cu) with nvcc for sm_90a;
  3. check     the kernel against its plain PyTorch version on the card, at
               N = 51,200 (the flagship fold, 1024 windows x 50 samples) and
               at a ragged N;
  4. time      the kernel's and the plain version's ms per call at
               N = 51,200, beside the least time the card could take;
  5. main path the flagship eval (inject/AE, 50 samples x 9 DDPM steps,
               'best', 5 views, batch 1024, float32) from a seeded checkpoint
               on a synthetic dataset to the frame-level AUC, through
               `restore_and_infer`, with the kernel's launches counted;
  6. agreement the same path twice on the same injected noise, once through
               the kernel and once through the plain version;
  7. profile   one more pass through the kernel under torch.profiler: the
               denoiser's device time, the rest of the device time, and the
               device's idle share of the pass.
Then one JSON line with each kernel's numbers, the card line, and last
{"ok": true, "device": {...}}.  Any failure exits non-zero without the
last line.  Needs one CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from mocodad_tpu_torch.config import flagship_config
from mocodad_tpu_torch.data import build_dataset, synthetic
from mocodad_tpu_torch.device import resolve_device
from mocodad_tpu_torch.eval.harness import post_processing_from_config
from mocodad_tpu_torch.models import mocodad as M
from mocodad_tpu_torch.ops import build, pallas_unet as P
from mocodad_tpu_torch.training.inference import (restore_and_infer,
                                                  run_inference)
from mocodad_tpu_torch.utils.weights import load_checkpoint_state_dict

N_FOLD = 1024 * 50          # one flagship batch: 1024 windows x 50 samples
N_RAGGED = 1031
# float32 on both sides: the kernel sums each product in another order than
# cuBLAS does and contracts multiply-adds into FMAs, so results differ in
# the last bits of float32, a few 1e-7 relative per layer
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
# the 9-step chain carries those differences forward (c1 > 1 at every
# step), and 'best' may pick another of two near-equal samples; both stay
# far below the per-window loss spread
PATH_RTOL, PATH_ATOL = 1e-4, 1e-5
REPEATS = 20

# the H100 SXM's float32 rate outside the tensor cores and its HBM rate
# (NVIDIA's data sheet, dense, at the full 700 W); CUDA names that card
# 'NVIDIA H100 80GB HBM3'.  Another card needs its own data sheet's rates.
H100_SXM = 'H100 80GB HBM3'
H100_SXM_PEAKS = (67e12, 3.35e12)


def peaks_for(name: str):
    if H100_SXM in name:
        return H100_SXM_PEAKS
    raise RuntimeError(f'no peak rates known for {name!r}; this script '
                       f'knows the {H100_SXM} only')


def phase(name: str, **kv) -> None:
    print(f'[{name}] ' + ' '.join(f'{k}={v}' for k, v in kv.items()),
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def max_rel_excess(got: torch.Tensor, want: torch.Tensor, rtol: float,
                   atol: float):
    """(max |got - want|, whether every element is within atol + rtol|want|)."""
    diff = (got - want).abs()
    ok = bool((diff <= atol + rtol * want.abs()).all()) and \
        bool(torch.isfinite(got).all())
    return float(diff.max()), ok


def time_ms(fn, repeats: int = REPEATS) -> float:
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


@contextlib.contextmanager
def plain_denoiser():
    """Route the generation chain through the plain version on the card,
    for the comparison run only."""
    saved = M.denoise
    M.denoise = P.denoise_reference
    try:
        yield
    finally:
        M.denoise = saved


def device_noise(n_steps: int, n_coords: int, tc: int, v: int):
    """noise_fn for run_inference: each batch's gaussians drawn on the
    card from a per-batch seed, so two runs see the same noise."""
    def fn(batch_idx: int, n_rows: int):
        g = torch.Generator(device='cuda').manual_seed(1000 + batch_idx)
        x0 = torch.randn((n_rows, n_coords, tc, v), generator=g,
                         device='cuda')
        zs = torch.randn((n_steps, n_rows, n_coords, tc, v), generator=g,
                         device='cuda')
        return x0, zs
    return fn


def device_time_split(fn):
    """Run `fn() -> (result, host seconds)` under torch.profiler; return the
    host seconds, the denoiser kernel's device ms, every other device
    activity's ms, and the four largest of those others by name."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, seconds = fn()
    kernel_ms, others = 0.0, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        if 'denoiser_kernel' in e.key:
            kernel_ms += ms
        else:
            others[e.key[:48]] = others.get(e.key[:48], 0.0) + ms
    top = sorted(others.items(), key=lambda kv: -kv[1])[:4]
    return seconds, kernel_ms, sum(others.values()), top


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    dev = resolve_device('cuda')
    name = torch.cuda.get_device_name(0)
    card = card_line()
    phase('card', card=repr(card), torch=torch.__version__,
          cuda=torch.version.cuda, count=torch.cuda.device_count())
    flops_peak, bytes_peak = peaks_for(name)

    # 2. build
    t0 = time.perf_counter()
    build.build(P.DENOISER.source, verbose=True)
    P.DENOISER.load()
    phase('build', kernel='denoiser', seconds=f'{time.perf_counter() - t0:.1f}')

    # 3. kernel against its plain version, flagship weights from a seed
    model = M.MoCoDADModel(flagship_config(n_generated_samples=50))
    net = M.seeded_state(model.build_net(), seed=0).to(dev).eval()
    folded = model.fold(net)
    g = torch.Generator(device='cuda').manual_seed(1)
    errs = {}
    for n in (N_FOLD, N_RAGGED):
        x = torch.randn((2, 51, n), generator=g, device='cuda')
        semb = torch.nn.functional.silu(
            torch.randn((16, n), generator=g, device='cuda'))
        got = P.DENOISER(x, semb, folded)
        want = P.denoise_reference(x, semb, folded)
        torch.cuda.synchronize()
        err, ok = max_rel_excess(got, want, KERNEL_RTOL, KERNEL_ATOL)
        errs[n] = err
        phase('check', n=n, max_abs_err=err, rtol=KERNEL_RTOL,
              atol=KERNEL_ATOL, ok=ok)
        if not ok:
            raise RuntimeError(f'kernel disagrees with its plain version at '
                               f'N={n}: max |diff| {err}')

    # 4. time and bound at N = 51,200
    x = torch.randn((2, 51, N_FOLD), generator=g, device='cuda')
    semb = torch.nn.functional.silu(
        torch.randn((16, N_FOLD), generator=g, device='cuda'))
    kernel_ms = time_ms(lambda: P.DENOISER(x, semb, folded))
    plain_ms = time_ms(lambda: P.denoise_reference(x, semb, folded))
    flops = P.denoiser_flops_per_row(folded) * N_FOLD
    n_bytes = 4 * (2 * x.numel() + semb.numel()) + \
        4 * P.kernel_plan(folded, dev).consts.numel()
    t_ops, t_bytes = flops / flops_peak * 1e3, n_bytes / bytes_peak * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = 'operations' if t_ops >= t_bytes else 'bytes'
    phase('time', n=N_FOLD, kernel_ms=f'{kernel_ms:.4f}',
          plain_ms=f'{plain_ms:.4f}', bound_ms=f'{bound_ms:.4f}',
          bound_by=bound_by, gflop=f'{flops / 1e9:.2f}',
          mbytes=f'{n_bytes / 1e6:.2f}',
          kernel_tflops=f'{flops / kernel_ms / 1e9:.2f}', card=repr(card))

    # 5. the main path: checkpoint -> views -> encoder -> 9-step chain ->
    # best -> losses -> AUC, on a synthetic dataset
    work = tempfile.mkdtemp(prefix='chip_smoke_')
    try:
        data_dir = os.path.join(work, 'data')
        synthetic.generate(data_dir, seed=0, n_scenes=2,
                           n_clips_per_split=3, n_actors=3, n_frames=120)
        cfg = flagship_config(
            split='test', n_generated_samples=50, batch_size=1024,
            num_transform=5, data_dir=data_dir, ckpt_dir=work,
            gt_path=os.path.join(data_dir, 'testing', 'test_frame_mask'),
            use_hr=False, vid_res=[640, 360], load_ckpt='best_weights.ckpt',
            seed=0)
        build_dataset(cfg, split='train')      # fits + saves the scaler
        torch.save({'state_dict': net.state_dict()},
                   os.path.join(work, cfg.load_ckpt))

        P.DENOISER.launches = 0
        t0 = time.perf_counter()
        model, ds, res = restore_and_infer(cfg, device='cuda')
        seconds = time.perf_counter() - t0
        launches = P.DENOISER.launches
        n_batches = -(-len(ds) // cfg.batch_size)
        auc = post_processing_from_config(res['loss'], res['trans'],
                                          res['meta'], res['frames'], cfg)
        phase('main', windows=len(ds), batches=n_batches,
              launches=launches, seconds=f'{seconds:.3f}',
              windows_per_s=f'{len(ds) / seconds:.1f}', auc=f'{auc:.6f}')
        if launches != 9 * n_batches:
            raise RuntimeError(f'{launches} kernel launches on the main '
                               f'path, expected 9 x {n_batches}')
        if res['loss'].shape != (len(ds),) or \
                not np.isfinite(res['loss']).all() or not 0 <= auc <= 1:
            raise RuntimeError('main path output malformed')

        # 6. the same path through the kernel and the plain version
        net2 = model.build_net()
        net2.load_state_dict(load_checkpoint_state_dict(
            os.path.join(work, cfg.load_ckpt)), strict=True)
        net2.to(dev).eval()
        noise = device_noise(model.schedule.noise_steps - 1, model.num_coords,
                             model.n_frames_corrupt, model.n_joints)

        def run():
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = run_inference(model, net2, ds, cfg.batch_size, cfg.seed,
                              dev, noise_fn=noise)
            return r, time.perf_counter() - t

        r_kernel, s_kernel = run()
        with plain_denoiser():
            r_plain, s_plain = run()
        lk, lp = torch.from_numpy(r_kernel['loss']), \
            torch.from_numpy(r_plain['loss'])
        err, ok = max_rel_excess(lk, lp, PATH_RTOL, PATH_ATOL)
        phase('agree', windows=len(lk), max_abs_err=err, rtol=PATH_RTOL,
              atol=PATH_ATOL, ok=ok,
              kernel_windows_per_s=f'{len(ds) / s_kernel:.1f}',
              plain_windows_per_s=f'{len(ds) / s_plain:.1f}')
        if not ok:
            raise RuntimeError('the main path through the kernel disagrees '
                               'with the plain version')

        # 7. where the time goes: one more pass through the kernel, under
        # the profiler (its own cost inflates this pass's host seconds)
        seconds, kernel_dev_ms, other_dev_ms, top = device_time_split(run)
        wall_ms = seconds * 1e3
        measured = kernel_dev_ms > 0
        phase('profile', seconds=f'{seconds:.3f}',
              denoiser_device_ms=f'{kernel_dev_ms:.1f}' if measured
              else 'not measured (no device events)',
              other_device_ms=f'{other_dev_ms:.1f}',
              idle_share=(f'{1 - (kernel_dev_ms + other_dev_ms) / wall_ms:.3f}'
                          if measured else 'not measured'),
              top_other=json.dumps([[k, round(v, 2)] for k, v in top]))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(json.dumps({'kernels': [{
        'name': 'denoiser', 'route': 'cuda',
        'source': 'mocodad_tpu_torch/csrc/denoiser.cu',
        'replaces': 'mocodad_tpu/ops/pallas_unet.py:105',
        'launches': launches, 'max_abs_err': errs[N_FOLD],
        'ms': kernel_ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
        'bound_by': bound_by, 'library_ms': None}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
