"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line:
  1. card      nvidia-smi's name and power limit, torch and CUDA versions;
  2. build     every kernel source (csrc/denoiser.cu, denoiser_dma.cu,
               denoiser_grouped.cu, denoiser_tc.cu, denoiser_tc_dma.cu,
               denoiser_tc_f32.cu, denoiser_tc_grouped.cu) with nvcc for
               sm_90a, one nvcc each, all started together;
  3. check     B1 in float32 (the 3xTF32 tensor-core kernel, and the FMA
               design kept as its yardstick) against its plain PyTorch
               version on the card, at N = 51,200 (the flagship fold, 1024
               windows x 50 samples) and at a ragged N;
  4. time      B1 float32's ms per call at N = 51,200 (kernel_ms, and the
               FMA design's fma_f32_ms) and the plain version's, beside the
               least time the card could take: 3xTF32 on the tensor cores
               (bound_ms) and the function on the FMA units
               (fma_bound_ms);
  5. main      the flagship eval (inject/AE, 50 samples x 9 DDPM steps,
               'best', 5 views, batch 1024, float32) from a seeded
               checkpoint on a synthetic dataset to the frame-level AUC,
               through `restore_and_infer`, with the kernels' launches
               counted (the 3xTF32 kernel only);
  6. agree     the same path twice on the same injected noise, once through
               the kernel and once through the plain version;
  7. profile   one more pass through the kernel under torch.profiler: the
               denoiser's device time, the rest of the device time, and the
               device's idle share of the pass;
  8. check_bf16, check_grouped, check_dma
               B1 at bfloat16, B2 (bfloat16) and B3 (float32 and
               bfloat16), each on the tensor cores and in the FMA design
               kept as its yardstick, against their plain versions at
               both N;
  9. time_bf16, time_grouped, time_dma
               ms per forward at N = 51,200 of each, its plain version's,
               its bound, and B1's at the same dtype in the same run
               (time_bf16 also the FMA design's, fma_bf16_ms); B2 and B3
               are timed by their probe scripts
               (mocodad_tpu_torch/tools/perf/), whose runs are those
               kernels' paths and count their launches, beside their FMA
               designs and B1's tensor-core kernel, the design they vary;
               time_grouped also B2's design floor (the intermediates'
               bytes added to the bound) and each group's ms;
 10. main_bf16 the main path again with `eval_dtype: bfloat16`, through
               the tensor-core kernel only;
 11. agree_bf16 that path through the kernel and through the plain version
               on the same noise, and its distance from the float32 path;
 12. profile_bf16 one more bfloat16 pass under torch.profiler, as 7;
 13. train     `Trainer.fit` of a fresh model at the flagship training
               settings (config/UBnormal/mocodad_train.yaml: batch 1024, 5
               views, validation with 5 samples) on the synthetic set's
               train split, 2 epochs, each ending with the validation AUC
               through B1 float32 (9 launches per validation batch, none
               in a train step, checked); one line per epoch (steps/s,
               windows/s, losses, AUC, validation seconds and launches),
               then best_weights.ckpt reloaded through
               `restore_and_infer`, whose AUC on the validation split
               must equal the logged one;
 14. train_agree 3 train steps on the card and the same 3 on the CPU, from
               the same weights, batches and injected (t, eps): each
               step's loss and the parameters after them;
 15. train_profile a few train steps under torch.profiler: the device ms
               of the forward, the backward and the optimizer, and the
               device's idle share;
 16. train_bf16 train steps/s at `train_dtype` float32 and bfloat16, in
               turns.
Then one JSON line with each kernel's numbers, the card line, and last
{"ok": true, "device": {...}}.  Any failure exits non-zero without the
last line.  Needs one CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import shutil
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
from mocodad_tpu_torch.ops import build, dma_unet as D, grouped_unet as G
from mocodad_tpu_torch.ops import pallas_unet as P
from mocodad_tpu_torch.tools.perf import (probe_dma_pipeline,
                                          probe_grouped_pallas)
from mocodad_tpu_torch.tools.perf.common import (N_ROWS as N_FOLD,
                                                 fold_inputs, rel_errors,
                                                 time_ms)
from mocodad_tpu_torch.data import apply_affine_batch, make_loader, to_device
from mocodad_tpu_torch.training.inference import (restore_and_infer,
                                                  run_inference)
from mocodad_tpu_torch.training.loop import SPANS, Trainer
from mocodad_tpu_torch.utils.weights import load_checkpoint_state_dict

N_RAGGED = 1031
# float32 on both sides: the kernel sums each product in another order than
# cuBLAS does and contracts multiply-adds into FMAs, so results differ in
# the last bits of float32, a few 1e-7 relative per layer
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
# the 9-step chain carries those differences forward (c1 > 1 at every
# step), and 'best' may pick another of two near-equal samples; both stay
# far below the per-window loss spread
PATH_RTOL, PATH_ATOL = 1e-4, 1e-5
# bfloat16 on both sides at the same rounding points: a float32 sum taken
# in another order that lands near a rounding boundary rounds the other
# way (2^-8 relative), and later layers carry the flip forward.  So the
# kernel is held to max |diff| within 3 % of max |want| and, tighter, mean
# |diff| within 0.1 % of mean |want| (the float32 function is about 0.25 %
# away on that mean).
BF16_MAX_REL, BF16_MEAN_REL = 3e-2, 1e-3
# the bfloat16 chain, kernel against plain version: per-window losses
PATH_BF16_MAX_REL, PATH_BF16_MEAN_REL = 1e-2, 1e-3

# training on the card against the CPU, 3 Adam steps from the same weights,
# batches and noise at full width, float32 on both sides (TF32 off).  The
# gradients of a step are sums that cancel: against float64 on the CPU the
# card's step-1 gradients land within 5.5e-4 of each tensor's largest
# gradient and the CPU's float32 within 5.3e-4 (on an NVIDIA H100 80GB
# HBM3 at 700 W).  Adam's first steps are about lr x sign(g), so an
# element whose gradient is below that rounding steps the other way on one
# side.  So: the card's
# step-1 gradients within 5e-3 of each tensor's largest float64 gradient;
# each step's loss within 1e-4 (measured 8.6e-6); after 3 steps no
# parameter further apart than 3 steps each way (a bias-corrected Adam
# step is at most about 1.01 lr in the first steps: 10 % of margin on top;
# measured 2.4e-3 to 3.7e-3), and the mean |diff| over all parameters
# within 2 % of a step (measured 1.6e-6).  The biases
# of the 1x1 convs that feed a train-mode BatchNorm have a true gradient
# of 0 (their steps are noise on both sides) and are left out of the
# gradient check and the mean.
TRAIN_GRAD_REL, TRAIN_LOSS_RTOL = 5e-3, 1e-4
TRAIN_PARAM_MEAN = 2e-5
TRAIN_STEP_MAX = 1.1      # the largest Adam step, in units of lr
BN_FED_BIASES = ('tcn.0.bias', 'residual.0.bias', 'block.0.bias')
TRAIN_LR = 1e-3

# the H100 SXM's float32 rate outside the tensor cores and its HBM rate,
# and its dense bfloat16 and TF32 tensor-core rates (NVIDIA's data sheet,
# at the full 700 W); CUDA names that card 'NVIDIA H100 80GB HBM3'.
# Another card needs its own data sheet's rates.
H100_SXM = 'H100 80GB HBM3'
H100_SXM_PEAKS = (67e12, 3.35e12)
H100_SXM_BF16_PEAK = 989e12
H100_SXM_TF32_PEAK = 495e12

# every kernel wrapper by its name in the kernels JSON line
KERNELS = {
    'denoiser': P.DENOISER, 'denoiser_f32_fma': P.DENOISER_F32_FMA,
    'denoiser_bf16': P.DENOISER_BF16, 'denoiser_bf16_fma': P.DENOISER_BF16_FMA,
    'denoiser_grouped': G.GROUPED, 'denoiser_grouped_fma': G.GROUPED_FMA,
    'denoiser_dma_f32': D.DMA_PIPELINED_F32,
    'denoiser_dma_f32_fma': D.DMA_PIPELINED_F32_FMA,
    'denoiser_dma_bf16': D.DMA_PIPELINED,
    'denoiser_dma_bf16_fma': D.DMA_PIPELINED_FMA}
CSRC = 'mocodad_tpu_torch/csrc/'
B1 = 'mocodad_tpu/ops/pallas_unet.py:105'


def peaks_for(name: str):
    """(float32 FLOP/s, bfloat16 FLOP/s, TF32 FLOP/s, bytes/s) of the
    card."""
    if H100_SXM in name:
        return (H100_SXM_PEAKS[0], H100_SXM_BF16_PEAK, H100_SXM_TF32_PEAK,
                H100_SXM_PEAKS[1])
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


def bf16_check(got: torch.Tensor, want: torch.Tensor, max_rel: float,
               mean_rel: float):
    """(max |diff|, max rel, mean rel, whether both are within bounds)."""
    err, mx, mean = rel_errors(got, want)
    ok = mx <= max_rel and mean <= mean_rel and \
        bool(torch.isfinite(got.float()).all())
    return err, mx, mean, ok


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def check_main_launches(counts: dict, kernel: str, n_batches: int,
                        what: str) -> None:
    """Raise unless the main path launched `kernel` 9 times per batch and
    no other kernel (no B2, B3 or FMA design) at all."""
    others = {k: v for k, v in counts.items() if k != kernel and v}
    if counts[kernel] != 9 * n_batches or others:
        raise RuntimeError(f'kernel launches on the {what} main path: '
                           f'{counts}, expected 9 x {n_batches} of '
                           f'{kernel} only')


def bound(flops: float, n_bytes: float, flops_peak: float,
          bytes_peak: float):
    """(least ms, what sets it): operations over the peak FLOP rate, or
    bytes (each input read once, each output written once) over the
    memory rate, whichever is larger."""
    t_ops, t_bytes = flops / flops_peak * 1e3, n_bytes / bytes_peak * 1e3
    return max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes
                                 else 'bytes')


def const_bytes(mats: torch.Tensor, vecs: torch.Tensor) -> int:
    return mats.numel() * mats.element_size() + \
        vecs.numel() * vecs.element_size()


@contextlib.contextmanager
def plain_denoiser():
    """Route the generation chain through the plain version on the card,
    at the chain's compute dtype, for the comparison run only."""
    saved = M.denoise
    M.denoise = lambda x, s, f: P.denoise_reference(x, s, f,
                                                    compute_dtype=x.dtype)
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


def profile_phase(name: str, fn) -> None:
    """Print where the time of one pass `fn() -> (result, host seconds)`
    goes: the denoiser kernel's device ms, the other device ms, the
    device's idle share of the pass, and the largest other activities."""
    seconds, kernel_dev_ms, other_dev_ms, top = device_time_split(fn)
    wall_ms = seconds * 1e3
    measured = kernel_dev_ms > 0
    phase(name, seconds=f'{seconds:.3f}',
          denoiser_device_ms=f'{kernel_dev_ms:.1f}' if measured
          else 'not measured (no device events)',
          other_device_ms=f'{other_dev_ms:.1f}',
          idle_share=(f'{1 - (kernel_dev_ms + other_dev_ms) / wall_ms:.3f}'
                      if measured else 'not measured'),
          top_other=json.dumps([[k, round(v, 2)] for k, v in top]))


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


def main_path(cfg, eval_dtype: str):
    """restore_and_infer + AUC with every launch count set to 0 just
    before and read just after; returns (model, dataset, result, counts,
    seconds, auc)."""
    cfg.extras['eval_dtype'] = eval_dtype
    reset_launches()
    t0 = time.perf_counter()
    model, ds, res = restore_and_infer(cfg, device='cuda')
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    auc = post_processing_from_config(res['loss'], res['trans'],
                                      res['meta'], res['frames'], cfg)
    if res['loss'].shape != (len(ds),) or \
            not np.isfinite(res['loss']).all() or not 0 <= auc <= 1:
        raise RuntimeError(f'main path ({eval_dtype}) output malformed')
    return model, ds, res, counts, seconds, auc


def train_config(data_dir: str, ckpt_dir: str, **kw):
    """config/UBnormal/mocodad_train.yaml's settings on the synthetic set;
    `kw` overrides any of them."""
    base = dict(
        split='train', validation=True, n_generated_samples=5,
        batch_size=1024, num_transform=5, data_dir=data_dir,
        ckpt_dir=ckpt_dir, use_hr=False, vid_res=[640, 360],
        gt_path=os.path.join(data_dir, 'validating', 'test_frame_mask'),
        opt_lr=TRAIN_LR)
    base.update(kw)
    return flagship_config(**base)


def train_phase(data_dir: str, work: str, card: str):
    """Phase 13; returns (config, train set) for the later train phases."""
    cfg = train_config(data_dir, os.path.join(work, 'train'),
                       extras={'log_every_n_steps': 5})
    os.makedirs(cfg.ckpt_dir, exist_ok=True)
    train_ds = build_dataset(cfg, split='train')
    val_ds = build_dataset(cfg, split='validation')
    val_batches = -(-len(val_ds) // cfg.batch_size)
    trainer = Trainer(cfg, device='cuda')
    validate, val_launches = trainer.validation_metric, []

    def counted(ds, epoch):
        before = P.DENOISER.launches
        out = validate(ds, epoch)
        val_launches.append(P.DENOISER.launches - before)
        return out

    trainer.validation_metric = counted
    reset_launches()
    t0 = time.perf_counter()
    trainer.fit(train_ds, val_ds, n_epochs=2)
    fit_seconds = time.perf_counter() - t0
    counts = launch_counts()
    steps = trainer.steps_per_epoch
    for e, launches in zip(trainer.history, val_launches):
        phase('train', epoch=e['epoch'], steps=steps,
              windows=len(train_ds),
              steps_per_s=f'{steps / e["train_seconds"]:.2f}',
              windows_per_s=f'{e["windows_per_s"]:.1f}',
              loss=f'{e["loss"]:.6f}', loss_noise=f'{e["loss_noise"]:.6f}',
              loss_recons=f'{e["loss_recons"]:.6f}', auc=f'{e["AUC"]:.6f}',
              lr=f'{e["lr"]:.8f}', val_windows=len(val_ds),
              val_batches=val_batches,
              val_seconds=f'{e["val_seconds"]:.3f}', val_launches=launches,
              card=repr(card))
    train_launches = sum(counts.values()) - sum(val_launches)
    phase('train', fit_seconds=f'{fit_seconds:.3f}',
          train_step_launches=train_launches,
          launches=json.dumps({k: v for k, v in counts.items() if v}))
    bad = [e for e in trainer.history
           if not np.isfinite([e['loss'], e['loss_noise'],
                               e['loss_recons']]).all()
           or not 0 <= e['AUC'] <= 1]
    if bad or train_launches or counts['denoiser'] != sum(val_launches) or \
            any(n != 9 * val_batches for n in val_launches):
        raise RuntimeError(f'train phase: malformed epochs {bad} or '
                           f'launches {counts}, validation {val_launches}, '
                           f'expected 9 x {val_batches} per validation')

    # the best checkpoint through the eval path, on the validation split
    # with the seed of the epoch that made it: the logged AUC again
    with open(os.path.join(cfg.ckpt_dir, 'best_weights.ckpt.json')) as f:
        best = json.load(f)
    ecfg = train_config(data_dir, cfg.ckpt_dir, split='validation',
                        load_ckpt='best_weights.ckpt',
                        seed=(1 << 30) + cfg.seed + best['epoch'])
    reset_launches()
    _, ds, res = restore_and_infer(ecfg, device='cuda')
    auc = post_processing_from_config(res['loss'], res['trans'],
                                      res['meta'], res['frames'], ecfg)
    reloaded = launch_counts()['denoiser']
    phase('train', reloaded='best_weights.ckpt', epoch=best['epoch'],
          auc=f'{auc:.6f}', logged_auc=f'{best["AUC"]:.6f}',
          launches=reloaded)
    if res['loss'].shape != (len(ds),) or \
            not np.isfinite(res['loss']).all() or \
            abs(auc - best['AUC']) > 1e-6 or reloaded != 9 * val_batches:
        raise RuntimeError('best_weights.ckpt does not give back the '
                           'validation it was saved for')
    return cfg, train_ds


def train_batches(cfg, ds, n: int):
    """The first n shuffled host batches of epoch 0 (fewer if the epoch
    has fewer)."""
    return list(itertools.islice(
        make_loader(ds, cfg.batch_size, shuffle=True, seed=cfg.seed), n))


def placed(batch, device):
    return [to_device(batch[k], device) for k in ('data', 'trans', 'mask')]


def train_agree_phase(cfg, ds) -> None:
    """Phase 14."""
    batches = train_batches(cfg, ds, 3)
    rng = np.random.default_rng(7)
    b = cfg.batch_size
    noise = [(torch.from_numpy(rng.integers(1, cfg.noise_steps, b)),
              torch.from_numpy(rng.standard_normal((b, 2, 3, 17)).astype(
                  np.float32))) for _ in batches]

    def grads(net):
        return {k: p.grad.detach().cpu().double()
                for k, p in net.named_parameters()
                if not k.endswith(BN_FED_BIASES)}

    runs = {}
    for dev in ('cuda', 'cpu'):
        t = Trainer(cfg, device=dev, noise_fn=lambda step, rows: noise[step])
        t.init_state(len(batches))
        losses, g1 = [], None
        for x in batches:
            losses.append(float(t.train_step(*placed(x, t.device))['loss']))
            g1 = g1 or grads(t.net)
        runs[dev] = (t, losses, g1)
    # step 1's gradients in float64 on the CPU, the reference for both
    t64 = Trainer(cfg, device='cpu')
    t64.init_state(1)
    t64.net.double()
    data, trans, mask = placed(batches[0], t64.device)
    data = apply_affine_batch(data.double(), t64.mats.double(), trans.long())
    loss64, _ = t64.model.loss(t64.net, data, sample_mask=mask.double(),
                               noise_override=(noise[0][0],
                                               noise[0][1].double()))
    loss64.backward()
    g64 = grads(t64.net)
    (gpu, l_gpu, g_gpu), (cpu, l_cpu, g_cpu) = runs['cuda'], runs['cpu']

    def grad_rel(g):
        return max(float((g[k] - v).abs().max() / v.abs().max())
                   for k, v in g64.items())

    loss_rel = max(abs(a - c) / abs(c) for a, c in zip(l_gpu, l_cpu))
    cpu_params = dict(cpu.net.named_parameters())
    diffs = {k: (p.detach().cpu() - cpu_params[k].detach()).abs()
             for k, p in gpu.net.named_parameters()}
    param_max = max(float(d.max()) for d in diffs.values())
    kept = [d for k, d in diffs.items() if not k.endswith(BN_FED_BIASES)]
    param_mean = float(sum(d.sum() for d in kept) /
                       sum(d.numel() for d in kept))
    rel_cuda, rel_cpu = grad_rel(g_gpu), grad_rel(g_cpu)
    bound_max = 2 * len(batches) * TRAIN_STEP_MAX * cfg.opt_lr
    ok = (loss_rel <= TRAIN_LOSS_RTOL and rel_cuda <= TRAIN_GRAD_REL
          and param_max <= bound_max
          and param_mean <= TRAIN_PARAM_MEAN and np.isfinite(l_gpu).all())
    phase('train_agree', steps=len(batches), batch=b,
          loss_cuda=json.dumps([round(x, 7) for x in l_gpu]),
          loss_cpu=json.dumps([round(x, 7) for x in l_cpu]),
          loss_max_rel=f'{loss_rel:.3e}', loss_rtol=TRAIN_LOSS_RTOL,
          grad1_rel_cuda_vs_f64=f'{rel_cuda:.3e}',
          grad1_rel_cpu_vs_f64=f'{rel_cpu:.3e}', grad_bound=TRAIN_GRAD_REL,
          param_max_abs=f'{param_max:.3e}',
          param_mean_abs=f'{param_mean:.3e}',
          bound_max=f'{bound_max:.3e}',
          bound_mean=TRAIN_PARAM_MEAN, ok=ok)
    if not ok:
        raise RuntimeError('train steps on the card disagree with the CPU')


def train_profile_phase(cfg, ds, card: str) -> None:
    """Phase 15: 8 steps after 2 warm-up steps, under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    batches = [placed(x, torch.device('cuda'))
               for x in train_batches(cfg, ds, 8)]
    t = Trainer(cfg, device='cuda')
    t.init_state(len(batches))
    for x in batches[:2]:
        t.train_step(*x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x in batches:
            t.train_step(*x)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    # kernels launched inside the forward and optimizer ranges are their
    # children; the backward's are launched by autograd's own thread, so
    # it is the rest of the window's device time
    spans = dict.fromkeys(SPANS, 0.0)
    for e in prof.events():
        if e.name in spans and \
                e.device_type == torch.autograd.DeviceType.CPU:
            spans[e.name] += e.device_time_total / 1e3
    device_ms, others = 0.0, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                getattr(e, 'is_user_annotation', False) or \
                e.key in spans or e.key.startswith('Optimizer.'):
            continue
        ms = e.self_device_time_total / 1e3
        device_ms += ms
        others[e.key[:48]] = others.get(e.key[:48], 0.0) + ms
    spans[SPANS[1]] = device_ms - spans[SPANS[0]] - spans[SPANS[2]]
    top = sorted(others.items(), key=lambda kv: -kv[1])[:5]
    wall_ms = seconds * 1e3
    n = len(batches)
    phase('train_profile', steps=n, seconds=f'{seconds:.3f}',
          step_ms=f'{wall_ms / n:.3f}',
          forward_device_ms=f'{spans[SPANS[0]] / n:.3f}',
          backward_device_ms=f'{spans[SPANS[1]] / n:.3f}',
          optimizer_device_ms=f'{spans[SPANS[2]] / n:.3f}',
          device_ms=f'{device_ms / n:.3f}',
          idle_share=(f'{1 - device_ms / wall_ms:.3f}' if device_ms > 0
                      else 'not measured (no device events)'),
          top=json.dumps([[k, round(v / n, 3)] for k, v in top]),
          card=repr(card))


def train_bf16_phase(cfg, ds, card: str) -> None:
    """Phase 16: 10 timed steps after 2 warm-up steps, float32 and
    bfloat16 in turns (f32, bf16, bf16, f32)."""
    batches = [placed(x, torch.device('cuda'))
               for x in train_batches(cfg, ds, 4)]
    rates = {'float32': [], 'bfloat16': []}
    for dtype in ('float32', 'bfloat16', 'bfloat16', 'float32'):
        c = train_config(cfg.data_dir, cfg.ckpt_dir,
                         batch_size=cfg.batch_size,
                         extras={'train_dtype': dtype})
        t = Trainer(c, device='cuda')
        t.init_state(len(batches))
        for x in batches[:2]:
            t.train_step(*x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(10):
            m = t.train_step(*batches[i % len(batches)])
        torch.cuda.synchronize()
        rates[dtype].append(10 / (time.perf_counter() - t0))
        if not np.isfinite(float(m['loss'])):
            raise RuntimeError(f'train_dtype {dtype}: loss not finite')
    b = cfg.batch_size
    phase('train_bf16', batch=b,
          float32_steps_per_s=json.dumps([round(r, 2)
                                          for r in rates['float32']]),
          bfloat16_steps_per_s=json.dumps([round(r, 2)
                                           for r in rates['bfloat16']]),
          float32_windows_per_s=f'{b * np.mean(rates["float32"]):.1f}',
          bfloat16_windows_per_s=f'{b * np.mean(rates["bfloat16"]):.1f}',
          card=repr(card))


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    dev = resolve_device('cuda')
    name = torch.cuda.get_device_name(0)
    card = card_line()
    phase('card', card=repr(card), torch=torch.__version__,
          cuda=torch.version.cuda, count=torch.cuda.device_count())
    flops_peak, bf16_peak, tf32_peak, bytes_peak = peaks_for(name)

    # 2. build: every source at once, then bind every entry point
    t0 = time.perf_counter()
    sources = sorted({k.source for k in KERNELS.values()})
    build.build_all(sources, verbose=True)
    for k in KERNELS.values():
        k.load()
    phase('build', kernels=','.join(sources),
          seconds=f'{time.perf_counter() - t0:.1f}')

    # 3. kernel against its plain version, flagship weights from a seed
    model = M.MoCoDADModel(flagship_config(n_generated_samples=50))
    net = M.seeded_state(model.build_net(), seed=0).to(dev).eval()
    folded = model.fold(net)
    g = torch.Generator(device='cuda').manual_seed(1)
    errs = {}
    for n in (N_FOLD, N_RAGGED):
        x, semb = fold_inputs(folded, n, g)
        want = P.denoise_reference(x, semb, folded)
        for key, kernel in (('denoiser', P.DENOISER),
                            ('denoiser_f32_fma', P.DENOISER_F32_FMA)):
            got = kernel(x, semb, folded)
            torch.cuda.synchronize()
            err, ok = max_rel_excess(got, want, KERNEL_RTOL, KERNEL_ATOL)
            errs[(key, n)] = err
            phase('check', kernel=key, n=n, max_abs_err=err,
                  rtol=KERNEL_RTOL, atol=KERNEL_ATOL, ok=ok)
            if not ok:
                raise RuntimeError(f'{key} disagrees with its plain version '
                                   f'at N={n}: max |diff| {err}')

    # 4. time and bounds at N = 51,200: the 3xTF32 kernel does three TF32
    # products per float32 product on the tensor cores; the FMA design
    # does the function's own on the FMA units
    x, semb = fold_inputs(folded, N_FOLD, g)
    kernel_ms = time_ms(lambda: P.DENOISER(x, semb, folded))
    fma_ms = time_ms(lambda: P.DENOISER_F32_FMA(x, semb, folded))
    plain_ms = time_ms(lambda: P.denoise_reference(x, semb, folded))
    flops = P.denoiser_flops_per_row(folded) * N_FOLD
    io_bytes = 4 * (2 * x.numel() + semb.numel())
    plan_tc32 = P.tc32_plan(folded, dev)
    n_bytes = io_bytes + plan_tc32.blob.numel()
    bound_ms, bound_by = bound(3 * flops, n_bytes, tf32_peak, bytes_peak)
    plan32 = P.kernel_plan(folded, dev)
    fma_bytes = io_bytes + const_bytes(plan32.mats, plan32.vecs)
    fma_bound_ms, fma_bound_by = bound(flops, fma_bytes, flops_peak,
                                       bytes_peak)
    phase('time', n=N_FOLD, kernel_ms=f'{kernel_ms:.4f}',
          fma_f32_ms=f'{fma_ms:.4f}', plain_ms=f'{plain_ms:.4f}',
          bound_ms=f'{bound_ms:.4f}', bound_by=bound_by,
          bound_share=f'{bound_ms / kernel_ms:.4f}',
          fma_bound_ms=f'{fma_bound_ms:.4f}',
          fma_bound_share=f'{fma_bound_ms / kernel_ms:.4f}',
          fma_f32_bound_share=f'{fma_bound_ms / fma_ms:.4f}',
          gflop=f'{flops / 1e9:.2f}', mbytes=f'{n_bytes / 1e6:.2f}',
          kernel_tflops=f'{flops / kernel_ms / 1e9:.2f}', card=repr(card))

    entries = {}
    work = tempfile.mkdtemp(prefix='chip_smoke_')
    try:
        # 5. the main path: checkpoint -> views -> encoder -> 9-step chain
        # -> best -> losses -> AUC, on a synthetic dataset
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

        model, ds, res, counts, seconds, auc = main_path(cfg, 'float32')
        launches = counts['denoiser']
        n_batches = -(-len(ds) // cfg.batch_size)
        phase('main', windows=len(ds), batches=n_batches,
              launches=launches, seconds=f'{seconds:.3f}',
              windows_per_s=f'{len(ds) / seconds:.1f}', auc=f'{auc:.6f}')
        check_main_launches(counts, 'denoiser', n_batches, 'float32')

        # 6. the same path through the kernel and the plain version
        net2 = model.build_net()
        net2.load_state_dict(load_checkpoint_state_dict(
            os.path.join(work, cfg.load_ckpt)), strict=True)
        net2.to(dev).eval()
        noise = device_noise(model.schedule.noise_steps - 1, model.num_coords,
                             model.n_frames_corrupt, model.n_joints)

        def run(m=model):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = run_inference(m, net2, ds, cfg.batch_size, cfg.seed,
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
        profile_phase('profile', run)
        entries['denoiser'] = dict(
            dtype='float32', path='main, eval_dtype float32',
            source=CSRC + 'denoiser_tc_f32.cu', replaces=B1,
            launches=launches, max_abs_err=errs[('denoiser', N_FOLD)],
            ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by)
        entries['denoiser_f32_fma'] = dict(
            dtype='float32', path='yardstick of denoiser, no main path',
            source=CSRC + 'denoiser.cu', replaces=B1,
            launches=counts['denoiser_f32_fma'],
            max_abs_err=errs[('denoiser_f32_fma', N_FOLD)], ms=fma_ms,
            plain_ms=plain_ms, bound_ms=fma_bound_ms,
            bound_by=fma_bound_by)

        # 8. the bfloat16 kernels, B2 and B3 against their plain versions
        bf16_errs = {}
        for n in (N_FOLD, N_RAGGED):
            x, semb = fold_inputs(folded, n, g)
            xb, sb = x.bfloat16(), semb.bfloat16()

            def b1_plain():
                return P.denoise_reference(xb, semb, folded,
                                           compute_dtype=torch.bfloat16)

            def grouped_plain():
                return G.grouped_reference(xb, sb, folded)

            def dma_plain():
                return D.dma_reference(x, semb, folded, torch.bfloat16)

            cases = (
                ('check_bf16', 'denoiser_bf16',
                 lambda: P.DENOISER_BF16(xb, semb, folded), b1_plain),
                ('check_bf16', 'denoiser_bf16_fma',
                 lambda: P.DENOISER_BF16_FMA(xb, semb, folded), b1_plain),
                ('check_grouped', 'denoiser_grouped',
                 lambda: G.GROUPED(xb, sb, folded), grouped_plain),
                ('check_grouped', 'denoiser_grouped_fma',
                 lambda: G.GROUPED_FMA(xb, sb, folded), grouped_plain),
                ('check_dma', 'denoiser_dma_bf16',
                 lambda: D.DMA_PIPELINED(x, semb, folded), dma_plain),
                ('check_dma', 'denoiser_dma_bf16_fma',
                 lambda: D.DMA_PIPELINED_FMA(x, semb, folded), dma_plain))
            for ph, key, kernel, plain in cases:
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                err, mx, mean, ok = bf16_check(got, want, BF16_MAX_REL,
                                               BF16_MEAN_REL)
                bf16_errs[(key, n)] = err
                phase(ph, kernel=key, n=n, max_abs_err=err,
                      max_rel=f'{mx:.3e}', mean_rel=f'{mean:.3e}',
                      bound_max_rel=BF16_MAX_REL,
                      bound_mean_rel=BF16_MEAN_REL, ok=ok)
                if not ok:
                    raise RuntimeError(f'{key} disagrees with its plain '
                                       f'version at N={n}')
            want = D.dma_reference(x, semb, folded, torch.float32)
            for key in ('denoiser_dma_f32', 'denoiser_dma_f32_fma'):
                got = KERNELS[key](x, semb, folded)
                torch.cuda.synchronize()
                err, ok = max_rel_excess(got, want, KERNEL_RTOL, KERNEL_ATOL)
                bf16_errs[(key, n)] = err
                phase('check_dma', kernel=key, n=n, max_abs_err=err,
                      rtol=KERNEL_RTOL, atol=KERNEL_ATOL, ok=ok)
                if not ok:
                    raise RuntimeError(f'{key} disagrees with its plain '
                                       f'version at N={n}')

        # 9. times at N = 51,200; B2's and B3's through their probe scripts,
        # whose runs are their paths (counts from 0 just before, read just
        # after)
        x, semb = fold_inputs(folded, N_FOLD, g)
        xb, sb = x.bfloat16(), semb.bfloat16()
        plan16 = P.kernel_plan(folded, dev, torch.bfloat16)
        bf16_bytes = 2 * 2 * x.numel() + 4 * semb.numel() + \
            const_bytes(plan16.mats, plan16.vecs)
        b_ms, b_by = bound(flops, bf16_bytes, bf16_peak, bytes_peak)
        bf_ms = time_ms(lambda: P.DENOISER_BF16(xb, semb, folded))
        fma_ms = time_ms(lambda: P.DENOISER_BF16_FMA(xb, semb, folded))
        bf_plain = time_ms(lambda: P.denoise_reference(
            xb, semb, folded, compute_dtype=torch.bfloat16))
        phase('time_bf16', n=N_FOLD, kernel_ms=f'{bf_ms:.4f}',
              fma_bf16_ms=f'{fma_ms:.4f}', plain_ms=f'{bf_plain:.4f}',
              bound_ms=f'{b_ms:.4f}', bound_by=b_by,
              bound_share=f'{b_ms / bf_ms:.4f}',
              mbytes=f'{bf16_bytes / 1e6:.2f}',
              b1_f32_ms=f'{kernel_ms:.4f}',
              kernel_tflops=f'{flops / bf_ms / 1e9:.2f}', card=repr(card))
        entries['denoiser_bf16'] = dict(
            dtype='bfloat16', path='main, eval_dtype bfloat16',
            source=CSRC + 'denoiser_tc.cu', replaces=B1,
            max_abs_err=bf16_errs[('denoiser_bf16', N_FOLD)], ms=bf_ms,
            plain_ms=bf_plain, bound_ms=b_ms, bound_by=b_by)
        entries['denoiser_bf16_fma'] = dict(
            dtype='bfloat16', path='yardstick of denoiser_bf16, no main path',
            source=CSRC + 'denoiser.cu', replaces=B1,
            max_abs_err=bf16_errs[('denoiser_bf16_fma', N_FOLD)], ms=fma_ms,
            plain_ms=bf_plain, bound_ms=b_ms, bound_by=b_by)

        reset_launches()
        pr = probe_grouped_pallas.probe(N_FOLD)
        g_launches = G.GROUPED.launches
        g_plain = time_ms(lambda: G.grouped_reference(xb, sb, folded))
        g_bytes = 2 * (2 * x.numel() + semb.numel()) + \
            G.grouped_tc_plan(folded, dev).blob.numel()
        gb_ms, gb_by = bound(flops, g_bytes, bf16_peak, bytes_peak)
        inter = G.intermediate_bytes(folded, N_FOLD)
        floor_ms, floor_by = bound(flops, g_bytes + inter, bf16_peak,
                                   bytes_peak)
        phase('time_grouped', n=N_FOLD, kernel_ms=f'{pr["ms"]:.4f}',
              fma_ms=f'{pr["fma_ms"]:.4f}',
              b1_bf16_tc_ms=f'{pr["b1_ms"]:.4f}', plain_ms=f'{g_plain:.4f}',
              bound_ms=f'{gb_ms:.4f}', bound_by=gb_by,
              bound_share=f'{gb_ms / pr["ms"]:.4f}',
              design_floor_ms=f'{floor_ms:.4f}', design_floor_by=floor_by,
              design_floor_share=f'{floor_ms / pr["ms"]:.4f}',
              probe_launches=g_launches, rows=pr['rows'], card=repr(card))
        phase('time_grouped', intermediate_mbytes=f'{inter / 1e6:.2f}',
              intermediate_ms_at_peak=f'{inter / bytes_peak * 1e3:.4f}',
              group_ms=json.dumps([round(t, 4) for t in pr['group_ms']]),
              group_mbytes=json.dumps([round(b / 1e6, 2)
                                       for b in pr['group_bytes']]))
        if g_launches != 5 * pr['forwards']:
            raise RuntimeError(f'grouped probe path launched {g_launches} '
                               f'for {pr["forwards"]} forwards, not 5 each')
        entries['denoiser_grouped'] = dict(
            dtype='bfloat16', path='probe_grouped_pallas',
            source=CSRC + 'denoiser_tc_grouped.cu',
            replaces='tools/perf/probe_grouped_pallas.py:111',
            launches=g_launches,
            max_abs_err=bf16_errs[('denoiser_grouped', N_FOLD)],
            ms=pr['ms'], plain_ms=g_plain, bound_ms=gb_ms, bound_by=gb_by)
        entries['denoiser_grouped_fma'] = dict(
            dtype='bfloat16', path='yardstick of denoiser_grouped',
            source=CSRC + 'denoiser_grouped.cu',
            replaces='tools/perf/probe_grouped_pallas.py:111',
            max_abs_err=bf16_errs[('denoiser_grouped_fma', N_FOLD)],
            ms=pr['fma_ms'], plain_ms=g_plain, bound_ms=gb_ms,
            bound_by=gb_by)

        for dtype, key in ((torch.float32, 'denoiser_dma_f32'),
                           (torch.bfloat16, 'denoiser_dma_bf16')):
            reset_launches()
            pr = probe_dma_pipeline.probe(dtype, N_FOLD)
            d_launches = KERNELS[key].launches
            d_plain = time_ms(lambda: D.dma_reference(x, semb, folded, dtype))
            if dtype == torch.float32:
                # 3xTF32 on the tensor cores; the function on the FMA units
                # beside it (the FMA design's own bound)
                d_bytes = 4 * (2 * x.numel() + semb.numel()) + \
                    plan_tc32.blob.numel()
                db_ms, db_by = bound(3 * flops, d_bytes, tf32_peak,
                                     bytes_peak)
                f_plan = P.kernel_plan(folded, dev, dtype)
                fb_ms, fb_by = bound(
                    flops, 4 * (2 * x.numel() + semb.numel()) +
                    const_bytes(f_plan.mats, f_plan.vecs), flops_peak,
                    bytes_peak)
            else:
                d_bytes = 4 * (2 * x.numel() + semb.numel()) + \
                    D.dma_tc_plan(folded, dev).kernel.blob.numel()
                db_ms, db_by = bound(flops, d_bytes, bf16_peak, bytes_peak)
                fb_ms, fb_by = db_ms, db_by
            phase('time_dma', kernel=key, n=N_FOLD,
                  kernel_ms=f'{pr["ms"]:.4f}', fma_ms=f'{pr["fma_ms"]:.4f}',
                  b1_tc_ms=f'{pr["b1_ms"]:.4f}', plain_ms=f'{d_plain:.4f}',
                  bound_ms=f'{db_ms:.4f}', bound_by=db_by,
                  bound_share=f'{db_ms / pr["ms"]:.4f}',
                  fma_bound_ms=f'{fb_ms:.4f}',
                  probe_launches=d_launches, card=repr(card))
            if d_launches != pr['forwards']:
                raise RuntimeError(f'{key} probe path launched {d_launches} '
                                   f'for {pr["forwards"]} forwards')
            entries[key] = dict(
                dtype=str(dtype)[6:], path='probe_dma_pipeline',
                source=CSRC + ('denoiser_tc_f32.cu' if dtype == torch.float32
                               else 'denoiser_tc_dma.cu'),
                replaces='tools/perf/probe_dma_pipeline.py:39',
                launches=d_launches, max_abs_err=bf16_errs[(key, N_FOLD)],
                ms=pr['ms'], plain_ms=d_plain, bound_ms=db_ms,
                bound_by=db_by)
            entries[key + '_fma'] = dict(
                dtype=str(dtype)[6:], path=f'yardstick of {key}',
                source=CSRC + 'denoiser_dma.cu',
                replaces='tools/perf/probe_dma_pipeline.py:39',
                max_abs_err=bf16_errs[(key + '_fma', N_FOLD)],
                ms=pr['fma_ms'], plain_ms=d_plain, bound_ms=fb_ms,
                bound_by=fb_by)

        # 10. the main path at eval_dtype bfloat16
        model16, ds16, res16, counts, seconds, auc = main_path(cfg,
                                                              'bfloat16')
        launches16 = counts['denoiser_bf16']
        phase('main_bf16', windows=len(ds16), batches=n_batches,
              launches=launches16, float32_launches=counts['denoiser'],
              other_launches=sum(counts.values()) - launches16,
              seconds=f'{seconds:.3f}',
              windows_per_s=f'{len(ds16) / seconds:.1f}', auc=f'{auc:.6f}')
        check_main_launches(counts, 'denoiser_bf16', n_batches, 'bfloat16')
        entries['denoiser_bf16']['launches'] = launches16
        # the yardsticks: their launches on the main paths (checked 0)
        for key in ('denoiser_bf16_fma', 'denoiser_grouped_fma',
                    'denoiser_dma_f32_fma', 'denoiser_dma_bf16_fma'):
            entries[key]['launches'] = counts[key]

        # 11. the bfloat16 path through the kernel and the plain version
        r16_kernel, s16_kernel = run(model16)
        with plain_denoiser():
            r16_plain, s16_plain = run(model16)
        lk16 = torch.from_numpy(r16_kernel['loss'])
        err, mx, mean, ok = bf16_check(
            lk16, torch.from_numpy(r16_plain['loss']), PATH_BF16_MAX_REL,
            PATH_BF16_MEAN_REL)
        vs32, vs32_rel, _ = rel_errors(lk16, lk)
        phase('agree_bf16', windows=len(lk16), max_abs_err=err,
              max_rel=f'{mx:.3e}', mean_rel=f'{mean:.3e}',
              bound_max_rel=PATH_BF16_MAX_REL,
              bound_mean_rel=PATH_BF16_MEAN_REL, ok=ok,
              vs_float32_max_abs=vs32, vs_float32_max_rel=f'{vs32_rel:.3e}',
              kernel_windows_per_s=f'{len(ds16) / s16_kernel:.1f}',
              plain_windows_per_s=f'{len(ds16) / s16_plain:.1f}')
        if not ok:
            raise RuntimeError('the bfloat16 main path through the kernel '
                               'disagrees with the plain version')

        # 12. where the time of the bfloat16 pass goes
        profile_phase('profile_bf16', lambda: run(model16))

        # 13-16. training from a fresh model; no train step launches a
        # kernel (counts from 0 before phases 14-16, read after)
        tcfg, train_ds = train_phase(data_dir, work, card)
        reset_launches()
        train_agree_phase(tcfg, train_ds)
        train_profile_phase(tcfg, train_ds, card)
        train_bf16_phase(tcfg, train_ds, card)
        if any(launch_counts().values()):
            raise RuntimeError(f'train steps launched kernels: '
                               f'{launch_counts()}')
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(json.dumps({'kernels': [
        dict(name=k, route='cuda', **entries[k], library_ms=None)
        for k in KERNELS]}), flush=True)
    print(card, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
