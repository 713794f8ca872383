"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line:
  1. card      nvidia-smi's name and power limit, torch and CUDA versions;
  2. build     every kernel source (csrc/denoiser.cu, denoiser_dma.cu,
               denoiser_grouped.cu, denoiser_tc.cu, denoiser_tc_dma.cu,
               denoiser_tc_f32.cu, denoiser_tc_grouped.cu, denoiser_wg.cu,
               denoiser_wg_f32.cu) with nvcc for sm_90a, one nvcc each,
               all started together;
  3. check     B1 in float32 (the 3xTF32 kernel with its channel mixes on
               wgmma, and the mma.sync kernel and the FMA design kept as
               its yardsticks) against its plain PyTorch version on the
               card, at N = 51,200 (the flagship fold, 1024 windows x 50
               samples) and at a ragged N;
  4. time      B1 float32's ms per call at N = 51,200: the wgmma kernel
               (kernel_ms), the mma.sync kernel (mma_f32_ms) and the FMA
               design (fma_f32_ms) timed in turns, each with its bound
               share, the wgmma build's registers and spills, and the
               plain version's ms, beside the least time the card could
               take: 3xTF32 on the tensor cores (bound_ms) and the
               function on the FMA units (fma_bound_ms); then B1 at both
               dtypes at the serve path's N = 12,800 (256 window-views x 50
               samples), checked against the plain version, timed in turns
               with its mma.sync yardstick and bounded, and at a rank's
               N = 25,600 of two ranks (phases 35, 37);
  5. main      the flagship eval (inject/AE, 50 samples x 9 DDPM steps,
               'best', 5 views, batch 1024, float32) from a seeded
               checkpoint on a synthetic dataset to the frame-level AUC,
               through `restore_and_infer`, with the kernels' launches
               counted (the wgmma 3xTF32 kernel only);
  6. agree     the same path twice on the same injected noise, once through
               the kernel and once through the plain version;
  7. profile   one more pass through the kernel under torch.profiler: the
               denoiser's device time, the rest of the device time, and the
               device's idle share of the pass;
  8. check_bf16, check_grouped, check_dma
               B1 at bfloat16 (the wgmma kernel, and the mma.sync kernel
               and the FMA design kept as its yardsticks), B2 (bfloat16)
               and B3 (float32 and bfloat16), each on the tensor cores and
               in the FMA design kept as its yardstick, against their
               plain versions at both N;
  9. time_bf16, time_grouped, time_dma
               ms per forward at N = 51,200 of each, its plain version's,
               its bound, and B1's at the same dtype in the same run
               (time_bf16: the wgmma kernel, the mma.sync kernel and the
               FMA design timed in turns, each with its bound share, and
               the wgmma build's registers and spills); B2 and B3
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
               turns;
 17. check_frames B1 float32 and bfloat16 (each the wgmma kernel and its
               mma.sync yardstick) against their plain versions at T = 1,
               2, 4, 5 and 6 frames (the U-Net of inject with 5, 4, 2 or 1
               conditioning frames of 6, and of concat; the mma.sync
               float32 kernel at T = 4 and 6), at both N;
 18. time_frames B1's ms per call at T = 6 and N = 51,200 at both dtypes
               (each the wgmma kernel and its mma.sync yardstick in
               turns), beside their bounds, their shares and the plain
               version's;
 19. main_concat the flagship architecture with `conditioning_strategy:
               concat` (the U-Net at T = 6) through `restore_and_infer`,
               as 5, B1 float32 only;
 20. agree_concat, agree_concat_bf16 that path through the kernel and
               through the plain version on the same noise, at float32 and
               bfloat16, each followed by one more kernel pass under
               torch.profiler (profile_concat, profile_concat_bf16), as 7;
 21. strategies one batch of 1024 windows x 50 samples each of
               inbetween_imp, random_imp, no_condition, inject with the
               E_unet encoder, DDIM at 3 steps and antithetic draws,
               through the kernel and through the plain version on the same
               generator, with the kernel's launches checked;
 22. train_concat, train_agree_random_imp `Trainer.fit` at concat, 2
               epochs, validation through B1 at T = 6; one random_imp
               train step on the card against the CPU, as 14.
 23. serve, serve_bf16 the streaming scorer (mocodad_tpu_torch/serve.py)
               at batch 256 on the synthetic test split pushed frame by
               frame: window-views/s, the host seconds of the pushes, of
               flush()'s launches, of the drain of the oldest batch and of
               the rest, B1's launches (9 per flush, no other kernel), the
               losses against a scorer through the plain version on the
               same injected noise, and finalize_clip against the offline
               post_processing of the same losses;
 24. serve_bound the test split pushed as fast as the host makes the
               pushes, with auto-flush and at most 2 batches in flight: the
               in-flight and queue bounds held on the card, and the per-push
               p50 and p99
               (tools/perf/probe_serve_latency.sustained_overload);
 25. checkpoint seeded weights -> a reference .ckpt -> the port's to-flax
               -> msgpack; scorers restored from each give the same losses
               bit for bit;
 26. serve_cli, predict_cli serve_MoCoDAD_torch.py and
               predict_MoCoDAD_torch.py as subprocesses on a JSON config of
               the main path, their output read back against the scorer in
               this process and the main path's losses.
 27-33. the latent variant at config/UBnormal/mocodad-latent_*.yaml's
               widths (`config.latent_config`: batch 1024, latent 64, MLP
               [64, 128, 128, 64]) on the same synthetic set, with every
               launch count set to 0 before these phases and checked 0
               after each path in this process, and each CLI's own
               counts checked 0 (no kernel of the port runs there):
               latent_pretrain (`Trainer.fit`, 2 epochs, the
               reconstruction loss as the validation metric, top-2, last
               and best_weights), latent_diffusion (2 epochs from the
               pretrain stage's best_weights.ckpt: the transferred
               parameters bit-equal before and after, every denoiser
               parameter moved, the frozen encoders' BatchNorm statistics
               moved; the AUC each epoch through the latent generate),
               latent_main (`restore_and_infer` on the test settings, 50
               samples x 9 steps, to the AUC; window-views/s),
               latent_agree (both stages on the card against the CPU on
               the same weights and noise, and one train_dtype bfloat16
               epoch of each), latent_profile (one pass under
               torch.profiler: device ms, idle share), latent_serve
               (`StreamScorer` at the diffusion stage over the test
               split's traffic; the pretrain stage refused), latent_cli
               (the train CLI at both stages, the eval and predict CLIs).
 34-37. data parallelism (mocodad_tpu_torch/parallel/), each rank a
               process with one device: dist1 (this process as a group of
               one rank over NCCL on cuda:0, the f32 agree pass through
               `run_inference(mesh=...)`, its losses against phase 6's,
               B1's launches, window-views/s), dist2_shared (two spawned
               ranks sharing cuda:0 over gloo, each the agree pass over
               its half of every batch, B1 at N = 25,600, gathered and
               held against phase 6's losses, and 3 train steps at
               mocodad_train.yaml's settings, batch 1024, with injected
               global noise against one process on the card: losses,
               parameters bit-equal across the ranks and close to one
               process's; window-views/s and steps/s), dist_cli
               (eval_MoCoDAD_torch.py alone and joined to a group of one
               rank through MOCODAD_*: the same AUC; --n-devices one more
               than the GPUs refused), dist_nccl2 (dist2_shared's checks
               over NCCL on two cards where two are visible, else
               `skipped=one_gpu`).
 38-41. the JAX Trainer's default path, the window pool on the card and
               K train steps per dispatch as one CUDA graph
               (`device_data`, `steps_per_dispatch`), where phases 6, 11,
               13-16 and 27-32 pin host batches (`device_data: false`):
               train_pool (after phase 16: phase 13's fit with the pool,
               one step per dispatch; steps/s, B1's validation launches,
               and one cudnn.deterministic epoch each of host batches and
               the pool, their losses and parameters within 1e-6),
               train_graph (the same with 8 steps per dispatch: one
               capture, one replay and one eager step per epoch, held to
               train_pool at train_agree's bounds, steps/s, epoch 0's
               training pass from the trace `profile_dir` writes: device
               busy ms, idle share, host ms in the replays and the eager
               steps; one bfloat16 epoch), agree_pool (after phase 12:
               the f32 and bf16 agree passes with the pool, bit-equal to
               phases 6 and 11, 81 launches each, window-views/s in turns
               with host batches, profile_pool and profile_pool_bf16 as
               7), latent_pool (after phase 33: one diffusion-stage epoch
               with the pool and 4 steps per dispatch, frozen parameters
               bit-equal, no launch).  The CLIs of phases 26 and 33 run
               the default path.
 42. bench     bench_torch.py's four cells at --reps 1 in this process
               (the eval passes at f32 and bf16, each warm-up pass checked
               against the reference dispatch on its first and last
               batch, the fast profile, the reference-dispatch baseline,
               whole fit epochs at f32 and bf16 with their first graphed
               group checked against eager steps, the graphed groups
               alone): its JSON line's metrics on a line of their own,
               the checks' readings, B1's launches 9 per eval batch and 0
               per train step, one capture and one replay per group of 8
               steps; then bench_control: faults planted where those
               checks must see them (B1's output off by 0.3 % at both
               dtypes, a graphed group that leaves the state unchanged,
               one that trains on half the mask), each read not correct.
Then the script's total seconds, one JSON line with each kernel's numbers
(B1's entries also carry `serve_*`, `n12800_*` and `n25600_*` keys: the
serve path's launches and window-views/s, and B1's numbers at N = 12,800
and at a rank's 25,600; `pool_launches`, on phase 40's passes, and
`denoiser` its validation launches in phases 38-39,
`train_pool_val_launches` and `train_graph_val_launches`; every entry
`latent_launches`, its count over
phases 27-33 and 41, 0, and its launches on phases 34-37: `dist1_launches`,
`dist2_launches` (per rank), `dist_cli_launches`, and `dist_nccl2_launches`
where two cards are visible; B1's `bench_launches_per_pass`, on phase
42's eval cells), the card line, and
last
{"ok": true, "device": {...}}.  Any failure exits non-zero without the
last line.  Needs one CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

import bench_torch
from mocodad_tpu_torch.config import (flagship_config, latent_config,
                                      load_config)
from mocodad_tpu_torch.data import build_dataset, synthetic
from mocodad_tpu_torch.device import resolve_device
from mocodad_tpu_torch.eval.harness import (post_processing,
                                            post_processing_from_config)
from mocodad_tpu_torch.models import frames as F, mocodad as M
from mocodad_tpu_torch.ops import build, dma_unet as D, grouped_unet as G
from mocodad_tpu_torch.ops import pallas_unet as P
from mocodad_tpu_torch.ops.roofline import (b1_bound, bound,
                                            denoiser_flops_per_row,
                                            peaks_for)
from mocodad_tpu_torch.parallel import (make_mesh, maybe_initialize,
                                        shard_batch, spawn)
from mocodad_tpu_torch.serve import StreamScorer
from mocodad_tpu_torch.tools import convert_checkpoint
from mocodad_tpu_torch.tools.perf import (probe_dma_pipeline,
                                          probe_grouped_pallas,
                                          probe_serve_latency)
from mocodad_tpu_torch.tools.perf.common import (
    BF16_MAX_REL, BF16_MEAN_REL, BN_FED_BIASES, GRAPH_STEP1_RTOL,
    N_ROWS as N_FOLD, PATH_ATOL, PATH_RTOL, TRAIN_LOSS_RTOL, TRAIN_PARAM_MEAN,
    TRAIN_STEP_MAX, card_line, device_busy, device_noise, fold_inputs,
    in_turns, plain_denoiser, rel_errors, time_ms)
from mocodad_tpu_torch.data import (affine_transform_matrices,
                                    apply_affine_batch, make_loader,
                                    to_device)
from mocodad_tpu_torch.training.inference import (PoolCache,
                                                  restore_and_infer,
                                                  run_inference)
from mocodad_tpu_torch.training.loop import EPOCH_SPAN, SPANS, Trainer
from mocodad_tpu_torch.training.step_graph import REPLAY_SPAN
from mocodad_tpu_torch.utils.weights import (is_torch_checkpoint,
                                             load_checkpoint_state_dict)

N_RAGGED = 1031
# float32 on both sides: the kernel sums each product in another order than
# cuBLAS does and contracts multiply-adds into FMAs, so results differ in
# the last bits of float32, a few 1e-7 relative per layer
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
# the chain's bounds (PATH_*, BF16_*) and the training bounds (TRAIN_*,
# GRAPH_STEP1_RTOL) are tools/perf/common.py's, shared with bench_torch.py
# the bfloat16 chain, kernel against plain version: per-window losses
PATH_BF16_MAX_REL, PATH_BF16_MEAN_REL = 1e-2, 1e-3
# training on the card against the CPU, 3 Adam steps from the same weights,
# batches and noise at full width, float32 on both sides (TF32 off).  The
# gradients of a step are sums that cancel: against float64 on the CPU the
# card's step-1 gradients land within 5.5e-4 of each tensor's largest
# gradient and the CPU's float32 within 5.3e-4 (on an NVIDIA H100 80GB
# HBM3 at 700 W); so the card's step-1 gradients within 5e-3 of each
# tensor's largest float64 gradient (measured after 3 steps: parameters
# 2.4e-3 to 3.7e-3 apart at most, 1.6e-6 on the mean), the BatchNorm-fed
# biases left out
TRAIN_GRAD_REL = 5e-3
TRAIN_LR = 1e-3

# every kernel wrapper by its name in the kernels JSON line
KERNELS = {
    'denoiser': P.DENOISER, 'denoiser_f32_mma': P.DENOISER_F32_MMA,
    'denoiser_f32_fma': P.DENOISER_F32_FMA,
    'denoiser_bf16': P.DENOISER_BF16,
    'denoiser_bf16_mma': P.DENOISER_BF16_MMA,
    'denoiser_bf16_fma': P.DENOISER_BF16_FMA,
    'denoiser_grouped': G.GROUPED, 'denoiser_grouped_fma': G.GROUPED_FMA,
    'denoiser_dma_f32': D.DMA_PIPELINED_F32,
    'denoiser_dma_f32_fma': D.DMA_PIPELINED_F32_FMA,
    'denoiser_dma_bf16': D.DMA_PIPELINED,
    'denoiser_dma_bf16_fma': D.DMA_PIPELINED_FMA}
CSRC = 'mocodad_tpu_torch/csrc/'
B1 = 'mocodad_tpu/ops/pallas_unet.py:105'


def phase(name: str, **kv) -> None:
    print(f'[{name}] ' + ' '.join(f'{k}={v}' for k, v in kv.items()),
          flush=True)


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


def ptxas_usage(source: str) -> tuple:
    """(registers, spill store bytes) of the most demanding kernel in
    ptxas's report on this process's build of `source` (phase 2 builds
    with -Xptxas=-v); (None, None) if it was not built here."""
    log = build.LOGS.get(source, '')
    regs = [int(v) for v in re.findall(r'Used (\d+) registers', log)]
    spills = [int(v) for v in re.findall(r'(\d+) bytes spill stores', log)]
    return (max(regs) if regs else None, max(spills) if spills else None)


def const_bytes(mats: torch.Tensor, vecs: torch.Tensor) -> int:
    return mats.numel() * mats.element_size() + \
        vecs.numel() * vecs.element_size()


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
    `kw` overrides any of them, and `kw['extras']` is merged into
    `device_data: false`: the phases that measure the host-batch path
    keep it, and the pool phases (38-41) ask for the pool."""
    base = dict(
        split='train', validation=True, n_generated_samples=5,
        batch_size=1024, num_transform=5, data_dir=data_dir,
        ckpt_dir=ckpt_dir, use_hr=False, vid_res=[640, 360],
        gt_path=os.path.join(data_dir, 'validating', 'test_frame_mask'),
        opt_lr=TRAIN_LR)
    extras = {'device_data': False, **kw.pop('extras', {})}
    base.update(kw)
    return flagship_config(**base, extras=extras)


def train_phase(data_dir: str, work: str, card: str, name: str = 'train',
                **kw):
    """Phase 13 (and 22 with `kw` from FRAMES); returns (config, train
    set) for the later train phases."""
    cfg = train_config(data_dir, os.path.join(work, name),
                       extras={'log_every_n_steps': 5}, **kw)
    os.makedirs(cfg.ckpt_dir, exist_ok=True)
    train_ds = build_dataset(cfg, split='train')
    val_ds = build_dataset(cfg, split='validation')
    val_batches = -(-len(val_ds) // cfg.batch_size)
    trainer, losses, val_launches, fit_seconds, counts = counted_fit(
        cfg, train_ds, val_ds, 2)
    steps = trainer.steps_per_epoch
    for e, launches in zip(trainer.history, val_launches):
        phase(name, epoch=e['epoch'], steps=steps,
              windows=len(train_ds),
              steps_per_s=f'{steps / e["train_seconds"]:.2f}',
              windows_per_s=f'{e["windows_per_s"]:.1f}',
              loss=f'{e["loss"]:.6f}', loss_noise=f'{e["loss_noise"]:.6f}',
              loss_recons=(f'{e["loss_recons"]:.6f}' if 'loss_recons' in e
                           else 'none'), auc=f'{e["AUC"]:.6f}',
              lr=f'{e["lr"]:.8f}', val_windows=len(val_ds),
              val_batches=val_batches,
              val_seconds=f'{e["val_seconds"]:.3f}', val_launches=launches,
              card=repr(card))
    train_launches = sum(counts.values()) - sum(val_launches)
    phase(name, fit_seconds=f'{fit_seconds:.3f}',
          train_step_launches=train_launches,
          launches=json.dumps({k: v for k, v in counts.items() if v}))
    bad = [e for e in trainer.history
           if not np.isfinite([e['loss'], e['loss_noise'],
                               e.get('loss_recons', 0.0)]).all()
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
                        seed=(1 << 30) + cfg.seed + best['epoch'], **kw)
    reset_launches()
    _, ds, res = restore_and_infer(ecfg, device='cuda')
    auc = post_processing_from_config(res['loss'], res['trans'],
                                      res['meta'], res['frames'], ecfg)
    reloaded = launch_counts()['denoiser']
    phase(name, reloaded='best_weights.ckpt', epoch=best['epoch'],
          auc=f'{auc:.6f}', logged_auc=f'{best["AUC"]:.6f}',
          launches=reloaded)
    if res['loss'].shape != (len(ds),) or \
            not np.isfinite(res['loss']).all() or \
            abs(auc - best['AUC']) > 1e-6 or reloaded != 9 * val_batches:
        raise RuntimeError('best_weights.ckpt does not give back the '
                           'validation it was saved for')
    return cfg, train_ds, val_ds, dict(losses=losses, params=params_of(
        trainer))


def counted_fit(cfg, train_ds, val_ds, n_epochs: int):
    """`Trainer.fit` on the card with every launch count set to 0 just
    before and read just after, recording each step's loss and B1's
    launches in each validation: (trainer, per-step losses, validation
    launches, fit seconds, counts)."""
    trainer = Trainer(cfg, device='cuda')
    validate, val_launches = trainer.validation_metric, []
    dispatch, losses = trainer.dispatch, []

    def counted(ds, epoch):
        before = P.DENOISER.launches
        out = validate(ds, epoch)
        val_launches.append(P.DENOISER.launches - before)
        return out

    def recorded(*batch):
        m = dispatch(*batch)
        losses.append(m['loss'].reshape(-1))
        return m

    trainer.validation_metric, trainer.dispatch = counted, recorded
    reset_launches()
    t0 = time.perf_counter()
    trainer.fit(train_ds, val_ds, n_epochs=n_epochs)
    fit_seconds = time.perf_counter() - t0
    counts = launch_counts()
    return (trainer, torch.cat(losses).double().cpu().numpy(), val_launches,
            fit_seconds, counts)


def params_of(trainer) -> dict:
    return {k: p.detach().cpu().double()
            for k, p in trainer.net.named_parameters()}


def train_batches(cfg, ds, n: int):
    """The first n shuffled host batches of epoch 0 (fewer if the epoch
    has fewer)."""
    return list(itertools.islice(
        make_loader(ds, cfg.batch_size, shuffle=True, seed=cfg.seed), n))


def placed(batch, device):
    return [to_device(batch[k], device) for k in ('data', 'trans', 'mask')]


def train_agree_phase(cfg, ds, name: str = 'train_agree', steps: int = 3,
                      order=None, grad_floor: float = 0.0) -> None:
    """Phase 14 (and 22 with `order`, one (B, T) frame order that every
    trainer's model takes in place of its random draws).  A tensor's
    gradient error is taken over its largest float64 gradient, or over
    `grad_floor` times the step's largest if that is more."""
    batches = train_batches(cfg, ds, steps)

    def trainer(dev, **kw):
        t = Trainer(cfg, device=dev, **kw)
        if order is not None:
            t.model.frame_order = lambda g, b, device=None: \
                torch.as_tensor(order[:b], device=device)
        return t
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
        t = trainer(dev, noise_fn=lambda step, rows: noise[step])
        t.init_state(len(batches))
        losses, g1 = [], None
        for x in batches:
            losses.append(float(t.train_step(*placed(x, t.device))['loss']))
            g1 = g1 or grads(t.net)
        runs[dev] = (t, losses, g1)
    # step 1's gradients in float64 on the CPU, the reference for both
    t64 = trainer('cpu')
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

    g_max = max(float(v.abs().max()) for v in g64.values())

    def grad_rel(g):
        return max((float((g[k] - v).abs().max()) /
                    max(float(v.abs().max()), grad_floor * g_max), k)
                   for k, v in g64.items())

    loss_rel = max(abs(a - c) / abs(c) for a, c in zip(l_gpu, l_cpu))
    cpu_params = dict(cpu.net.named_parameters())
    diffs = {k: (p.detach().cpu() - cpu_params[k].detach()).abs()
             for k, p in gpu.net.named_parameters()}
    param_max = max(float(d.max()) for d in diffs.values())
    kept = [d for k, d in diffs.items() if not k.endswith(BN_FED_BIASES)]
    param_mean = float(sum(d.sum() for d in kept) /
                       sum(d.numel() for d in kept))
    (rel_cuda, worst), (rel_cpu, _) = grad_rel(g_gpu), grad_rel(g_cpu)
    bound_max = 2 * len(batches) * TRAIN_STEP_MAX * cfg.opt_lr
    ok = (loss_rel <= TRAIN_LOSS_RTOL and rel_cuda <= TRAIN_GRAD_REL
          and param_max <= bound_max
          and param_mean <= TRAIN_PARAM_MEAN and np.isfinite(l_gpu).all())
    phase(name, steps=len(batches), batch=b,
          loss_cuda=json.dumps([round(x, 7) for x in l_gpu]),
          loss_cpu=json.dumps([round(x, 7) for x in l_cpu]),
          loss_max_rel=f'{loss_rel:.3e}', loss_rtol=TRAIN_LOSS_RTOL,
          grad1_rel_cuda_vs_f64=f'{rel_cuda:.3e}',
          grad1_rel_cpu_vs_f64=f'{rel_cpu:.3e}', grad_bound=TRAIN_GRAD_REL,
          grad_floor=grad_floor, grad1_worst_cuda=worst,
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


# ---------------------------------------------------------------------------
# The default training and eval path (phases 38-41): the window pool on the
# device, and K train steps per dispatch as one CUDA graph
# ---------------------------------------------------------------------------

# the pool against host batches: the same steps on the same windows, held
# within 1e-6 of the largest loss and parameter (the JAX package holds its
# pool to 1e-6).  Training on the card is not bit-reproducible as it
# stands: cuDNN picks backward kernels that sum in a run-dependent order,
# and the pool fit landed 3.9e-6 (losses) and 9.3e-3 of the largest
# parameter from phase 13's host-batch fit of the same steps (NVIDIA H100
# 80GB HBM3, 700.00 W), where with `cudnn.deterministic` the two are
# bit-equal.  So the pool is held to host batches in one deterministic
# epoch of each
POOL_REL = 1e-6
GRAPH_K = 8


def params_rel(got: dict, want: dict) -> float:
    largest = max(float(v.abs().max()) for v in want.values())
    return max(float((got[k] - v).abs().max()) for k, v in want.items()) \
        / largest


def pool_cfg(tcfg, name: str, k, **extras):
    return train_config(tcfg.data_dir, os.path.join(os.path.dirname(
        tcfg.ckpt_dir), name), extras={'log_every_n_steps': 5,
                                       'device_data': True,
                                       'steps_per_dispatch': k, **extras})


def fit_lines(name: str, trainer, val_launches, card: str) -> None:
    """One line per epoch of a pool fit (phases 38, 39)."""
    steps = trainer.steps_per_epoch
    for e, launches in zip(trainer.history, val_launches):
        phase(name, epoch=e['epoch'], steps=steps,
              graph_replays=e['graph_replays'],
              steps_per_s=f'{steps / e["train_seconds"]:.2f}',
              windows_per_s=f'{e["windows_per_s"]:.1f}',
              loss=f'{e["loss"]:.6f}',
              auc=f'{e["AUC"]:.6f}' if 'AUC' in e else 'none',
              val_seconds=f'{e["val_seconds"]:.3f}', val_launches=launches,
              card=repr(card))


@contextlib.contextmanager
def cudnn_deterministic():
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def train_pool_phase(tcfg, train_ds, val_ds, host: dict, card: str) -> dict:
    """Phase 38: `fit` of phase 13's configuration with `device_data:
    true` and one step per dispatch: each step gathers its windows from
    the pool on the card; steps/s and B1's launches in each validation,
    and how far it lands from phase 13's host-batch run (printed, not
    held: cuDNN's backward is not bit-reproducible).  Then one epoch each
    of host batches and of the pool under `cudnn.deterministic`: every
    step's loss and the parameters within POOL_REL of the largest.
    Returns the first run for phase 39."""
    cfg = pool_cfg(tcfg, 'train_pool', 1)
    os.makedirs(cfg.ckpt_dir, exist_ok=True)
    trainer, losses, val_launches, seconds, counts = counted_fit(
        cfg, train_ds, val_ds, 2)
    fit_lines('train_pool', trainer, val_launches, card)
    params = params_of(trainer)
    val_batches = -(-len(val_ds) // cfg.batch_size)
    det = {}
    with cudnn_deterministic():
        for name, pool in (('host', False), ('pool', True)):
            c = pool_cfg(tcfg, f'train_pool_{name}', 1, device_data=pool)
            os.makedirs(c.ckpt_dir, exist_ok=True)
            t, det_losses, _, _, _ = counted_fit(c, train_ds, None, 1)
            det[name] = (det_losses, params_of(t))
    loss_rel = rel_to_largest(det['pool'][0], det['host'][0])
    p_rel = params_rel(det['pool'][1], det['host'][1])
    ok = (loss_rel <= POOL_REL and p_rel <= POOL_REL
          and trainer.graph_captures == 0
          and all(n == 9 * val_batches for n in val_launches)
          and counts['denoiser'] == sum(val_launches))
    phase('train_pool', steps=len(losses), fit_seconds=f'{seconds:.3f}',
          loss_rel_to_phase13=f'{rel_to_largest(losses, host["losses"]):.3e}',
          params_rel_to_phase13=f'{params_rel(params, host["params"]):.3e}',
          deterministic_steps=len(det['pool'][0]),
          deterministic_loss_rel_to_host=f'{loss_rel:.3e}',
          deterministic_params_rel_to_host=f'{p_rel:.3e}', bound=POOL_REL,
          val_launches=json.dumps(val_launches), ok=ok)
    if not ok:
        raise RuntimeError('train_pool: the pool does not train as host '
                           'batches do')
    return dict(losses=losses, params=params, val_launches=val_launches)


def trace_breakdown(trace_dir: str) -> dict:
    """Where epoch 0's training pass (the EPOCH_SPAN range) went in the
    torch.profiler trace that `profile_dir` wrote: its ms, the device's
    busy ms (the union of kernels and copies) and idle share (None without
    device activity), the kernels, and the host ms inside the graph
    replays' and the eager steps' ranges."""
    files = sorted(f for f in os.listdir(trace_dir) if f.endswith('.json'))
    if not files:
        raise RuntimeError(f'no profiler trace in {trace_dir}')
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)['traceEvents']
    ranges = [e for e in events if e.get('cat') == 'user_annotation']
    epoch = [e for e in ranges if e['name'] == EPOCH_SPAN]
    if not epoch:
        raise RuntimeError(f'no {EPOCH_SPAN} range in {files[0]}')
    t0, t1 = epoch[0]['ts'], epoch[0]['ts'] + epoch[0]['dur']
    busy, kernels = device_busy(events, t0, t1)

    def host_ms(names):
        return sum(e['dur'] for e in ranges if e['name'] in names
                   and t0 <= e['ts'] < t1) / 1e3
    return dict(trace=files[0], epoch_ms=(t1 - t0) / 1e3,
                device_busy_ms=busy / 1e3,
                idle_share=1 - busy / (t1 - t0) if busy > 0 else None,
                kernels=kernels,
                replay_host_ms=host_ms({REPLAY_SPAN}),
                eager_step_host_ms=host_ms(set(SPANS)))


def train_graph_phase(tcfg, train_ds, val_ds, pool: dict, card: str):
    """Phase 39: `fit` with the pool and GRAPH_K steps per dispatch, each
    group one replay of a CUDA graph captured once: its losses and
    parameters against phase 38's eager steps, one capture and 9 // 8 = 1
    replay per epoch (the 9th step eager), steps/s, and the device's
    idle share over epoch 0's training pass from the trace that
    `profile_dir` wrote.  Then one epoch at `train_dtype: bfloat16`.
    Returns B1's validation launches."""
    trace_dir = os.path.join(os.path.dirname(tcfg.ckpt_dir), 'graph_trace')
    cfg = pool_cfg(tcfg, 'train_graph', GRAPH_K, profile_dir=trace_dir)
    os.makedirs(cfg.ckpt_dir, exist_ok=True)
    trainer, losses, val_launches, seconds, counts = counted_fit(
        cfg, train_ds, val_ds, 2)
    fit_lines('train_graph', trainer, val_launches, card)
    where = trace_breakdown(trace_dir)
    want, n = pool['losses'], len(pool['losses'])
    step1 = abs(losses[0] - want[0]) / abs(want[0])
    loss_rel = (float(np.max(np.abs(losses - want) / np.abs(want)))
                if losses.shape == want.shape else float('inf'))
    params = params_of(trainer)
    diffs = {k: (v - pool['params'][k]).abs() for k, v in params.items()}
    param_max = max(float(d.max()) for d in diffs.values())
    kept = [d for k, d in diffs.items() if not k.endswith(BN_FED_BIASES)]
    param_mean = float(sum(d.sum() for d in kept) /
                       sum(d.numel() for d in kept))
    bound_max = 2 * n * TRAIN_STEP_MAX * cfg.opt_lr
    steps = trainer.steps_per_epoch
    replays = [e['graph_replays'] for e in trainer.history]
    val_batches = -(-len(val_ds) // cfg.batch_size)
    ok = (step1 <= GRAPH_STEP1_RTOL and loss_rel <= TRAIN_LOSS_RTOL
          and param_max <= bound_max and param_mean <= TRAIN_PARAM_MEAN
          and trainer.graph_captures == 1
          and replays == [steps // GRAPH_K] * 2
          and all(v == 9 * val_batches for v in val_launches)
          and counts['denoiser'] == sum(val_launches))
    phase('train_graph', steps=n, k=GRAPH_K,
          captures=trainer.graph_captures,
          replays_per_epoch=json.dumps(replays),
          eager_steps_per_epoch=steps % GRAPH_K,
          fit_seconds=f'{seconds:.3f}',
          loss_step1_rel=f'{step1:.3e}', loss_step1_rtol=GRAPH_STEP1_RTOL,
          loss_max_rel=f'{loss_rel:.3e}', loss_rtol=TRAIN_LOSS_RTOL,
          param_max_abs=f'{param_max:.3e}', bound_max=f'{bound_max:.3e}',
          param_mean_abs=f'{param_mean:.3e}', bound_mean=TRAIN_PARAM_MEAN,
          ok=ok)
    idle = where.pop('idle_share')
    phase('train_graph', profiled='epoch 0 training pass',
          **{k: (f'{v:.3f}' if isinstance(v, float) else v)
             for k, v in where.items()},
          idle_share=('not measured (no device events)' if idle is None
                      else f'{idle:.3f}'), card=repr(card))
    if not ok:
        raise RuntimeError('train_graph: the graphed steps do not train as '
                           'the eager pool steps do')
    bcfg = pool_cfg(tcfg, 'train_graph_bf16', GRAPH_K,
                    train_dtype='bfloat16')
    os.makedirs(bcfg.ckpt_dir, exist_ok=True)
    t = Trainer(bcfg, device='cuda')
    t.fit(train_ds, None, n_epochs=1)
    e = t.history[0]
    ok = (bool(np.isfinite([e['loss'], e['loss_noise']]).all())
          and e['graph_replays'] == steps // GRAPH_K
          and t.graph_captures == 1)
    phase('train_graph', train_dtype='bfloat16', steps=t.steps_per_epoch,
          graph_replays=e['graph_replays'],
          steps_per_s=f'{t.steps_per_epoch / e["train_seconds"]:.2f}',
          loss=f'{e["loss"]:.6f}', ok=ok, card=repr(card))
    if not ok:
        raise RuntimeError(f'train_graph at bfloat16: {e}')
    return val_launches


def agree_pool_phase(ds, cfg, noise, net, runs, card: str) -> dict:
    """Phase 40: the f32 and bf16 agree passes (phases 6 and 11) with the
    window pool, on the same injected noise: the losses, views, meta and
    frames bit-equal to the host-batch passes', 9 B1 launches per batch,
    then host and pool passes in turns (host, pool, pool, host) for their
    window-views/s, and a pool pass under the profiler.  Returns B1's
    launches on the pool passes."""
    n_batches = -(-len(ds) // cfg.batch_size)
    out = {}
    for model, want, key in runs:
        pool_run = eval_pass(model, net, ds, cfg, noise, device_data=True)
        host_run = eval_pass(model, net, ds, cfg, noise)
        reset_launches()
        got, _ = pool_run()
        counts = launch_counts()
        check_main_launches(counts, key, n_batches, f'pool {key}')
        equal = all(np.array_equal(got[k], want[k])
                    for k in ('loss', 'trans', 'meta', 'frames'))
        rates = {'host': [], 'pool': []}
        for which in ('host', 'pool', 'pool', 'host'):
            _, secs = (host_run if which == 'host' else pool_run)()
            rates[which].append(round(len(ds) / secs, 1))
        phase('agree_pool', kernel=key, dtype=str(model.eval_dtype)[6:],
              windows=len(got['loss']), launches=counts[key],
              bit_equal_to_host=equal,
              pool_windows_per_s=json.dumps(rates['pool']),
              host_windows_per_s=json.dumps(rates['host']), ok=equal,
              card=repr(card))
        if not equal:
            raise RuntimeError(f'agree_pool ({key}): the pool pass differs '
                               f'from the host-batch pass')
        profile_phase('profile_pool' if key == 'denoiser'
                      else 'profile_pool_bf16', pool_run)
        out[key] = counts[key]
    return out


# the U-Net at more frames than the flagship's 3: inject with 2 of 6
# frames conditioning (T = 4), and concat (T = 6, as inbetween_imp,
# random_imp and no_condition at seg_len 6)
FRAMES = {4: dict(conditioning_indices=[0, 1]),
          6: dict(conditioning_strategy='concat')}
# and the other frame counts B1 at bfloat16 is checked at: inject with 5,
# 4 or 1 of 6 frames conditioning (T = 1, 2, 5)
BF16_FRAMES = {1: dict(conditioning_indices=[0, 1, 2, 3, 4]),
               2: dict(conditioning_indices=[0, 1, 2, 3]),
               5: dict(conditioning_indices=[0]), **FRAMES}
# B1 at each dtype and its mma.sync yardstick, with their plans
F32_TC = (('denoiser', P.DENOISER, P.wg32_plan),
          ('denoiser_f32_mma', P.DENOISER_F32_MMA, P.tc32_plan))
BF16_TC = (('denoiser_bf16', P.DENOISER_BF16, P.wg_plan),
           ('denoiser_bf16_mma', P.DENOISER_BF16_MMA, P.tc_plan))
# the other paths of `generate`, each on the flagship's other settings
STRATEGY_PATHS = (
    ('inbetween_imp', dict(conditioning_strategy='inbetween_imp',
                           conditioning_indices=2)),
    ('random_imp', dict(conditioning_strategy='random_imp',
                        conditioning_indices=3)),
    ('no_condition', dict(conditioning_strategy='no_condition')),
    ('inject_e_unet', dict(conditioning_architecture='E_unet')),
    ('ddim', dict(extras={'sampler': 'ddim', 'ddim_steps': 3})),
    ('antithetic', dict(extras={'antithetic': True})))


def seeded_model(seed: int = 0, frames: Optional[int] = None, **kw):
    """(model, eval-mode net on the card) of the flagship architecture
    with 50 samples, at `frames` U-Net frames (FRAMES) and `kw`."""
    model = M.MoCoDADModel(flagship_config(
        n_generated_samples=50, **BF16_FRAMES.get(frames, {}), **kw))
    net = M.seeded_state(model.build_net(), seed=seed).to('cuda').eval()
    return model, net


def check_frames_phase(g) -> dict:
    """Phase 17 (B1 float32 and bfloat16 at T = 1, 2, 4, 5 and 6, the
    float32 mma.sync yardstick at T = 4 and 6); returns each kernel's max
    |diff| by (kernel, T, N)."""
    errs = {}
    for t in sorted(BF16_FRAMES):
        model, net = seeded_model(frames=t)
        folded = model.fold(net)
        for n in (N_FOLD, N_RAGGED):
            x, semb = fold_inputs(folded, n, g)
            want = P.denoise_reference(x, semb, folded)
            for key, kernel, plan in F32_TC:
                if key != 'denoiser' and t not in FRAMES:
                    continue
                got = kernel(x, semb, folded)
                torch.cuda.synchronize()
                err, ok = max_rel_excess(got, want, KERNEL_RTOL, KERNEL_ATOL)
                phase('check_frames', frames=t, kernel=key, n=n,
                      rows=plan(folded, x.device).rows,
                      max_abs_err=err, rtol=KERNEL_RTOL, atol=KERNEL_ATOL,
                      ok=ok)
                if not ok:
                    raise RuntimeError(f'{key} disagrees with its plain '
                                       f'version at T={t}, N={n}')
                errs[(key, t, n)] = err
            xb = x.bfloat16()
            want16 = P.denoise_reference(xb, semb, folded,
                                         compute_dtype=torch.bfloat16)
            for key, kernel, plan in BF16_TC:
                got16 = kernel(xb, semb, folded)
                torch.cuda.synchronize()
                err16, mx, mean, ok16 = bf16_check(got16, want16,
                                                   BF16_MAX_REL, BF16_MEAN_REL)
                phase('check_frames', frames=t, kernel=key, n=n,
                      rows=plan(folded, x.device).rows, max_abs_err=err16,
                      max_rel=f'{mx:.3e}', mean_rel=f'{mean:.3e}',
                      bound_max_rel=BF16_MAX_REL,
                      bound_mean_rel=BF16_MEAN_REL, ok=ok16)
                if not ok16:
                    raise RuntimeError(f'{key} disagrees with its plain '
                                       f'version at T={t}, N={n}')
                errs[(key, t, n)] = err16
    return errs


def time_frames_phase(g, peaks, card: str) -> dict:
    """Phase 18; returns {kernel: (ms, plain ms, bound ms, bound by)} at
    T = 6, N = 51,200."""
    model, net = seeded_model(frames=6)
    folded = model.fold(net)
    x, semb = fold_inputs(folded, N_FOLD, g)
    xb = x.bfloat16()
    flops = denoiser_flops_per_row(folded) * N_FOLD
    out = {}
    # B1 at each dtype and its mma.sync yardstick in turns
    times = dict(zip((key for key, _, _ in F32_TC), in_turns(
        *(lambda k=k: k(x, semb, folded) for _, k, _ in F32_TC))))
    times.update(zip((key for key, _, _ in BF16_TC), in_turns(
        *(lambda k=k: k(xb, semb, folded) for _, k, _ in BF16_TC))))
    for key, kernel, xin, plan in (
            *((key, k, x, plan(folded, x.device)) for key, k, plan in F32_TC),
            *((key, k, xb, plan(folded, x.device))
              for key, k, plan in BF16_TC)):
        ms = times[key]
        plain_ms = time_ms(lambda: P.denoise_reference(
            xin, semb, folded, compute_dtype=xin.dtype))
        b_ms, b_by = b1_bound(folded, N_FOLD, xin.dtype == torch.bfloat16,
                              plan.blob.numel(), peaks)
        phase('time_frames', frames=6, kernel=key, n=N_FOLD,
              kernel_ms=f'{ms:.4f}', plain_ms=f'{plain_ms:.4f}',
              bound_ms=f'{b_ms:.4f}', bound_by=b_by,
              bound_share=f'{b_ms / ms:.4f}', rows=plan.rows,
              records=int(plan.table[0]), smem_bytes=plan.smem_bytes,
              gflop=f'{flops / 1e9:.2f}',
              kernel_tflops=f'{flops / ms / 1e9:.2f}', card=repr(card))
        out[key] = (ms, plain_ms, b_ms, b_by)
    return out


def eval_pass(model, net, ds, cfg, noise, device_data: bool = False):
    """One `run_inference` pass over `ds` on the given noise, on the net's
    device, on host batches or with the window pool: () -> (result, host
    seconds)."""
    def run():
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = run_inference(model, net, ds, cfg.batch_size, cfg.seed,
                          next(net.parameters()).device, noise_fn=noise,
                          device_data=device_data)
        return r, time.perf_counter() - t
    return run


def concat_phases(cfg, card: str) -> dict:
    """Phases 19 and 20 on the eval set of `cfg` (the main path's);
    returns B1's launches on the concat path at each dtype."""
    model, net = seeded_model(frames=6)
    ccfg = flagship_config(**{**{k: getattr(cfg, k) for k in (
        'split', 'n_generated_samples', 'batch_size', 'num_transform',
        'data_dir', 'ckpt_dir', 'gt_path', 'use_hr', 'vid_res', 'seed')},
        **FRAMES[6], 'load_ckpt': 'concat_weights.ckpt'})
    torch.save({'state_dict': net.state_dict()},
               os.path.join(ccfg.ckpt_dir, ccfg.load_ckpt))
    model, ds, res, counts, seconds, auc = main_path(ccfg, 'float32')
    n_batches = -(-len(ds) // ccfg.batch_size)
    phase('main_concat', frames=model.input_n_frames, windows=len(ds),
          batches=n_batches, launches=counts['denoiser'],
          seconds=f'{seconds:.3f}', windows_per_s=f'{len(ds) / seconds:.1f}',
          auc=f'{auc:.6f}', card=repr(card))
    check_main_launches(counts, 'denoiser', n_batches, 'concat float32')
    launches = {'denoiser': counts['denoiser']}
    noise = device_noise(model.schedule.noise_steps - 1, model.num_coords,
                         model.n_frames_corrupt, model.n_joints)
    lk = None
    for dtype, key in (('float32', 'denoiser'), ('bfloat16', 'denoiser_bf16')):
        ccfg.extras['eval_dtype'] = dtype
        run = eval_pass(M.MoCoDADModel(ccfg), net, ds, ccfg, noise)
        reset_launches()
        r_k, s_k = run()
        counts = launch_counts()
        check_main_launches(counts, key, n_batches, f'concat {dtype}')
        with plain_denoiser():
            r_p, s_p = run()
        got, want = torch.from_numpy(r_k['loss']), torch.from_numpy(
            r_p['loss'])
        if dtype == 'float32':
            lk = got
            err, ok = max_rel_excess(got, want, PATH_RTOL, PATH_ATOL)
            extra = dict(rtol=PATH_RTOL, atol=PATH_ATOL)
        else:
            err, mx, mean, ok = bf16_check(got, want, PATH_BF16_MAX_REL,
                                           PATH_BF16_MEAN_REL)
            _, vs32_rel, _ = rel_errors(got, lk)
            extra = dict(max_rel=f'{mx:.3e}', mean_rel=f'{mean:.3e}',
                         bound_max_rel=PATH_BF16_MAX_REL,
                         bound_mean_rel=PATH_BF16_MEAN_REL,
                         vs_float32_max_rel=f'{vs32_rel:.3e}')
        phase('agree_concat' if dtype == 'float32' else 'agree_concat_bf16',
              windows=len(got), launches=counts[key], max_abs_err=err,
              **extra, ok=ok,
              kernel_windows_per_s=f'{len(ds) / s_k:.1f}',
              plain_windows_per_s=f'{len(ds) / s_p:.1f}')
        if not ok:
            raise RuntimeError(f'the concat path at {dtype} through the '
                               f'kernel disagrees with the plain version')
        launches.setdefault(key, counts[key])
        profile_phase('profile_concat' if dtype == 'float32' else
                      'profile_concat_bf16', run)
    return launches


def strategies_phase(ds, card: str) -> None:
    """Phase 21 on the first 1024 windows of `ds`."""
    batch = next(iter(make_loader(ds, 1024)))
    data = to_device(batch['data'], torch.device('cuda'))
    for i, (name, kw) in enumerate(STRATEGY_PATHS):
        model, net = seeded_model(seed=i + 1, **kw)
        folded = model.fold(net)
        n_steps = len(model.chain_steps()[0])

        def run():
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, loss = model.generate(
                net, data, torch.Generator('cuda').manual_seed(7),
                folded=folded)
            torch.cuda.synchronize()
            return loss, time.perf_counter() - t
        run()                                 # the plans, once
        reset_launches()
        lk, sk = run()
        counts = launch_counts()
        with plain_denoiser():
            lp, sp = run()
        err, ok = max_rel_excess(lk, lp, PATH_RTOL, PATH_ATOL)
        launches_ok = counts['denoiser'] == n_steps and \
            sum(counts.values()) == n_steps
        phase('strategies', path=name, frames=model.input_n_frames,
              steps=n_steps, windows=len(lk), samples=50,
              launches=counts['denoiser'], max_abs_err=err,
              rtol=PATH_RTOL, atol=PATH_ATOL, ok=ok and launches_ok,
              kernel_windows_per_s=f'{len(lk) / sk:.1f}',
              plain_windows_per_s=f'{len(lk) / sp:.1f}', card=repr(card))
        if not (ok and launches_ok):
            raise RuntimeError(f'{name}: kernel against plain {err}, '
                               f'launches {counts}')


# one serve flush: 256 window-views x 50 samples (the JAX scorer's default
# batch, mocodad_tpu/serve.py:123)
SERVE_BATCH = 256
SERVE_HOLD_CYCLES = 4_000_000_000   # ~2 s of the SMs' clock
N_SERVE = SERVE_BATCH * 50
# malformed protocol lines for the serve CLI, each skipped with a message
SERVE_MALFORMED = ('not json', '[1, 2]', '{"type": "pose", "scene": 1}',
                   '{"type": "end_clip", "clip": 1}')


def time_fold_phase(folded, g, peaks, card: str, n: int) -> dict:
    """B1 at N fold rows at both dtypes (the serve path's 12,800; a rank's
    25,600 of two): max |diff| against the plain version, ms, the plain
    version's ms and the bound; returns {kernel: numbers}, keyed n<N>_*."""
    x, semb = fold_inputs(folded, n, g)
    xb = x.bfloat16()
    flops = denoiser_flops_per_row(folded) * n
    out = {}
    # each dtype's kernel and its mma.sync yardstick in turns
    times = dict(zip((key for key, _, _ in F32_TC), in_turns(
        *(lambda k=k: k(x, semb, folded) for _, k, _ in F32_TC))))
    times.update(zip((key for key, _, _ in BF16_TC), in_turns(
        *(lambda k=k: k(xb, semb, folded) for _, k, _ in BF16_TC))))
    for key, kernel, xin, plan in (
            *((key, k, x, plan(folded, x.device)) for key, k, plan in F32_TC),
            *((key, k, xb, plan(folded, x.device))
              for key, k, plan in BF16_TC)):
        want = P.denoise_reference(xin, semb, folded, compute_dtype=xin.dtype)
        got = kernel(xin, semb, folded)
        torch.cuda.synchronize()
        if xin.dtype == torch.float32:
            err, ok = max_rel_excess(got, want, KERNEL_RTOL, KERNEL_ATOL)
        else:
            err, _, _, ok = bf16_check(got, want, BF16_MAX_REL,
                                       BF16_MEAN_REL)
        ms = times[key]
        plain_ms = time_ms(lambda: P.denoise_reference(
            xin, semb, folded, compute_dtype=xin.dtype))
        b_ms, b_by = b1_bound(folded, n, xin.dtype == torch.bfloat16,
                              plan.blob.numel(), peaks)
        phase('time', n=n, kernel=key, max_abs_err=err, ok=ok,
              kernel_ms=f'{ms:.4f}', plain_ms=f'{plain_ms:.4f}',
              bound_ms=f'{b_ms:.4f}', bound_by=b_by,
              bound_share=f'{b_ms / ms:.4f}', gflop=f'{flops / 1e9:.2f}',
              kernel_tflops=f'{flops / ms / 1e9:.2f}', card=repr(card))
        if not ok:
            raise RuntimeError(f'{key} disagrees with its plain version at '
                               f'N={n}')
        out[key] = {f'n{n}_ms': ms, f'n{n}_plain_ms': plain_ms,
                    f'n{n}_bound_ms': b_ms, f'n{n}_bound_by': b_by,
                    f'n{n}_max_abs_err': err}
    return out


def push_all(scorer: StreamScorer, poses) -> None:
    for scene, clip, person, frame, kp in poses:
        scorer.push(scene, clip, person, frame, kp)


def scored(scorer: StreamScorer):
    """The scorer's window results over every clip, clips in key order:
    (losses, views, meta, frames)."""
    keys = sorted(scorer._scored)
    r = [scorer._scored[k] for k in keys]
    return (np.concatenate([x['loss'] for x in r]),
            np.concatenate([x['trans'] for x in r]),
            np.concatenate([np.stack(x['meta']) for x in r]),
            np.concatenate([np.stack(x['frames']) for x in r]))


def with_eval_dtype(cfg, eval_dtype: str, **kw):
    return dataclasses.replace(cfg, extras=dict(cfg.extras,
                                                eval_dtype=eval_dtype), **kw)


def serve_phase(cfg, net, poses, eval_dtype: str, card: str) -> dict:
    """Phase 23: the test split pushed frame by frame at batch 256
    (flush_every None, so every batch launches at the final flush), timed:
    the pushes, flush()'s launches, the drain of the oldest batch and the
    rest; B1's launches (9 per flush, no other kernel); whether the oldest
    batch's drain waits on its own event (an untimed run held behind a
    sleeping kernel); the losses against a scorer through the plain version
    on the same injected noise, and finalize_clip against the offline
    post_processing of the same losses.  Returns B1's launches and the
    window-views per second."""
    f32 = eval_dtype == 'float32'
    name, key = ('serve', 'denoiser') if f32 else ('serve_bf16',
                                                   'denoiser_bf16')
    scfg = with_eval_dtype(cfg, eval_dtype)
    model = M.MoCoDADModel(scfg)
    scorer = StreamScorer(scfg, net, batch_size=SERVE_BATCH,
                          max_pending_batches=1 << 20, device='cuda')
    # B1's plan for this fold, built once before the timed run
    data = torch.zeros((SERVE_BATCH, scfg.num_coords, scfg.seg_len,
                        scfg.n_joints), device='cuda')
    scorer._step(data, torch.zeros(SERVE_BATCH, dtype=torch.long,
                                   device='cuda'), -1)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    push_all(scorer, poses)
    views = scorer.pending
    t1 = time.perf_counter()
    scorer.flush(force=True)
    t2 = time.perf_counter()
    last = scorer._pending_dev[-1].done
    busy = not last.query()
    scorer._drain_one()
    t3 = time.perf_counter()
    last_done = last.query()
    scorer._drain()
    t4 = time.perf_counter()
    counts = launch_counts()
    batches = -(-views // SERVE_BATCH)
    check_main_launches(counts, key, batches, f'serve {eval_dtype}')
    # the oldest batch's drain waits on its own event: the card is busy
    # when it starts, and the newest batch is still running when it returns
    # (an idle card at the first drain would show nothing, so it fails too).
    # Read on a second run whose batches queue behind a sleeping kernel, so
    # that the answer does not hang on how fast the host launched them: in
    # the timed run a slow host lets the card finish the newest batch first
    held = StreamScorer(scfg, net, batch_size=SERVE_BATCH,
                        max_pending_batches=1 << 20, device='cuda')
    push_all(held, poses)
    torch.cuda._sleep(SERVE_HOLD_CYCLES)
    held.flush(force=True)
    newest = held._pending_dev[-1].done
    held_busy = not newest.query()
    held._drain_one()
    pipelined = held_busy and not newest.query()
    held._drain()

    noise = device_noise(model.schedule.noise_steps - 1, model.num_coords,
                         model.n_frames_corrupt, model.n_joints)
    s = model.n_generated_samples

    def injected():
        sc = StreamScorer(scfg, net, batch_size=SERVE_BATCH, device='cuda')
        step = sc._step
        sc._step = lambda d, tr, i: step(d, tr, i, noise_override=noise(
            i, d.shape[0] * s))
        push_all(sc, poses)
        sc.flush(force=True)
        sc._drain()
        return sc
    sk = injected()
    with plain_denoiser():
        sp = injected()
    got, want = (torch.from_numpy(scored(x)[0]) for x in (sk, sp))
    if f32:
        err, ok = max_rel_excess(got, want, PATH_RTOL, PATH_ATOL)
        extra = dict(rtol=PATH_RTOL, atol=PATH_ATOL)
    else:
        err, mx, mean, ok = bf16_check(got, want, PATH_BF16_MAX_REL,
                                       PATH_BF16_MEAN_REL)
        extra = dict(max_rel=f'{mx:.3e}', mean_rel=f'{mean:.3e}',
                     bound_max_rel=PATH_BF16_MAX_REL,
                     bound_mean_rel=PATH_BF16_MEAN_REL)
    loss, trans, meta, frames = scored(sk)
    _, offline, _ = post_processing(
        loss, trans, meta, frames, gt_path=scfg.gt_path,
        num_transform=scfg.num_transform, dataset_name=scfg.dataset_choice,
        split='test', use_hr=False, pad_size=scfg.pad_size,
        filter_kernel_size=scfg.filter_kernel_size,
        frames_shift=scfg.frames_shift, return_scores=True)
    streamed = []
    for f in sorted(f for f in os.listdir(scfg.gt_path)
                    if f.endswith('.npy')):
        gt = np.load(os.path.join(scfg.gt_path, f))
        streamed.append(sk.finalize_clip(
            int(f.split('_')[0]), int(f.split('_')[1][:-4]), gt.shape[0],
            gt=gt if scfg.pad_size != -1 else None))
    fin_err = float(np.abs(np.concatenate(streamed) - offline).max())
    seconds = t4 - t0
    phase(name, window_views=views, windows=views // scfg.num_transform,
          pushes=len(poses), batches=batches, launches=counts[key],
          push_seconds=f'{t1 - t0:.4f}', launch_seconds=f'{t2 - t1:.4f}',
          first_drain_seconds=f'{t3 - t2:.4f}',
          drain_seconds=f'{t4 - t3:.4f}', seconds=f'{seconds:.4f}',
          window_views_per_s=f'{views / seconds:.1f}',
          busy_at_first_drain=busy, newest_done_after_first_drain=last_done,
          card=repr(card))
    phase(name, compared_window_views=len(got), max_abs_err=err, **extra,
          finalize_vs_offline_max_abs=fin_err, pipelined=pipelined,
          ok=ok and fin_err == 0.0 and pipelined)
    if not (ok and fin_err == 0.0 and pipelined):
        raise RuntimeError(f'{name}: kernel against plain {err}, finalize '
                           f'against offline {fin_err}, pipelined '
                           f'{pipelined}')
    return dict(serve_launches=counts[key],
                serve_window_views_per_s=views / seconds)


def serve_bound_phase(cfg, net, poses, card: str) -> None:
    """Phase 24: the test split pushed as fast as the host makes the
    pushes, with auto-flush at every full batch and at most 2 batches in
    flight (probe_serve_latency's overload run)."""
    r = probe_serve_latency.sustained_overload(
        with_eval_dtype(cfg, 'float32'), net, poses, batch=SERVE_BATCH)
    phase('serve_bound', batch=SERVE_BATCH, max_pending_batches=2,
          **{k: f'{v:.4f}' if isinstance(v, float) else v
             for k, v in r.items()}, card=repr(card))
    if not r['bounds_held']:
        raise RuntimeError(f'serve bounds not held on the card: {r}')


def checkpoint_phase(cfg, net, poses) -> None:
    """Phase 25: seeded weights -> a reference .ckpt -> the port's to-flax
    -> msgpack; a scorer restored from each gives the same losses, bit
    for bit."""
    ref = os.path.join(cfg.ckpt_dir, 'ref_weights.ckpt')
    packed = os.path.join(cfg.ckpt_dir, 'flax_weights.msgpack')
    torch.save({'state_dict': net.state_dict()}, ref)
    n = convert_checkpoint.convert(cfg, 'to-flax', ref, packed)
    losses = []
    for path in (ref, packed):
        sc = StreamScorer(with_eval_dtype(cfg, 'float32',
                                          load_ckpt=os.path.basename(path)),
                          None, batch_size=SERVE_BATCH, device='cuda')
        push_all(sc, poses)
        sc.flush(force=True)
        sc._drain()
        losses.append(scored(sc)[0])
    err = float(np.abs(losses[0] - losses[1]).max())
    ok = err == 0.0 and not is_torch_checkpoint(packed) and \
        np.isfinite(losses[0]).all()
    phase('checkpoint', tensors=n, msgpack_bytes=os.path.getsize(packed),
          window_views=len(losses[0]), max_abs_err=err, ok=ok)
    if not ok:
        raise RuntimeError(f'a scorer restored from msgpack differs from '
                           f'the .ckpt by {err}')


def cli_config(cfg, work: str) -> str:
    """The main path's configuration as a JSON config file whose ckpt_dir
    holds its scaler and checkpoint; returns the file's path."""
    root = os.path.join(work, 'cli')
    ckpt_dir = os.path.join(root, cfg.dataset_choice, 'smoke')
    os.makedirs(ckpt_dir, exist_ok=True)
    for f in ('local_robust.npz', cfg.load_ckpt):
        shutil.copyfile(os.path.join(cfg.ckpt_dir, f),
                        os.path.join(ckpt_dir, f))
    d = with_eval_dtype(cfg, 'float32').to_dict()
    d.update(exp_dir=root, dir_name='smoke', test_path=cfg.gt_path,
             create_experiment_dir=False)
    path = os.path.join(root, 'smoke.json')
    with open(path, 'w') as f:
        json.dump(d, f)
    return path


# Runs a CLI script as __main__, then prints the launch counts of the
# port's kernels in its process as the last line of its standard error.
CLI_WRAPPER = (
    'import atexit, json, runpy, sys\n'
    'from chip_smoke import launch_counts\n'
    'atexit.register(lambda: print("launches", json.dumps(launch_counts()),'
    ' file=sys.stderr))\n'
    'sys.argv = sys.argv[1:]\n'
    'runpy.run_path(sys.argv[0], run_name="__main__")\n')


def run_clis(*calls, stdin: str = '', envs=None, check: bool = True):
    """Run each (script, *args) as a subprocess, all at once, with `stdin`
    on its standard input and `envs[i]` added to the i-th one's
    environment, and wait for every one (600 s at most); with `check`,
    raise if any fails.  Every process is stopped on the way out.  Returns
    their CompletedProcess in order, each with `launches`, the CLI's own
    launch counts."""
    repo = os.path.dirname(os.path.abspath(__file__))
    envs = envs or [{}] * len(calls)
    procs = [subprocess.Popen([sys.executable, '-c', CLI_WRAPPER,
                               os.path.join(repo, c[0]), *c[1:]],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=repo,
                              env={**os.environ, **e})
             for c, e in zip(calls, envs)]
    try:
        out = [subprocess.CompletedProcess(p.args, None, *p.communicate(
            stdin, timeout=600)) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for c, p, o in zip(calls, procs, out):
        o.returncode = p.returncode
        if p.returncode != 0 and check:
            raise RuntimeError(f'{c[0]} exited {p.returncode}: '
                               f'{o.stderr[-2000:]}')
        counts = [line for line in o.stderr.splitlines()
                  if line.startswith('launches ')]
        o.launches = json.loads(counts[-1][9:]) if counts else None
    return out


def run_cli(script: str, *args, stdin: str = ''):
    return run_clis((script, *args), stdin=stdin)[0]


def serve_cli_phase(config: str, poses) -> None:
    """Phase 26: serve_MoCoDAD_torch.py as a subprocess on one clip's
    poses with malformed lines among them; its scores against a scorer
    in this process on the same configuration and poses."""
    cfg = load_config(config)
    scene, clip = poses[0][:2]
    clip_poses = [p for p in poses if p[:2] == (scene, clip)]
    n_frames = np.load(os.path.join(cfg.gt_path,
                                    f'{scene}_{clip}.npy')).shape[0]
    lines = [json.dumps({'type': 'pose', 'scene': s, 'clip': c,
                         'person': p, 'frame': f, 'keypoints': kp.tolist()})
             for s, c, p, f, kp in clip_poses]
    for i, bad in enumerate(SERVE_MALFORMED):
        lines.insert(i * len(lines) // len(SERVE_MALFORMED), bad)
    lines.append(json.dumps({'type': 'end_clip', 'scene': scene,
                             'clip': clip, 'n_frames': n_frames}))
    t0 = time.perf_counter()
    proc = run_cli('serve_MoCoDAD_torch.py', '-c', config, '--batch-size',
                   str(SERVE_BATCH), stdin='\n'.join(lines) + '\n')
    seconds = time.perf_counter() - t0
    out = [json.loads(x) for x in proc.stdout.splitlines()]
    skipped = proc.stderr.count('skipping malformed')
    sc = StreamScorer(cfg, batch_size=SERVE_BATCH, device='cuda')
    push_all(sc, clip_poses)
    want = sc.finalize_clip(scene, clip, n_frames)
    got = np.asarray(out[0]['scores']) if len(out) == 1 else np.zeros(0)
    err = float(np.abs(got - want).max()) if got.shape == want.shape \
        else float('inf')
    # the CLI rounds each score to 6 decimals
    ok = [o['type'] for o in out] == ['scores'] and err <= 1e-6 and \
        skipped == len(SERVE_MALFORMED)
    phase('serve_cli', poses=len(clip_poses), malformed=skipped,
          lines_out=len(out), frames=len(got), max_abs_err=err,
          seconds=f'{seconds:.2f}', ok=ok)
    if not ok:
        raise RuntimeError(f'serve CLI: {out[:1]}, max |diff| {err}, '
                           f'{skipped} malformed lines skipped')


def predict_cli_phase(config: str, res: dict) -> None:
    """Phase 26: predict_MoCoDAD_torch.py as a subprocess; its saved
    losses against the main path's on the same configuration."""
    t0 = time.perf_counter()
    proc = run_cli('predict_MoCoDAD_torch.py', '-c', config)
    seconds = time.perf_counter() - t0
    path = proc.stdout.strip().splitlines()[-1].split('saved tensors to ')[-1]
    got = np.load(os.path.join(path, 'prediction.npy'))
    meta = np.load(os.path.join(path, 'metadata.npy'))
    ok = got.shape == res['loss'].shape and \
        np.array_equal(meta, res['meta'])
    err = float('inf')
    if ok:
        err, ok = max_rel_excess(torch.from_numpy(got),
                                 torch.from_numpy(res['loss']), PATH_RTOL,
                                 PATH_ATOL)
    phase('predict_cli', windows=len(got), max_abs_err=err,
          rtol=PATH_RTOL, atol=PATH_ATOL, seconds=f'{seconds:.2f}', ok=ok)
    if not ok:
        raise RuntimeError(f'predict CLI: saved losses differ from the main '
                           f'path by {err}')


# ---------------------------------------------------------------------------
# The latent variant (config/UBnormal/mocodad-latent_{train,test}.yaml):
# no kernel of the port runs on its paths, checked with the counters
# ---------------------------------------------------------------------------

LATENT_EPOCHS = 2
# the card against the CPU, float32 on both sides (TF32 off): per-window
# losses within 1e-5 of the largest loss
LATENT_AGREE_REL = 1e-5


def latent_cfg(stage: str, data_dir: str, ckpt_dir: str, **kw):
    """mocodad-latent_train.yaml's settings at `stage` on the synthetic
    set (its own frame size, no HR masks), on host batches; `kw`
    overrides any of them, and `kw['extras']` is merged into the
    extras."""
    extras = {'log_every_n_steps': 5, 'device_data': False,
              **kw.pop('extras', {})}
    base = dict(data_dir=data_dir, ckpt_dir=ckpt_dir, vid_res=[640, 360],
                gt_path=os.path.join(data_dir, 'validating',
                                     'test_frame_mask'))
    base.update(kw)
    return latent_config(stage, **base, extras=extras)


def latent_test_cfg(data_dir: str, ckpt_dir: str, **kw):
    """mocodad-latent_test.yaml's settings on the synthetic test split
    (50 samples, 5 views, batch 1024; no HR masks, no saved tensors)."""
    return latent_cfg('diffusion', data_dir, ckpt_dir, split='test',
                      validation=False, n_generated_samples=50,
                      load_ckpt='best_weights.ckpt',
                      gt_path=os.path.join(data_dir, 'testing',
                                           'test_frame_mask'), **kw)


def check_no_launches(what: str) -> None:
    """Raise if any kernel of the port launched since the latent phases
    began: a latent path that reached B1, B2 or B3 would be a fault."""
    counts = launch_counts()
    if any(counts.values()):
        raise RuntimeError(f'the latent {what} path launched kernels: '
                           f'{counts}')


def latent_fit_phase(name: str, cfg, card: str):
    """Phases 27-28: `Trainer.fit` for LATENT_EPOCHS epochs with
    validation; one line per epoch (steps/s, windows/s, the stage's
    losses, its monitored metric, validation seconds), then the
    checkpoints and the launch counts (all 0).  Returns the trainer."""
    os.makedirs(cfg.ckpt_dir, exist_ok=True)
    train_ds = build_dataset(cfg, split='train')
    val_ds = build_dataset(cfg, split='validation')
    trainer = Trainer(cfg, device='cuda')
    t0 = time.perf_counter()
    trainer.fit(train_ds, val_ds, n_epochs=LATENT_EPOCHS)
    fit_seconds = time.perf_counter() - t0
    check_no_launches(name)
    losses = (('loss', 'loss_unet', 'loss_recons') if cfg.stage == 'pretrain'
              else ('loss', 'loss_noise'))
    metric = 'pretrain_rec_loss' if cfg.stage == 'pretrain' else 'AUC'
    steps = trainer.steps_per_epoch
    for e in trainer.history:
        phase(name, epoch=e['epoch'], steps=steps, windows=len(train_ds),
              steps_per_s=f'{steps / e["train_seconds"]:.2f}',
              windows_per_s=f'{e["windows_per_s"]:.1f}',
              **{k: f'{e[k]:.6f}' for k in losses + (metric,)},
              val_windows=len(val_ds),
              val_seconds=f'{e["val_seconds"]:.3f}', card=repr(card))
    with open(os.path.join(cfg.ckpt_dir, 'topk.json')) as f:
        kept = [os.path.join(cfg.ckpt_dir, n) for _, n in
                json.load(f)['entries']]
    files = kept + [os.path.join(cfg.ckpt_dir, n)
                    for n in ('last.ckpt', 'best_weights.ckpt')]
    ok = (len(trainer.history) == LATENT_EPOCHS and len(kept) == 2
          and all(os.path.exists(f) for f in files)
          and all(np.isfinite([e[k] for k in losses + (metric,)]).all()
                  for e in trainer.history)
          and (metric != 'AUC'
               or all(0 <= e['AUC'] <= 1 for e in trainer.history)))
    phase(name, fit_seconds=f'{fit_seconds:.3f}', top2=len(kept),
          checkpoints=','.join(os.path.basename(f) for f in files),
          launches=0, ok=ok)
    if not ok:
        raise RuntimeError(f'{name}: malformed epochs {trainer.history} or '
                           f'checkpoints {files}')
    return trainer


def latent_diffusion_phase(data_dir: str, work: str, pretrained: str,
                           card: str):
    """Phase 28: the diffusion stage from the pretrain stage's
    best_weights.ckpt.  Every parameter outside the denoiser must be
    bit-equal to the pretrained one before and after, every denoiser
    parameter must move, and so must the frozen encoders' BatchNorm
    statistics (they stay in train mode, as JAX's do).  Returns the
    diffusion stage's config."""
    cfg = latent_cfg('diffusion', data_dir,
                     os.path.join(work, 'latent_diffusion'),
                     pretrained_model_ckpt_path=pretrained)
    first = Trainer(cfg, device='cuda')
    first.init_state(1)
    start = {k: v.detach().clone()
             for k, v in first.net.state_dict().items()}
    pre = load_checkpoint_state_dict(pretrained)
    copied = [k for k, v in start.items() if k in pre
              and tuple(pre[k].shape) == tuple(v.shape)
              and not k.endswith('num_batches_tracked')]
    transferred = all(torch.equal(start[k].cpu(), pre[k]) for k in copied)
    trainer = latent_fit_phase('latent_diffusion', cfg, card)
    after = trainer.net.state_dict()
    params = [k for k, _ in trainer.net.named_parameters()]
    frozen = [k for k in params if not k.startswith('denoiser.')]
    stats = [k for k in after if 'running' in k
             and not k.startswith('denoiser.')]
    frozen_equal = all(torch.equal(after[k], start[k]) for k in frozen)
    denoiser_moved = all(not torch.equal(after[k], start[k])
                         for k in params if k.startswith('denoiser.'))
    stats_moved = sum(not torch.equal(after[k], start[k]) for k in stats)
    ok = transferred and frozen_equal and denoiser_moved and \
        stats_moved == len(stats) and len(copied) > 100
    phase('latent_diffusion', transferred=len(copied),
          transferred_equal=transferred, frozen_params=len(frozen),
          frozen_bit_equal=frozen_equal,
          denoiser_params=len(params) - len(frozen),
          denoiser_all_moved=denoiser_moved,
          frozen_bn_stats_moved=f'{stats_moved}/{len(stats)}', ok=ok)
    if not ok:
        raise RuntimeError('latent diffusion stage: the transfer or the '
                           'freezing does not hold')
    return cfg


def latent_net(model, path: str, dev: str):
    net = model.build_net()
    net.load_state_dict(load_checkpoint_state_dict(path), strict=True)
    return net.to(dev).eval()


def latent_main_phase(mcfg, card: str):
    """Phase 29: `restore_and_infer` on mocodad-latent_test.yaml's settings
    (50 samples x 9 DDPM steps, 5 views, batch 1024) to the AUC, no kernel
    launched; then two `run_inference` passes on the restored weights,
    timed.  Returns (model, net, dataset, result, window-views/s)."""
    t0 = time.perf_counter()
    model, ds, res = restore_and_infer(mcfg, device='cuda')
    seconds = time.perf_counter() - t0
    check_no_launches('eval')
    auc = post_processing_from_config(res['loss'], res['trans'],
                                      res['meta'], res['frames'], mcfg)
    net = latent_net(model, os.path.join(mcfg.ckpt_dir, mcfg.load_ckpt),
                     'cuda')
    run = eval_pass(model, net, ds, mcfg, None)
    rates = [len(ds) / run()[1] for _ in range(2)]
    check_no_launches('eval')
    ok = res['loss'].shape == (len(ds),) and \
        bool(np.isfinite(res['loss']).all()) and 0 <= auc <= 1
    phase('latent_main', stage=model.stage, windows=len(ds),
          batches=-(-len(ds) // mcfg.batch_size),
          samples=model.n_generated_samples,
          steps=len(model.chain_steps()[0]), seconds=f'{seconds:.3f}',
          windows_per_s=f'{len(ds) / seconds:.1f}',
          pass_windows_per_s=json.dumps([round(r, 1) for r in rates]),
          auc=f'{auc:.6f}', b1_b2_b3_launches=0, ok=ok, card=repr(card))
    if not ok:
        raise RuntimeError('latent main path output malformed')
    return model, net, ds, res, max(rates)


def latent_agree_phase(pcfg, mcfg, data_dir: str, work: str, card: str):
    """Phase 30: both stages on the card and on the CPU, same weights, the
    first 1024 window-views of the test split, the same noise_override:
    the per-window losses within LATENT_AGREE_REL of the largest; then one
    `train_dtype: bfloat16` epoch of each stage with finite losses."""
    ds = build_dataset(mcfg, split='test')
    batch = next(iter(make_loader(ds, mcfg.batch_size)))
    mats = torch.as_tensor(affine_transform_matrices(mcfg.num_transform))
    data = apply_affine_batch(torch.from_numpy(batch['data']), mats,
                              torch.from_numpy(batch['trans']).long())
    for stage, cfg in (('pretrain', pcfg), ('diffusion', mcfg)):
        model = M.build_model(cfg)
        path = os.path.join(cfg.ckpt_dir, 'best_weights.ckpt')
        out = {}
        for d in ('cuda', 'cpu'):
            net = latent_net(model, path, d)
            x = data.to(d)
            if stage == 'pretrain':
                _, loss = model.reconstruction_losses(net, x)
            else:
                rng = np.random.default_rng(5)
                n, dim = x.shape[0] * model.n_generated_samples, \
                    model.latent_embedding_dim
                noise = (rng.standard_normal((n, dim), np.float32),
                         rng.standard_normal((9, n, dim), np.float32))
                _, loss = model.generate(net, x, noise_override=tuple(
                    torch.from_numpy(a).to(d) for a in noise))
            out[d] = loss.double().cpu()
        err = float((out['cuda'] - out['cpu']).abs().max())
        rel = err / float(out['cpu'].abs().max())
        ok = rel <= LATENT_AGREE_REL and bool(
            torch.isfinite(out['cuda']).all())
        phase('latent_agree', stage=stage, windows=len(out['cpu']),
              max_abs_err=err, max_rel=f'{rel:.3e}',
              bound_rel=LATENT_AGREE_REL, ok=ok)
        if not ok:
            raise RuntimeError(f'latent {stage}: the card disagrees with '
                               f'the CPU by {rel:.3e} of the largest loss')
    for stage, cfg in (('pretrain', pcfg), ('diffusion', mcfg)):
        bcfg = latent_cfg(stage, data_dir,
                          os.path.join(work, f'latent_bf16_{stage}'),
                          pretrained_model_ckpt_path=os.path.join(
                              pcfg.ckpt_dir, 'best_weights.ckpt'),
                          extras={'train_dtype': 'bfloat16'})
        os.makedirs(bcfg.ckpt_dir, exist_ok=True)
        t = Trainer(bcfg, device='cuda')
        t.fit(build_dataset(bcfg, split='train'), None, n_epochs=1)
        check_no_launches('bfloat16 train')
        e = t.history[0]
        keys = [k for k in e if k.startswith('loss')]
        ok = bool(np.isfinite([e[k] for k in keys]).all())
        phase('latent_agree', stage=stage, train_dtype='bfloat16',
              steps=t.steps_per_epoch,
              steps_per_s=f'{t.steps_per_epoch / e["train_seconds"]:.2f}',
              **{k: f'{e[k]:.6f}' for k in keys}, ok=ok, card=repr(card))
        if not ok:
            raise RuntimeError(f'latent {stage} at bfloat16: {e}')


def latent_profile_phase(model, net, ds, mcfg, card: str) -> None:
    """Phase 31: one `run_inference` pass under torch.profiler: the
    device ms, the idle share, the largest activities."""
    seconds, kernel_ms, dev_ms, top = device_time_split(
        eval_pass(model, net, ds, mcfg, None))
    wall_ms = seconds * 1e3
    measured = dev_ms > 0
    phase('latent_profile', seconds=f'{seconds:.3f}',
          device_ms=f'{dev_ms:.1f}' if measured
          else 'not measured (no device events)',
          idle_share=(f'{1 - dev_ms / wall_ms:.3f}' if measured
                      else 'not measured'),
          denoiser_kernel_ms=kernel_ms,
          top=json.dumps([[k, round(v, 2)] for k, v in top]),
          card=repr(card))
    if kernel_ms:
        raise RuntimeError('a denoiser kernel ran on the latent path')


def latent_noise(dim: int, steps: int):
    """Each flush's (z0, zs) drawn on the card from its flush index."""
    def fn(i: int, rows: int):
        g = torch.Generator(device='cuda').manual_seed(3000 + i)
        return (torch.randn((rows, dim), generator=g, device='cuda'),
                torch.randn((steps, rows, dim), generator=g, device='cuda'))
    return fn


def latent_serve_phase(mcfg, net, poses, card: str) -> None:
    """Phase 32: `StreamScorer` on the diffusion stage at batch 256 over
    the test split's traffic, timed, no kernel launched; on injected noise
    each flush's losses equal `generate` on the same batch, views and
    noise, and finalize_clip equals the offline scoring of the streamed
    losses; the pretrain stage is refused."""
    scorer = StreamScorer(mcfg, net, batch_size=SERVE_BATCH,
                          max_pending_batches=1 << 20, device='cuda')
    data = torch.zeros((SERVE_BATCH, mcfg.num_coords, mcfg.seg_len,
                        mcfg.n_joints), device='cuda')
    scorer._step(data, torch.zeros(SERVE_BATCH, dtype=torch.long,
                                   device='cuda'), -1)
    t0 = time.perf_counter()
    push_all(scorer, poses)
    views = scorer.pending
    t1 = time.perf_counter()
    scorer.flush(force=True)
    scorer._drain()
    seconds = time.perf_counter() - t0
    check_no_launches('serve')

    model = scorer.model
    noise = latent_noise(model.latent_embedding_dim,
                         len(model.chain_steps()[0]))
    sc = StreamScorer(mcfg, net, batch_size=SERVE_BATCH, device='cuda')
    step, seen = sc._step, []

    def injected(d, tr, i):
        nz = noise(i, d.shape[0] * model.n_generated_samples)
        loss = step(d, tr, i, noise_override=nz)
        seen.append((d, tr, nz, loss))
        return loss
    sc._step = injected
    push_all(sc, poses)
    sc.flush(force=True)
    sc._drain()
    mats = sc._mats
    err = max(float((model.generate(
        net, apply_affine_batch(d, mats, tr.long()), noise_override=nz)[1]
        - loss).abs().max()) for d, tr, nz, loss in seen)
    loss, trans, meta, frames = scored(sc)
    _, offline, _ = post_processing(
        loss, trans, meta, frames, gt_path=mcfg.gt_path,
        num_transform=mcfg.num_transform, dataset_name=mcfg.dataset_choice,
        split='test', use_hr=False, pad_size=mcfg.pad_size,
        filter_kernel_size=mcfg.filter_kernel_size,
        frames_shift=mcfg.frames_shift, return_scores=True)
    streamed = []
    for f in sorted(f for f in os.listdir(mcfg.gt_path)
                    if f.endswith('.npy')):
        n_frames = np.load(os.path.join(mcfg.gt_path, f)).shape[0]
        streamed.append(sc.finalize_clip(int(f.split('_')[0]),
                                         int(f.split('_')[1][:-4]),
                                         n_frames))
    fin_err = float(np.abs(np.concatenate(streamed) - offline).max())
    try:
        StreamScorer(dataclasses.replace(mcfg, stage='pretrain'), None,
                     device='cuda')
        refused = False
    except NotImplementedError:
        refused = True
    ok = err == 0.0 and fin_err == 0.0 and refused and \
        len(loss) == views and bool(np.isfinite(loss).all())
    phase('latent_serve', window_views=views, pushes=len(poses),
          batches=-(-views // SERVE_BATCH), launches=0,
          push_seconds=f'{t1 - t0:.4f}', seconds=f'{seconds:.4f}',
          window_views_per_s=f'{views / seconds:.1f}',
          flush_vs_generate_max_abs=err,
          finalize_vs_offline_max_abs=fin_err, pretrain_refused=refused,
          ok=ok, card=repr(card))
    if not ok:
        raise RuntimeError(f'latent serve: flush against generate {err}, '
                           f'finalize against offline {fin_err}, pretrain '
                           f'refused {refused}')


def latent_cli_phase(data_dir: str, work: str) -> None:
    """Phase 33: train_MoCoDAD_torch.py at pretrain and then at diffusion
    (one epoch each, JSON configs of mocodad-latent_train.yaml), then
    eval_MoCoDAD_torch.py and predict_MoCoDAD_torch.py side by side on
    mocodad-latent_test.yaml's settings, as subprocesses; the eval's AUC
    and the predict's losses against `restore_and_infer` in this process
    on the same configuration, and each CLI's own launch counts all 0."""
    root = os.path.join(work, 'latent_cli')
    os.makedirs(root, exist_ok=True)
    common = dict(exp_dir=root, create_experiment_dir=True, n_epochs=1)

    def write(name, cfg, **kw):
        d = cfg.to_dict()
        # the CLIs run the default path: the pool and, for training, K
        # steps per dispatch as a CUDA graph
        d.pop('device_data')
        d.update(common, test_path=cfg.gt_path, dir_name=name)
        d.update(kw)
        path = os.path.join(root, f'{name}.json')
        with open(path, 'w') as f:
            json.dump(d, f)
        return path
    ckpt = os.path.join(root, 'UBnormal', 'pretrain', 'best_weights.ckpt')
    configs = [
        write('pretrain', latent_cfg('pretrain', data_dir, root)),
        write('diffusion', latent_cfg('diffusion', data_dir, root,
                                      pretrained_model_ckpt_path=ckpt)),
        write('test', latent_test_cfg(data_dir, root), dir_name='diffusion')]
    t0 = time.perf_counter()
    out = [run_cli('train_MoCoDAD_torch.py', '-c', configs[0]),
           run_cli('train_MoCoDAD_torch.py', '-c', configs[1])]
    # the eval and predict CLIs read the same checkpoint: side by side
    out += run_clis(('eval_MoCoDAD_torch.py', '-c', configs[2]),
                    ('predict_MoCoDAD_torch.py', '-c', configs[2]))
    seconds = time.perf_counter() - t0
    launches = [o.launches for o in out]
    cli_auc = float(out[2].stdout.split('AUC score: ')[-1].split()[0])
    saved = out[3].stdout.strip().splitlines()[-1].split(
        'saved tensors to ')[-1]
    got = np.load(os.path.join(saved, 'prediction.npy'))
    tcfg = load_config(configs[2])
    _, _, res = restore_and_infer(tcfg, device='cuda')
    check_no_launches('CLI comparison')
    auc = post_processing_from_config(res['loss'], res['trans'],
                                      res['meta'], res['frames'], tcfg)
    err, close = float('inf'), False
    if got.shape == res['loss'].shape:
        err, close = max_rel_excess(torch.from_numpy(got),
                                    torch.from_numpy(res['loss']),
                                    PATH_RTOL, PATH_ATOL)
    # the CLI prints the AUC to 6 decimals
    ok = ('checkpointing on pretrain_rec_loss (min)' in out[0].stdout
          and 'checkpointing on AUC (max)' in out[1].stdout
          and abs(cli_auc - auc) <= 5e-7 and close
          and not any(any(n.values()) for n in launches))
    phase('latent_cli', runs='train pretrain, train diffusion, eval, predict',
          eval_auc=f'{cli_auc:.6f}', in_process_auc=f'{auc:.6f}',
          predict_vs_in_process_max_abs=err, rtol=PATH_RTOL, atol=PATH_ATOL,
          cli_launches=json.dumps([sum(n.values()) for n in launches]),
          seconds=f'{seconds:.2f}', ok=ok)
    if not ok:
        raise RuntimeError(f'latent CLIs: AUC {cli_auc} against {auc}, '
                           f'saved losses {err} from the in-process run, '
                           f'launches {launches}')


def latent_pool_phase(data_dir: str, work: str, pretrained: str,
                      card: str) -> None:
    """Phase 41: one diffusion-stage epoch from the pretrain stage's
    best_weights.ckpt with the window pool and 4 steps per dispatch (a
    CUDA graph of 4 steps): finite losses, every frozen parameter
    bit-equal before and after, one capture, and no kernel of the port
    launched."""
    cfg = latent_cfg('diffusion', data_dir,
                     os.path.join(work, 'latent_pool'),
                     pretrained_model_ckpt_path=pretrained,
                     extras={'device_data': True, 'steps_per_dispatch': 4})
    os.makedirs(cfg.ckpt_dir, exist_ok=True)
    first = Trainer(cfg, device='cuda')
    first.init_state(1)
    start = {k: p.detach().clone() for k, p in first.net.named_parameters()
             if not k.startswith('denoiser.')}
    trainer = Trainer(cfg, device='cuda')
    trainer.fit(build_dataset(cfg, split='train'), None, n_epochs=1)
    check_no_launches('pool')
    e = trainer.history[0]
    frozen = dict(trainer.net.named_parameters())
    frozen_equal = all(torch.equal(frozen[k], v) for k, v in start.items())
    ok = (bool(np.isfinite([e['loss'], e['loss_noise']]).all())
          and frozen_equal and trainer.graph_captures == 1
          and e['graph_replays'] == trainer.steps_per_epoch // 4)
    phase('latent_pool', stage='diffusion', k=4,
          steps=trainer.steps_per_epoch,
          graph_replays=e['graph_replays'],
          steps_per_s=f'{trainer.steps_per_epoch / e["train_seconds"]:.2f}',
          loss_noise=f'{e["loss_noise"]:.6f}', frozen_params=len(start),
          frozen_bit_equal=frozen_equal, launches=0, ok=ok, card=repr(card))
    if not ok:
        raise RuntimeError(f'latent_pool: {e}, frozen equal {frozen_equal}')


def latent_phases(data_dir: str, work: str, poses, card: str) -> dict:
    """Phases 27-33, with every launch count set to 0 before them; returns
    this process's counts after them, checked 0 after each path.  The
    CLIs of phase 33 report their own counts, checked 0 there."""
    reset_launches()
    pcfg = latent_cfg('pretrain', data_dir,
                      os.path.join(work, 'latent_pretrain'))
    latent_fit_phase('latent_pretrain', pcfg, card)
    pretrained = os.path.join(pcfg.ckpt_dir, 'best_weights.ckpt')
    dcfg = latent_diffusion_phase(data_dir, work, pretrained, card)
    mcfg = latent_test_cfg(data_dir, dcfg.ckpt_dir)
    model, net, ds, _, _ = latent_main_phase(mcfg, card)
    latent_agree_phase(pcfg, mcfg, data_dir, work, card)
    latent_profile_phase(model, net, ds, mcfg, card)
    latent_serve_phase(mcfg, net, poses, card)
    latent_cli_phase(data_dir, work)
    latent_pool_phase(data_dir, work, pretrained, card)
    return launch_counts()


# ---------------------------------------------------------------------------
# Data parallelism (mocodad_tpu_torch/parallel/): ranks of one process and
# one device each, holding W = 1 or 2 against this process alone
# ---------------------------------------------------------------------------

# each fold row is computed on its own wherever it lands, so the eval
# losses of W ranks should equal one process's bit for bit; held within
# 1e-6 of the largest loss
DIST_EVAL_REL = 1e-6
# train steps at W = 2 against one process on the card: the BatchNorm
# statistics and the gradients are summed in another order, so step 1's
# loss agrees within 1e-5.  Adam's first steps are about lr x sign(g), so
# an element whose gradient is at rounding level (the biases before a
# train-mode BatchNorm, whose true gradient is 0, and a few others) steps
# the other way on one side, and the later losses carry it (step 3 landed
# 1.6e-5 apart on an NVIDIA H100 80GB HBM3 at 700 W, steps 1-2 0): held as
# train_agree holds the card against the CPU, the losses within
# TRAIN_LOSS_RTOL, no parameter further apart than 3 steps each way, the
# mean |diff| within TRAIN_PARAM_MEAN; the largest |diff| of the
# parameters not fed to a BatchNorm, over the largest parameter, printed
DIST_STEP1_RTOL = 1e-5
DIST_STEPS = 3


def dist_eval(model, net, ds, cfg, noise, mesh):
    """The f32 agree pass as one rank of `mesh`: (result, host seconds,
    launch counts), the counts set to 0 just before."""
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_inference(model, net, ds, cfg.batch_size, cfg.seed,
                        mesh.device, noise_fn=noise, mesh=mesh)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, launch_counts()


def rel_to_largest(got: np.ndarray, want: np.ndarray) -> float:
    if got.shape != want.shape:
        return float('inf')
    return float(np.abs(got - want).max() / np.abs(want).max())


def dist1_phase(model, net, ds, cfg, noise, want: dict, work: str,
                card: str) -> dict:
    """Phase 34: this process as a group of one rank over NCCL on cuda:0,
    the f32 agree pass through `run_inference(mesh=...)`; its losses
    against the agree pass's.  Returns B1's launch counts."""
    maybe_initialize('file://' + os.path.join(work, 'dist1'), 1, 0)
    try:
        mesh = make_mesh(devices=['cuda:0'])
        dist_eval(model, net, ds, cfg, noise, mesh)   # NCCL's set-up
        res, seconds, counts = dist_eval(model, net, ds, cfg, noise, mesh)
    finally:
        torch.distributed.destroy_process_group()
    n_batches = -(-len(ds) // cfg.batch_size)
    err = rel_to_largest(res['loss'], want['loss'])
    ok = mesh.backend == 'nccl' and err <= DIST_EVAL_REL
    phase('dist1', ranks=1, backend=mesh.backend, device=str(mesh.device),
          launches=counts['denoiser'], batches=n_batches,
          max_abs_err=float(np.abs(res['loss'] - want['loss']).max()),
          max_rel_to_largest=f'{err:.3e}', bound=DIST_EVAL_REL,
          seconds=f'{seconds:.3f}',
          window_views_per_s=f'{len(ds) / seconds:.1f}', ok=ok,
          card=repr(card))
    if not ok:
        raise RuntimeError(f'dist1: {mesh.backend}, max |diff| / max {err}')
    check_main_launches(counts, 'denoiser', n_batches, 'dist1')
    dist_draws_phase(model, cfg, seconds / n_batches)
    return counts


def dist_draws_phase(model, cfg, batch_s: float) -> None:
    """What drawing at the global batch's size costs a rank: a batch's
    (C, Tc*V, B*S) gaussians (x0 and every chain step but t = 1:
    noise_steps - 1 draws) at the global size, and at a rank's of two,
    timed on the card, beside the measured seconds of a batch."""
    c, tcv = model.num_coords, model.n_frames_corrupt * model.n_joints
    n = cfg.batch_size * model.n_generated_samples
    draws = model.schedule.noise_steps - 1
    g = torch.Generator(device='cuda').manual_seed(0)
    ms = {w: time_ms(lambda: [torch.randn((c, tcv, n // w), generator=g,
                                          device='cuda')
                              for _ in range(draws)]) for w in (1, 2)}
    phase('dist_draws', rows=n, draws_per_batch=draws,
          mbytes_per_batch=f'{4 * c * tcv * n * draws / 1e6:.1f}',
          global_ms_per_batch=f'{ms[1]:.4f}',
          half_ms_per_batch=f'{ms[2]:.4f}',
          global_share_of_batch=f'{ms[1] / (batch_s * 1e3):.5f}',
          extra_share_at_2_ranks=f'{(ms[1] - ms[2]) / (batch_s * 1e3):.5f}')


def dist_rank(job: dict) -> None:
    """One spawned rank of dist2_shared / dist_nccl2, in a group that
    `parallel.spawn` joined: the f32 agree pass over the rank's rows (the
    weights of the main path's checkpoint, the agree pass's noise) and
    DIST_STEPS train steps of `job['tcfg']` at the global batch with
    injected global noise; saves each result, its seconds and the launch
    counts to job['out']/rank<r>.pt."""
    mesh = make_mesh(devices=job['devices'])
    cfg = job['cfg']
    model = M.MoCoDADModel(with_eval_dtype(cfg, 'float32'))
    net = model.build_net()
    net.load_state_dict(load_checkpoint_state_dict(
        os.path.join(cfg.ckpt_dir, cfg.load_ckpt)), strict=True)
    net.to(mesh.device).eval()
    ds = build_dataset(cfg, split=cfg.split)
    noise = device_noise(model.schedule.noise_steps - 1, model.num_coords,
                         model.n_frames_corrupt, model.n_joints)
    dist_eval(model, net, ds, cfg, noise, mesh)      # warm-up
    res, eval_s, counts = dist_eval(model, net, ds, cfg, noise, mesh)

    tcfg = job['tcfg']
    batches = train_batches(tcfg, build_dataset(tcfg, split='train'),
                            DIST_STEPS)
    trainer = Trainer(tcfg, mesh=mesh,
                      noise_fn=lambda step, rows: job['noise'][step])
    trainer.init_state(len(batches))
    losses, step_s = [], []
    for x in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(trainer.train_step(*placed(
            shard_batch(x, mesh), mesh.device))['loss']))
        step_s.append(time.perf_counter() - t0)
    torch.save({'loss': res['loss'], 'eval_seconds': eval_s,
                'launches': counts, 'backend': mesh.backend,
                'device': str(mesh.device), 'train_loss': losses,
                'step_seconds': step_s,
                'params': {k: p.detach().cpu() for k, p in
                           trainer.net.named_parameters()}},
               os.path.join(job['out'], f'rank{mesh.rank}.pt'))


def dist_train_reference(tcfg, noise) -> tuple:
    """DIST_STEPS train steps of one process on the card, on the batches
    and noise the ranks take: (losses, parameters)."""
    batches = train_batches(tcfg, build_dataset(tcfg, split='train'),
                            DIST_STEPS)
    t = Trainer(tcfg, device='cuda', noise_fn=lambda step, rows: noise[step])
    t.init_state(len(batches))
    losses = [float(t.train_step(*placed(x, t.device))['loss'])
              for x in batches]
    return losses, {k: p.detach().cpu() for k, p in t.net.named_parameters()}


def dist2_phase(name: str, devices, cfg, tcfg, want: dict, work: str,
                card: str) -> list:
    """Phase 35 (dist2_shared: two ranks on cuda:0 over gloo) and 37
    (dist_nccl2: on cuda:0 and cuda:1 over NCCL): `dist_rank` spawned on
    each of `devices`; each rank's gathered eval losses against the agree
    pass's, its B1 launches, its train losses against one process's, the
    ranks' parameters against each other (bit for bit) and against one
    process's.  Returns each rank's launch counts."""
    out = os.path.join(work, name)
    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(7)
    b = tcfg.batch_size
    noise = [(torch.from_numpy(rng.integers(1, tcfg.noise_steps, b)),
              torch.from_numpy(rng.standard_normal((b, 2, 3, 17)).astype(
                  np.float32))) for _ in range(DIST_STEPS)]
    t0 = time.perf_counter()
    code = spawn(dist_rank, (dict(devices=devices, cfg=cfg, tcfg=tcfg,
                                  noise=noise, out=out),), len(devices),
                 url='file://' + os.path.join(out, 'rendezvous'),
                 timeout=600)
    seconds = time.perf_counter() - t0
    if code:
        raise RuntimeError(f'{name}: a rank exited with code {code}')
    ranks = [torch.load(os.path.join(out, f'rank{r}.pt'), weights_only=False)
             for r in range(len(devices))]
    want_losses, want_params = dist_train_reference(tcfg, noise)
    n_batches = -(-len(want['loss']) // cfg.batch_size)
    eval_err = max(rel_to_largest(r['loss'], want['loss']) for r in ranks)
    rels = [max(abs(r['train_loss'][i] - c) / abs(c) for r in ranks)
            for i, c in enumerate(want_losses)]
    same = all(torch.equal(ranks[0]['params'][k], r['params'][k])
               for r in ranks[1:] for k in want_params)
    p_max = max(float(p.abs().max()) for p in want_params.values())
    diffs = {k: (ranks[0]['params'][k] - v).abs()
             for k, v in want_params.items()}
    param_max = max(float(d.max()) for d in diffs.values())
    kept = [d for k, d in diffs.items() if not k.endswith(BN_FED_BIASES)]
    param_mean = float(sum(d.sum() for d in kept) /
                       sum(d.numel() for d in kept))
    kept_rel = max(float(d.max()) for d in kept) / p_max
    bound_max = 2 * DIST_STEPS * TRAIN_STEP_MAX * tcfg.opt_lr
    ok = (all(r['backend'] == ('gloo' if len(set(devices)) == 1 else 'nccl')
              for r in ranks)
          and eval_err <= DIST_EVAL_REL and rels[0] <= DIST_STEP1_RTOL
          and max(rels) <= TRAIN_LOSS_RTOL and same
          and param_max <= bound_max and param_mean <= TRAIN_PARAM_MEAN)
    n_views = len(want['loss'])
    eval_s = [r['eval_seconds'] for r in ranks]
    # a step ends when its slower rank ends it
    later_s = sum(max(r['step_seconds'][i] for r in ranks)
                  for i in range(1, DIST_STEPS))
    phase(name, ranks=len(devices), backend=ranks[0]['backend'],
          devices=','.join(r['device'] for r in ranks),
          launches_per_rank=json.dumps([r['launches']['denoiser']
                                        for r in ranks]),
          batches=n_batches, fold_rows_per_launch=cfg.batch_size //
          len(devices) * cfg.n_generated_samples,
          eval_max_abs_err=max(float(np.abs(r['loss'] - want['loss']).max())
                               for r in ranks),
          eval_max_rel_to_largest=f'{eval_err:.3e}', eval_bound=DIST_EVAL_REL,
          eval_seconds=json.dumps([round(x, 3) for x in eval_s]),
          window_views_per_s=f'{n_views / max(eval_s):.1f}',
          train_loss=json.dumps([round(x, 7) for x in ranks[0]['train_loss']]),
          train_loss_one=json.dumps([round(x, 7) for x in want_losses]),
          train_loss_rel=json.dumps([float(f'{x:.3e}') for x in rels]),
          step1_rtol=DIST_STEP1_RTOL, train_loss_rtol=TRAIN_LOSS_RTOL,
          step_seconds=json.dumps([round(x, 4) for x in
                                   ranks[0]['step_seconds']]),
          steps_per_s_after_first=f'{(DIST_STEPS - 1) / later_s:.2f}',
          params_equal_across_ranks=same,
          param_max_abs=f'{param_max:.3e}',
          bound_max=f'{bound_max:.3e}', param_mean_abs=f'{param_mean:.3e}',
          not_bn_fed_max_rel_to_largest=f'{kept_rel:.3e}',
          bound_mean=TRAIN_PARAM_MEAN, seconds=f'{seconds:.1f}', ok=ok,
          card=repr(card))
    if not ok:
        raise RuntimeError(f'{name} disagrees with one process')
    for r, out in enumerate(ranks):
        check_main_launches(out['launches'], 'denoiser', n_batches,
                            f'{name} rank {r}')
    return [r['launches'] for r in ranks]


def dist_cli_phase(config: str, work: str, n_batches: int) -> dict:
    """Phase 36: eval_MoCoDAD_torch.py alone and joined to a group of one
    rank through the MOCODAD_* variables, side by side: the same AUC, B1's
    launches in the joined run; then --n-devices one more than the visible
    GPUs, refused with the JAX package's words.  Returns the joined run's
    counts."""
    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    alone, joined, refused = run_clis(
        ('eval_MoCoDAD_torch.py', '-c', config),
        ('eval_MoCoDAD_torch.py', '-c', config),
        ('eval_MoCoDAD_torch.py', '-c', config, '--n-devices', str(n + 1)),
        envs=[{}, {'MOCODAD_COORDINATOR': 'file://' + os.path.join(
                   work, 'dist_cli'),
                   'MOCODAD_NUM_PROCESSES': '1', 'MOCODAD_PROCESS_ID': '0'},
              {}], check=False)
    seconds = time.perf_counter() - t0
    for o in (alone, joined):
        if o.returncode != 0:
            raise RuntimeError(f'dist_cli: eval exited {o.returncode}: '
                               f'{o.stderr[-2000:]}')
    aucs = [float(o.stdout.split('AUC score: ')[-1].split()[0])
            for o in (alone, joined)]
    words = f'requested {n + 1} devices, have {n}'
    ok = (aucs[0] == aucs[1] and joined.launches == alone.launches
          and 'joined a group as rank 0 of 1' in joined.stderr
          and refused.returncode != 0 and words in refused.stderr)
    phase('dist_cli', auc_alone=f'{aucs[0]:.6f}', auc_joined=f'{aucs[1]:.6f}',
          joined_launches=joined.launches['denoiser'],
          refused_exit=refused.returncode, refused_words=repr(words),
          seconds=f'{seconds:.2f}', ok=ok)
    if not ok:
        raise RuntimeError(f'dist_cli: AUC {aucs}, launches '
                           f'{joined.launches}, refusal '
                           f'{refused.returncode} {refused.stderr[-500:]}')
    check_main_launches(joined.launches, 'denoiser', n_batches, 'dist_cli')
    return joined.launches


def dist_phases(model, net, ds, cfg, noise, want: dict, tcfg, config: str,
                work: str, card: str) -> dict:
    """Phases 34-37; returns each kernel's launches on them."""
    counts = {'dist1': dist1_phase(model, net, ds, cfg, noise, want, work,
                                   card)}
    counts['dist2'] = dist2_phase('dist2_shared', ['cuda:0', 'cuda:0'], cfg,
                                  tcfg, want, work, card)
    counts['dist_cli'] = dist_cli_phase(config, work,
                                        -(-len(ds) // cfg.batch_size))
    if torch.cuda.device_count() >= 2:
        counts['dist_nccl2'] = dist2_phase(
            'dist_nccl2', ['cuda:0', 'cuda:1'], cfg, tcfg, want, work, card)
    else:
        phase('dist_nccl2', skipped='one_gpu',
              count=torch.cuda.device_count())
    return {k: {f'{p}_launches': (c[k] if isinstance(c, dict)
                                  else [r[k] for r in c])
                for p, c in counts.items()} for k in KERNELS}


def bench_phase(card: str) -> dict:
    """Phase 42: bench_torch.py's cells at one rep each; returns B1's
    launches per eval pass by kernel name.  The bench checks its launch
    counts, each eval cell's warm-up pass against the reference dispatch,
    the first graphed group of each training cell against eager steps,
    the graph's replays and every `mfu`, and raises on a failure; this
    phase reads the counts and the readings back from its line, and the
    bfloat16 cell's pass must miss the float32 limits (the control of
    those limits)."""
    out = bench_torch.run_bench(['--reps', '1'])
    cells = out.pop('cells')
    for key in ('fast_profile', 'baseline_measured'):
        out.pop(key)
    out['cells'] = {name: {m: st['median'] for m, st in c['metrics'].items()}
                    for name, c in cells.items()}
    print('[bench] ' + json.dumps(out), flush=True)
    launches = {}
    for name, kernel in (('ubnormal_eval_f32', 'denoiser'),
                         ('ubnormal_eval_bf16', 'denoiser_bf16')):
        c = cells[name]
        launches[kernel] = c['layers']['b1_launches_per_pass']
        phase('bench', cell=name, **{f'{k}_{m}': v for k in
                                     ('reference', 'plain',
                                      'control_at_f32_limits')
                                     for m, v in c['check'].get(k, {}).items()
                                     if m in ('max_rel', 'mean_rel', 'ok')})
        if launches[kernel] != 9 * c['batches'] or not c['check']['ok']:
            raise RuntimeError(f'bench {name}: {c["layers"]}, {c["check"]}')
    if cells['ubnormal_eval_bf16']['check']['control_at_f32_limits']['ok']:
        raise RuntimeError('bench: the bfloat16 pass meets the float32 '
                           'limits, which cannot tell the dtypes apart')
    for name in ('ubnormal_train_f32', 'ubnormal_train_bf16'):
        c = cells[name]
        layers = c['layers']
        phase('bench', cell=name, **{k: v for k, v in c['check'].items()
                                     if not k.startswith(('bound', 'loss_r'))})
        if layers['b1_launches_per_step'] != 0 or \
                layers['graph_captures'] != 1 or \
                layers['graph_replays_per_epoch'] != \
                c['steps_per_epoch'] // c['k'] or \
                layers['replays_per_rep'] != bench_torch.FULL.groups or \
                not c['check']['ok']:
            raise RuntimeError(f'bench {name}: {layers}, {c["check"]}')
    phase('bench', cells=','.join(cells), ok=True, card=repr(card))
    bench_controls_phase(card)
    return launches


# the control of the eval check: B1's output off by 0.3 %, which moves the
# losses about 1 % (on the CPU at the flagship's width)
EPS_FAULT = 1.003


def bench_controls_phase(card: str) -> None:
    """Phase 42's controls: faults planted where the bench's checks must
    see them, at the cells' size on the card.  Eval, at both dtypes: a pass
    with B1's output scaled by EPS_FAULT, through `check_pass`.  Training:
    the first graphed group with the state left unchanged, and with half
    of each batch's mask zeroed, through `group_check`.  Each must read
    not correct."""
    B, size = bench_torch, bench_torch.FULL
    dev = torch.device('cuda')
    with tempfile.TemporaryDirectory(prefix='bench_controls_') as work:
        run = B.Run(dev, size, 1, 0, work)
        for dtype in ('float32', 'bfloat16'):
            cfg = B.eval_config(size, run.data_dir, work, 0, dtype)
            model = M.MoCoDADModel(cfg)
            net = B.seeded_net(run, model)
            noise = device_noise(model.schedule.noise_steps - 1,
                                 model.num_coords, model.n_frames_corrupt,
                                 model.n_joints, dev)
            saved = M.denoise
            M.denoise = lambda x, s, f: saved(x, s, f) * EPS_FAULT
            try:
                res = B.eval_pass(run, model, net, cfg, PoolCache(),
                                  noise)()
            finally:
                M.denoise = saved
            out = B.check_pass(run, model, net, res['loss'], noise,
                               dtype == 'bfloat16')
            phase('bench_control', fault=f'B1 output x {EPS_FAULT}',
                  dtype=dtype, **{f'{k}_{m}': v for k in ('reference',
                                                          'plain')
                                  for m, v in out.get(k, {}).items()
                                  if m in ('max_rel', 'mean_rel', 'ok')},
                  caught=not out['ok'])
            if out['ok']:
                raise RuntimeError(f'bench control: the eval check missed '
                                   f'a fault at {dtype}')
        cfg = B.train_config(size, run.data_dir, work, 0, 'float32')
        ds = B.pool_windows(cfg, size, 0)
        steps = len(ds) // size.batch
        g = torch.Generator(device=dev).manual_seed(0)
        for fault in ('state unchanged', 'half the mask'):
            trainer, ref = Trainer(cfg, device=dev), Trainer(cfg, device=dev)
            trainer.init_state(steps_per_epoch=steps, capturable=True)
            trainer.start_pool(ds.data, size.k)
            ref.init_state(steps_per_epoch=steps)
            ref.start_pool(ds.data, 1)
            r = torch.randint(0, len(ds), (size.k, size.batch), generator=g,
                              device=dev)
            n = size.pool
            rows, trans = (r % n).int(), (r // n).int()
            mask = torch.ones((size.k, size.batch), device=dev)

            def frozen(rows, trans, mask):
                saved = [p.detach().clone() for p in trainer.net.parameters()]
                out = trainer.dispatch(rows, trans, mask)
                with torch.no_grad():
                    for p, v in zip(trainer.net.parameters(), saved):
                        p.copy_(v)
                return out

            half = mask.clone()
            half[:, size.batch // 2:] = 0
            dispatch = frozen if fault == 'state unchanged' else \
                (lambda rows, trans, mask: trainer.dispatch(rows, trans,
                                                            mask * half))
            _, out = B.group_check(trainer, ref, rows, trans, mask,
                                   dispatch=dispatch)
            phase('bench_control', fault=fault, dtype='float32',
                  **{k: v for k, v in out.items()
                     if not k.startswith(('bound', 'loss_r', 'ok'))},
                  caught=not out['ok'])
            if out['ok']:
                raise RuntimeError(f'bench control: the training check '
                                   f'missed {fault!r}')
    phase('bench_control', ok=True, card=repr(card))


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = resolve_device('cuda')
    name = torch.cuda.get_device_name(0)
    card = card_line()
    phase('card', card=repr(card), torch=torch.__version__,
          cuda=torch.version.cuda, count=torch.cuda.device_count())
    peaks = peaks_for(name)
    flops_peak, bf16_peak, _, bytes_peak = peaks

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
                            ('denoiser_f32_mma', P.DENOISER_F32_MMA),
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

    # 4. time and bounds at N = 51,200, the wgmma kernel, the mma.sync
    # kernel and the FMA design in turns: the tensor-core kernels do three
    # TF32 products per float32 product; the FMA design does the
    # function's own on the FMA units
    x, semb = fold_inputs(folded, N_FOLD, g)
    kernel_ms, mma_ms, fma_ms = in_turns(
        lambda: P.DENOISER(x, semb, folded),
        lambda: P.DENOISER_F32_MMA(x, semb, folded),
        lambda: P.DENOISER_F32_FMA(x, semb, folded))
    plain_ms = time_ms(lambda: P.denoise_reference(x, semb, folded))
    flops = denoiser_flops_per_row(folded) * N_FOLD
    io_bytes = 4 * (2 * x.numel() + semb.numel())
    blob32 = P.wg32_plan(folded, dev).blob.numel()
    n_bytes = io_bytes + blob32
    bound_ms, bound_by = b1_bound(folded, N_FOLD, False, blob32, peaks)
    mma_bound_ms, mma_bound_by = b1_bound(
        folded, N_FOLD, False, P.tc32_plan(folded, dev).blob.numel(), peaks)
    plan32 = P.kernel_plan(folded, dev)
    fma_bytes = io_bytes + const_bytes(plan32.mats, plan32.vecs)
    fma_bound_ms, fma_bound_by = bound(flops, fma_bytes, flops_peak,
                                       bytes_peak)
    regs, spills = ptxas_usage(P.DENOISER.source)
    phase('time', n=N_FOLD, kernel_ms=f'{kernel_ms:.4f}',
          mma_f32_ms=f'{mma_ms:.4f}', fma_f32_ms=f'{fma_ms:.4f}',
          plain_ms=f'{plain_ms:.4f}',
          bound_ms=f'{bound_ms:.4f}', bound_by=bound_by,
          bound_share=f'{bound_ms / kernel_ms:.4f}',
          mma_bound_share=f'{mma_bound_ms / mma_ms:.4f}',
          fma_bound_ms=f'{fma_bound_ms:.4f}',
          fma_bound_share=f'{fma_bound_ms / kernel_ms:.4f}',
          fma_f32_bound_share=f'{fma_bound_ms / fma_ms:.4f}',
          wg32_registers=regs, wg32_spill_bytes=spills,
          speedup_over_mma=f'{mma_ms / kernel_ms:.3f}',
          gflop=f'{flops / 1e9:.2f}', mbytes=f'{n_bytes / 1e6:.2f}',
          kernel_tflops=f'{flops / kernel_ms / 1e9:.2f}', card=repr(card))
    serve_times = time_fold_phase(folded, g, peaks, card, N_SERVE)
    # a rank's launches when two ranks split a batch (phases 35, 37)
    shard_times = time_fold_phase(folded, g, peaks, card, N_FOLD // 2)

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

        run = eval_pass(model, net2, ds, cfg, noise)
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
            source=CSRC + 'denoiser_wg_f32.cu', replaces=B1,
            launches=launches, max_abs_err=errs[('denoiser', N_FOLD)],
            ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by)
        entries['denoiser_f32_mma'] = dict(
            dtype='float32', path='yardstick of denoiser, no main path',
            source=CSRC + 'denoiser_tc_f32.cu', replaces=B1,
            launches=counts['denoiser_f32_mma'],
            max_abs_err=errs[('denoiser_f32_mma', N_FOLD)], ms=mma_ms,
            plain_ms=plain_ms, bound_ms=mma_bound_ms, bound_by=mma_bound_by)
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
                ('check_bf16', 'denoiser_bf16_mma',
                 lambda: P.DENOISER_BF16_MMA(xb, semb, folded), b1_plain),
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
        blob16 = P.tc_plan(folded, dev).blob.numel()
        bf16_bytes = 2 * 2 * x.numel() + 4 * semb.numel() + blob16
        b_ms, b_by = b1_bound(folded, N_FOLD, True, blob16, peaks)
        bf_ms, mma_ms, fma_ms = in_turns(
            lambda: P.DENOISER_BF16(xb, semb, folded),
            lambda: P.DENOISER_BF16_MMA(xb, semb, folded),
            lambda: P.DENOISER_BF16_FMA(xb, semb, folded))
        bf_plain = time_ms(lambda: P.denoise_reference(
            xb, semb, folded, compute_dtype=torch.bfloat16))
        regs, spills = ptxas_usage(P.DENOISER_BF16.source)
        phase('time_bf16', n=N_FOLD, kernel_ms=f'{bf_ms:.4f}',
              mma_bf16_ms=f'{mma_ms:.4f}', fma_bf16_ms=f'{fma_ms:.4f}',
              plain_ms=f'{bf_plain:.4f}', bound_ms=f'{b_ms:.4f}',
              bound_by=b_by, bound_share=f'{b_ms / bf_ms:.4f}',
              mma_bound_share=f'{b_ms / mma_ms:.4f}',
              fma_bound_share=f'{b_ms / fma_ms:.4f}',
              wg_registers=regs, wg_spill_bytes=spills,
              mbytes=f'{bf16_bytes / 1e6:.2f}',
              b1_f32_ms=f'{kernel_ms:.4f}',
              kernel_tflops=f'{flops / bf_ms / 1e9:.2f}', card=repr(card))
        entries['denoiser_bf16'] = dict(
            dtype='bfloat16', path='main, eval_dtype bfloat16',
            source=CSRC + 'denoiser_wg.cu', replaces=B1,
            max_abs_err=bf16_errs[('denoiser_bf16', N_FOLD)], ms=bf_ms,
            plain_ms=bf_plain, bound_ms=b_ms, bound_by=b_by)
        entries['denoiser_bf16_mma'] = dict(
            dtype='bfloat16', path='yardstick of denoiser_bf16, no main path',
            source=CSRC + 'denoiser_tc.cu', replaces=B1,
            max_abs_err=bf16_errs[('denoiser_bf16_mma', N_FOLD)], ms=mma_ms,
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
                # B1's mma.sync kernel (3xTF32) and its bound; the
                # function on the FMA units beside it (the FMA design's own
                # bound)
                db_ms, db_by = b1_bound(
                    folded, N_FOLD, False,
                    P.tc32_plan(folded, dev).blob.numel(), peaks)
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
        for key in ('denoiser_bf16_mma', 'denoiser_bf16_fma',
                    'denoiser_grouped_fma', 'denoiser_dma_f32_fma',
                    'denoiser_dma_bf16_fma'):
            entries[key]['launches'] = counts[key]

        # 11. the bfloat16 path through the kernel and the plain version
        run16 = eval_pass(model16, net2, ds, cfg, noise)
        r16_kernel, s16_kernel = run16()
        with plain_denoiser():
            r16_plain, s16_plain = run16()
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
        profile_phase('profile_bf16', run16)

        # 40. both agree passes again with the window pool
        pool_launches = agree_pool_phase(
            ds, cfg, noise, net2, ((model, r_kernel, 'denoiser'),
                                   (model16, r16_kernel, 'denoiser_bf16')),
            card)
        for key, n in pool_launches.items():
            entries[key]['pool_launches'] = n

        # 13-16. training from a fresh model; no train step launches a
        # kernel (counts from 0 before phases 14-16, read after)
        tcfg, train_ds, val_ds, host_run = train_phase(data_dir, work, card)
        reset_launches()
        train_agree_phase(tcfg, train_ds)
        train_profile_phase(tcfg, train_ds, card)
        train_bf16_phase(tcfg, train_ds, card)
        if any(launch_counts().values()):
            raise RuntimeError(f'train steps launched kernels: '
                               f'{launch_counts()}')
        # 38-39. the default training path: the window pool, then K steps
        # per dispatch as one CUDA graph
        pool_run = train_pool_phase(tcfg, train_ds, val_ds, host_run, card)
        graph_launches = train_graph_phase(tcfg, train_ds, val_ds, pool_run,
                                           card)
        entries['denoiser'].update(
            train_pool_val_launches=pool_run['val_launches'],
            train_graph_val_launches=graph_launches)

        # 17-22. B1 at 4 and 6 frames; the other strategies and samplers
        frame_errs = check_frames_phase(g)
        frame_times = time_frames_phase(g, peaks, card)
        concat_launches = concat_phases(cfg, card)
        strategies_phase(ds, card)
        train_phase(data_dir, work, card, name='train_concat', **FRAMES[6])
        rcfg = train_config(data_dir, os.path.join(work, 'train_random_imp'),
                            conditioning_strategy='random_imp',
                            conditioning_indices=3)
        os.makedirs(rcfg.ckpt_dir, exist_ok=True)
        order = F.random_order(torch.Generator().manual_seed(5),
                               rcfg.batch_size, rcfg.seg_len, 3).numpy()
        reset_launches()
        # a fresh model's PReLU slopes and first graph mixes have gradients
        # of 0.3-1 % of the step's largest, sums that cancel: over their
        # own largest, the card's float32 landed 1.2e-2 (a PReLU slope)
        # and 4.7e-3 (p1a's A) from float64, the CPU's 5.0e-3 and 1.4e-3
        # (NVIDIA H100 80GB HBM3, 700.00 W).  So each tensor is held over
        # 2 % of the step's largest gradient at least, as
        # tests/test_torch_train_step.py holds the slopes (GRAD_FLOOR)
        train_agree_phase(rcfg, build_dataset(rcfg, split='train'),
                          name='train_agree_random_imp', steps=1,
                          order=order, grad_floor=2e-2)
        for key in ('denoiser', 'denoiser_f32_mma', 'denoiser_bf16',
                    'denoiser_bf16_mma'):
            ms, plain_ms, b_ms, b_by = frame_times[key]
            entries[key].update(
                t6_path='main_concat / agree_concat_bf16',
                t6_launches=concat_launches.get(key, 0), t6_ms=ms,
                t6_plain_ms=plain_ms, t6_bound_ms=b_ms, t6_bound_by=b_by,
                t6_max_abs_err=frame_errs[(key, 6, N_FOLD)])

        # 23-26. serving: the scorer at both dtypes, its bounds on the
        # card, the checkpoint formats, the serve and predict CLIs
        poses = probe_serve_latency.stream_poses(data_dir)
        for dtype, key in (('float32', 'denoiser'),
                           ('bfloat16', 'denoiser_bf16')):
            entries[key].update(serve_phase(cfg, net, poses, dtype, card),
                                serve_path='serve / serve_bf16',
                                **serve_times[key])
        for key in ('denoiser_f32_mma', 'denoiser_bf16_mma'):
            entries[key].update(serve_times[key])
        serve_bound_phase(cfg, net, poses, card)
        checkpoint_phase(cfg, net, poses[:len(poses) // 4])
        config = cli_config(cfg, work)
        serve_cli_phase(config, poses)
        predict_cli_phase(config, res)

        # 27-33. the latent variant: no kernel on any of its paths
        latent_counts = latent_phases(data_dir, work, poses, card)
        for k in entries:
            entries[k]['latent_launches'] = latent_counts[k]

        # 34-37. data parallelism: the f32 agree pass and the train steps
        # on ranks of one process each
        for k, v in dist_phases(model, net2, ds, cfg, noise, r_kernel, tcfg,
                                config, work, card).items():
            entries[k].update(v, **shard_times.get(k, {}))

        # 42. the bench's cells, one rep each
        for k, n in bench_phase(card).items():
            entries[k]['bench_launches_per_pass'] = n
    finally:
        shutil.rmtree(work, ignore_errors=True)

    phase('total', seconds=f'{time.perf_counter() - t_start:.1f}')
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
