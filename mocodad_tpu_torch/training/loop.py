"""Training: the port's counterpart of the JAX package's `Trainer.fit`
(mocodad_tpu/training/loop.py:482-631), which replaces the reference's
PyTorch-Lightning Trainer (train_MoCoDAD.py:70-75).

One epoch is a shuffled pass over the (window x view) index space, seeded
`cfg.seed + epoch`; batches are assembled and copied to the card by a
producer thread (`data/prefetch.py`).  A step applies the affine views on
the device, computes `MoCoDADModel.loss` in train mode (flax's BatchNorm
semantics, `nn/stsgcn.FlaxBatchNorm2d`), backpropagates, takes an Adam step
at optax's staircase learning rate, and updates the EMA.  Each epoch ends
with the validation AUC through `run_inference` (on the card, the B1
kernel), the metrics log and the top-2 checkpoints.

Left out of the JAX loop: the device-resident window pool and
`steps_per_dispatch` (loop.py:159-211, :262-283) only amortize TPU
dispatch, so their YAML keys (`device_data`, `device_data_cap_gb`,
`steps_per_dispatch`) are accepted and ignored, as are `use_wandb`
(metrics go to metrics.csv only), `profile_dir` and `debug_nans`; the
latent variant's pretrained transfer and `trainable_mask` are not ported
(`build_model` raises for the latent config).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from mocodad_tpu_torch.config import Config
from mocodad_tpu_torch.data import (PoseWindows, affine_transform_matrices,
                                    apply_affine_batch, make_loader,
                                    num_batches, prefetch, to_device)
from mocodad_tpu_torch.device import resolve_device
from mocodad_tpu_torch.eval.harness import post_processing_from_config
from mocodad_tpu_torch.models.mocodad import MoCoDADNet, build_model
from mocodad_tpu_torch.training.checkpoint import TopKCheckpointManager
from mocodad_tpu_torch.training.ema import ema_init, ema_update
from mocodad_tpu_torch.training.inference import run_inference

# (step, batch rows) -> (t (B,), eps (B, C, Tc, V)), the loss's noise_override
TrainNoiseFn = Callable[[int, int], Tuple[torch.Tensor, torch.Tensor]]

LR_DECAY = 0.99  # per epoch (ref models/mocodad.py:324-334)

# profiler ranges of a train step, read by chip_smoke.py's train_profile:
# views + loss, backward, Adam + EMA
SPANS = ('train_step.forward', 'train_step.backward', 'train_step.optimizer')


def monitored_metric_for(cfg: Config) -> Tuple[str, str]:
    """(metric name, mode), mirroring train_MoCoDAD.py:42-50."""
    if cfg.diffusion_on_latent is not None and cfg.stage == 'pretrain':
        return 'pretrain_rec_loss', 'min'
    if cfg.validation:
        return 'AUC', 'max'
    return 'loss_noise', 'min'


def step_seed(seed: int, step: int) -> int:
    """The seed of one train step's draws: a function of the config seed
    and the step alone, so a resumed run draws what the uninterrupted run
    would have (JAX folds the step into its key the same way)."""
    return (int(seed) << 32) + int(step)


class Trainer:
    """Fits a fresh model (`cfg`'s architecture, initialized from
    `cfg.seed`) on a training set.

    `device=None` means CUDA and raises without it; pass 'cpu' to train on
    the CPU.  `noise_fn(step, batch_rows) -> (t, eps)`, when given,
    replaces each step's draws of the timesteps and the forward noise.
    """

    def __init__(self, cfg: Config, device=None,
                 noise_fn: Optional[TrainNoiseFn] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg)
        self.noise_fn = noise_fn
        self.mats = torch.as_tensor(
            affine_transform_matrices(max(cfg.num_transform, 1)),
            device=self.device)
        self.use_ema = bool(cfg.use_ema)
        self._log_every = int(cfg.extras.get('log_every_n_steps', 20))
        self._gen = torch.Generator(device=self.device)
        self.net: Optional[MoCoDADNet] = None
        self.opt: Optional[torch.optim.Adam] = None
        self.ema: Optional[Dict[str, torch.Tensor]] = None
        self.step = 0
        self.steps_per_epoch = 1
        # one dict per epoch fit() ran: the logged means, the step, and the
        # train pass's and the validation's seconds
        self.history = []
        if cfg.use_wandb:
            print('wandb disabled (the port logs to metrics.csv only)',
                  file=sys.stderr)

    # ---- state ------------------------------------------------------------

    def init_state(self, steps_per_epoch: int) -> None:
        """A fresh network from `cfg.seed` (the global RNG is left as it
        was), Adam, the EMA copy and step 0."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.cfg.seed)
            net = self.model.build_net()
        self.net = net.to(self.device).train()
        self.opt = torch.optim.Adam(self.net.parameters(),
                                    lr=self.cfg.opt_lr, betas=(0.9, 0.999),
                                    eps=1e-8)
        self.ema = ema_init(self.net) if self.use_ema else None
        self.step = 0
        self.steps_per_epoch = steps_per_epoch

    def lr_at(self, step: int) -> float:
        """optax.exponential_decay(opt_lr, steps_per_epoch, 0.99,
        staircase=True) at `step` updates already applied
        (mocodad_tpu/training/loop.py:104-110)."""
        return self.cfg.opt_lr * LR_DECAY ** (step // self.steps_per_epoch)

    def train_step(self, data: torch.Tensor, trans: torch.Tensor,
                   mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One update on a batch of un-transformed windows, their view
        indices and the valid-row mask, all on the device
        (mocodad_tpu/training/loop.py:233-260).  Returns the loss metrics,
        still on the device."""
        with record_function(SPANS[0]):
            data = apply_affine_batch(data, self.mats, trans.long())
            noise = (None if self.noise_fn is None
                     else self.noise_fn(self.step, data.shape[0]))
            if noise is None:
                self._gen.manual_seed(step_seed(self.cfg.seed, self.step))
            loss, metrics = self.model.loss(self.net, data, self._gen,
                                            sample_mask=mask,
                                            noise_override=noise)
        with record_function(SPANS[1]):
            self.opt.zero_grad(set_to_none=True)
            loss.backward()
        with record_function(SPANS[2]):
            for group in self.opt.param_groups:
                group['lr'] = self.lr_at(self.step)
            self.opt.step()
            if self.use_ema:
                ema_update(self.ema, self.net)
        self.step += 1
        return metrics

    def payload(self) -> Dict:
        """The checkpoint dict (`training/checkpoint.py`)."""
        sd = {k: v.detach().cpu().clone()
              for k, v in self.net.state_dict().items()}
        out = {'state_dict': sd, 'optimizer_states': [self.opt.state_dict()],
               'step': self.step}
        if self.use_ema:
            out['state_dict_ema'] = {**sd, **{k: v.cpu().clone()
                                              for k, v in self.ema.items()}}
        return out

    def restore_state(self, path: str) -> int:
        """Load network, EMA, Adam state and step from a checkpoint this
        trainer wrote; return the epoch to continue at: the sidecar's
        epoch + 1, or derived from the step when the sidecar is lost
        (mocodad_tpu/training/loop.py:447-480)."""
        raw = torch.load(path, map_location=self.device, weights_only=False)
        self.net.load_state_dict(raw['state_dict'], strict=True)
        if self.use_ema:
            src = raw.get('state_dict_ema') or raw['state_dict']
            self.ema = {k: src[k].to(self.device).clone() for k in self.ema}
        self.opt.load_state_dict(raw['optimizer_states'][0])
        self.step = int(raw['step'])
        if os.path.exists(path + '.json'):
            with open(path + '.json') as f:
                return int(json.load(f).get('epoch', -1)) + 1
        epoch = self.step // self.steps_per_epoch - 1
        print(f'WARNING: {path}.json missing; resuming at epoch {epoch + 1} '
              f'derived from step {self.step}', file=sys.stderr)
        return epoch + 1

    # ---- validation -------------------------------------------------------

    @torch.no_grad()
    def validation_metric(self, ds: PoseWindows, epoch: int
                          ) -> Dict[str, float]:
        """The frame-level AUC on `ds`, generated with the EMA parameters
        (or the live ones) and the live BatchNorm statistics
        (mocodad_tpu/training/loop.py:440-445, :584-591).  `run_inference`
        folds the weights it is given, so each epoch's weights are
        refolded; the net is back in train mode, with its live parameters,
        on return."""
        net, live = self.net, None
        if self.use_ema:
            live = {k: p.detach().clone() for k, p in net.named_parameters()}
            for k, p in net.named_parameters():
                p.copy_(self.ema[k])
        net.eval()
        try:
            res = run_inference(self.model, net, ds, self.cfg.batch_size,
                                (1 << 30) + self.cfg.seed + epoch,
                                self.device, with_pose=False)
        finally:
            if live is not None:
                for k, p in net.named_parameters():
                    p.copy_(live[k])
            net.train()
        auc = post_processing_from_config(res['loss'], res['trans'],
                                          res['meta'], res['frames'],
                                          self.cfg)
        return {'AUC': float(auc)}

    # ---- the loop ---------------------------------------------------------

    def _place(self, b):
        dev = self.device
        return (to_device(b['data'], dev), to_device(b['trans'], dev),
                to_device(b['mask'], dev))

    def fit(self, train_ds: PoseWindows,
            val_ds: Optional[PoseWindows] = None,
            n_epochs: Optional[int] = None,
            resume: Optional[str] = None) -> MoCoDADNet:
        """Train for `n_epochs` (default cfg.n_epochs) from a fresh model,
        or from `resume` ('auto' or True: ckpt_dir/last.ckpt); returns the
        network.  Writes metrics.csv, last.ckpt, the top-2 by the
        monitored metric and best_weights.ckpt under cfg.ckpt_dir."""
        cfg = self.cfg
        n_epochs = n_epochs if n_epochs is not None else cfg.n_epochs
        self.init_state(num_batches(train_ds, cfg.batch_size))
        start_epoch = 0
        if resume:
            if resume is True or resume == 'auto':
                resume = os.path.join(cfg.ckpt_dir, 'last.ckpt')
            start_epoch = self.restore_state(resume)
            print(f'resumed from {resume} at epoch {start_epoch} '
                  f'(step {self.step})', flush=True)
        monitor, mode = monitored_metric_for(cfg)
        ckpt = TopKCheckpointManager(cfg.ckpt_dir, monitor, mode, k=2)
        if resume:
            ckpt.restore_index()

        with open(os.path.join(cfg.ckpt_dir, 'metrics.csv'), 'a') as log_f:
            for epoch in range(start_epoch, n_epochs):
                means, seconds = self._train_epoch(train_ds, epoch, log_f)
                wps = len(train_ds) / seconds if seconds > 0 else 0.0
                t0 = time.perf_counter()
                if val_ds is not None:
                    means.update(self.validation_metric(val_ds, epoch))
                val_seconds = time.perf_counter() - t0
                # the decayed lr at the current step (the reference's
                # LearningRateMonitor, ref train_MoCoDAD.py:57-62)
                means['lr'] = self.lr_at(self.step)
                self.history.append(dict(
                    means, epoch=epoch, step=self.step,
                    train_seconds=seconds, windows_per_s=wps,
                    val_seconds=val_seconds))
                line = ' '.join(f'{k}={v:.5f}' for k, v in means.items())
                print(f'[epoch {epoch}] {line} ({wps:.0f} windows/s)',
                      flush=True)
                log_f.write(f'{epoch},epoch_end,' + ','.join(
                    f'{k}={v}' for k, v in means.items()) + '\n')
                log_f.flush()
                value = means.get(monitor)
                if value is not None:
                    ckpt.save(self.payload(), epoch, value)
                else:
                    ckpt.save_last(self.payload(), epoch)
        return self.net

    def _train_epoch(self, ds: PoseWindows, epoch: int, log_f
                     ) -> Tuple[Dict[str, float], float]:
        """One shuffled pass; returns the epoch's metric means and its
        seconds."""
        cfg = self.cfg
        sums: Dict[str, list] = {}
        t0 = time.perf_counter()
        loader = prefetch(make_loader(ds, cfg.batch_size, shuffle=True,
                                      seed=cfg.seed + epoch),
                          place=self._place)
        last_logged = self.step
        for data, trans, mask in loader:
            metrics = self.train_step(data, trans, mask)
            for k, v in metrics.items():
                sums.setdefault(k, []).append(v)
            if self.step - last_logged >= self._log_every:
                last_logged = self.step
                vals = {k: float(v) for k, v in metrics.items()}
                print(f'epoch {epoch} step {self.step}: ' + ' '.join(
                    f'{k}={v:.5f}' for k, v in vals.items()), flush=True)
                log_f.write(f'{epoch},{self.step},' + ','.join(
                    f'{k}={v}' for k, v in vals.items()) + '\n')
        # reading the means waits for the card: the epoch's time is then
        # its device time too
        means = {k: float(torch.stack(v).mean()) for k, v in sums.items()}
        return means, time.perf_counter() - t0
