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
(metrics go to metrics.csv only), `profile_dir` and `debug_nans`.

Data parallelism (`mesh`, parallel/): each rank is a process with its
own device; every rank's loader yields the same seeded global batch and
the rank keeps its block of rows (`shard_batch`).  The step draws the
global batch's noise and keeps its rows, the BatchNorms take global
statistics (`nn.stsgcn.sync_batch_norms`), the loss is the rank's share
of the global mean, and the gradients are summed over the ranks in one
collective before Adam, so the parameters, Adam's moments and the EMA
stay the same on every rank (rank 0's are broadcast after init and
restore).  Validation scores each rank's rows and gathers them.  Rank 0
alone writes metrics.csv and the checkpoints and prints the epoch lines
(mocodad_tpu/training/loop.py:520-525, :611).

The latent variant trains in two stages.  Stage 'pretrain' monitors the
validation reconstruction loss (`pretrain_rec_loss`).  Stage 'diffusion'
starts from `pretrained_model_ckpt_path` (any checkpoint format), whose
parameters and BatchNorm statistics are copied wherever name and shape
match (`checkpoint.merge_matching`, loop.py:141-155), and trains the
denoiser alone: the JAX step zeroes the other parameters' Adam updates
(loop.py:243-249), and Adam is elementwise, so Adam over the denoiser's
parameters takes the same steps.  The frozen modules keep train mode, so
their BatchNorm running statistics move as JAX's mutated `batch_stats` do.
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
from mocodad_tpu_torch.eval.harness import post_processing_from_config
from mocodad_tpu_torch.models.mocodad import MoCoDADNet, build_model
from mocodad_tpu_torch.nn.stsgcn import sync_batch_norms
from mocodad_tpu_torch.parallel import (barrier, global_rows,
                                        is_main_process, make_mesh,
                                        replicate, shard_batch,
                                        sum_gradients)
from mocodad_tpu_torch.training.checkpoint import (TopKCheckpointManager,
                                                   merge_matching)
from mocodad_tpu_torch.training.ema import ema_init, ema_update
from mocodad_tpu_torch.training.inference import run_inference
from mocodad_tpu_torch.utils.weights import load_checkpoint_state_dict

# (step, global batch rows) -> (t (B,), eps (B, C, Tc, V)) of the global
# batch, the loss's noise_override
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
    the CPU.  `mesh` (or `n_devices`, through `parallel.make_mesh`) makes
    this trainer one rank of a data-parallel run; by default a process in
    a group is a rank of it and a process alone trains alone.
    `noise_fn(step, batch_rows) -> (t, eps)`, when given, replaces each
    step's draws of the timesteps and the forward noise, at the global
    batch's rows.
    """

    def __init__(self, cfg: Config, device=None, mesh=None,
                 n_devices: Optional[int] = None,
                 noise_fn: Optional[TrainNoiseFn] = None):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh(n_devices,
                                                            device=device)
        self.device = self.mesh.device
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
        was), with the pretrained transfer in the latent diffusion stage;
        Adam over the trainable parameters (the others stop requiring
        gradients), the EMA copy and step 0."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.cfg.seed)
            net = self.model.build_net()
        if self.model.needs_pretrained:
            self._load_pretrained_into(net)
        self.net = net.to(self.device).train()
        sync_batch_norms(self.net, self.mesh)
        replicate(self.net, self.mesh)
        mask = self.model.trainable_mask(self.net)
        for k, p in self.net.named_parameters():
            p.requires_grad_(mask[k])
        self.opt = torch.optim.Adam(
            [p for p in self.net.parameters() if p.requires_grad],
            lr=self.cfg.opt_lr, betas=(0.9, 0.999), eps=1e-8)
        self.ema = ema_init(self.net) if self.use_ema else None
        self.step = 0
        self.steps_per_epoch = steps_per_epoch

    def _load_pretrained_into(self, net: MoCoDADNet) -> None:
        """Copy the parameters AND BatchNorm running statistics of
        `pretrained_model_ckpt_path` into `net` wherever name and shape
        match (mocodad_tpu/training/loop.py:141-155): without the
        statistics the frozen encoder would normalize with mean 0, var 1."""
        path = self.cfg.pretrained_model_ckpt_path
        if not path:
            raise ValueError('Pretrained model checkpoint path not specified')
        barrier()   # rank 0 may have written it
        src = load_checkpoint_state_dict(path)
        net.load_state_dict(merge_matching(net.state_dict(), src),
                            strict=True)

    def lr_at(self, step: int) -> float:
        """optax.exponential_decay(opt_lr, steps_per_epoch, 0.99,
        staircase=True) at `step` updates already applied
        (mocodad_tpu/training/loop.py:104-110)."""
        return self.cfg.opt_lr * LR_DECAY ** (step // self.steps_per_epoch)

    def train_step(self, data: torch.Tensor, trans: torch.Tensor,
                   mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One update on a batch of un-transformed windows, their view
        indices and the valid-row mask, all on the device (on a mesh, the
        rank's rows of the global batch)
        (mocodad_tpu/training/loop.py:233-260).  Returns the loss metrics,
        still on the device (on a mesh, the global batch's)."""
        with record_function(SPANS[0]):
            data = apply_affine_batch(data, self.mats, trans.long())
            noise = (None if self.noise_fn is None else self.noise_fn(
                self.step, global_rows(data.shape[0], self.mesh)))
            if noise is None:
                self._gen.manual_seed(step_seed(self.cfg.seed, self.step))
            loss, metrics = self.model.loss(self.net, data, self._gen,
                                            sample_mask=mask,
                                            noise_override=noise,
                                            mesh=self.mesh)
        with record_function(SPANS[1]):
            self.opt.zero_grad(set_to_none=True)
            loss.backward()
            sum_gradients(self.net.parameters(), self.mesh)
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
        barrier()   # rank 0 may have written it
        raw = torch.load(path, map_location=self.device, weights_only=False)
        self.net.load_state_dict(raw['state_dict'], strict=True)
        replicate(self.net, self.mesh)
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
        """The frame-level AUC on `ds`, or in the latent pretrain stage the
        mean reconstruction loss (`pretrain_rec_loss`), generated with the
        EMA parameters (or the live ones) and the live BatchNorm statistics
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
                                self.device, with_pose=False, mesh=self.mesh)
        finally:
            if live is not None:
                for k, p in net.named_parameters():
                    p.copy_(live[k])
            net.train()
        metric, _ = monitored_metric_for(self.cfg)
        if metric == 'pretrain_rec_loss':
            return {metric: float(res['loss'].mean())}
        auc = post_processing_from_config(res['loss'], res['trans'],
                                          res['meta'], res['frames'],
                                          self.cfg)
        return {'AUC': float(auc)}

    # ---- the loop ---------------------------------------------------------

    def _place(self, b):
        dev = self.device
        b = shard_batch({k: b[k] for k in ('data', 'trans', 'mask')},
                        self.mesh)
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
        main = is_main_process()
        if resume:
            if resume is True or resume == 'auto':
                resume = os.path.join(cfg.ckpt_dir, 'last.ckpt')
            start_epoch = self.restore_state(resume)
            if main:
                print(f'resumed from {resume} at epoch {start_epoch} '
                      f'(step {self.step})', flush=True)
        monitor, mode = monitored_metric_for(cfg)
        ckpt = TopKCheckpointManager(cfg.ckpt_dir, monitor, mode, k=2)
        if resume:
            ckpt.restore_index()

        # every rank computes the same metrics; rank 0 owns the files
        log_path = (os.path.join(cfg.ckpt_dir, 'metrics.csv') if main
                    else os.devnull)
        with open(log_path, 'a') as log_f:
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
                log_f.write(f'{epoch},epoch_end,' + ','.join(
                    f'{k}={v}' for k, v in means.items()) + '\n')
                log_f.flush()
                if not main:
                    continue
                line = ' '.join(f'{k}={v:.5f}' for k, v in means.items())
                print(f'[epoch {epoch}] {line} ({wps:.0f} windows/s)',
                      flush=True)
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
                if is_main_process():
                    print(f'epoch {epoch} step {self.step}: ' + ' '.join(
                        f'{k}={v:.5f}' for k, v in vals.items()), flush=True)
                log_f.write(f'{epoch},{self.step},' + ','.join(
                    f'{k}={v}' for k, v in vals.items()) + '\n')
        # reading the means waits for the card: the epoch's time is then
        # its device time too
        means = {k: float(torch.stack(v).mean()) for k, v in sums.items()}
        return means, time.perf_counter() - t0
