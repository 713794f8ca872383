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

The keys of the JAX Trainer, honoured as it honours them:
- `device_data` (auto/true/false) and `device_data_cap_gb` (4.0): the
  window pool (loop.py:159-188).  Under 'auto' the training windows go to
  the device once per `fit` when they fit under the cap, each step gets
  only its rows' indices, views and mask, and gathers `pool[idx]` on the
  device; validation takes the same pool of its dataset (`run_inference`).
- `steps_per_dispatch` ('auto': 8 with the pool on one rank, else 1;
  loop.py:190-211): groups of K index batches (`_group_batches`).  On the
  card a group is one replay of a CUDA graph of K steps
  (`training/step_graph.py`); on the CPU, K steps in a loop.  The trailing
  batches of an epoch (fewer than K) run one step each.  The trajectory is
  the one of K single steps: each step's draws come from its own seed.
- `profile_dir`: a `torch.profiler` trace of the fit's first epoch and its
  validation on rank 0, written there (loop.py:527-528, :606-608).
- `debug_nans`: after each dispatch the steps' losses and gradients are
  checked, and a non-finite one raises `FloatingPointError` naming the step
  (JAX's `jax_debug_nans`, loop.py:99-100).
- `use_wandb` and `log_model`: the metric means of each epoch mirrored to
  wandb on rank 0, and last.ckpt uploaded as an artifact after each save,
  when wandb imports (loop.py:85-97, :604-605, :619-629); otherwise
  `wandb disabled (...)` on stderr.

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
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
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
from mocodad_tpu_torch.training.inference import (PoolCache, pool_options,
                                                  run_inference,
                                                  use_device_pool)
from mocodad_tpu_torch.training.step_graph import StepGraph
from mocodad_tpu_torch.utils.weights import load_checkpoint_state_dict

# (step, global batch rows) -> (t (B,), eps (B, C, Tc, V)) of the global
# batch, the loss's noise_override
TrainNoiseFn = Callable[[int, int], Tuple[torch.Tensor, torch.Tensor]]

LR_DECAY = 0.99  # per epoch (ref models/mocodad.py:324-334)

# profiler ranges of a train step, read by chip_smoke.py's train_profile:
# views + loss, backward, Adam + EMA
SPANS = ('train_step.forward', 'train_step.backward', 'train_step.optimizer')
# profiler range of an epoch's training pass (chip_smoke.py's train_graph)
EPOCH_SPAN = 'train_epoch'


def monitored_metric_for(cfg: Config) -> Tuple[str, str]:
    """(metric name, mode), mirroring train_MoCoDAD.py:42-50."""
    if cfg.diffusion_on_latent is not None and cfg.stage == 'pretrain':
        return 'pretrain_rec_loss', 'min'
    if cfg.validation:
        return 'AUC', 'max'
    return 'loss_noise', 'min'


def _group_batches(it, k: int):
    """Stack k consecutive index batches into (k, B) arrays; the trailing
    batches (fewer than k at the end of an epoch) pass through one by one
    (mocodad_tpu/training/loop.py:46-57)."""
    buf = []
    for b in it:
        buf.append(b)
        if len(buf) == k:
            yield {key: np.stack([x[key] for x in buf]) for key in buf[0]}
            buf = []
    yield from buf


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
        # during fit(): the training windows on the device (the window
        # pool), and the CUDA graph of a group of steps
        self.pool: Optional[torch.Tensor] = None
        self._graph: Optional[StepGraph] = None
        self.graph_captures = 0
        # capturable Adam's learning rate, a device tensor (graphed fits)
        self._lr: Optional[torch.Tensor] = None
        self._eval_pools = PoolCache()
        self._debug_nans = bool(cfg.extras.get('debug_nans'))
        self._profile_dir = cfg.extras.get('profile_dir')
        # one dict per epoch fit() ran: the logged means, the step, the
        # graph replays, and the train pass's and the validation's seconds
        self.history = []
        self._wandb = None
        if cfg.use_wandb and is_main_process():
            try:
                import wandb
                self._wandb = wandb.init(
                    project=cfg.project_name, group=cfg.group_name,
                    entity=cfg.wandb_entity, name=cfg.dir_name,
                    config=cfg.to_dict())
            except Exception as e:  # not installed, offline, refused
                print(f'wandb disabled ({e})', file=sys.stderr)

    # ---- state ------------------------------------------------------------

    def init_state(self, steps_per_epoch: int,
                   capturable: bool = False) -> None:
        """A fresh network from `cfg.seed` (the global RNG is left as it
        was), with the pretrained transfer in the latent diffusion stage;
        Adam over the trainable parameters (the others stop requiring
        gradients), the EMA copy and step 0.  `capturable`: Adam for a
        CUDA graph, with its learning rate in a device tensor."""
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
        self._lr = (torch.full((), float(self.cfg.opt_lr),
                               device=self.device) if capturable else None)
        self.opt = torch.optim.Adam(
            [p for p in self.net.parameters() if p.requires_grad],
            lr=self.cfg.opt_lr if self._lr is None else self._lr,
            betas=(0.9, 0.999), eps=1e-8, capturable=capturable)
        self.ema = ema_init(self.net) if self.use_ema else None
        self.step = 0
        self.steps_per_epoch = steps_per_epoch
        self._graph = None

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

    def _set_lr(self, step: int) -> None:
        if self._lr is not None:
            self._lr.fill_(self.lr_at(step))
            return
        for group in self.opt.param_groups:
            group['lr'] = self.lr_at(step)

    def _bind_optimizer(self) -> None:
        """After `opt.load_state_dict`, which takes the saved groups'
        settings: this fit's learning-rate holder and capturable flag, and
        each step count where that Adam keeps it (on the device when
        capturable, else on the host)."""
        capturable = self._lr is not None
        for group in self.opt.param_groups:
            group['capturable'] = capturable
            group['lr'] = self._lr if capturable else float(group['lr'])
        for state in self.opt.state.values():
            if 'step' in state:
                state['step'] = (state['step'].to(self.device, torch.float32)
                                 if capturable else state['step'].cpu())

    def state_tensors(self) -> List[torch.Tensor]:
        """Every tensor a step updates in place: the parameters, the
        buffers, the EMA and Adam's state."""
        out = list(self.net.parameters()) + list(self.net.buffers())
        if self.use_ema:
            out += list(self.ema.values())
        for state in self.opt.state.values():
            out += [v for v in state.values() if torch.is_tensor(v)]
        return out

    def _step_noise(self, step: int, rows: int):
        """`noise_fn`'s (t, eps) for `step`, or None after seeding the
        step's generator, whose draws `loss` then makes."""
        noise = (None if self.noise_fn is None else self.noise_fn(
            step, global_rows(rows, self.mesh)))
        if noise is None:
            self._gen.manual_seed(step_seed(self.cfg.seed, step))
        return noise

    def step_draws(self, step: int, rows: int, window: Tuple[int, ...]):
        """What `train_step` at `step` on `rows` windows of shape `window`
        draws, drawn ahead as `loss` would draw it: (the random_imp frame
        order or None, (t, eps))."""
        noise = self._step_noise(step, rows)
        order = (self.model.rank_frame_order(self._gen, rows, self.device,
                                             self.mesh)
                 if self.model.draws_order else None)
        if noise is None:
            noise = self.model.draw_noise(self._gen, rows, window,
                                          self.device, self.mesh)
        return order, noise

    def update(self, data: torch.Tensor, trans: torch.Tensor,
               mask: torch.Tensor, noise=None,
               order: Optional[torch.Tensor] = None
               ) -> Tuple[Dict[str, torch.Tensor], Optional[torch.Tensor]]:
        """The step itself, at the learning rate already set: views, loss
        (draws from the generator as it stands, or `noise` and `order`),
        backward, gradient sum over the ranks, Adam and the EMA; no host
        work, so a CUDA graph can capture it.  Returns the metrics and,
        under debug_nans, whether the loss and every gradient are
        finite."""
        with record_function(SPANS[0]):
            data = apply_affine_batch(data, self.mats, trans.long())
            loss, metrics = self.model.loss(self.net, data, self._gen,
                                            sample_mask=mask,
                                            noise_override=noise,
                                            mesh=self.mesh, order=order)
        with record_function(SPANS[1]):
            # a graph's steps keep their gradients' storage
            self.opt.zero_grad(set_to_none=self._lr is None)
            loss.backward()
            sum_gradients(self.net.parameters(), self.mesh)
            finite = None
            if self._debug_nans:
                finite = torch.cat(
                    [loss.detach().reshape(1)]
                    + [p.grad.reshape(-1) for p in self.net.parameters()
                       if p.grad is not None]).isfinite().all()
        with record_function(SPANS[2]):
            self.opt.step()
            if self.use_ema:
                ema_update(self.ema, self.net)
        return metrics, finite

    @staticmethod
    def _check_finite(finite: Optional[torch.Tensor], first: int) -> None:
        """Raise at the first step of a dispatch (starting at step `first`)
        whose loss or gradients were not finite."""
        if finite is None:
            return
        ok = finite.reshape(-1).cpu()
        if not bool(ok.all()):
            bad = first + int((~ok).nonzero()[0])
            raise FloatingPointError(f'debug_nans: non-finite loss or '
                                     f'gradient at step {bad}')

    def train_step(self, data: torch.Tensor, trans: torch.Tensor,
                   mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One update on a batch of un-transformed windows, their view
        indices and the valid-row mask, all on the device (on a mesh, the
        rank's rows of the global batch)
        (mocodad_tpu/training/loop.py:233-260).  Returns the loss metrics,
        still on the device (on a mesh, the global batch's)."""
        noise = self._step_noise(self.step, data.shape[0])
        self._set_lr(self.step)
        metrics, finite = self.update(data, trans, mask, noise)
        self._check_finite(finite, self.step)
        self.step += 1
        return metrics

    def _replay(self, idx: torch.Tensor, trans: torch.Tensor,
                mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """A group of K steps as one replay of the step graph, with each
        step's draws made ahead from its own seed; the lr is the same for
        the K steps (a group never crosses an epoch)."""
        k, rows = idx.shape
        window = tuple(self.pool.shape[1:])
        draws = [self.step_draws(self.step + j, rows, window)
                 for j in range(k)]
        self._set_lr(self.step)
        metrics, finite = self._graph.replay(idx, trans, mask, draws)
        self._check_finite(finite, self.step)
        self.step += k
        return metrics

    def _dispatch(self, rows: torch.Tensor, trans: torch.Tensor,
                  mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One dispatch of the epoch loop: a host batch's step, a pool
        batch's step (gather on the device), or a group of K pool batches
        (one graph replay on the card, K steps on the CPU).  Returns each
        metric's value per step."""
        if self.pool is None:
            return self.train_step(rows, trans, mask)
        if rows.dim() == 1:
            return self.train_step(self.pool.index_select(0, rows), trans,
                                   mask)
        if self._graph is not None:
            return self._replay(rows, trans, mask)
        steps = [self.train_step(self.pool.index_select(0, i), t, m)
                 for i, t, m in zip(rows, trans, mask)]
        return {k: torch.stack([s[k] for s in steps]) for k in steps[0]}

    def payload(self) -> Dict:
        """The checkpoint dict (`training/checkpoint.py`); the learning
        rate is saved as a number whatever holds it."""
        sd = {k: v.detach().cpu().clone()
              for k, v in self.net.state_dict().items()}
        opt = self.opt.state_dict()
        for group in opt['param_groups']:
            group['lr'] = float(group['lr'])
        out = {'state_dict': sd, 'optimizer_states': [opt],
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
            with torch.no_grad():
                for k, v in self.ema.items():
                    v.copy_(src[k])
        # Adam's state tensors are new objects now: a step graph captured
        # before is stale, and fit() captures again
        self.opt.load_state_dict(raw['optimizer_states'][0])
        self._bind_optimizer()
        self._graph = None
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
                                self.device, with_pose=False, mesh=self.mesh,
                                pools=self._eval_pools,
                                **pool_options(self.cfg))
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

    def _use_device_pool(self, ds: PoseWindows) -> bool:
        """Whether `fit` keeps `ds`'s windows on the device
        (`inference.use_device_pool` on cfg's `device_data` keys)."""
        return use_device_pool(ds, **pool_options(self.cfg))

    def steps_per_dispatch(self, pool_mode: bool) -> int:
        """Train steps per dispatch, from the `steps_per_dispatch` key:
        'auto' is 8 with the window pool on one rank, else 1
        (mocodad_tpu/training/loop.py:190-211)."""
        v = self.cfg.extras.get('steps_per_dispatch', 'auto')
        if v == 'auto':
            return 8 if (pool_mode and self.mesh.world == 1) else 1
        k = int(v)
        if k < 1:
            raise ValueError(f'steps_per_dispatch must be >= 1, got {k}')
        if k > 1 and not pool_mode:
            raise ValueError('steps_per_dispatch > 1 requires the '
                             'device-resident pool (device_data)')
        if k > 1 and self.mesh.world > 1:
            raise ValueError(
                'steps_per_dispatch > 1 is single-process only: grouped '
                '(K, B) batches would need a second-axis global-array '
                'assembly across ranks')
        return k

    def _place(self, b):
        """A loader batch on the device: (rows, trans, mask), where rows
        are the windows, or with the pool their indices ((K, B) for a
        group, which is single-process)."""
        keys = ('idx' if 'idx' in b else 'data', 'trans', 'mask')
        b = {k: b[k] for k in keys}
        if b['trans'].ndim == 1:
            b = shard_batch(b, self.mesh)
        return tuple(to_device(b[k], self.device) for k in keys)

    def _start_profile(self):
        """The profiler of the first epoch on rank 0, when `profile_dir`
        is set (once per trainer, as the JAX loop clears its key)."""
        if not self._profile_dir or not is_main_process():
            return None
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)
        acts = [ProfilerActivity.CPU]
        if self.device.type == 'cuda':
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts,
                       on_trace_ready=tensorboard_trace_handler(
                           self._profile_dir))
        self._profile_dir = None
        prof.start()
        return prof

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
        use_pool = self._use_device_pool(train_ds)
        k = self.steps_per_dispatch(use_pool)
        graphed = k > 1 and self.device.type == 'cuda'
        self.init_state(num_batches(train_ds, cfg.batch_size),
                        capturable=graphed)
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
        if use_pool:
            # every rank holds the whole pool (JAX replicates it)
            self.pool = torch.as_tensor(train_ds.data, device=self.device)
            if main:
                print(f'window pool device-resident '
                      f'({train_ds.data.nbytes / 1e6:.0f} MB, '
                      f'index-only batches)', flush=True)
        if graphed:
            self._graph = StepGraph(self, k, cfg.batch_size)
            self.graph_captures += 1

        # every rank computes the same metrics; rank 0 owns the files
        log_path = (os.path.join(cfg.ckpt_dir, 'metrics.csv') if main
                    else os.devnull)
        prof = self._start_profile()
        try:
            with open(log_path, 'a') as log_f:
                for epoch in range(start_epoch, n_epochs):
                    self._fit_epoch(train_ds, val_ds, epoch, k, log_f, ckpt,
                                    monitor)
                    if prof is not None:
                        prof.stop()
                        prof = None
        finally:
            if prof is not None:
                prof.stop()
            self.pool = self._graph = None
        return self.net

    def _fit_epoch(self, train_ds: PoseWindows,
                   val_ds: Optional[PoseWindows], epoch: int, k: int, log_f,
                   ckpt: TopKCheckpointManager, monitor: str) -> None:
        """One epoch of `fit`: the training pass, the validation, the
        logs, wandb and the checkpoints."""
        cfg = self.cfg
        replays = 0 if self._graph is None else self._graph.replays
        means, seconds = self._train_epoch(train_ds, epoch, k, log_f)
        replays = 0 if self._graph is None else self._graph.replays - replays
        wps = len(train_ds) / seconds if seconds > 0 else 0.0
        t0 = time.perf_counter()
        if val_ds is not None:
            means.update(self.validation_metric(val_ds, epoch))
        val_seconds = time.perf_counter() - t0
        # the decayed lr at the current step (the reference's
        # LearningRateMonitor, ref train_MoCoDAD.py:57-62)
        means['lr'] = self.lr_at(self.step)
        self.history.append(dict(
            means, epoch=epoch, step=self.step, graph_replays=replays,
            train_seconds=seconds, windows_per_s=wps,
            val_seconds=val_seconds))
        log_f.write(f'{epoch},epoch_end,' + ','.join(
            f'{k}={v}' for k, v in means.items()) + '\n')
        log_f.flush()
        if not is_main_process():
            return
        line = ' '.join(f'{k}={v:.5f}' for k, v in means.items())
        print(f'[epoch {epoch}] {line} ({wps:.0f} windows/s)', flush=True)
        if self._wandb is not None:
            self._wandb.log(means, step=self.step)
        value = means.get(monitor)
        if value is not None:
            ckpt.save(self.payload(), epoch, value)
        else:
            ckpt.save_last(self.payload(), epoch)
        if self._wandb is not None and cfg.extras.get('log_model'):
            # the reference's WandbLogger(log_model='all') upload
            # (ref train_MoCoDAD.py:57-62)
            try:
                import wandb
                art = wandb.Artifact(f'model-{cfg.dir_name}', type='model')
                art.add_file(os.path.join(cfg.ckpt_dir, 'last.ckpt'))
                self._wandb.log_artifact(art)
            except Exception as e:  # an upload failure ends no training
                print(f'wandb log_model failed ({e})', file=sys.stderr)

    def _train_epoch(self, ds: PoseWindows, epoch: int, k: int, log_f
                     ) -> Tuple[Dict[str, float], float]:
        """One shuffled pass in dispatches of `k` steps; returns the
        epoch's metric means over every step and its seconds.  A logged
        line is the dispatch's last step (mocodad_tpu/training/
        loop.py:551-580)."""
        cfg = self.cfg
        sums: Dict[str, list] = {}
        t0 = time.perf_counter()
        base = make_loader(ds, cfg.batch_size, shuffle=True,
                           seed=cfg.seed + epoch,
                           yield_indices=self.pool is not None)
        if k > 1:
            base = _group_batches(base, k)
        last_logged = self.step
        with record_function(EPOCH_SPAN):
            for rows, trans, mask in prefetch(base, place=self._place):
                metrics = self._dispatch(rows, trans, mask)
                for name, v in metrics.items():
                    sums.setdefault(name, []).append(v.reshape(-1))
                if self.step - last_logged >= self._log_every:
                    last_logged = self.step
                    vals = {name: float(v.reshape(-1)[-1])
                            for name, v in metrics.items()}
                    if is_main_process():
                        print(f'epoch {epoch} step {self.step}: ' + ' '.join(
                            f'{n}={v:.5f}' for n, v in vals.items()),
                            flush=True)
                    log_f.write(f'{epoch},{self.step},' + ','.join(
                        f'{n}={v}' for n, v in vals.items()) + '\n')
            # reading the means waits for the card: the epoch's time is
            # then its device time too
            means = {name: float(torch.cat(v).mean())
                     for name, v in sums.items()}
        return means, time.perf_counter() - t0
