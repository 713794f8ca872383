"""Checkpoint -> per-window losses: the eval half of the training loop.

Counterpart of `Trainer.run_inference`, `restore_and_infer` and
`export_prediction_tensors` (mocodad_tpu/training/loop.py:327-432,
634-677).  Padded batches carry a mask, the affine views are applied on the
device, and the padding is stripped at the end.  Batches are assembled and
copied to the device by a producer thread one or two batches ahead
(`data/prefetch.py`, as JAX `loop.py:379-391`), and results stay on the
device until the pass ends, so the host does not wait on the card batch
by batch.

With the window pool (`device_data`, as JAX's `run_inference` at
loop.py:366-385), the windows are copied to the device once and each
batch sends only its rows' indices and views; the meta and frame numbers
are gathered on the host in the producer thread.  A `PoolCache` keeps one
dataset's pool across passes (each epoch's validation) and evicts it for
another dataset.

On a data-parallel `mesh` (parallel/), every rank's loader yields the same
global batches; each rank scores its block of rows (B1 at (B/W)*S fold
rows on the card) and at the end of the pass, not batch by batch, the
losses (and poses) are gathered into global order on every rank.  Every
rank holds the whole pool, as JAX replicates it.
`restore_and_infer` is each rank's eval and predict path.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mocodad_tpu_torch.config import Config
from mocodad_tpu_torch.data import (PoseWindows, affine_transform_matrices,
                                    apply_affine_batch, build_dataset,
                                    make_loader, prefetch, to_device,
                                    transformed_gt_data)
from mocodad_tpu_torch.models.mocodad import (MoCoDADModel, MoCoDADNet,
                                              build_model)
from mocodad_tpu_torch.parallel import (all_gather_rows, global_rows,
                                        is_distributed, is_main_process,
                                        make_mesh, shard_batch)
from mocodad_tpu_torch.utils.weights import load_checkpoint_state_dict

# Separates the eval generator's stream from a training stream seeded with
# the same config seed (the JAX package folds the same tag into its key).
EVAL_DOMAIN_TAG = 0x45564C  # 'EVL'

NoiseFn = Callable[[int, int], Tuple[torch.Tensor, torch.Tensor]]

# device_data 'auto' keeps a pool of at most this many GB on the device
# (mocodad_tpu/training/loop.py:187)
POOL_CAP_GB = 4.0


def use_device_pool(ds: PoseWindows, device_data: Any = 'auto',
                    pool_cap_gb: float = POOL_CAP_GB) -> bool:
    """Whether `ds`'s windows go to the device as one pool, from the
    `device_data` key (mocodad_tpu/training/loop.py:159-188): 'auto' when
    the pool is at most `pool_cap_gb` GB, true/false to force.  The old_aug
    path's per-item host-side crops need host batches: with 'auto' it takes
    them, and an explicit true raises."""
    mode = device_data
    if isinstance(mode, str):
        mode = mode.strip().lower()
    truthy = mode in (True, 'true', 'on', 'yes', '1', 1)
    falsy = mode in (False, 'false', 'off', 'no', '0', 0)
    if not (truthy or falsy or mode == 'auto'):
        raise ValueError(f'device_data must be auto/true/false, '
                         f'got {mode!r}')
    if falsy:
        return False
    if ds.old_aug:
        if truthy:
            raise ValueError(
                'device_data: true is incompatible with the old_aug '
                'dataset path (per-item host-side random crops need '
                'materialized batches)')
        return False
    return truthy or ds.data.nbytes <= pool_cap_gb * 1e9


def pool_options(cfg: Config) -> Dict[str, Any]:
    """`run_inference`'s and `use_device_pool`'s pool keywords from cfg's
    `device_data` and `device_data_cap_gb` keys."""
    return {'device_data': cfg.extras.get('device_data', 'auto'),
            'pool_cap_gb': float(cfg.extras.get('device_data_cap_gb',
                                                POOL_CAP_GB))}


class PoolCache:
    """One dataset's window pool on the device at a time, keyed on its
    host buffer by identity (the JAX Trainer's `_eval_pools`, loop.py:80-83,
    :366-378): a pass over the same dataset reuses the pool, and another
    dataset's evicts it.  The cache holds the host buffer, so its id()
    cannot be recycled while the key stands."""

    def __init__(self):
        self._host: Optional[np.ndarray] = None
        self._pool: Optional[torch.Tensor] = None
        self.uploads = 0

    def get(self, data: np.ndarray, device: torch.device) -> torch.Tensor:
        if self._host is not data:
            self._host = self._pool = None     # one pool on the device
            self._pool = torch.as_tensor(data, device=device)
            self._host = data
            self.uploads += 1
        return self._pool


@torch.no_grad()
def run_inference(model: MoCoDADModel, net: MoCoDADNet, ds: PoseWindows,
                  batch_size: int, seed: int, device: torch.device,
                  with_pose: Optional[bool] = None,
                  noise_fn: Optional[NoiseFn] = None,
                  mesh=None, device_data: Any = 'auto',
                  pool_cap_gb: float = POOL_CAP_GB,
                  pools: Optional[PoolCache] = None) -> Dict[str, Any]:
    """Run generation over a dataset once.

    Returns host arrays with padding stripped: {'loss': (N,), 'pose':
    (N, C, Tc, V) or None, 'trans', 'meta', 'frames'}.  `with_pose`
    defaults to whether `model_return_value` needs the selected poses.
    `noise_fn(batch_idx, n_rows) -> (x0, zs)`, when given, supplies each
    batch's gaussians as `generate`'s `noise_override` (n_rows = B*S; the
    latent diffusion stage takes latent-shaped noise, (B*S, D) and
    (n_chain_steps, B*S, D)).  Each batch is scored by
    `model.window_losses`: `generate`, or the latent pretrain stage's
    reconstruction loss.

    On a `mesh`, `device` is the rank's, `noise_fn` gives the global
    batch's gaussians (n_rows = global B*S) and every rank returns the
    whole pass's results.

    `device_data` and `pool_cap_gb` decide whether the windows go to the
    device as one pool (`use_device_pool`); `pools`, when given, keeps
    that pool for the next pass over the same dataset.
    """
    if with_pose is None:
        with_pose = model.model_return_value in ('pose', 'all')
    if with_pose and not model.returns_pose():
        raise ValueError(
            f"model_return_value '{model.model_return_value}' needs selected "
            f"poses, but aggregation strategy "
            f"'{model.aggregation_strategy}' is loss-only")
    folded = model.fold(net)
    mats = torch.as_tensor(affine_transform_matrices(max(ds.num_transform, 1)),
                           device=device)
    rng = torch.Generator(device=device).manual_seed(
        (int(seed) << 24) ^ EVAL_DOMAIN_TAG)
    s = model.n_generated_samples
    keep = ('mask', 'trans', 'meta', 'frames')
    pool = None
    if use_device_pool(ds, device_data, pool_cap_gb):
        pool = (pools or PoolCache()).get(ds.data, device)

    def place(b):
        if pool is None:
            local = shard_batch({k: b[k] for k in ('data', 'trans')}, mesh)
            return ({k: b[k] for k in keep}, to_device(local['data'], device),
                    to_device(local['trans'], device))
        # only the rows' indices and views cross; meta and frames are
        # gathered here, in the producer thread
        host = {'mask': b['mask'], 'trans': b['trans'],
                'meta': ds.meta[b['idx']], 'frames': ds.frames[b['idx']]}
        local = shard_batch({k: b[k] for k in ('idx', 'trans')}, mesh)
        return (host, to_device(local['idx'], device),
                to_device(local['trans'], device))

    pending = []
    for i, (batch, rows, trans) in enumerate(prefetch(
            make_loader(ds, batch_size, yield_indices=pool is not None),
            place=place)):
        data = rows if pool is None else pool.index_select(0, rows)
        data = apply_affine_batch(data, mats, trans.long())
        noise = None if noise_fn is None else noise_fn(
            i, global_rows(data.shape[0], mesh) * s)
        sel, loss = model.window_losses(net, data, rng, noise_override=noise,
                                        folded=folded, mesh=mesh)
        pending.append((loss, sel if with_pose else None, batch))
    if pending and is_distributed(mesh):
        # one gather per pass: (batches, rows of a rank, ...) -> every
        # rank's rows side by side, the global batch's order
        losses = all_gather_rows(torch.stack([p[0] for p in pending]), mesh,
                                 dim=1)
        poses = [None] * len(pending)
        if with_pose:
            poses = all_gather_rows(torch.stack([p[1] for p in pending]),
                                    mesh, dim=1)
        pending = [(l, p, b[2]) for l, p, b in zip(losses, poses, pending)]
    outs: Dict[str, list] = {k: [] for k in
                             ('loss', 'pose', 'trans', 'meta', 'frames')}
    for loss, pose, batch in pending:
        valid = batch['mask'] > 0
        outs['loss'].append(loss.cpu().numpy()[valid])
        if pose is not None:
            outs['pose'].append(pose.cpu().numpy()[valid])
        for k in ('trans', 'meta', 'frames'):
            outs[k].append(batch[k][valid])
    return {k: (np.concatenate(v) if v else None) for k, v in outs.items()}


def restore_and_infer(cfg: Config, device=None,
                      n_devices: Optional[int] = None,
                      with_pose: Optional[bool] = None,
                      noise_fn: Optional[NoiseFn] = None):
    """Build the split's dataset, restore the configured checkpoint and
    run generation over the split (ref eval_MoCoDAD.py:32-38).

    `device=None` means CUDA, and raises without it; pass 'cpu' to run on
    the CPU.  In a process group (or with `n_devices`, through
    `parallel.make_mesh`) this process is one rank of the pass, and every
    rank returns the whole result.  The checkpoint at
    cfg.ckpt_dir/cfg.load_ckpt is a reference-named state dict written by `torch.save`, bare or as
    Lightning's {'state_dict': ...}, or a JAX-package msgpack train state;
    it holds the whole net of the configured model, either stage of the
    latent variant included.  Returns (model, dataset, result) with
    `result` as run_inference returns it.
    """
    mesh = make_mesh(n_devices, device=device)
    dev = mesh.device
    main = is_main_process()
    if main:
        print('Loading data and creating loaders.....')
    ds = build_dataset(cfg, split=cfg.split)
    if main:
        print(f'{cfg.split} windows: {ds.num_samples} '
              f'(x{ds.num_transform} transforms)')
    model = build_model(cfg)
    net = model.build_net()
    sd = load_checkpoint_state_dict(os.path.join(cfg.ckpt_dir, cfg.load_ckpt),
                                    use_ema=cfg.use_ema)
    net.load_state_dict(sd, strict=True)
    net.to(dev).eval()
    res = run_inference(model, net, ds, cfg.batch_size, cfg.seed, dev,
                        with_pose=with_pose, noise_fn=noise_fn, mesh=mesh,
                        **pool_options(cfg))
    return model, ds, res


def export_prediction_tensors(model: MoCoDADModel, ds: PoseWindows,
                              res: Dict[str, Any], cfg: Config) -> str:
    """Write a run_inference result as the reference's saved-tensor cache
    under cfg.ckpt_dir (loop.py:661-677)."""
    from mocodad_tpu_torch.utils.tensors import (pack_prediction_tensors,
                                                 save_tensors)
    tensors = pack_prediction_tensors(
        res, model.model_return_value,
        gt_data=transformed_gt_data(ds.data, ds.num_transform))
    return save_tensors(tensors, cfg.ckpt_dir, cfg.split,
                        cfg.aggregation_strategy, model.n_generated_samples)
