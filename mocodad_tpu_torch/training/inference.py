"""Checkpoint -> per-window losses: the eval half of the training loop.

Counterpart of `Trainer.run_inference`, `restore_and_infer` and
`export_prediction_tensors` (mocodad_tpu/training/loop.py:327-432,
634-677).  Padded batches carry a mask, the affine views are applied on the
device, and the padding is stripped at the end.  Batches are assembled and
copied to the device by a producer thread one or two batches ahead
(`data/prefetch.py`, as JAX `loop.py:379-391`), and results stay on the
device until the pass ends, so the host does not wait on the card batch
by batch.
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
from mocodad_tpu_torch.device import resolve_device
from mocodad_tpu_torch.models.losses import selects_pose
from mocodad_tpu_torch.models.mocodad import (MoCoDADModel, MoCoDADNet,
                                              build_model)
from mocodad_tpu_torch.utils.weights import load_checkpoint_state_dict

# Separates the eval generator's stream from a training stream seeded with
# the same config seed (the JAX package folds the same tag into its key).
EVAL_DOMAIN_TAG = 0x45564C  # 'EVL'

NoiseFn = Callable[[int, int], Tuple[torch.Tensor, torch.Tensor]]


@torch.no_grad()
def run_inference(model: MoCoDADModel, net: MoCoDADNet, ds: PoseWindows,
                  batch_size: int, seed: int, device: torch.device,
                  with_pose: Optional[bool] = None,
                  noise_fn: Optional[NoiseFn] = None) -> Dict[str, Any]:
    """Run generation over a dataset once.

    Returns host arrays with padding stripped: {'loss': (N,), 'pose':
    (N, C, Tc, V) or None, 'trans', 'meta', 'frames'}.  `with_pose`
    defaults to whether `model_return_value` needs the selected poses.
    `noise_fn(batch_idx, n_rows) -> (x0, zs)`, when given, supplies each
    batch's gaussians as `generate`'s `noise_override` (n_rows = B*S).
    """
    if with_pose is None:
        with_pose = model.model_return_value in ('pose', 'all')
    if with_pose and not selects_pose(str(model.aggregation_strategy)):
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
    loader = prefetch(make_loader(ds, batch_size), place=lambda b: (
        {k: b[k] for k in keep}, to_device(b['data'], device),
        to_device(b['trans'], device)))
    pending = []
    for i, (batch, data, trans) in enumerate(loader):
        data = apply_affine_batch(data, mats, trans.long())
        noise = None if noise_fn is None else noise_fn(i, data.shape[0] * s)
        sel, loss = model.generate(net, data, rng, noise_override=noise,
                                   folded=folded)
        pending.append((loss, sel if with_pose else None, batch))
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
                      with_pose: Optional[bool] = None,
                      noise_fn: Optional[NoiseFn] = None):
    """Build the split's dataset, restore the configured checkpoint and
    run generation over the split (ref eval_MoCoDAD.py:32-38).

    `device=None` means CUDA, and raises without it; pass 'cpu' to run on
    the CPU.  The checkpoint at cfg.ckpt_dir/cfg.load_ckpt is a
    reference-named state dict written by `torch.save`, bare or as
    Lightning's {'state_dict': ...}.  Returns (model, dataset, result) with
    `result` as run_inference returns it.
    """
    dev = resolve_device(device)
    print('Loading data and creating loaders.....')
    ds = build_dataset(cfg, split=cfg.split)
    print(f'{cfg.split} windows: {ds.num_samples} '
          f'(x{ds.num_transform} transforms)')
    model = build_model(cfg)
    net = model.build_net()
    sd = load_checkpoint_state_dict(os.path.join(cfg.ckpt_dir, cfg.load_ckpt),
                                    use_ema=cfg.use_ema)
    net.load_state_dict(sd, strict=True)
    net.to(dev).eval()
    res = run_inference(model, net, ds, cfg.batch_size, cfg.seed, dev,
                        with_pose=with_pose, noise_fn=noise_fn)
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
