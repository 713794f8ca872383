"""Saved-tensor cache: export eval outputs, replay scoring without the model.

Counterpart of MoCoDAD._save_tensors/_load_tensors/test_on_saved_tensors
(ref: models/mocodad.py:433-448, 583-603, 689-705) and predict_MoCoDAD.py.
Arrays are stored as .npy; .pt files written by the reference are also
readable (torch is an optional runtime dependency for that path only).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

TENSOR_NAMES = ['prediction', 'gt_data', 'trans', 'metadata', 'frames']


def tensors_dir(ckpt_dir: str, split: str, aggr_strategy: str,
                n_gen: int) -> str:
    return os.path.join(ckpt_dir,
                        f'saved_tensors_{split}_{aggr_strategy}_{n_gen}')


def save_tensors(tensors: Dict[str, np.ndarray], ckpt_dir: str, split: str,
                 aggr_strategy: str, n_gen: int) -> str:
    path = tensors_dir(ckpt_dir, split, aggr_strategy, n_gen)
    os.makedirs(path, exist_ok=True)
    # remove stale side tensors from a previous run with a different
    # model_return_value (e.g. a leftover loss.npy would otherwise win
    # over a fresh prediction at replay time and poison the AUC)
    for name in set(TENSOR_NAMES + ['loss', 'pose']) - set(tensors):
        stale = os.path.join(path, name + '.npy')
        if os.path.exists(stale):
            os.remove(stale)
    for name, arr in tensors.items():
        np.save(os.path.join(path, name + '.npy'), np.asarray(arr))
    return path


def pack_prediction_tensors(res: Dict[str, np.ndarray],
                            model_return_value: str,
                            gt_data: np.ndarray) -> Dict[str, np.ndarray]:
    """Assemble the saved-tensor dict for a `Trainer.run_inference` result
    according to `model_return_value` (ref `_pack_out_data`,
    models/mocodad.py:606-636):

    - 'loss': prediction = per-window losses (the reference contract);
    - 'pose': prediction = selected poses, plus a separate 'loss' tensor so
      replay scoring keeps working (the reference would score the pose
      tensor and produce garbage AUC);
    - 'all': prediction = losses, plus a separate 'pose' tensor (the
      reference's 6-field pack breaks its own 5-field unpack,
      utils/model_utils.py:110-137 — documented fix).
    """
    out = {'prediction': res['loss'], 'gt_data': gt_data,
           'trans': res['trans'], 'metadata': res['meta'],
           'frames': res['frames']}
    if model_return_value == 'pose':
        if res.get('pose') is None:
            raise ValueError("model_return_value 'pose' requires selected "
                             'poses from run_inference')
        out['prediction'] = res['pose']
        out['loss'] = res['loss']
    elif model_return_value == 'all':
        if res.get('pose') is None:
            raise ValueError("model_return_value 'all' requires selected "
                             'poses from run_inference')
        out['pose'] = res['pose']
    return out


def load_tensors(ckpt_dir: str, split: str, aggr_strategy: str,
                 n_gen: int) -> Dict[str, np.ndarray]:
    path = tensors_dir(ckpt_dir, split, aggr_strategy, n_gen)
    if not os.path.isdir(path):
        # the `_{n_gen}` suffix comes from effective_n_generated_samples:
        # adding `eval_profile: fast` (or changing fast_profile_samples /
        # n_generated_samples) after exporting a cache resolves to a
        # DIFFERENT directory — say so, instead of a bare missing-file
        raise FileNotFoundError(
            f'saved-tensor cache not found: {path}\n'
            f'The trailing _{n_gen} is the effective sample count — '
            "'eval_profile: fast' / 'fast_profile_samples' / "
            "'n_generated_samples' all change it, so a cache exported "
            'under different sampling settings lives in a differently '
            'named directory. Re-export with the current config '
            '(save_tensors: true) or match the settings the cache was '
            'exported under.')
    out: Dict[str, np.ndarray] = {}
    for fname in os.listdir(path):
        name, ext = os.path.splitext(fname)
        full = os.path.join(path, fname)
        if ext == '.npy':
            out[name] = np.load(full)
        elif ext == '.pt':  # reference-written caches
            import torch
            out[name] = torch.load(full, map_location='cpu').numpy()
    if not out:
        raise FileNotFoundError(f'no tensors found in {path}')
    return out
