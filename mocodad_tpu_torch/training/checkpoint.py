"""Checkpoints with top-k retention by a monitored metric.

Counterpart of `TopKCheckpointManager` (mocodad_tpu/training/checkpoint.py:
93-160), which replaces Lightning's ModelCheckpoint(save_top_k=2,
monitor=...).  A checkpoint is the port's own `torch.save` dict, laid out
so that the port's eval reads it (`utils/weights.load_checkpoint_state_dict`):

    'state_dict'        the network's state dict, reference key names
    'state_dict_ema'    the same with the EMA parameters (when use_ema)
    'optimizer_states'  [the Adam state dict], for resume
    'step'              updates applied so far, for resume

and a `.json` sidecar with the epoch (and the monitored value).  The JAX
package's own checkpoints are flax msgpack train states; `load_state_dict`
reads one as a nested dict (mocodad_tpu/training/checkpoint.py:55-67),
without flax, and `is_torch_checkpoint` tells the two formats apart; both
live in `utils/weights.py` beside the format dispatch and are re-exported
here under the JAX module's names.  `merge_matching` is the latent
variant's transfer of a pretrained checkpoint (the reference's
load_state_dict(strict=False), ref mocodad_latent.py:223-228).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional

import torch

# the JAX module's names for the format check and the msgpack reader
from mocodad_tpu_torch.utils.weights import (  # noqa: F401
    is_torch_checkpoint, load_state_dict)


def merge_matching(target: Mapping[str, torch.Tensor],
                   source: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """`target` (a state dict) with each entry replaced by `source`'s where
    both the key and the shape match (mocodad_tpu/training/checkpoint.py:
    37-52).  `load_state_dict(strict=False)` would raise on a shape
    mismatch; here the target's tensor stays."""
    out = dict(target)
    for k, v in target.items():
        src = source.get(k)
        if src is not None and tuple(src.shape) == tuple(v.shape):
            out[k] = torch.as_tensor(src).to(v.dtype)
    return out


def save_checkpoint(path: str, payload: Dict[str, Any],
                    meta: Optional[Dict] = None) -> None:
    torch.save(payload, path)
    if meta is not None:
        with open(path + '.json', 'w') as f:
            json.dump(meta, f)


class TopKCheckpointManager:
    """Keep the best k checkpoints by a monitored metric, plus 'last.ckpt'.

    Files are named epoch=N-<metric>=V.ckpt, as Lightning names them;
    'best_weights.ckpt' is a copy of the current best (the load_ckpt name
    of the shipped test configs), and 'topk.json' indexes the kept files
    so a resumed run keeps the same retention.
    """

    def __init__(self, ckpt_dir: str, monitor: str, mode: str = 'min',
                 k: int = 2):
        if mode not in ('min', 'max'):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.ckpt_dir = ckpt_dir
        self.monitor = monitor
        self.mode = mode
        self.k = k
        self.entries = []  # (value, path), best first
        os.makedirs(ckpt_dir, exist_ok=True)

    def restore_index(self) -> None:
        """Reload the bookkeeping a previous run wrote, when it monitored
        the same metric the same way."""
        path = os.path.join(self.ckpt_dir, 'topk.json')
        if not os.path.exists(path):
            return
        with open(path) as f:
            idx = json.load(f)
        if idx.get('monitor') != self.monitor or idx.get('mode') != self.mode:
            return
        self.entries = [(float(v), os.path.join(self.ckpt_dir, name))
                        for v, name in idx.get('entries', [])
                        if os.path.exists(os.path.join(self.ckpt_dir, name))]

    @property
    def best(self) -> Optional[float]:
        return self.entries[0][0] if self.entries else None

    def save_last(self, payload: Dict[str, Any], epoch: int) -> None:
        save_checkpoint(os.path.join(self.ckpt_dir, 'last.ckpt'), payload,
                        {'epoch': epoch})

    def save(self, payload: Dict[str, Any], epoch: int, value: float) -> str:
        name = f'epoch={epoch}-{self.monitor}={value:.6f}.ckpt'
        path = os.path.join(self.ckpt_dir, name)
        meta = {'epoch': epoch, self.monitor: value, 'monitor': self.monitor}
        save_checkpoint(os.path.join(self.ckpt_dir, 'last.ckpt'), payload,
                        meta)
        self.entries.append((value, path))
        self.entries.sort(key=lambda e: e[0], reverse=(self.mode == 'max'))
        if (value, path) in self.entries[:self.k]:
            save_checkpoint(path, payload, meta)
            if self.entries[0][1] == path:
                save_checkpoint(os.path.join(self.ckpt_dir,
                                             'best_weights.ckpt'),
                                payload, meta)
        for _, stale in self.entries[self.k:]:
            for f in (stale, stale + '.json'):
                if os.path.exists(f):
                    os.remove(f)
        self.entries = self.entries[:self.k]
        with open(os.path.join(self.ckpt_dir, 'topk.json'), 'w') as f:
            json.dump({'monitor': self.monitor, 'mode': self.mode,
                       'entries': [[v, os.path.basename(p)]
                                   for v, p in self.entries]}, f)
        return path
