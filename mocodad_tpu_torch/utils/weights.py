"""Weights carried across: the JAX package's variables tree and reference
(PyTorch Lightning) checkpoints, as the state dict of the port's
`MoCoDADNet`.

`state_dict_from_jax` is this package's own copy of the export logic in
`mocodad_tpu/utils/torch_compat.py:237-327`, for the modules of the eval
slice (the U-Net, its joint mixes and the AE/E condition encoders).  It
takes the variables tree as nested dicts of NumPy arrays and emits the
reference key names, e.g.

    model.st_gcnnsp1a.0.gcn.A     model.st_gcnnsd1.1.tcn.0.weight
    model.down1.block.0.weight    condition_encoder.encoder.model_layers.0...

Layout conversions: a dense (in, out) kernel becomes a Linear (out, in)
weight or a 1x1 Conv2d (out, in, 1, 1) weight; a flax BatchNorm's
scale/bias and its batch_stats mean/var become weight/bias and
running_mean/running_var.
"""

from __future__ import annotations

import re
import sys
from typing import Dict, Mapping, Optional

import numpy as np
import torch

# flax U-Net layer prefix -> reference ModuleList name
_INV_UNET_STACKS = {'p1a': 'st_gcnnsp1a', 'd1': 'st_gcnnsd1',
                    'd2': 'st_gcnnsd2', 'd3': 'st_gcnnsd3',
                    'u4': 'st_gcnnsu4', 'u3': 'st_gcnnsu3'}
_JOINT_MIXES = ('down1', 'down2', 'up2', 'up3')


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _export_bn(prefix: str, p: Mapping, s: Optional[Mapping],
               out: Dict[str, torch.Tensor]) -> None:
    out[f'{prefix}.weight'] = _t(p['scale'])
    out[f'{prefix}.bias'] = _t(p['bias'])
    if s is not None:
        out[f'{prefix}.running_mean'] = _t(s['mean'])
        out[f'{prefix}.running_var'] = _t(s['var'])


def _conv1x1(kernel) -> torch.Tensor:
    """(in, out) dense kernel -> (out, in, 1, 1) conv weight."""
    return _t(np.asarray(kernel).T[:, :, None, None])


def _export_gcnn(prefix: str, p: Mapping, s: Optional[Mapping],
                 out: Dict[str, torch.Tensor]) -> None:
    out[f'{prefix}.gcn.A'] = _t(p['gcn']['A'])
    out[f'{prefix}.gcn.T'] = _t(p['gcn']['T'])
    out[f'{prefix}.tcn.0.weight'] = _conv1x1(p['tcn_kernel'])
    if 'tcn_bias' in p:
        out[f'{prefix}.tcn.0.bias'] = _t(p['tcn_bias'])
    _export_bn(f'{prefix}.tcn.1', p['tcn_bn'], s['tcn_bn'] if s else None,
               out)
    if 'residual_kernel' in p:
        out[f'{prefix}.residual.0.weight'] = _conv1x1(p['residual_kernel'])
        if 'residual_bias' in p:
            out[f'{prefix}.residual.0.bias'] = _t(p['residual_bias'])
        _export_bn(f'{prefix}.residual.1', p['residual_bn'],
                   s['residual_bn'] if s else None, out)
    out[f'{prefix}.prelu.weight'] = _t(
        np.asarray(p['PReLU_0']['negative_slope']).reshape(1))
    if 'emb_kernel' in p:
        out[f'{prefix}.emb_layer.1.weight'] = _t(np.asarray(p['emb_kernel']).T)
        out[f'{prefix}.emb_layer.1.bias'] = _t(p['emb_bias'])


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX variables tree ({'params': ..., 'batch_stats': ...}, nested
    dicts of arrays) -> reference-named torch state dict of `MoCoDADNet`."""
    params = variables['params']
    stats = variables.get('batch_stats', {})
    out: Dict[str, torch.Tensor] = {}
    for root, p in params.items():
        if root not in ('model', 'condition_encoder'):
            raise ValueError(f'{root!r} is not part of the ported eval slice')
        s = stats.get(root, {})
        for name, sub in p.items():
            ss = s.get(name, {}) if isinstance(s, Mapping) else {}
            if name in ('encoder', 'decoder'):
                for lname, lp in sub.items():
                    i = lname.split('_')[1]
                    _export_gcnn(f'{root}.{name}.model_layers.{i}', lp,
                                 ss.get(lname), out)
            elif name == 'p1a':
                _export_gcnn(f'{root}.st_gcnnsp1a.0', sub, ss, out)
            elif re.fullmatch(r'[du][1-4]_[0-9]', name):
                stack, idx = name.split('_')
                _export_gcnn(f'{root}.{_INV_UNET_STACKS[stack]}.{idx}', sub,
                             ss, out)
            elif name in _JOINT_MIXES:
                out[f'{root}.{name}.block.0.weight'] = _conv1x1(sub['kernel'])
                if 'bias' in sub:
                    out[f'{root}.{name}.block.0.bias'] = _t(sub['bias'])
                _export_bn(f'{root}.{name}.block.1', sub['BatchNorm_0'],
                           ss.get('BatchNorm_0'), out)
            elif name.endswith('_kernel'):
                out[f'{root}.{name[:-len("_kernel")]}.weight'] = _t(
                    np.asarray(sub).T)
            elif name.endswith('_bias'):
                out[f'{root}.{name[:-len("_bias")]}.bias'] = _t(sub)
            else:
                raise ValueError(f'unhandled flax entry {root}.{name}')
    return out


def load_checkpoint_state_dict(path: str, use_ema: bool = False
                               ) -> Dict[str, torch.Tensor]:
    """Read a reference-named state dict written by `torch.save`: a bare
    dict, or Lightning's {'state_dict': ...} (the reference's
    eval_MoCoDAD.py:32-38 consumes the latter).

    `use_ema` takes the EMA shadow weights: the reference EMACallback's
    'state_dict_ema' payload (ref utils/ema.py:66-72) when present, else
    embedded 'model_ema.module.*' keys; it warns and keeps the raw weights
    when the file carries no EMA copy.  Full unpickling, as the JAX
    package's reader does: Lightning checkpoints hold hyper-parameter
    objects, so load only files you trust."""
    raw = torch.load(path, map_location='cpu', weights_only=False)
    sd = raw.get('state_dict', raw) if isinstance(raw, dict) else raw
    if use_ema:
        prefix = 'model_ema.module.'
        ema = {k[len(prefix):]: v for k, v in sd.items()
               if k.startswith(prefix)}
        if isinstance(raw, dict) and raw.get('state_dict_ema'):
            sd = raw['state_dict_ema']
        elif ema:
            sd = ema
        else:
            print('WARNING: use_ema requested but the checkpoint carries no '
                  'EMA payload; loading raw weights', file=sys.stderr)
    return {re.sub(r'^module\.', '', k): v for k, v in sd.items()
            if not k.startswith('model_ema.')}
