"""Weights carried across: the JAX package's variables tree and checkpoints,
and reference (PyTorch Lightning) checkpoints, as the state dict of the
port's `MoCoDADNet`.

`state_dict_from_jax` is this package's own copy of the export logic in
`mocodad_tpu/utils/torch_compat.py:237-327`, for every module the JAX
package builds (the U-Nets with their linear heads, their joint mixes, the
AE / E / E_unet condition encoders and the latent variant's MLP
denoiser).  It takes the variables tree as nested dicts of NumPy arrays
and emits the reference key names, e.g.

    model.st_gcnnsp1a.0.gcn.A     model.st_gcnnsd1.1.tcn.0.weight
    model.down1.block.0.weight    condition_encoder.encoder.model_layers.0...
    model.to_time_dim.weight      denoiser.net.0.0.weight (Linear)
    denoiser.net.0.1.running_var  denoiser.net.3.weight (the last Linear)
    denoiser.cond_layers.0.bias

Layout conversions: a dense (in, out) kernel becomes a Linear (out, in)
weight or a 1x1 Conv2d (out, in, 1, 1) weight; a flax BatchNorm's
scale/bias and its batch_stats mean/var become weight/bias and
running_mean/running_var.  `variables_from_state_dict` is the inverse
(a copy of `convert_torch_state_dict`, torch_compat.py:46-233, for the same
modules).

`load_checkpoint_state_dict` reads either checkpoint format by its magic
bytes: a `torch.save` file (the reference's and the port's own), or the
flax msgpack train state that the JAX package's trainer writes, decoded by
`utils/msgpack.py` and carried across by `state_dict_from_jax`.
"""

from __future__ import annotations

import re
import sys
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from mocodad_tpu_torch.utils.msgpack import unpackb

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


def _export_denoiser(p: Mapping, s: Mapping,
                     out: Dict[str, torch.Tensor]) -> None:
    """The MLP denoiser's w{i}_* / bn{i} / c{i}_* entries
    (torch_compat.py:281-297)."""
    i = 0
    while f'w{i}_kernel' in p:
        last = f'w{i + 1}_kernel' not in p
        base = f'denoiser.net.{i}' if last else f'denoiser.net.{i}.0'
        out[f'{base}.weight'] = _t(np.asarray(p[f'w{i}_kernel']).T)
        if f'w{i}_bias' in p:
            out[f'{base}.bias'] = _t(p[f'w{i}_bias'])
        if not last:
            _export_bn(f'denoiser.net.{i}.1', p[f'bn{i}'], s.get(f'bn{i}'),
                       out)
        out[f'denoiser.cond_layers.{i}.weight'] = _t(
            np.asarray(p[f'c{i}_kernel']).T)
        if f'c{i}_bias' in p:
            out[f'denoiser.cond_layers.{i}.bias'] = _t(p[f'c{i}_bias'])
        i += 1


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX variables tree ({'params': ..., 'batch_stats': ...}, nested
    dicts of arrays) -> reference-named torch state dict of `MoCoDADNet`
    or `MoCoDADLatentNet`."""
    params = variables['params']
    stats = variables.get('batch_stats', {})
    out: Dict[str, torch.Tensor] = {}
    for root, p in params.items():
        if root not in ('model', 'condition_encoder', 'denoiser'):
            raise ValueError(f'{root!r} is no module of the MoCoDAD nets')
        s = stats.get(root, {})
        if root == 'denoiser':
            _export_denoiser(p, s, out)
            continue
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


# torch ModuleList name -> flax layer prefix
_UNET_STACKS = {v: k for k, v in _INV_UNET_STACKS.items()}
_BN_LEAVES = {'weight': ('params', 'scale'), 'bias': ('params', 'bias'),
              'running_mean': ('batch_stats', 'mean'),
              'running_var': ('batch_stats', 'var')}

Entry = Optional[Tuple[str, Tuple[str, ...], np.ndarray]]


def _gcnn_entry(rest: list, value: np.ndarray) -> Entry:
    """One ST-GCNN layer's torch key (after the layer prefix) ->
    (collection, path within the layer, value in flax layout)."""
    head = rest[0]
    if head == 'gcn':
        return 'params', ('gcn', rest[1]), value
    if head in ('tcn', 'residual'):
        sub, leaf = rest[1], rest[2]
        if sub == '0':                       # 1x1 Conv2d: (Co, Ci, 1, 1)
            if leaf == 'weight':
                return 'params', (f'{head}_kernel',), value[:, :, 0, 0].T
            return 'params', (f'{head}_bias',), value
        if sub == '1' and leaf in _BN_LEAVES:
            col, name = _BN_LEAVES[leaf]
            return col, (f'{head}_bn', name), value
        return None
    if head == 'prelu':
        return 'params', ('PReLU_0', 'negative_slope'), value.reshape(())
    if head == 'emb_layer':                  # Linear(E, Co)
        if rest[2] == 'weight':
            return 'params', ('emb_kernel',), value.T
        return 'params', ('emb_bias',), value
    return None


def _unet_entry(rest: list, value: np.ndarray) -> Entry:
    head = rest[0]
    if head in _UNET_STACKS:
        prefix = _UNET_STACKS[head]
        layer = prefix if prefix == 'p1a' else f'{prefix}_{rest[1]}'
        out = _gcnn_entry(rest[2:], value)
        return None if out is None else (out[0], (layer,) + out[1], out[2])
    if head in _JOINT_MIXES:
        sub, leaf = rest[2], rest[3]
        if sub == '0':
            if leaf == 'weight':
                return 'params', (head, 'kernel'), value[:, :, 0, 0].T
            return 'params', (head, 'bias'), value
        if sub == '1' and leaf in _BN_LEAVES:
            col, name = _BN_LEAVES[leaf]
            return col, (head, 'BatchNorm_0', name), value
        return None
    if head in ('to_time_dim', 'rev_to_time_dim'):
        return _linear_entry(head, rest[1], value)
    return None


def _linear_entry(base: str, leaf: str, value: np.ndarray) -> Entry:
    if leaf == 'weight':
        return 'params', (f'{base}_kernel',), value.T
    return 'params', (f'{base}_bias',), value


def _denoiser_entry(rest: list, value: np.ndarray) -> Entry:
    """net.{i}[.0].* (Linear), net.{i}.1.* (BatchNorm1d) or
    cond_layers.{i}.* (torch_compat.py:134-160)."""
    stack, idx = rest[0], rest[1]
    if stack == 'cond_layers':
        return _linear_entry(f'c{idx}', rest[2], value)
    if stack != 'net':
        return None
    if rest[2] in ('weight', 'bias'):          # the last layer, bare Linear
        return _linear_entry(f'w{idx}', rest[2], value)
    if rest[2] == '0':
        return _linear_entry(f'w{idx}', rest[3], value)
    if rest[2] == '1' and rest[3] in _BN_LEAVES:
        col, name = _BN_LEAVES[rest[3]]
        return col, (f'bn{idx}', name), value
    return None


def _map_key(key: str, value: np.ndarray) -> Entry:
    """One reference key -> (collection, flax path, value), or None for a
    key with no flax counterpart."""
    parts = key.split('.')
    root, rest = parts[0], parts[1:]
    if root == 'model':
        out = _unet_entry(rest, value)
    elif root == 'denoiser':
        out = _denoiser_entry(rest, value)
    elif root == 'condition_encoder':
        if rest[0] in ('encoder', 'decoder'):
            out = _gcnn_entry(rest[3:], value)
            if out is not None:
                out = (out[0], (rest[0], f'layer_{rest[2]}') + out[1],
                       out[2])
        elif rest[0] in ('btlnk', 'rev_btlnk'):
            out = _linear_entry(rest[0], rest[1], value)
        else:                                # the E_unet encoder
            out = _unet_entry(rest, value)
    else:
        return None
    return None if out is None else (out[0], (root,) + out[1], out[2])


def variables_from_state_dict(state_dict: Mapping[str, Any]
                              ) -> Dict[str, Dict]:
    """Reference-named state dict of `MoCoDADNet` or `MoCoDADLatentNet` ->
    the JAX package's {'params': ..., 'batch_stats': ...} tree of float32
    NumPy arrays.  Raises on a key it cannot place (num_batches_tracked
    has no flax counterpart and is dropped)."""
    out: Dict[str, Dict] = {'params': {}, 'batch_stats': {}}
    unmapped = []
    for key, val in state_dict.items():
        if key.endswith('num_batches_tracked'):
            continue
        v = val.detach().cpu().numpy() if isinstance(val, torch.Tensor) \
            else np.asarray(val)
        entry = _map_key(key, np.asarray(v, dtype=np.float32))
        if entry is None:
            unmapped.append(key)
            continue
        col, path, value = entry
        node = out[col]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.array(value, dtype=np.float32, order='C')
    if unmapped:
        raise ValueError(f'state dict keys with no flax counterpart: '
                         f'{unmapped[:10]}')
    return out


def load_state_dict(path: str) -> Dict:
    """A msgpack checkpoint as a raw nested dict of NumPy arrays (no
    template needed; mocodad_tpu/training/checkpoint.py:55-58)."""
    with open(path, 'rb') as f:
        return unpackb(f.read())


def is_torch_checkpoint(path: str) -> bool:
    """`torch.save` files are zip archives ('PK...') or legacy pickle
    streams ('\\x80' and a protocol byte)."""
    with open(path, 'rb') as f:
        magic = f.read(2)
    return magic in (b'PK', b'\x80\x02', b'\x80\x03', b'\x80\x04',
                     b'\x80\x05')


def _from_msgpack(path: str, use_ema: bool) -> Dict[str, torch.Tensor]:
    """A JAX-package train state (flax msgpack) -> reference-named state
    dict, with `ema_params` under use_ema as `restore_variables` takes
    them (mocodad_tpu/training/checkpoint.py:70-91)."""
    raw = load_state_dict(path)
    if not isinstance(raw, dict) or 'params' not in raw:
        raise ValueError(f'{path}: a msgpack checkpoint without params')
    if use_ema and not raw.get('ema_params'):
        print(f'WARNING: use_ema requested but {path} carries no '
              'ema_params; loading raw weights', file=sys.stderr)
    params = raw['ema_params'] if use_ema and raw.get('ema_params') \
        else raw['params']
    return state_dict_from_jax({'params': params,
                                'batch_stats': raw.get('batch_stats') or {}})


def load_checkpoint_state_dict(path: str, use_ema: bool = False
                               ) -> Dict[str, torch.Tensor]:
    """Read a reference-named state dict from a checkpoint of either
    format.  A file that is not a `torch.save` file is read as the JAX
    package's msgpack train state (`params`, `batch_stats`, and
    `ema_params` under `use_ema`).  A `torch.save` file holds a bare dict,
    or Lightning's {'state_dict': ...} (the reference's
    eval_MoCoDAD.py:32-38 consumes the latter).

    `use_ema` takes the EMA shadow weights: the reference EMACallback's
    'state_dict_ema' payload (ref utils/ema.py:66-72) when present, else
    embedded 'model_ema.module.*' keys; it warns and keeps the raw weights
    when the file carries no EMA copy.  Full unpickling, as the JAX
    package's reader does: Lightning checkpoints hold hyper-parameter
    objects, so load only files you trust."""
    if not is_torch_checkpoint(path):
        return _from_msgpack(path, use_ema)
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
