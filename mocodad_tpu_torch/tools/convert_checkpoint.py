"""Checkpoint converter between the JAX package's flax msgpack train states
and reference (PyTorch Lightning) `.ckpt` files, with the port's own
msgpack codec (`utils/msgpack.py`): no flax, no msgpack package.

  to-torch   a JAX-package checkpoint (msgpack; a `torch.save` file is
             read too) -> `{'state_dict': ...}` with the reference's key
             names, which the reference, the port and the JAX package all
             load.
  to-flax    a reference `.ckpt`/`.pt` -> a `{'params', 'batch_stats'}`
             msgpack that the JAX package's `restore_variables` reads.

Both directions are strict, as tools/convert_checkpoint.py is: the weights
must load into the configured architecture with `strict=True`, and a key
without a counterpart is an error.

    python -m mocodad_tpu_torch.tools.convert_checkpoint to-torch \\
        -c <yaml> --ckpt checkpoints/.../best_weights.ckpt --out ref.ckpt
    python -m mocodad_tpu_torch.tools.convert_checkpoint to-flax \\
        -c <yaml> --ckpt published_reference.ckpt --out imported.ckpt

The YAML describes the architecture the checkpoint was trained with; it is
loaded without side effects (no experiment directories are made).
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch

from mocodad_tpu_torch.config import Config, load_config
from mocodad_tpu_torch.models.mocodad import build_model
from mocodad_tpu_torch.utils.msgpack import packb
from mocodad_tpu_torch.utils.weights import (is_torch_checkpoint,
                                             load_checkpoint_state_dict,
                                             variables_from_state_dict)


def _leaves(tree) -> int:
    return sum(_leaves(v) for v in tree.values()) \
        if isinstance(tree, dict) else 1


def convert(cfg: Config, direction: str, ckpt: str, out: str,
            use_ema: bool = False) -> int:
    """Run one conversion; returns the number of tensors written."""
    if direction not in ('to-torch', 'to-flax'):
        raise ValueError(f'unknown direction {direction!r}')
    if direction == 'to-flax' and not is_torch_checkpoint(ckpt):
        raise SystemExit(f'{ckpt!r} is not a torch checkpoint; to-flax '
                         'expects a reference .ckpt/.pt file')
    sd = load_checkpoint_state_dict(ckpt, use_ema=use_ema)
    net = build_model(cfg).build_net()
    net.load_state_dict(sd, strict=True)
    if direction == 'to-torch':
        torch.save({'state_dict': sd}, out)
        return len(sd)
    variables = variables_from_state_dict(net.state_dict())
    with open(out, 'wb') as f:
        f.write(packb(variables))
    return _leaves(variables)


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('direction', choices=['to-torch', 'to-flax'])
    p.add_argument('-c', '--config', required=True,
                   help='model YAML (architecture must match the checkpoint)')
    p.add_argument('--ckpt', required=True, help='input checkpoint path')
    p.add_argument('--out', required=True, help='output path')
    p.add_argument('--use-ema', action='store_true',
                   help='convert the EMA shadow weights instead of the raw '
                        'ones (warns and keeps the raw ones when the input '
                        'has none)')
    args = p.parse_args(argv)
    cfg = load_config(args.config, finalize=False)
    n = convert(cfg, args.direction, args.ckpt, args.out,
                use_ema=args.use_ema)
    print(f'wrote {args.direction.split("-")[1]} checkpoint ({n} tensors) '
          f'to {args.out}')


if __name__ == '__main__':
    main()
