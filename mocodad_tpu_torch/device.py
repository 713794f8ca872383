"""Device selection for the port's entry points.

Every entry point takes an explicit `device`.  `None` means the GPU; when
CUDA is absent the call raises instead of carrying on on the CPU, so a run
never reports host numbers under the name of the card.  The CPU is used
only when the caller asks for it (`device='cpu'`), as the tests do.  In a
data-parallel run each rank drives one device (`rank_device`).
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """'cuda' unless the caller names another device; raises when CUDA is
    asked for (explicitly or by default) and is not available."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                'CUDA is not available; pass device="cpu" (or --device cpu '
                'on the command line) to run on the CPU')
        # f32 on the card means f32: no TF32 in matmuls or convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != 'cpu':
        raise ValueError(f'unsupported device {dev}')
    return dev


def rank_device(device: Optional[Union[str, torch.device]] = None,
                rank: int = 0) -> torch.device:
    """The device a rank drives: for CUDA the card at the rank's index on
    its host (LOCAL_RANK, as torchrun and `parallel.launch` set it, else
    `rank`), made the current device; the CPU for CPU ranks.  Raises as
    `resolve_device` does."""
    dev = resolve_device(device)
    if dev.type == 'cpu':
        return dev
    dev = torch.device('cuda', int(os.environ.get('LOCAL_RANK', rank)))
    torch.cuda.set_device(dev)
    return dev


def check_device_count(n_devices: int, device=None) -> None:
    """Raise as `resolve_device(device)` does, or when `n_devices` ranks of
    one GPU each ask for more GPUs than this host shows (the JAX package's
    `make_mesh` wording); CPU ranks are not counted."""
    if resolve_device(device).type == 'cuda' and \
            n_devices > torch.cuda.device_count():
        raise ValueError(f'requested {n_devices} devices, have '
                         f'{torch.cuda.device_count()}')
