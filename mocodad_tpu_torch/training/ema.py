"""Exponential moving average of the parameters.

Counterpart of `mocodad_tpu/training/ema.py:15-26` (decay 0.9999, timm
ModelEmaV2's default).  It acts on parameters only: the BatchNorm running
statistics are buffers and stay the live network's, as in the JAX
package, where the EMA shadows `params` and not `batch_stats`.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

EMA_DECAY = 0.9999


def ema_init(net: nn.Module) -> Dict[str, torch.Tensor]:
    """A detached copy of every parameter, by name."""
    return {k: p.detach().clone() for k, p in net.named_parameters()}


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], net: nn.Module,
               decay: float = EMA_DECAY) -> None:
    """ema <- decay * ema + (1 - decay) * params, in place."""
    for k, p in net.named_parameters():
        e = ema[k]
        e.copy_(decay * e + (1.0 - decay) * p)
