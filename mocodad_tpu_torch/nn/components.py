"""Sinusoidal time embedding and the condition-encoder stacks.

PyTorch counterpart of `mocodad_tpu/nn/components.py` (reference
models/common/components.py: Encoder :8-86, Decoder :91-164).  The
latent variant's MLP `Denoiser` is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mocodad_tpu_torch.nn.stsgcn import STGCNNLayer


def sinusoidal_pos_encoding(t: torch.Tensor, channels: int) -> torch.Tensor:
    """Sinusoidal timestep embedding (ref: models/stsae/stsae_unet.py:161-179).

    t: (B,) or (B, 1); returns (B, channels) = [sin(t*f), cos(t*f)] in f32.
    """
    t = t.reshape(-1, 1).to(torch.float32)
    inv_freq = 1.0 / (10000 ** (torch.arange(
        0, channels, 2, dtype=torch.float32, device=t.device) / channels))
    ang = t * inv_freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class _Stack(nn.Module):
    """ST-GCNN layers with the given channel sequence, held in the
    reference's `model_layers` ModuleList."""

    def __init__(self, channels: Sequence[int], n_frames: int, n_joints: int,
                 dropout: float, bias: bool):
        super().__init__()
        self.model_layers = nn.ModuleList(
            STGCNNLayer(c_in, c_out, n_frames, n_joints, dropout, bias=bias)
            for c_in, c_out in zip(channels[:-1], channels[1:]))

    def forward(self, x: torch.Tensor,
                t_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in self.model_layers:
            x = layer(x, t_emb)
        return x


class Encoder(_Stack):
    """Channels input_dim -> layer_channels -> hidden_dimension
    (ref: models/common/components.py:41-86)."""

    def __init__(self, input_dim: int, layer_channels: Sequence[int],
                 hidden_dimension: int, n_frames: int, n_joints: int,
                 dropout: float, bias: bool = True):
        super().__init__([input_dim] + list(layer_channels)
                         + [hidden_dimension], n_frames, n_joints, dropout,
                         bias)


class Decoder(_Stack):
    """Mirrored stack: hidden_dimension -> reversed(layer_channels) ->
    output_dim (ref: models/common/components.py:124-164)."""

    def __init__(self, output_dim: int, layer_channels: Sequence[int],
                 hidden_dimension: int, n_frames: int, n_joints: int,
                 dropout: float, bias: bool = True):
        super().__init__([hidden_dimension] + list(layer_channels)[::-1]
                         + [output_dim], n_frames, n_joints, dropout, bias)
