"""Sinusoidal time embedding, the condition-encoder stacks and the latent
variant's MLP denoiser.

PyTorch counterpart of `mocodad_tpu/nn/components.py` (reference
models/common/components.py: Encoder :8-86, Decoder :91-164, Denoiser
:203-291).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mocodad_tpu_torch.nn.stsgcn import FlaxBatchNorm1d, STGCNNLayer


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


def promoted_linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """`lin(x)` at the promoted dtype of x and the weights, as `x @ kernel
    + bias` promotes in JAX: a float32 input meets bfloat16-cast weights in
    float32."""
    dt = torch.promote_types(x.dtype, lin.weight.dtype)
    return nn.functional.linear(
        x.to(dt), lin.weight.to(dt),
        None if lin.bias is None else lin.bias.to(dt))


class Denoiser(nn.Module):
    """Conditioned MLP denoiser of the latent diffusion stage
    (mocodad_tpu/nn/components.py:80-118, ref models/common/
    components.py:203-291).

    With c = sinusoidal(t) + cond, layer i maps x to Linear_i(x), then
    BatchNorm and ReLU on every layer but the last, then adds
    cond_layers_i(c).  Reference names: `net.{i}.0` (Linear) and `net.{i}.1`
    (BatchNorm1d) for the hidden layers, a bare Linear `net.{i}` for the
    last, and `cond_layers.{i}`.  The output width is hidden_sizes[-1].
    """

    def __init__(self, input_size: int, hidden_sizes: Sequence[int],
                 cond_size: int, bias: bool = True):
        super().__init__()
        self.cond_size = cond_size
        sizes = [input_size] + list(hidden_sizes)
        last = len(hidden_sizes) - 1
        self.net = nn.ModuleList(
            nn.Linear(a, b, bias=bias) if i == last else nn.Sequential(
                nn.Linear(a, b, bias=bias), FlaxBatchNorm1d(b), nn.ReLU())
            for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])))
        self.cond_layers = nn.ModuleList(
            nn.Linear(cond_size, b, bias=bias) for b in hidden_sizes)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = sinusoidal_pos_encoding(t, self.cond_size)
        if cond is not None:
            c = c + cond
        for layer, cond_layer in zip(self.net, self.cond_layers):
            if isinstance(layer, nn.Linear):
                x = promoted_linear(x, layer)
            else:
                x = layer[2](layer[1](promoted_linear(x, layer[0])))
            x = x + promoted_linear(c, cond_layer)
        return x
