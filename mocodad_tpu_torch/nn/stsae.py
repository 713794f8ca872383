"""STS-GCN condition encoders: STSE (encoder-only) and STSAE (autoencoder).

PyTorch counterpart of `mocodad_tpu/nn/stsae.py` (reference
models/stsae/stsae.py), with the reference's submodule names.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from mocodad_tpu_torch.nn.components import Decoder, Encoder


class STSE(nn.Module):
    """Encoder + flatten + linear bottleneck -> latent
    (ref: models/stsae/stsae.py:9-107)."""

    def __init__(self, c_in: int, h_dim: int = 32, latent_dim: int = 64,
                 n_frames: int = 12, n_joints: int = 17,
                 layer_channels: Sequence[int] = (128, 64, 128),
                 dropout: float = 0.3):
        super().__init__()
        self.h_dim, self.n_frames, self.n_joints = h_dim, n_frames, n_joints
        self.encoder = Encoder(c_in, layer_channels, h_dim, n_frames,
                               n_joints, dropout)
        self.flat_dim = h_dim * n_frames * n_joints
        self.btlnk = nn.Linear(self.flat_dim, latent_dim)

    def encode(self, x: torch.Tensor,
               t_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.encoder(x, t_emb)
        return self.btlnk(h.reshape(h.shape[0], -1))

    def forward(self, x: torch.Tensor, t_emb: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        return self.encode(x, t_emb), None


class STSAE(STSE):
    """STSE + mirrored decoder; returns (latent, reconstruction)
    (ref: models/stsae/stsae.py:112-188)."""

    def __init__(self, c_in: int, h_dim: int = 32, latent_dim: int = 64,
                 n_frames: int = 12, n_joints: int = 17,
                 layer_channels: Sequence[int] = (128, 64, 128),
                 dropout: float = 0.3):
        super().__init__(c_in, h_dim, latent_dim, n_frames, n_joints,
                         layer_channels, dropout)
        self.decoder = Decoder(c_in, layer_channels, h_dim, n_frames,
                               n_joints, dropout)
        self.rev_btlnk = nn.Linear(latent_dim, self.flat_dim)

    def decode(self, z: torch.Tensor,
               t_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.rev_btlnk(z).reshape(-1, self.h_dim, self.n_frames,
                                      self.n_joints)
        return self.decoder(h, t_emb)

    def forward(self, x: torch.Tensor, t_emb: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        z = self.encode(x)
        return z, self.decode(z, t_emb)
