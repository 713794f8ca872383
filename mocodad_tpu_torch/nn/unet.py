"""Space-time-separable U-Net over the joints dimension.

PyTorch counterpart of `mocodad_tpu/nn/unet.py` (reference
models/stsae/stsae_unet.py), with the reference's submodule names
(`st_gcnnsp1a`, `st_gcnnsd1`..., `down1`, `up2`...).  Level 'a' of the joint
pyramid follows the input's joint count, as in the JAX package.

This module forward is the oracle for the folded denoiser
(`ops/pallas_unet.py`); generation itself runs the folded form.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from mocodad_tpu_torch.nn.components import sinusoidal_pos_encoding
from mocodad_tpu_torch.nn.stsgcn import JointMixLayer, STGCNNLayer


def joint_pyramid(n_joints: int) -> dict:
    """Joint counts per U-Net level (ref: stsae_unet.py:11, level 'a'
    generalized to the input's joint count)."""
    return {'a': n_joints, 'b': 12, 'c': 10, 'd': 8}


class STSEUnet(nn.Module):
    """Downscaling half (encoder) of the U-Net
    (ref: models/stsae/stsae_unet.py:8-249)."""

    default_down_channels: Tuple[int, ...] = (16, 32, 32, 64, 64, 128, 6)

    def __init__(self, c_in: int, embedding_dim: Optional[int] = 256,
                 latent_dim: int = 64, n_frames: int = 12,
                 n_joints: int = 17,
                 unet_down_channels: Optional[Sequence[int]] = None,
                 dropout: float = 0.3, set_out_layer: bool = True,
                 use_bottleneck: bool = False):
        super().__init__()
        self.c_in, self.embedding_dim = c_in, embedding_dim
        self.n_frames, self.n_joints = n_frames, n_joints
        self.set_out_layer = set_out_layer
        jp = joint_pyramid(n_joints)
        ch = list(unet_down_channels if unet_down_channels is not None
                  else self.default_down_channels)
        self.down_channels = ch

        def gcn(ci, co, joints):
            return STGCNNLayer(ci, co, n_frames, joints, dropout,
                               emb_dim=embedding_dim)

        self.st_gcnnsp1a = nn.ModuleList([gcn(c_in, ch[0], jp['a'])])
        self.st_gcnnsd1 = nn.ModuleList([gcn(ch[0], ch[1], jp['a']),
                                         gcn(ch[1], ch[2], jp['a'])])
        self.st_gcnnsd2 = nn.ModuleList([gcn(ch[2], ch[3], jp['b']),
                                         gcn(ch[3], ch[4], jp['b'])])
        self.st_gcnnsd3 = nn.ModuleList([gcn(ch[4], ch[5], jp['c']),
                                         gcn(ch[5], ch[6], jp['c'])])
        self.down1 = JointMixLayer(jp['a'], jp['b'], dropout)
        self.down2 = JointMixLayer(jp['b'], jp['c'], dropout)
        self.flat_dim = ch[6] * n_frames * jp['c']
        self.to_time_dim = (nn.Linear(self.flat_dim, latent_dim)
                            if set_out_layer or use_bottleneck else None)

    def time_embedding(self, t: Optional[torch.Tensor],
                       condition: Optional[torch.Tensor]
                       ) -> Optional[torch.Tensor]:
        if t is None or self.embedding_dim is None:
            return None
        emb = sinusoidal_pos_encoding(t, self.embedding_dim)
        return emb if condition is None else emb + condition

    def downscale(self, x: torch.Tensor, t_emb: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        f = self.st_gcnnsp1a[0](x, t_emb)
        for layer in self.st_gcnnsd1:
            f = layer(f, t_emb)
        d1 = f
        f = self.down1(f)
        for layer in self.st_gcnnsd2:
            f = layer(f, t_emb)
        d2 = f
        f = self.down2(f)
        for layer in self.st_gcnnsd3:
            f = layer(f, t_emb)
        return f, d1, d2

    def out_layer(self, f: torch.Tensor) -> torch.Tensor:
        return self.to_time_dim(f.reshape(f.shape[0], -1))

    def forward(self, x: torch.Tensor, t: Optional[torch.Tensor] = None,
                condition: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, List]:
        f, _, _ = self.downscale(x, self.time_embedding(t, condition))
        if self.set_out_layer:
            f = self.out_layer(f)
        return f, []


class STSAEUnet(STSEUnet):
    """Full U-Net: down path + up path with skip residuals
    (ref: models/stsae/stsae_unet.py:254-438).  The last up channel is
    c_in so the final +x residual is valid."""

    default_down_channels = (16, 32, 32, 64, 64, 128, 64)

    def __init__(self, c_in: int, embedding_dim: Optional[int] = 256,
                 latent_dim: int = 64, n_frames: int = 12,
                 n_joints: int = 17,
                 unet_down_channels: Optional[Sequence[int]] = None,
                 unet_up_channels: Optional[Sequence[int]] = None,
                 dropout: float = 0.3, inject_condition: bool = False,
                 use_bottleneck: bool = False):
        super().__init__(c_in, embedding_dim, latent_dim, n_frames, n_joints,
                         unet_down_channels, dropout, set_out_layer=False,
                         use_bottleneck=use_bottleneck)
        self.inject_condition = inject_condition
        self.use_bottleneck = use_bottleneck
        jp = joint_pyramid(n_joints)
        up = (list(unet_up_channels) if unet_up_channels is not None
              else [64, 32, 32, c_in])
        dn = self.down_channels

        def gcn(ci, co, joints):
            return STGCNNLayer(ci, co, n_frames, joints, dropout,
                               emb_dim=embedding_dim)

        self.st_gcnnsu4 = nn.ModuleList([gcn(dn[-1], up[0], jp['b']),
                                         gcn(up[0], up[1], jp['b'])])
        self.st_gcnnsu3 = nn.ModuleList([gcn(up[1], up[2], jp['a']),
                                         gcn(up[2], up[3], jp['a'])])
        self.up2 = JointMixLayer(jp['b'], jp['a'], dropout)
        self.up3 = JointMixLayer(jp['c'], jp['b'], dropout)
        self.bottleneck_shape = (dn[6], n_frames, jp['c'])
        self.rev_to_time_dim = (nn.Linear(latent_dim, self.flat_dim)
                                if use_bottleneck else None)

    def bottleneck(self, f: torch.Tensor) -> torch.Tensor:
        """Flat latent round-trip (ref: stsae_unet.py:359-361, 430-434)."""
        f = self.rev_to_time_dim(self.out_layer(f))
        return f.reshape(-1, *self.bottleneck_shape)

    def upscale(self, x, f, d1, d2, t_emb) -> torch.Tensor:
        f = self.up3(f) + d2
        for layer in self.st_gcnnsu4:
            f = layer(f, t_emb)
        f = self.up2(f) + d1
        for layer in self.st_gcnnsu3:
            f = layer(f, t_emb)
        return f + x

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                condition: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, List]:
        emb = sinusoidal_pos_encoding(t, self.embedding_dim)
        if self.inject_condition and condition is not None:
            emb = emb + condition
        f, d1, d2 = self.downscale(x, emb)
        if self.use_bottleneck:
            f = self.bottleneck(f)
        return self.upscale(x, f, d1, d2, emb), []
