"""Space-Time-Separable GCN building blocks.

PyTorch counterpart of `mocodad_tpu/nn/stsgcn.py`, with the reference's
module and parameter names (models/gcae/stsgcn.py), so a reference state
dict loads into these modules with `strict=True`.

The time mix `T` and the joint mix `A` compose into one dense (T*V, T*V)
operator K, as in the JAX package:

    Y[n,c,q,w] = sum_{t,v} X[n,c,t,v] * Tm[v,t,q] * A[q,v,w]
               = reshape(X, (N*C, T*V)) @ K,   K[(t,v),(q,w)] = Tm[v,t,q]*A[q,v,w]

Layout is channels-first (N, C, T, V).  BatchNorms run with running
statistics in eval mode (eps 1e-5, as flax) and follow flax's
`nn.BatchNorm` in train mode (`FlaxBatchNorm2d`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` with flax `nn.BatchNorm`'s train-mode semantics
    (mocodad_tpu/nn/stsgcn.py:120, :131, :177; flax momentum 0.9 is this
    class's momentum 0.1, the default).

    In train mode the input is normalized with the batch mean and the
    BIASED batch variance, and `running_var` takes the biased variance
    too, where `nn.BatchNorm2d` would put the unbiased one.  The statistics
    are float32 whatever the input's dtype, as flax computes them; flax
    takes the variance as E[x^2] - E[x]^2 and torch by Welford's method,
    the same value up to float32 rounding.  The normalization is one
    `batch_norm` call, so autograd sees one node.
    Eval mode is `nn.BatchNorm2d`'s; parameter and buffer names are
    unchanged, so reference state dicts load with `strict=True`.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                       correction=0)
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean, alpha=m)
            self.running_var.mul_(1 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return nn.functional.batch_norm(x, None, None, self.weight,
                                        self.bias, True, 0.0, self.eps)


def compose_graph_operator(tm: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Fold (time-mix Tm (V, T, T), joint-mix A (T, V, V)) into one
    (T*V, T*V) matrix; row index is the input (t, v) pair, column index the
    output (q, w) pair, both flattened C-order."""
    t_dim, v_dim = a.shape[0], a.shape[1]
    k = torch.einsum('vtq,qvw->tvqw', tm, a)
    return k.reshape(t_dim * v_dim, t_dim * v_dim)


class ConvTemporalGraphical(nn.Module):
    """Learnable dense space-time adjacency mix
    (ref: models/gcae/stsgcn.py:120-156)."""

    def __init__(self, time_dim: int, joints_dim: int):
        super().__init__()
        self.time_dim, self.joints_dim = time_dim, joints_dim
        self.A = nn.Parameter(torch.empty(time_dim, joints_dim, joints_dim))
        self.T = nn.Parameter(torch.empty(joints_dim, time_dim, time_dim))
        # U(+-1/sqrt(size(1))), as the reference (stsgcn.py:134-140)
        nn.init.uniform_(self.A, -1 / math.sqrt(joints_dim),
                         1 / math.sqrt(joints_dim))
        nn.init.uniform_(self.T, -1 / math.sqrt(time_dim),
                         1 / math.sqrt(time_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = compose_graph_operator(self.T, self.A)
        n, c = x.shape[0], x.shape[1]
        y = x.reshape(n, c, self.time_dim * self.joints_dim) @ k
        return y.reshape(n, c, self.time_dim, self.joints_dim)


class STGCNNLayer(nn.Module):
    """Space-time GCN layer: graph mix -> 1x1 conv + BN + dropout ->
    residual -> PReLU -> optional additive time embedding
    (ref: models/gcae/stsgcn.py:9-116).  Input/output (N, C, T, V)."""

    def __init__(self, in_channels: int, out_channels: int, time_dim: int,
                 joints_dim: int, dropout: float, bias: bool = True,
                 emb_dim: Optional[int] = None):
        super().__init__()
        self.gcn = ConvTemporalGraphical(time_dim, joints_dim)
        self.tcn = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 1, bias=bias),
            FlaxBatchNorm2d(out_channels),
            nn.Dropout(dropout))
        # residual: identity when shapes match, else 1x1 conv + BN
        self.residual = (None if in_channels == out_channels else
                         nn.Sequential(
                             nn.Conv2d(in_channels, out_channels, 1,
                                       bias=bias),
                             FlaxBatchNorm2d(out_channels)))
        self.prelu = nn.PReLU()
        self.emb_layer = (None if emb_dim is None else nn.Sequential(
            nn.SiLU(), nn.Linear(emb_dim, out_channels)))

    def forward(self, x: torch.Tensor,
                t_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        res = x if self.residual is None else self.residual(x)
        y = self.tcn(self.gcn(x))
        y = self.prelu(y + res)
        if self.emb_layer is not None and t_emb is not None:
            # the embedding path runs in t_emb's float32 whatever the
            # weights' dtype, and is cast to y's
            # (mocodad_tpu/nn/stsgcn.py:146-149)
            lin = self.emb_layer[1]
            emb = nn.functional.linear(nn.functional.silu(t_emb),
                                       lin.weight.to(t_emb.dtype),
                                       lin.bias.to(t_emb.dtype))
            y = y + emb.to(y.dtype)[:, :, None, None]
        return y


class JointMixLayer(nn.Module):
    """Joint up/down-scaling: a 1x1 conv over the joints 'channel' + BN +
    dropout (the reference's CNN_layer, models/gcae/stsgcn.py:161-199).
    BatchNorm normalizes per output joint over (N, C, T)."""

    def __init__(self, in_joints: int, out_joints: int, dropout: float,
                 bias: bool = True):
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv2d(in_joints, out_joints, 1, bias=bias),
            FlaxBatchNorm2d(out_joints),
            nn.Dropout(dropout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # (N, C, T, V) -> (N, V, C, T) -> block -> (N, C, T, V_out)
        y = self.block(x.permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1)
