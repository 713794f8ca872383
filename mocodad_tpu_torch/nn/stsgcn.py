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
`nn.BatchNorm` in train mode (`FlaxBatchNorm2d`), over the global batch
of every rank in a data-parallel run (`sync_batch_norms`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from mocodad_tpu_torch.parallel.distributed import (all_reduce_sum,
                                                    is_distributed)


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` with flax `nn.BatchNorm`'s train-mode semantics
    (mocodad_tpu/nn/stsgcn.py:120, :131, :177; flax momentum 0.9 is this
    class's momentum 0.1, the default).

    In train mode the input is normalized with the batch mean and the
    BIASED batch variance, and `running_var` takes the biased variance
    too, where `nn.BatchNorm2d` would put the unbiased one.  The statistics
    are float32 for a bfloat16 or float32 input, as flax computes them.  The
    normalization is written out (`global_batch_norm`), on one rank as on
    several: with `mesh` set (`sync_batch_norms`) it takes the statistics
    over every rank's rows, as flax does over a sharded global batch, and
    only the sums cross the ranks, so W ranks round as one process does.
    Eval mode is `nn.BatchNorm2d`'s; parameter and buffer names are
    unchanged, so reference state dicts load with `strict=True`.
    """

    mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        return global_batch_norm(self, x, self.weight, self.bias)


class FlaxBatchNorm1d(nn.BatchNorm1d):
    """`FlaxBatchNorm2d`'s sibling for an (N, C) matrix: flax `nn.BatchNorm`
    on axis -1 at momentum 0.9 (mocodad_tpu/nn/components.py:109-110), the
    latent denoiser's.  Train mode normalizes with the batch mean and the
    biased variance and puts the biased variance into `running_var`; the
    statistics are float32.  As in flax, the output takes the promoted
    dtype of the input and the scale, so a float32 input meets
    bfloat16-cast weights in float32.  `mesh` as for `FlaxBatchNorm2d`."""

    mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        w, b = self.weight.to(dt), self.bias.to(dt)
        x = x.to(dt)
        if not self.training:
            return nn.functional.batch_norm(
                x, self.running_mean, self.running_var, w, b, False, 0.0,
                self.eps)
        return global_batch_norm(self, x, w, b)


class _GlobalBatchNorm(torch.autograd.Function):
    """Flax's train-mode BatchNorm over the global batch of `mesh`'s ranks
    (this process's rows off a mesh), in float32 or wider, with its
    closed-form backward: one autograd node where the normalization
    written out in tensor ops took a dozen, so a step issues fewer host
    ops.

    Forward: the per-channel sum of x and the row count, then the sum of
    (x - mean)^2, each summed over the ranks; the biased variance, as
    flax's.  Backward, with xhat = (x - mean) / std: the scale's and the
    shift's gradients are this rank's sums of g * xhat and g (the step
    sums parameter gradients over the ranks), and x's is
    scale / std * (g - mean(g) - xhat * mean(g * xhat)) with the means
    over the global batch, one more sum over the ranks."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, mesh):
        c = x.shape[1]
        dims = (0,) + tuple(range(2, x.ndim))
        shape = (1, c) + (1,) * (x.ndim - 2)
        # float32 at least, as flax promotes: float64 stays float64
        ct = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(ct)
        sums = all_reduce_sum(torch.cat([
            xf.sum(dims), xf.new_full((1,), xf.numel() // c)]), mesh)
        n = sums[c]
        mean = sums[:c] / n
        centred = xf - mean.view(shape)
        var = all_reduce_sum((centred * centred).sum(dims), mesh) / n
        invstd = torch.rsqrt(var + eps)
        xhat = centred * invstd.view(shape)
        y = xhat * weight.to(ct).view(shape) + bias.to(ct).view(shape)
        ctx.save_for_backward(xhat, invstd, weight)
        ctx.mesh, ctx.n, ctx.dims, ctx.shape = mesh, n, dims, shape
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy, _mean, _var):
        xhat, invstd, weight = ctx.saved_tensors
        c, dims, shape = invstd.numel(), ctx.dims, ctx.shape
        g = gy.to(xhat.dtype)
        local = torch.cat([g.sum(dims), (g * xhat).sum(dims)])
        sums = all_reduce_sum(local, ctx.mesh) / ctx.n
        scale = (weight.to(xhat.dtype) * invstd).view(shape)
        gx = scale * (g - sums[:c].view(shape) - xhat * sums[c:].view(shape))
        return (gx.to(gy.dtype), local[c:].to(weight.dtype),
                local[:c].to(weight.dtype), None, None)


def global_batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
                      weight: torch.Tensor, bias: torch.Tensor
                      ) -> torch.Tensor:
    """Train-mode flax BatchNorm of x (N, C, ...) over the global batch of
    `bn.mesh`'s ranks (this process's rows off a mesh), in float32
    (`_GlobalBatchNorm`); the running statistics take the global mean
    and biased variance, the same on every rank.

    Two sums where flax takes one (E[x^2] - E[x]^2): that difference
    cancels, and its rounding, carried by Adam's sign-like first steps,
    put two ranks' second-step loss 8.8e-5 from one process's (NVIDIA
    H100 80GB HBM3, 700 W, the flagship's training widths at batch 1024);
    with the centred sum the first two steps' losses were equal.  One
    process takes the same function: with torch's own BatchNorm there (one
    `batch_norm` call, Welford's variance) two ranks' gradients landed 74
    times the port-against-JAX gradient bounds from one process's at
    batch 128 on the CPU, where the JAX package's meshes of 2 and 1 give
    the same gradients; with this one on both, within 0.08 of them
    (tests/test_torch_dist_drift.py)."""
    y, mean, var = _GlobalBatchNorm.apply(x, weight, bias, bn.eps, bn.mesh)
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1 - m).add_(mean, alpha=m)
        bn.running_var.mul_(1 - m).add_(var, alpha=m)
        bn.num_batches_tracked.add_(1)
    return y


def sync_batch_norms(net: nn.Module, mesh) -> None:
    """Make every flax BatchNorm of `net` take its train-mode statistics
    over `mesh`'s global batch (a mesh without a process group, or None:
    over its own input, the single-process code path)."""
    for m in net.modules():
        if isinstance(m, (FlaxBatchNorm2d, FlaxBatchNorm1d)):
            m.mesh = mesh if is_distributed(mesh) else None


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
