"""Elementwise losses and sample-aggregation strategies.

PyTorch counterpart of `mocodad_tpu/models/losses.py` (reference
models/mocodad.py:24 and `_aggregation_strategy` :454-520), on a stacked
(S, B, ...) tensor of generated samples.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def elementwise_loss(kind: str, pred: torch.Tensor, target: torch.Tensor
                     ) -> torch.Tensor:
    if kind == 'l1':
        return torch.abs(pred - target)
    if kind == 'mse':
        return torch.square(pred - target)
    if kind == 'smooth_l1':
        # torch.nn.SmoothL1Loss with beta=1.0
        d = torch.abs(pred - target)
        return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
    raise ValueError(f'unknown loss {kind!r}')


def _lower_median(x: torch.Tensor, dim: int) -> torch.Tensor:
    """For even counts, the LOWER of the two middle values (torch.median's
    rule); NaNs sort last, as in jnp.sort."""
    n = x.shape[dim]
    return torch.sort(x, dim=dim).values.select(dim, (n - 1) // 2)


def per_sample_losses(kind: str, xs: torch.Tensor, target: torch.Tensor
                      ) -> torch.Tensor:
    """(S, B, ...) samples vs (B, ...) target -> (S, B) mean loss per
    sample (ref models/mocodad.py:483-485)."""
    l = elementwise_loss(kind, xs, target[None])
    return l.reshape(l.shape[0], l.shape[1], -1).mean(dim=-1)


def selects_pose(strategy: str) -> bool:
    """Whether aggregate() returns a selected pose for this strategy."""
    return not (strategy in ('mean', 'median')
                or strategy.startswith('quantile'))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx[b], b, ...] for an (S, B, ...) tensor and (B,) indices."""
    return x[idx, torch.arange(x.shape[1], device=x.device)]


def aggregate(strategy: str, loss_kind: str, xs: torch.Tensor,
              target: torch.Tensor,
              generator: Optional[torch.Generator] = None
              ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Select a sample / loss per window from S generations.

    xs: (S, B, ...); target: (B, ...).  Returns (selected_x, loss);
    selected_x is None for the loss-only strategies.  For 'all', selected_x
    is (B, S, ...) and loss is (B, S).  'random' draws its choice from
    `generator`.
    """
    s = xs.shape[0]
    losses = per_sample_losses(loss_kind, xs, target)  # (S, B)

    if strategy == 'all':
        return xs.movedim(0, 1), losses.movedim(0, 1)
    if strategy == 'mean':
        return None, losses.mean(dim=0)
    if strategy == 'mean_pose':
        sel = xs.mean(dim=0)
        l = elementwise_loss(loss_kind, sel, target)
        return sel, l.reshape(l.shape[0], -1).mean(dim=-1)
    if strategy == 'median':
        return None, _lower_median(losses, dim=0)
    if strategy == 'median_pose':
        sel = _lower_median(xs, dim=0)
        l = elementwise_loss(loss_kind, sel, target)
        return sel, l.reshape(l.shape[0], -1).mean(dim=-1)
    if strategy in ('best', 'worst'):
        # a NaN loss is never selected (the reference's running comparison,
        # models/mocodad.py:504-512): mask it to the neutral infinity
        fill = float('inf') if strategy == 'best' else float('-inf')
        ls = torch.where(torch.isnan(losses), fill, losses)
        idx = (torch.argmin(ls, dim=0) if strategy == 'best'
               else torch.argmax(ls, dim=0))
        return _take(xs, idx), _take(ls, idx)
    if strategy.startswith('quantile'):
        q = float(strategy.split(':')[-1])
        return None, torch.quantile(losses, q, dim=0)
    if strategy == 'random':
        if generator is None:
            raise ValueError("aggregation 'random' needs a generator")
        idx = torch.randint(0, s, (losses.shape[1],), generator=generator,
                            device=generator.device)
        return _take(xs, idx.to(xs.device)), _take(losses, idx.to(xs.device))
    raise ValueError(f'Unknown aggregation strategy {strategy}')
