"""Frame selection and input assembly for the conditioning strategies.

PyTorch counterpart of `mocodad_tpu/models/frames.py` (reference
models/mocodad.py:523-543, :654-686, :708-750, :811-840).  Selection is a
gather with a frame ORDER: order[..., :n_cond] holds the (sorted)
conditioning positions, order[..., n_cond:] the (sorted) corrupted
positions, as one static (T,) order or one (B, T) order per window
(random_imp).  Assembling the full window is a gather with the inverse
order; extracting the corrupted frames is a gather with
order[..., n_cond:].

Two layouts: the windows' (B, C, T, V), and the generation chain's
(C, T*V, N), where the fold is b-major (column = b*S + s) and a per-window
order becomes one row per column (`repeat_interleave`, as the JAX
package's `tile`, mocodad_tpu/models/mocodad.py:417-422).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def static_order(cond_idxs: Tuple[int, ...], corrupt_idxs: Tuple[int, ...]
                 ) -> np.ndarray:
    """(T,) frame order for the deterministic strategies."""
    return np.asarray(tuple(cond_idxs) + tuple(corrupt_idxs), dtype=np.int64)


def random_order(generator: Optional[torch.Generator], batch: int,
                 n_frames: int, n_cond: int,
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """(B, T) per-window random conditioning subsets (random_imp), on the
    generator's device: a random permutation per window marks which
    positions condition (those whose value is below n_cond), and each
    group keeps position order (models/mocodad.py:719-724).  The JAX
    package's distribution, not its stream."""
    if device is None:
        device = generator.device if generator is not None else 'cpu'
    perm = torch.argsort(torch.rand((batch, n_frames), generator=generator,
                                    device=device), dim=1)
    pos = torch.arange(n_frames, device=device)
    key = torch.where(perm < n_cond, pos, n_frames + pos)
    return torch.argsort(key, dim=1)


def _order(order, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(order, device=like.device).long()


def _gather_frames(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Frames (axis 2 of (B, C, T, V)) at static (K,) or per-window (B, K)
    indices."""
    if idx.dim() == 1:
        return x.index_select(2, idx)
    b, c, _, v = x.shape
    return torch.gather(x, 2, idx[:, None, :, None].expand(
        b, c, idx.shape[1], v))


def select_frames(data: torch.Tensor, order, n_cond: int
                  ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Split (B, C, T, V) into (conditioning, corrupted) frame groups."""
    if n_cond == 0:
        return None, data
    order = _order(order, data)
    return (_gather_frames(data, order[..., :n_cond]),
            _gather_frames(data, order[..., n_cond:]))


def assemble_input(strategy: str, cond: Optional[torch.Tensor],
                   corrupt: torch.Tensor, order, n_cond: int
                   ) -> torch.Tensor:
    """The U-Net input (ref `_prepare_input_data`, models/mocodad.py
    :654-686): the corrupted frames for inject / no_condition, the
    conditioning frames first for concat, every frame at its position for
    the imputation strategies."""
    if strategy in ('inject', 'no_condition'):
        return corrupt
    stacked = torch.cat([cond, corrupt], dim=2)
    if strategy == 'concat':
        return stacked
    if strategy in ('random_imp', 'inbetween_imp'):
        return _gather_frames(stacked,
                              torch.argsort(_order(order, corrupt), dim=-1))
    raise ValueError(f'unknown strategy {strategy}')


def extract_corrupt(strategy: str, prediction: torch.Tensor, order,
                    n_cond: int) -> torch.Tensor:
    """The corrupted frames' predictions (ref `_unet_forward`,
    models/mocodad.py:828-838)."""
    if strategy in ('inject', 'no_condition'):
        return prediction
    return _gather_frames(prediction, _order(order, prediction)[..., n_cond:])


# ---- the chain's (C, T*V, N) layout ---------------------------------------

def column_order(order: torch.Tensor, samples: int) -> torch.Tensor:
    """A window order for the b-major fold of `samples` samples per window:
    a static (T,) order as it is, a (B, T) one as (B*S, T)."""
    return order if order.dim() == 1 else order.repeat_interleave(samples, 0)


def _gather_ctn(x: torch.Tensor, idx: torch.Tensor, v: int) -> torch.Tensor:
    """Frames of x (C, T*V, N) at static (K,) or per-column (N, K) indices,
    as (C, K*V, N)."""
    c, _, n = x.shape
    f = x.reshape(c, -1, v, n)
    if idx.dim() == 1:
        out = f.index_select(1, idx)
    else:
        out = torch.gather(f, 1, idx.T[None, :, None, :].expand(
            c, idx.shape[1], v, n))
    return out.reshape(c, -1, n)


def assemble_ctn(strategy: str, cond: Optional[torch.Tensor],
                 corrupt: torch.Tensor, order: torch.Tensor, n_cond: int,
                 v: int) -> torch.Tensor:
    """`assemble_input` in the chain's layout: cond (C, Tn*V, N) and
    corrupt (C, Tc*V, N) -> the contiguous U-Net input (C, T*V, N), with
    `order` from `column_order`."""
    if strategy in ('inject', 'no_condition'):
        return corrupt
    stacked = torch.cat([cond, corrupt], dim=1)
    if strategy == 'concat':
        return stacked
    if strategy in ('random_imp', 'inbetween_imp'):
        return _gather_ctn(stacked, torch.argsort(order, dim=-1), v)
    raise ValueError(f'unknown strategy {strategy}')


def extract_ctn(strategy: str, prediction: torch.Tensor, order: torch.Tensor,
                n_cond: int, v: int) -> torch.Tensor:
    """`extract_corrupt` in the chain's layout: (C, T*V, N) ->
    (C, Tc*V, N)."""
    if strategy in ('inject', 'no_condition'):
        return prediction
    return _gather_ctn(prediction, order[..., n_cond:], v)


def to_ctn(x: torch.Tensor) -> torch.Tensor:
    """(N, C, T, V) -> the chain's contiguous (C, T*V, N)."""
    n, c = x.shape[:2]
    return x.reshape(n, c, -1).permute(1, 2, 0).contiguous()
