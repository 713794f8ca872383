"""Frame selection and input assembly.

PyTorch counterpart of `mocodad_tpu/models/frames.py` (reference
models/mocodad.py:523-543, :654-686, :708-750, :811-840).  Selection is a
gather with a frame ORDER array: order[:n_cond] holds the (sorted)
conditioning positions, order[n_cond:] the (sorted) corrupted positions.
This slice ports the static orders and the inject / no_condition assembly
(an identity); the other strategies are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def static_order(cond_idxs: Tuple[int, ...], corrupt_idxs: Tuple[int, ...]
                 ) -> np.ndarray:
    """(T,) frame order for the deterministic strategies."""
    return np.asarray(tuple(cond_idxs) + tuple(corrupt_idxs), dtype=np.int64)


def _gather_frames(x: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """Frames (axis 2 of (B, C, T, V)) at static (K,) indices."""
    return x[:, :, torch.as_tensor(idx, device=x.device)]


def select_frames(data: torch.Tensor, order: np.ndarray, n_cond: int
                  ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Split (B, C, T, V) into (conditioning, corrupted) frame groups."""
    if n_cond == 0:
        return None, data
    return (_gather_frames(data, order[:n_cond]),
            _gather_frames(data, order[n_cond:]))


def _check_strategy(strategy: str) -> None:
    if strategy not in ('inject', 'no_condition'):
        raise NotImplementedError(
            f'conditioning strategy {strategy!r} is not ported yet')


def assemble_input(strategy: str, cond: Optional[torch.Tensor],
                   corrupt: torch.Tensor, order: np.ndarray, n_cond: int
                   ) -> torch.Tensor:
    """U-Net input (ref `_prepare_input_data`, models/mocodad.py:654-686):
    the corrupted frames themselves for inject / no_condition."""
    _check_strategy(strategy)
    return corrupt


def extract_corrupt(strategy: str, prediction: torch.Tensor,
                    order: np.ndarray, n_cond: int) -> torch.Tensor:
    """Corrupted-frame predictions (ref `_unet_forward`,
    models/mocodad.py:828-838): all of them for inject / no_condition."""
    _check_strategy(strategy)
    return prediction
