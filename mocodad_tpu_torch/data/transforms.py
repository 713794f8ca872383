"""The 5 affine view transforms.

Counterpart of the view-transform part of `mocodad_tpu/data/transforms.py`
(reference utils/dataset_utils.py:255-310).  The base windows are stored
once; a batch carries a transform index per window and
`apply_affine_batch` applies the (K, 3, 3) matrix bank on the batch's
device.  Only `temporal_crop` of the augmentation library is ported (the
`num_transform < 1` path needs it).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def affine_matrix(sx=1.0, sy=1.0, tx=0.0, ty=0.0, rot=0.0,
                  flip=False) -> np.ndarray:
    """3x3 matrix: flip @ (rot @ trans_scale)
    (ref: utils/dataset_utils.py:255-269)."""
    cos_r = math.cos(math.radians(rot))
    sin_r = math.sin(math.radians(rot))
    flip_mat = np.eye(3, dtype=np.float32)
    if flip:
        flip_mat[0, 0] = -1.0
    trans_scale = np.array([[sx, 0, tx], [0, sy, ty], [0, 0, 1]],
                           dtype=np.float32)
    rot_mat = np.array([[cos_r, -sin_r, 0], [sin_r, cos_r, 0], [0, 0, 1]],
                       dtype=np.float32)
    return flip_mat @ (rot_mat @ trans_scale)


# The 5 shipped view transforms (ref: utils/dataset_utils.py:304-310):
# identity, flip, rot90, rot90+flip, rot45.
_AE_TRANS_SPECS = [
    dict(rot=0, flip=False),
    dict(rot=0, flip=True),
    dict(rot=90, flip=False),
    dict(rot=90, flip=True),
    dict(rot=45, flip=False),
]


def affine_transform_matrices(num_transform: int) -> np.ndarray:
    """(K, 3, 3) bank of the first K shipped transforms."""
    if num_transform > len(_AE_TRANS_SPECS):
        raise ValueError(f'only {len(_AE_TRANS_SPECS)} shipped transforms')
    return np.stack([affine_matrix(**spec)
                     for spec in _AE_TRANS_SPECS[:num_transform]])


def transformed_gt_data(data: np.ndarray, num_transform: int) -> np.ndarray:
    """All affine views of the stored-once windows, stacked transform-major:
    the reference's saved 'gt_data' tensor.  (N, C, T, V) -> (K*N, C, T, V).
    """
    mats = affine_transform_matrices(max(num_transform, 1))
    blocks = []
    for m in mats:
        xy = np.einsum('dk,bktv->bdtv', m[:2, :2], data[:, :2])
        xy += m[:2, 2][None, :, None, None]
        blocks.append(np.concatenate([xy, data[:, 2:]], axis=1)
                      if data.shape[1] > 2 else xy)
    return np.concatenate(blocks, axis=0)


def apply_affine_batch(data: torch.Tensor, mats: torch.Tensor,
                       trans_idx: torch.Tensor) -> torch.Tensor:
    """Batched affine on the batch's device: data (B, C, T, V) with C >= 2,
    mats (K, 3, 3), trans_idx (B,) -> transformed data.  Only (x, y) mix;
    extra channels pass through (mocodad_tpu/data/transforms.py:88-103)."""
    m = mats[trans_idx]                                   # (B, 3, 3)
    lin = torch.einsum('bdk,bktv->bdtv', m[:, :2, :2], data[:, :2])
    out_xy = lin + m[:, :2, 2][:, :, None, None]
    if data.shape[1] > 2:
        return torch.cat([out_xy, data[:, 2:]], dim=1)
    return out_xy


def temporal_crop(pose: np.ndarray, padding_ratio: int = 6,
                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Reflect-pad in time then randomly crop back to T
    (ref: utils/tools.py:66-75)."""
    rng = rng or np.random.default_rng()
    c, t, v = pose.shape
    pad = t // padding_ratio
    start = int(rng.integers(0, pad * 2 + 1))
    padded = np.concatenate([pose[:, :pad][:, ::-1], pose,
                             pose[:, -pad:][:, ::-1]], axis=1)
    return padded[:, start:start + t]
