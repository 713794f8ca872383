"""Anomaly-score assembly primitives.

Behavioural counterparts of the reference's utils/eval_utils.py:
`compute_var_matrix` :27-34, `score_process` :100-106, `ranges` :109-113,
`pad_scores` :133-149, `get_avenue_mask` :152-166,
`get_hr_ubnormal_mask` :169-185 — all host-side NumPy, like the reference.
The gaussian smoother is a standalone scipy.ndimage.gaussian_filter1d
equivalent (order 0, mode 'reflect', truncate 4.0) so the framework has no
scipy dependency.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Dict, List, Tuple

import numpy as np


def gaussian_filter1d(x: np.ndarray, sigma: float,
                      truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage.gaussian_filter1d(x, sigma) equivalent
    (order=0, mode='reflect')."""
    x = np.asarray(x, dtype=np.float64)
    lw = int(truncate * float(sigma) + 0.5)
    if lw == 0:
        return x.copy()
    t = np.arange(-lw, lw + 1, dtype=np.float64)
    w = np.exp(-0.5 * (t / sigma) ** 2)
    w /= w.sum()
    padded = np.pad(x, lw, mode='symmetric')  # == scipy 'reflect'
    return np.convolve(padded, w, mode='valid')


def compute_fig_matrix(pos: np.ndarray, frames_pos: np.ndarray,
                       n_frames: int) -> np.ndarray:
    """Scatter per-window POSE tensors onto the clip timeline: (W, C, T, V)
    windows -> (W, n_frames, V*C) with rows placed at frames_pos-1
    (ref: utils/eval_utils.py:13-24)."""
    assert pos.ndim == 4
    w, dim, timesteps, joints = pos.shape
    flat = pos.transpose(0, 2, 3, 1).reshape(w, timesteps, joints * dim)
    pose = np.zeros((w, n_frames, joints * dim))
    rows = np.repeat(np.arange(w), timesteps)
    cols = (frames_pos - 1).reshape(-1)
    pose[rows, cols] = flat.reshape(-1, joints * dim)
    return pose


def compute_var_matrix(pos: np.ndarray, frames_pos: np.ndarray,
                       n_frames: int) -> np.ndarray:
    """Scatter per-window scalar scores onto the clip frame timeline.

    pos: (W,) scores; frames_pos: (W, T) 1-indexed frame numbers.
    Returns (W, n_frames) with pos[n] written at frames_pos[n]-1
    (ref: utils/eval_utils.py:27-34)."""
    w = pos.shape[0]
    mat = np.zeros((w, n_frames), dtype=np.float64)
    rows = np.repeat(np.arange(w), frames_pos.shape[1])
    cols = (frames_pos - 1).reshape(-1)
    mat[rows, cols] = np.repeat(pos, frames_pos.shape[1])
    return mat


def score_process(score: np.ndarray, shift: int, kernel_size: float
                  ) -> np.ndarray:
    """Shift the score forward by `shift` frames then gaussian-smooth with
    sigma = kernel_size (ref: utils/eval_utils.py:100-106)."""
    if shift <= 0:
        raise ValueError('frames_shift must be >= 1 (the reference slices '
                         'score[:-shift])')
    shifted = np.zeros_like(score)
    shifted[shift:] = score[:-shift]
    return gaussian_filter1d(shifted, kernel_size)


def ranges(nums) -> List[Tuple[int, int]]:
    """Contiguous ranges of a set of ints (ref: utils/eval_utils.py:109-113)."""
    nums = sorted(set(nums))
    gaps = [[s, e] for s, e in zip(nums, nums[1:]) if s + 1 < e]
    edges = iter(nums[:1] + sum(gaps, []) + nums[-1:])
    return list(zip(edges, edges))


def pad_scores(fig_reconstruction_loss: np.ndarray, gt: np.ndarray,
               pad_size: int) -> np.ndarray:
    """Zero out actor-absence intervals, widened by pad_size
    (ref: utils/eval_utils.py:133-149).  Returns a new array (the
    reference mutates in place; a public helper should not)."""
    fig_reconstruction_loss = np.array(fig_reconstruction_loss)
    zero_interval = (set(range(len(gt) - 1))
                     - set(np.nonzero(fig_reconstruction_loss)[0]))
    non_presence_intervals = ranges(zero_interval)
    nope = []
    for interval in non_presence_intervals:
        start, end = interval
        if start == 0 and end == len(gt) - 2:
            continue
        elif start == 0 and end != len(gt) - 2:
            nope.append((start, min(end + pad_size, len(gt))))
        elif start != 0 and end == len(gt) - 2:
            nope.append((max(start - pad_size, 0), end))
        else:
            nope.append((max(start - pad_size, 0), min(end + pad_size,
                                                       len(gt))))
    for interval in nope:
        fig_reconstruction_loss[interval[0]:interval[1]] = 0
    return fig_reconstruction_loss


def get_avenue_mask() -> Dict[int, List[int]]:
    """HR-Avenue per-clip human-related frame masks — dataset constants
    (ref: utils/eval_utils.py:152-166)."""
    v01 = [1] * 75 + [0] * 46 + [1] * 269 + [0] * 47 + [1] * 427 + [0] * 47 \
        + [1] * 20 + [0] * 70 + [1] * 438   # 1439 frames
    v02 = [1] * 272 + [0] * 48 + [1] * 403 + [0] * 41 + [1] * 447  # 1211
    v03 = [1] * 293 + [0] * 48 + [1] * 582                          # 923
    v06 = [1] * 561 + [0] * 64 + [1] * 189 + [0] * 193 + [1] * 276  # 1283
    v16 = [1] * 728 + [0] * 12                                      # 740
    return {1: v01, 2: v02, 3: v03, 6: v06, 16: v16}


def get_hr_ubnormal_mask(split: str,
                         masks_root: str = './data/UBnormal/hr_bool_masks'
                         ) -> Dict[Tuple[int, int], np.ndarray]:
    """HR-UBnormal boolean frame masks from .npy files
    (ref: utils/eval_utils.py:169-185)."""
    split = 'testing' if 'test' in split else 'validating'
    pattern = os.path.join(masks_root, split, 'test_frame_mask', '*')
    masks: Dict[Tuple[int, int], np.ndarray] = {}
    for path in glob(pattern):
        scene_clip_id = os.path.basename(path).split('.')[0]
        scene_id, clip_id = map(int, scene_clip_id.split('_'))
        masks[(scene_id, clip_id)] = np.load(path)
    return masks
