"""Sliding-window aggregation of trajectories into model windows.

Behavioural counterpart of the reference's utils/preprocessing.py:14-86
(`aggregate_rnn_autoencoder_data` / `_aggregate_rnn_autoencoder_data`),
vectorized: windows are gathered with one index matrix per trajectory
instead of per-window Python loops.

Output contract (matches the reference's return_ids=True path):
  X      (W, input_length, D) float32 windows
  meta   (W, 4) int64 rows [scene_id, clip_id, person_id, start_frame]
  frames (W, input_length) int32 actual frame numbers per window position
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from mocodad_tpu_torch.data.trajectories import Trajectory


def window_index_matrix(n_steps: int, input_length: int, input_gap: int
                        ) -> np.ndarray:
    """(W, input_length) gather indices: dense sliding windows of span
    input_length + gap*(input_length-1), sampled every (gap+1) steps within
    the span (ref: utils/preprocessing.py:55-86)."""
    step = input_gap + 1
    span = input_length + input_gap * (input_length - 1)
    n_windows = n_steps - span + 1
    if n_windows <= 0:
        return np.zeros((0, input_length), dtype=np.int64)
    starts = np.arange(n_windows, dtype=np.int64)
    offsets = np.arange(0, span, step, dtype=np.int64)
    return starts[:, None] + offsets[None, :]


def parse_scene_clip(trajectory_id: str) -> Tuple[int, int]:
    """'{scene}-{clip}_{person}' -> (scene, clip)
    (ref: utils/preprocessing.py:25)."""
    scene_id, clip_id = trajectory_id.split('_')[0].split('-')
    return int(scene_id), int(clip_id)


def aggregate_windows(trajectories: Dict[str, Trajectory], input_length: int,
                      input_gap: int = 0
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All trajectories -> stacked windows + metadata + per-window frames."""
    xs, metas, frames_list = [], [], []
    for t in trajectories.values():
        idx = window_index_matrix(len(t), input_length, input_gap)
        if idx.shape[0] == 0:
            continue
        xs.append(t.coordinates[idx])
        fr = t.frames[idx]
        frames_list.append(fr)
        scene_id, clip_id = parse_scene_clip(t.trajectory_id)
        person = int(t.person_id)
        meta = np.empty((idx.shape[0], 4), dtype=np.int64)
        meta[:, 0] = scene_id
        meta[:, 1] = clip_id
        meta[:, 2] = person
        meta[:, 3] = fr[:, 0]
        metas.append(meta)
    if not xs:
        d = next(iter(trajectories.values())).coordinates.shape[-1] \
            if trajectories else 0
        return (np.zeros((0, input_length, d), np.float32),
                np.zeros((0, 4), np.int64),
                np.zeros((0, input_length), np.int32))
    return (np.concatenate(xs, axis=0).astype(np.float32),
            np.concatenate(metas, axis=0),
            np.concatenate(frames_list, axis=0).astype(np.int32))
