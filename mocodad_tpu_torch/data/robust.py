"""The "robust" CSV-trajectory dataset build — the live path for every
shipped config (normalization_strategy == 'robust' selects it,
ref: utils/dataset.py:309-312).

Behavioural counterpart of utils/get_robust_data.py:24-190
(`data_of_combined_model`): load per-actor CSV tracks, drop short ones,
move local coordinates to the bbox-centre system (and optionally extract
global bbox features), window with stride, and robust-scale with
train-split-fitted scalers persisted as checkpoint artifacts.
"""

from __future__ import annotations

import copy
import os
from typing import Optional, Tuple

import numpy as np

from mocodad_tpu_torch.data import scalers as S
from mocodad_tpu_torch.data import trajectories as T
from mocodad_tpu_torch.data import windows as W
from mocodad_tpu_torch.data.json_pose import keypoints17_to_coco18


def _subfolder(split: str) -> str:
    if 'train' in split:
        return 'training'
    if 'test' in split:
        return 'testing'
    return 'validating'


def scaler_artifact_path(exp_dir: str, scope: str, strategy: str,
                         val: bool = False) -> str:
    """Scaler checkpoint artifact (the reference pickles sklearn objects to
    '{scope}_{strategy}.pickle', utils/get_robust_data.py:83,116; we store
    the fitted arrays as .npz)."""
    suffix = '_val' if val else ''
    return os.path.join(exp_dir, f'{scope}_{strategy}{suffix}.npz')


def _fit_or_load_scaler(trajs, split: str, exp_dir: str, strategy: str,
                        scope: str, is_ubnormal: bool):
    """Train split: fit + save.  Validation on non-UBnormal: fit + save a
    _val artifact — but ONLY for the local scaler; the reference's global
    block has just train/else branches, so the global scaler always loads
    the train-fitted artifact (ref: utils/get_robust_data.py:85-90 global
    vs :116-127 local)."""
    if split == 'train':
        _, scaler = S.scale_trajectories(T.aggregate_autoencoder_data(trajs),
                                         strategy=strategy)
        S.save_scaler(scaler, scaler_artifact_path(exp_dir, scope, strategy))
    elif split == 'validation' and not is_ubnormal and scope == 'local':
        _, scaler = S.scale_trajectories(T.aggregate_autoencoder_data(trajs),
                                         strategy=strategy)
        S.save_scaler(scaler,
                      scaler_artifact_path(exp_dir, scope, strategy, val=True))
    else:
        scaler = S.load_scaler(scaler_artifact_path(exp_dir, scope, strategy))
    return scaler


def build_robust_data(trajectories_path: str, split: str, seg_len: int,
                      seg_stride: int, vid_res, normalization_strategy: str,
                      exp_dir: str, normalize_pose: bool = True,
                      include_global: bool = False, debug: bool = False
                      ) -> Tuple[Optional[np.ndarray], np.ndarray,
                                 np.ndarray, np.ndarray]:
    """Returns (X_global or None, X_local, meta, frames).

    X_local: (W, seg_len, K*2) robust-scaled bbox-centre coordinates.
    X_global: (W, seg_len, 4) scaled global bbox features when requested.
    meta: (W, 4) [scene, clip, person, start_frame]; frames: (W, seg_len).
    """
    path = os.path.join(trajectories_path, _subfolder(split), 'trajectories')
    video_resolution = np.array(vid_res, dtype=np.float32)
    input_gap = seg_stride - 1  # (ref: utils/get_robust_data.py:44)
    is_ubnormal = 'UBnormal' in path

    trajs = T.load_trajectories(path, debug=debug, split=split)
    trajs = T.remove_short_trajectories(trajs, input_length=seg_len,
                                        input_gap=input_gap)

    x_global = None
    if include_global:
        gtrajs = copy.deepcopy(trajs)
        for t in gtrajs.values():
            t.use_global_features(video_resolution)
            t.change_coordinate_system(video_resolution, 'global')
        x_global, _, _ = W.aggregate_windows(gtrajs, seg_len, input_gap)
        if normalize_pose:
            gs = _fit_or_load_scaler(gtrajs, split, exp_dir,
                                     normalization_strategy, 'global',
                                     is_ubnormal)
            x_global, _ = S.scale_trajectories(
                x_global, scaler=gs, strategy=normalization_strategy)

    for t in trajs.values():
        t.change_coordinate_system(video_resolution, 'bounding_box_centre')
    x_local, meta, frames = W.aggregate_windows(trajs, seg_len, input_gap)
    if normalize_pose:
        ls = _fit_or_load_scaler(trajs, split, exp_dir,
                                 normalization_strategy, 'local', is_ubnormal)
        x_local, _ = S.scale_trajectories(
            x_local, scaler=ls, strategy=normalization_strategy)

    return x_global, x_local.astype(np.float32), meta, frames


def robust_pose_windows(trajectories_path: str, split: str, seg_len: int,
                        seg_stride: int, vid_res,
                        normalization_strategy: str, exp_dir: str,
                        normalize_pose: bool = True,
                        include_global: bool = False, debug: bool = False,
                        kp18_format: bool = False, headless: bool = False
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(W, C, T, V) float32 windows + meta + frames, matching
    `PoseDatasetRobust.gen_dataset` (utils/dataset.py:231-281): local coords
    reshaped to (T, 17, 2), a constant confidence channel appended
    (+ global features broadcast over joints when num_coords == 6), then
    optional kp18 / headless joint remapping, channels-first transpose."""
    x_global, x_local, meta, frames = build_robust_data(
        trajectories_path, split, seg_len, seg_stride, vid_res,
        normalization_strategy, exp_dir, normalize_pose, include_global,
        debug)

    w, t = x_local.shape[:2]
    x_local = x_local.reshape(w, t, 17, 2)
    if not include_global:
        data = np.empty((w, t, 17, 3), dtype=np.float32)
        data[..., :2] = x_local
        data[..., 2] = 1.0
    else:
        # The reference's broadcast here is shape-invalid (utils/dataset.py:266
        # assigns (W,T,4) into (W,T,17,4)); we broadcast the global features
        # across joints explicitly.
        data = np.empty((w, t, 17, 7), dtype=np.float32)
        data[..., :2] = x_local
        data[..., 2:6] = x_global[:, :, None, :]
        data[..., 6] = 1.0

    if kp18_format and data.shape[-2] == 17:
        data = keypoints17_to_coco18(data)
    if headless:
        data = data[:, :, :14]

    data = np.transpose(data, (0, 3, 1, 2)).astype(np.float32)
    return data, meta, frames
