"""Per-actor pose-trajectory loading, bounding boxes, and coordinate systems.

Behavioural counterpart of the reference's utils/data.py (Trajectory :46-216,
load_trajectories :219-236, compute_bounding_box :11-43) — vectorized over
frames (the reference loops per frame / uses apply_along_axis) and with a
fast CSV reader (the reference uses np.loadtxt per file, utils/data.py:228).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List

import numpy as np


def read_csv_matrix(path: str) -> np.ndarray:
    """Comma-separated float matrix reader (rows = lines), NumPy only."""
    with open(path, 'rb') as f:
        buf = f.read()
    # utf-8-sig: tolerate a BOM; blank INTERIOR lines are skipped to match
    # the native parser's row counting (it counts non-blank lines only)
    txt = buf.decode('utf-8-sig')
    lines = [ln for ln in txt.split('\n') if ln.strip()]
    if not lines:
        return np.zeros((0, 0), dtype=np.float32)
    ncols = lines[0].count(',') + 1
    flat = np.array(' '.join(lines).replace(',', ' ').split(),
                    dtype=np.float32)
    return flat.reshape(len(lines), ncols)


def compute_bounding_boxes(coords: np.ndarray, video_resolution,
                           discrete: bool = True) -> np.ndarray:
    """Vectorized bbox per frame with the reference's semantics
    (utils/data.py:11-43): zeros are missing, +10% margin on each side,
    clipped to [0, res-1], rounded to ints when discrete.

    coords: (T, K*2) -> (T, 4) [left, right, top, bottom].  Frames where
    all x or all y are missing get an all-zero bbox (the reference's
    empty-min ValueError branch).
    """
    width, height = float(video_resolution[0]), float(video_resolution[1])
    t = coords.shape[0]
    pts = coords.reshape(t, -1, 2)
    x = np.where(pts[..., 0] == 0.0, np.nan, pts[..., 0])
    y = np.where(pts[..., 1] == 0.0, np.nan, pts[..., 1])
    bad = np.all(np.isnan(x), axis=1) | np.all(np.isnan(y), axis=1)
    # avoid all-NaN warnings
    x = np.where(bad[:, None], 0.0, x)
    y = np.where(bad[:, None], 0.0, y)
    with np.errstate(all='ignore'):
        left, right = np.nanmin(x, axis=1), np.nanmax(x, axis=1)
        top, bottom = np.nanmin(y, axis=1), np.nanmax(y, axis=1)
    extra_w = 0.1 * (right - left + 1)
    extra_h = 0.1 * (bottom - top + 1)
    left = np.clip(left - extra_w, 0, width - 1)
    right = np.clip(right + extra_w, 0, width - 1)
    top = np.clip(top - extra_h, 0, height - 1)
    bottom = np.clip(bottom + extra_h, 0, height - 1)
    bb = np.stack([left, right, top, bottom], axis=1)
    bb[bad] = 0.0
    if discrete:
        bb = np.rint(bb)
    return bb


@dataclass
class Trajectory:
    """One actor's track: frame indices + flattened keypoint coordinates
    (ref: utils/data.py:46-216)."""
    trajectory_id: str
    frames: np.ndarray       # (T,) int32
    coordinates: np.ndarray  # (T, K*2) float32
    is_global: bool = False

    @property
    def person_id(self) -> str:
        return self.trajectory_id.split('_')[1]

    def __len__(self) -> int:
        return len(self.frames)

    def is_short(self, input_length: int, input_gap: int,
                 pred_length: int = 0) -> bool:
        min_len = input_length + input_gap * (input_length - 1) + pred_length
        return len(self) < min_len

    # -- feature extraction ------------------------------------------------

    def extract_global_features(self, video_resolution) -> np.ndarray:
        """(T, 4): bbox centre (x, y) + bbox (width, height)
        (ref: utils/data.py:70-86)."""
        bb = compute_bounding_boxes(self.coordinates, video_resolution)
        centre = np.stack([(bb[:, 0] + bb[:, 1]) / 2,
                           (bb[:, 2] + bb[:, 3]) / 2], axis=1)
        measures = np.stack([bb[:, 1] - bb[:, 0],
                             bb[:, 3] - bb[:, 2]], axis=1)
        return np.hstack([centre, measures]).astype(np.float32)

    def use_global_features(self, video_resolution) -> None:
        self.coordinates = self.extract_global_features(video_resolution)
        self.is_global = True

    # -- coordinate systems --------------------------------------------------

    def change_coordinate_system(self, video_resolution,
                                 coordinate_system: str = 'global',
                                 invert: bool = False) -> None:
        res = np.asarray(video_resolution, dtype=np.float32)
        if invert:
            if coordinate_system != 'global':
                raise ValueError(
                    'Only global is available for inversion.')
            shape = self.coordinates.shape
            self.coordinates = (self.coordinates.reshape(-1, 2) * res
                                ).reshape(shape)
            return
        if coordinate_system == 'global':
            shape = self.coordinates.shape
            self.coordinates = (self.coordinates.reshape(-1, 2) / res
                                ).reshape(shape)
        elif coordinate_system == 'bounding_box_centre':
            self.coordinates = _to_bbox_centre(self.coordinates, res)
        elif coordinate_system == 'bounding_box_top_left':
            self.coordinates = _to_bbox_top_left(self.coordinates, res)
        else:
            raise ValueError(
                'Unknown coordinate system. Please select one of: global, '
                'bounding_box_top_left, or bounding_box_centre.')

    def input_missing_steps(self) -> None:
        """Linear interpolation of fully-missing steps
        (ref: utils/data.py:193-216)."""
        coords = self.coordinates
        t, d = coords.shape
        missing = np.all(coords == 0.0, axis=1)
        idx = np.arange(t)
        known = idx[~missing]
        if known.size == 0 or known.size == t:
            return
        for j in np.where(missing)[0]:
            prev = known[known < j]
            nxt = known[known > j]
            if prev.size == 0 or nxt.size == 0:
                continue  # leading/trailing gaps stay missing (as in ref)
            a, b = prev[-1], nxt[0]
            wa = (b - j) / (b - a)
            fill = wa * coords[a] + (1 - wa) * coords[b]
            fill = np.where((coords[a] == 0) | (coords[b] == 0), 0.0, fill)
            coords[j] = fill


def _to_bbox_centre(coords: np.ndarray, res: np.ndarray) -> np.ndarray:
    """(ref: utils/data.py:165-186, vectorized).  For each frame with any
    keypoints: missing coords snap to the bbox centre, then all coords are
    centred and divided by bbox width/height (zero-size -> zeros)."""
    t = coords.shape[0]
    any_kp = np.any(coords != 0.0, axis=1)
    bb = compute_bounding_boxes(coords, res)  # discrete ints as floats
    cx = (bb[:, 0] + bb[:, 1]) / 2
    cy = (bb[:, 2] + bb[:, 3]) / 2
    w = bb[:, 1] - bb[:, 0]
    h = bb[:, 3] - bb[:, 2]
    pts = coords.reshape(t, -1, 2).astype(np.float64)
    xs = np.where(pts[..., 0] == 0.0, cx[:, None], pts[..., 0]) - cx[:, None]
    ys = np.where(pts[..., 1] == 0.0, cy[:, None], pts[..., 1]) - cy[:, None]
    with np.errstate(all='ignore'):
        xs = np.where(w[:, None] != 0, xs / w[:, None], 0.0)
        ys = np.where(h[:, None] != 0, ys / h[:, None], 0.0)
    out = np.stack([xs, ys], axis=-1).reshape(t, -1)
    out = np.where(any_kp[:, None], out, coords)
    return out.astype(np.float32)


def _to_bbox_top_left(coords: np.ndarray, res: np.ndarray) -> np.ndarray:
    """(ref: utils/data.py:151-162, vectorized)."""
    t = coords.shape[0]
    any_kp = np.any(coords != 0.0, axis=1)
    bb = compute_bounding_boxes(coords, res)
    left, right, top, bottom = bb[:, 0], bb[:, 1], bb[:, 2], bb[:, 3]
    pts = coords.reshape(t, -1, 2).astype(np.float64)
    xs = np.where(pts[..., 0] == 0.0, left[:, None], pts[..., 0])
    ys = np.where(pts[..., 1] == 0.0, top[:, None], pts[..., 1])
    with np.errstate(all='ignore'):
        xs = (xs - left[:, None]) / (right - left)[:, None]
        ys = (ys - top[:, None]) / (bottom - top)[:, None]
    out = np.stack([xs, ys], axis=-1).reshape(t, -1)
    out = np.where(any_kp[:, None], out, coords)
    return out.astype(np.float32)


def load_trajectories(trajectories_path: str, debug: bool = False,
                      split: str = 'train') -> Dict[str, Trajectory]:
    """Load {scene-clip}/{person}.csv tracks (ref: utils/data.py:219-236).

    Folder iteration is sorted for determinism (the reference uses raw
    os.listdir order)."""
    trajectories: Dict[str, Trajectory] = {}
    folder_names = sorted(os.listdir(trajectories_path))
    if debug:
        folder_names = folder_names[:5]
    for folder_name in folder_names:
        folder = os.path.join(trajectories_path, folder_name)
        for csv_file_name in sorted(os.listdir(folder)):
            m = read_csv_matrix(os.path.join(folder, csv_file_name))
            if m.size == 0:
                continue
            person_id = csv_file_name.split('.')[0]
            trajectory_id = folder_name + '_' + person_id
            trajectories[trajectory_id] = Trajectory(
                trajectory_id=trajectory_id,
                frames=m[:, 0].astype(np.int32),
                coordinates=m[:, 1:].astype(np.float32))
    return trajectories


def remove_short_trajectories(trajectories: Dict[str, Trajectory],
                              input_length: int, input_gap: int,
                              pred_length: int = 0) -> Dict[str, Trajectory]:
    """(ref: utils/preprocessing.py:4-10)."""
    return {tid: t for tid, t in trajectories.items()
            if not t.is_short(input_length, input_gap, pred_length)}


def aggregate_autoencoder_data(trajectories: Dict[str, Trajectory]
                               ) -> np.ndarray:
    """Stack all per-frame coordinates (scaler-fit input; ref:
    utils/data.py:362-367)."""
    return np.vstack([t.coordinates for t in trajectories.values()])


def load_anomaly_masks(anomaly_masks_path: str) -> Dict[str, np.ndarray]:
    """{file stem: 0/1 frame mask} (ref: utils/data.py:396-404)."""
    masks = {}
    for file_name in sorted(os.listdir(anomaly_masks_path)):
        full_id = file_name.split('.')[0]
        masks[full_id] = np.load(os.path.join(anomaly_masks_path, file_name))
    return masks


def assemble_ground_truth_and_reconstructions(
        anomaly_masks: Dict[str, np.ndarray], trajectory_ids: np.ndarray,
        reconstruction_frames: np.ndarray, reconstruction_errors: np.ndarray,
        return_video_ids: bool = False):
    """Per-video max-pooled reconstruction errors aligned with ground truth
    (ref: utils/data.py:407-437).  trajectory_ids are '{video}_{person}'."""
    y_true, y_hat = {}, {}
    for full_id, mask in anomaly_masks.items():
        y_true[full_id] = mask.astype(np.int32)
        y_hat[full_id] = np.zeros_like(y_true[full_id], dtype=np.float32)

    for trajectory_id in np.unique(trajectory_ids):
        video_id = str(trajectory_id).split('_')[0]
        sel = trajectory_ids == trajectory_id
        frames = reconstruction_frames[sel] - 1  # frames are 1-indexed
        y_hat[video_id][frames] = np.maximum(
            y_hat[video_id][frames], reconstruction_errors[sel])

    y_true_, y_hat_, video_ids = [], [], []
    for video_id in sorted(y_true.keys()):
        y_true_.append(y_true[video_id])
        y_hat_.append(y_hat[video_id])
        video_ids.extend([video_id] * len(y_true_[-1]))
    y_true_, y_hat_ = np.concatenate(y_true_), np.concatenate(y_hat_)
    if return_video_ids:
        return y_true_, y_hat_, video_ids
    return y_true_, y_hat_


def quantile_transform_errors(y_hats: Dict[str, np.ndarray]
                              ) -> Dict[str, np.ndarray]:
    """Map each camera's scores to uniform quantiles
    (ref: utils/data.py:440-444 = sklearn quantile_transform defaults).

    Mirrors sklearn's forward/backward-interpolation average so TIED
    scores (ubiquitous: every actor-less frame scores exactly 0) map to
    one shared quantile — a rank transform would spread ties across
    distinct position-dependent values."""
    for camera_id, y_hat in y_hats.items():
        y = np.asarray(y_hat, dtype=np.float64)
        n_q = max(min(1000, len(y)), 1)
        refs = np.linspace(0.0, 1.0, n_q, endpoint=True)
        quantiles = np.maximum.accumulate(np.nanpercentile(y, refs * 100))
        fwd = np.interp(y, quantiles, refs)
        bwd = np.interp(-y, -quantiles[::-1], -refs[::-1])
        y_hats[camera_id] = 0.5 * (fwd - bwd)
    return y_hats
