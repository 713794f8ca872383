"""Legacy AlphaPose-JSON dataset path (PoseDataset in the reference).

The port's copy of `mocodad_tpu/data/json_pose.py` (host NumPy, imports
rewritten).

Behavioural counterpart of utils/dataset.py:13-199 (`PoseDataset`) and
utils/dataset_utils.py (kp17->18 conversion :7-19, the four pose
normalizers :21-149, continuity-checked windowing :155-253).  Selected when
normalization_strategy != 'robust' (ref: utils/dataset.py:313-314).

The reference's np.int usages (utils/dataset_utils.py:17,240) crash on
numpy >= 1.24; fixed here.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from mocodad_tpu_torch.data.scalers import RobustScaler

# kp17 -> coco18 reorder (ref: utils/dataset_utils.py:16)
_COCO18_ORDER = np.array(
    [0, 17, 6, 8, 10, 5, 7, 9, 12, 14, 16, 11, 13, 15, 2, 1, 4, 3],
    dtype=np.int64)


def keypoints17_to_coco18(kps: np.ndarray) -> np.ndarray:
    """17-kp COCO -> 18-kp (neck = mean of shoulders) + reorder
    (ref: utils/dataset_utils.py:7-19)."""
    kp = np.asarray(kps)
    neck = 0.5 * (kp[..., 5, :] + kp[..., 6, :])
    kp = np.concatenate([kp, neck[..., None, :]], axis=-2)
    return kp[..., _COCO18_ORDER, :]


# ---------------------------------------------------------------------------
# Pose normalizers.  All take (N, T, V, F) with F = (x, y, conf).
# ---------------------------------------------------------------------------


def normalize_pose(pose_data: np.ndarray, **kwargs
                   ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """'markovitz' strategy (ref: utils/dataset_utils.py:21-60): scale by
    video resolution, optional [-1, 1] shift, optional per-sample mean
    subtraction, optional hip centring."""
    vid_res = kwargs.get('vid_res', [856, 480])
    symm_range = kwargs.get('symm_range', True)
    sub_mean = kwargs.get('sub_mean', True)
    return_mean = kwargs.get('return_mean', True)
    hip_center = kwargs.get('hip_center', False)

    norm_factor = np.array(list(vid_res) + [1], dtype=np.float64)
    data = np.asarray(pose_data, dtype=np.float64) / norm_factor
    if symm_range:
        data[..., :2] = 2 * data[..., :2] - 1

    mean_kp_val = None
    if sub_mean:
        mean_kp_val = np.mean(data[..., :2], (1, 2))
        data[..., :2] -= mean_kp_val[:, None, None, :]
    if hip_center:
        hips = data[:, :, [8, 11], :2].copy()
        data[..., :2] -= np.mean(hips, axis=2)[:, :, None, :]

    if return_mean:
        return data, mean_kp_val
    return data, None


def normalize_pose_robust(pose_data: np.ndarray, scaler=None, **kwargs
                          ) -> Tuple[np.ndarray, RobustScaler]:
    """'robust' strategy for the JSON path
    (ref: utils/dataset_utils.py:62-100): resolution + [-1,1] shift, then a
    RobustScaler over flattened (x, y) joints with 0 <-> NaN round-trip;
    confidence channel replaced by ones."""
    vid_res = kwargs.get('vid_res', [640, 360])
    symm_range = kwargs.get('symm_range', True)

    norm_factor = np.array(list(vid_res) + [1], dtype=np.float64)
    data = np.asarray(pose_data, dtype=np.float64) / norm_factor
    if symm_range:
        data[..., :2] = 2 * data[..., :2] - 1

    original_shape = data[..., :2].shape
    input_dim = original_shape[-1] * original_shape[-2]
    x = data[..., :2].reshape(-1, input_dim)
    x = np.where(x == 0.0, np.nan, x)
    if scaler is None:
        scaler = RobustScaler((10.0, 90.0)).fit(x)
    x = scaler.transform(x)
    x = np.where(np.isnan(x), 0.0, x).reshape(original_shape)
    ones = np.ones(original_shape[:-1] + (1,))
    return np.concatenate([x, ones], axis=-1), scaler


def normalize_pose_stan(pose_data: np.ndarray, **kwargs
                        ) -> Tuple[np.ndarray, None]:
    """'stan' strategy (ref: utils/dataset_utils.py:103-124)."""
    vid_res = kwargs.get('vid_res', [640, 360])
    symm_range = kwargs.get('symm_range', True)

    norm_factor = np.array(list(vid_res) + [1], dtype=np.float64)
    data = np.asarray(pose_data, dtype=np.float64) / norm_factor
    if symm_range:
        data[..., :2] = 2 * data[..., :2] - 1
    data -= np.mean(data, axis=1, keepdims=True)
    spatial_mean = np.mean(data[..., :2], axis=(2, 3), keepdims=True)
    std = np.sqrt(np.mean(np.square(data[..., :2] - spatial_mean),
                          axis=(2, 3), keepdims=True) + 1e-5)
    data[..., :2] /= std
    return data, None


def normalize_pose_bbox(pose_data: np.ndarray, **kwargs
                        ) -> Tuple[np.ndarray, None]:
    """'bbox' strategy (ref: utils/dataset_utils.py:127-149)."""
    vid_res = kwargs.get('vid_res', [640, 360])
    symm_range = kwargs.get('symm_range', True)

    norm_factor = np.array(list(vid_res) + [1], dtype=np.float64)
    data = np.asarray(pose_data, dtype=np.float64) / norm_factor
    if symm_range:
        data[..., :2] = 2 * data[..., :2] - 1
    w = (data[..., 0].max(axis=-2, keepdims=True)
         - data[..., 0].min(axis=-2, keepdims=True))
    h = (data[..., 1].max(axis=-2, keepdims=True)
         - data[..., 1].min(axis=-2, keepdims=True))
    data[..., 0] = data[..., 0] / w
    data[..., 1] = data[..., 1] / h
    return data, None


NORMALIZERS = {'markovitz': normalize_pose, 'robust': normalize_pose_robust,
               'stan': normalize_pose_stan, 'bbox': normalize_pose_bbox}


# ---------------------------------------------------------------------------
# Windowing with frame-continuity checks.
# ---------------------------------------------------------------------------


def is_seg_continuous(sorted_seg_keys: List[int], start_key: int,
                      seg_len: int, missing_th: int = 2) -> bool:
    """(ref: utils/dataset_utils.py:213-231): a window is usable when at
    most missing_th of its expected consecutive frames are absent."""
    start_idx = sorted_seg_keys.index(start_key)
    expected = set(range(start_key, start_key + seg_len))
    actual = sorted_seg_keys[start_idx:start_idx + seg_len]
    return len(expected.intersection(actual)) >= seg_len - missing_th


def single_pose_dict2np(person_dict: Dict, idx, kp_threshold: float = 0
                        ) -> Tuple[np.ndarray, List[int], List[str]]:
    """(ref: utils/dataset_utils.py:182-200)."""
    single_person = person_dict[str(idx)]
    if isinstance(single_person, list):
        merged = {}
        for sub in single_person:
            merged.update(**sub)
        single_person = merged
    keys = sorted(single_person.keys())
    meta = [int(idx), int(keys[0])]
    poses = []
    for key in keys:
        pose = np.array(single_person[key]['keypoints'],
                        dtype=np.float64).reshape(-1, 3)
        if kp_threshold > 0:
            low = pose[:, 2] < kp_threshold
            pose[low, :2] = 0
        poses.append(pose)
    return np.stack(poses, axis=0), meta, keys


def split_pose_to_segments(single_pose: np.ndarray, single_pose_meta,
                           single_pose_keys, start_ofst: int = 0,
                           seg_dist: int = 6, seg_len: int = 12,
                           scene_id='', clip_id=''):
    """(ref: utils/dataset_utils.py:234-253)."""
    clip_t, kp_count, kp_dim = single_pose.shape
    segs, metas, ids = [], [], []
    num_segs = int(np.ceil((clip_t - seg_len) / seg_dist))
    keys_sorted = sorted(int(i) for i in single_pose_keys)
    for seg_ind in range(num_segs):
        start_ind = start_ofst + seg_ind * seg_dist
        start_key = keys_sorted[start_ind]
        if is_seg_continuous(keys_sorted, start_key, seg_len):
            start_idx = keys_sorted.index(start_key)
            segs.append(single_pose[start_ind:start_ind + seg_len])
            metas.append([int(scene_id), int(clip_id),
                          int(single_pose_meta[0]), int(start_key)])
            ids.append(keys_sorted[start_idx:start_idx + seg_len])
    if segs:
        return np.stack(segs, axis=0), metas, ids
    return np.zeros((0, seg_len, kp_count, kp_dim)), metas, ids


def gen_clip_seg_data(clip_dict: Dict, start_ofst: int = 0,
                      seg_stride: int = 4, seg_len: int = 12,
                      scene_id='', clip_id='', kp_threshold: float = 0):
    """(ref: utils/dataset_utils.py:155-180)."""
    segs, metas, ids = [], [], []
    person_keys = {}
    for idx in sorted(clip_dict.keys(), key=lambda x: int(x)):
        pose, meta, keys = single_pose_dict2np(clip_dict, idx, kp_threshold)
        key = '{:02d}_{:04d}_{:02d}'.format(int(scene_id), int(clip_id),
                                            int(idx))
        person_keys[key] = keys
        s, m, i = split_pose_to_segments(pose, meta, keys, start_ofst,
                                         seg_stride, seg_len, scene_id,
                                         clip_id)
        segs.append(s)
        metas += m
        ids += i
    return np.concatenate(segs, axis=0), metas, person_keys, ids


def json_pose_windows(path_to_json: str, seg_len: int, seg_stride: int,
                      start_ofst: int = 0, kp_threshold: float = 0,
                      num_clips: Optional[int] = None,
                      normalize: bool = True,
                      normalization_strategy: str = 'markovitz',
                      kp18_format: bool = True, headless: bool = False,
                      scaler=None, **norm_kwargs):
    """Full JSON dataset build (ref `PoseDataset.gen_dataset`,
    utils/dataset.py:132-199).

    Returns (data (W, F, T, V) float32, meta (W, 4) int, frames (W, T) int,
    scaler-or-mean artifact).
    """
    json_list = sorted(fn for fn in os.listdir(path_to_json)
                       if fn.endswith('.json'))
    if num_clips is not None:
        json_list = json_list[:num_clips]
        # the reference then appends json_list[-num_clips:] — the SAME
        # truncated clips again, doubling every debug clip
        # (utils/dataset.py:144-145); mirrored for debug-mode parity
        json_list += json_list[-num_clips:]

    segs, metas, ids = [], [], []
    for fn in json_list:
        scene_id, clip_id = fn.split('_')[:2]
        with open(os.path.join(path_to_json, fn)) as f:
            clip_dict = json.load(f)
        s, m, _, i = gen_clip_seg_data(clip_dict, start_ofst, seg_stride,
                                       seg_len, scene_id, clip_id,
                                       kp_threshold)
        segs.append(s)
        metas += m
        ids += i
    data = np.concatenate(segs, axis=0)

    if kp18_format and data.shape[-2] == 17:
        data = keypoints17_to_coco18(data)
    if headless:
        data = data[:, :, :14]

    artifact = None
    if normalize:
        fn = NORMALIZERS[normalization_strategy]
        if normalization_strategy == 'robust':
            data, artifact = fn(data, scaler=scaler, **norm_kwargs)
        else:
            data, artifact = fn(data, **norm_kwargs)

    data = np.transpose(data, (0, 3, 1, 2)).astype(np.float32)
    meta = np.asarray(metas, dtype=np.int64).reshape(-1, 4)
    frames = np.asarray(ids, dtype=np.int32).reshape(-1, seg_len) \
        if ids else np.zeros((0, seg_len), np.int32)
    return data, meta, frames, artifact
