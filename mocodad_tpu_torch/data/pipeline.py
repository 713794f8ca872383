"""Dataset assembly + host-side batch iterator.

Counterpart of `mocodad_tpu/data/pipeline.py` (reference
`get_dataset_and_loader`, utils/dataset.py:286-330): the base windows are
stored once and batches carry a transform index, applied on the device by
`data/transforms.apply_affine_batch`.  Virtual index i maps to
(sample = i % N, transform = i // N), as in the reference.  Only the
'robust' normalization (the CSV-trajectory path every shipped config
takes) is ported; the JSON-pose path is not.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from mocodad_tpu_torch.config import Config
from mocodad_tpu_torch.data.robust import robust_pose_windows


@dataclass
class PoseWindows:
    """Base (un-transformed) pose windows + metadata."""
    data: np.ndarray      # (N, C, T, V) float32
    meta: np.ndarray      # (N, 4) int64 [scene, clip, person, start_frame]
    frames: np.ndarray    # (N, T) int32 actual frame numbers
    num_transform: int
    # With no affine transform list, the reference applies a RANDOM temporal
    # crop per item instead — even at test time (utils/dataset.py:81,125-130).
    old_aug: bool = False

    @property
    def num_samples(self) -> int:
        return self.data.shape[0]

    def __len__(self) -> int:
        # virtual length: every sample under every transform
        return self.num_samples * max(self.num_transform, 1)


def build_dataset(cfg: Config, split: str = 'train') -> PoseWindows:
    """Build the window arrays for a split (ref: utils/dataset.py:286-330).

    Test/validation always use stride 1 (ref: utils/dataset.py:308,318).
    The train split fits and saves the robust scaler under cfg.ckpt_dir;
    the other splits load it (data/robust.py)."""
    if cfg.normalization_strategy != 'robust':
        raise NotImplementedError(
            f'normalization_strategy {cfg.normalization_strategy!r} needs the '
            'JSON-pose data path, which is not ported yet (robust only)')
    seg_stride = cfg.seg_stride if split == 'train' else 1
    data, meta, frames = robust_pose_windows(
        trajectories_path=cfg.data_dir, split=split, seg_len=cfg.seg_len,
        seg_stride=seg_stride, vid_res=cfg.vid_res,
        normalization_strategy=cfg.normalization_strategy,
        exp_dir=cfg.ckpt_dir, normalize_pose=True,
        include_global=(cfg.num_coords == 6), debug=cfg.debug,
        kp18_format=cfg.kp18_format, headless=cfg.headless)
    # keep only the modeled coordinate channels (ref: utils/dataset.py:75)
    data = data[:, :cfg.num_coords]
    return PoseWindows(data=data, meta=meta, frames=frames,
                       num_transform=max(cfg.num_transform, 1),
                       old_aug=(cfg.num_transform < 1))


def make_loader(ds: PoseWindows, batch_size: int, shuffle: bool = False,
                seed: int = 0, pad_to_full: bool = True
                ) -> Iterator[Dict[str, np.ndarray]]:
    """Yield host batches over the virtual (sample x transform) index space.

    Each batch carries the UN-transformed window data plus its transform
    index.  The final partial batch is padded to batch_size by wrapping the
    epoch order, with `mask` marking the valid rows."""
    n_virtual = len(ds)
    rng = np.random.default_rng(seed)
    order = np.arange(n_virtual)
    if shuffle:
        rng.shuffle(order)
    n = ds.num_samples
    for start in range(0, n_virtual, batch_size):
        idx = order[start:start + batch_size]
        valid = idx.shape[0]
        if valid < batch_size and pad_to_full:
            pad = np.resize(order, batch_size - valid).astype(idx.dtype)
            idx = np.concatenate([idx, pad])
        sample_idx = idx % n
        mask = np.zeros(idx.shape[0], dtype=np.float32)
        mask[:valid] = 1.0
        data = ds.data[sample_idx]
        if ds.old_aug:
            from mocodad_tpu_torch.data.transforms import temporal_crop
            data = np.stack([temporal_crop(d, rng=rng) for d in data])
        yield {
            'data': data,
            'trans': (idx // n).astype(np.int32),
            'meta': ds.meta[sample_idx],
            'frames': ds.frames[sample_idx],
            'mask': mask,
        }


def num_batches(ds: PoseWindows, batch_size: int) -> int:
    return -(-len(ds) // batch_size)
