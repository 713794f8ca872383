"""Synthetic micro-dataset generator (UBnormal-layout CSV trajectories).

The reference has no test fixtures at all (SURVEY.md section 4); this module
provides a deterministic synthetic dataset in the exact on-disk layout the
robust CSV path consumes:

  {out}/training/trajectories/{scene}-{clip}/{person}.csv
  {out}/validating/trajectories/..., {out}/testing/trajectories/...
  {out}/validating/test_frame_mask/{scene}_{clip}.npy   (0/1 gt per frame)
  {out}/testing/test_frame_mask/{scene}_{clip}.npy

Normal actors follow smooth sinusoidal gaits; anomalous actors (test split
only) have high-frequency, large-amplitude jitter over a contiguous frame
interval which is flagged in the gt masks.  A trained MoCoDAD should score
those frames higher — the dataset supports a real end-to-end
train -> eval -> AUC check.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

# a rough 17-joint human template (x, y offsets), unit height
_SKELETON = np.array([
    [0.00, 0.00], [-0.03, -0.02], [0.03, -0.02], [-0.07, 0.00], [0.07, 0.00],
    [-0.12, 0.12], [0.12, 0.12], [-0.16, 0.28], [0.16, 0.28],
    [-0.17, 0.42], [0.17, 0.42], [-0.07, 0.45], [0.07, 0.45],
    [-0.08, 0.68], [0.08, 0.68], [-0.08, 0.92], [0.08, 0.92],
], dtype=np.float64)


def _actor_track(rng, n_frames: int, vid_res, anomalous: bool,
                 anomaly_span: Tuple[int, int],
                 anomaly_strength: float = 0.35) -> np.ndarray:
    w, h = vid_res
    scale = rng.uniform(60, 140)
    x0 = rng.uniform(0.2 * w, 0.8 * w)
    y0 = rng.uniform(0.2 * h, 0.5 * h)
    vx = rng.uniform(-1.5, 1.5)
    phase = rng.uniform(0, 2 * np.pi)
    t = np.arange(n_frames)
    cx = x0 + vx * t
    cy = y0 + 2.0 * np.sin(0.15 * t + phase)
    gait = 0.04 * np.sin(0.5 * t + phase)

    joints = np.empty((n_frames, 17, 2))
    joints[..., 0] = cx[:, None] + scale * (_SKELETON[None, :, 0]
                                            + gait[:, None] * _SKELETON[None, :, 1])
    joints[..., 1] = cy[:, None] + scale * _SKELETON[None, :, 1]
    joints += rng.normal(0, 0.5, joints.shape)  # tracking noise

    if anomalous:
        a, b = anomaly_span
        jitter = rng.normal(0, anomaly_strength * scale, (b - a, 17, 2))
        joints[a:b] += jitter
    joints[..., 0] = np.clip(joints[..., 0], 1, w - 1)
    joints[..., 1] = np.clip(joints[..., 1], 1, h - 1)
    return joints.reshape(n_frames, 34)


def generate(out_dir: str, seed: int = 0, n_scenes: int = 1,
             n_clips_per_split: int = 3, n_actors: int = 3,
             n_frames: int = 120, vid_res=(640, 360),
             anomaly_strength: float = 0.35) -> None:
    """anomaly_strength scales the anomalous jitter relative to actor
    size: the default 0.35 is grossly separable (smoke tests); ~0.02 is
    comparable to the normal gait amplitude and yields mid-range AUCs
    (useful for sensitivity studies where a saturated AUC hides
    effects)."""
    rng = np.random.default_rng(seed)
    for split, has_gt, has_anom in [('training', False, False),
                                    ('validating', True, True),
                                    ('testing', True, True)]:
        for scene in range(1, n_scenes + 1):
            for clip in range(1, n_clips_per_split + 1):
                folder = os.path.join(out_dir, split, 'trajectories',
                                      f'{scene}-{clip}')
                os.makedirs(folder, exist_ok=True)
                gt = np.zeros(n_frames, dtype=np.int64)
                for person in range(1, n_actors + 1):
                    # frame numbers are 1-indexed like the real datasets:
                    # the scoring chain scatters window losses at frame-1
                    # (eval/scoring.py compute_var_matrix), so a 0-based
                    # frame would wrap to the clip's last column and shift
                    # every score one frame off its gt label
                    start = int(rng.integers(1, 11))
                    length = int(rng.integers(n_frames - 30,
                                              n_frames - start + 1))
                    frames = np.arange(start, start + length)
                    anomalous = has_anom and person == n_actors
                    span_lo = length // 3
                    span_hi = min(length, span_lo + max(10, length // 3))
                    track = _actor_track(rng, length, vid_res, anomalous,
                                         (span_lo, span_hi),
                                         anomaly_strength)
                    if anomalous:
                        gt[frames[span_lo:span_hi] - 1] = 1
                    rows = np.concatenate(
                        [frames[:, None].astype(np.float64), track], axis=1)
                    path = os.path.join(folder, f'{person:04d}.csv')
                    with open(path, 'w') as f:
                        for row in rows:
                            f.write('%d,' % row[0])
                            f.write(','.join('%.4f' % v for v in row[1:]))
                            f.write('\n')
                if has_gt:
                    mask_dir = os.path.join(out_dir, split, 'test_frame_mask')
                    os.makedirs(mask_dir, exist_ok=True)
                    np.save(os.path.join(mask_dir, f'{scene}_{clip}.npy'), gt)


if __name__ == '__main__':
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument('--out', required=True)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--frames', type=int, default=120)
    a = p.parse_args()
    generate(a.out, seed=a.seed, n_frames=a.frames)
    print(f'synthetic dataset written to {a.out}')
