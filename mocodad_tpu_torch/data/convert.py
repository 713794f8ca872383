"""Annotation-format conversion: AlphaPose tracked-person JSON ->
CSV trajectory layout (the port's copy of `mocodad_tpu/data/convert.py`).

    python -m mocodad_tpu_torch.data.convert --json-dir <dir> --out <dir>

The two on-disk input formats (docs/annotations.md) come from different
stages of the upstream tooling; every shipped config consumes the CSV
("robust") layout.  This converter bridges them so a dataset annotated
with the AlphaPose+PoseFlow image (tools/annotations/) can feed the main
path directly (ref counterparts: the JSON is what utils/dataset.py's
PoseDataset reads; the CSVs are what utils/get_robust_data.py reads).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np


def tracked_json_to_trajectories(json_path: str, out_dir: str,
                                 scene_clip: Optional[str] = None,
                                 n_joints: int = 17) -> int:
    """One `{scene}_{clip}_alphapose_tracked_person.json` -> per-actor
    `{out_dir}/{scene}-{clip}/{person}.csv` files (frame, x1, y1, ...).

    Returns the number of actor CSVs written.  Missing frames are simply
    absent rows (the windowing stage handles gaps); keypoint confidences
    are dropped — the CSV layout carries coordinates only.
    """
    name = os.path.basename(json_path)
    if scene_clip is None:
        parts = name.split('_')
        scene_clip = f'{parts[0]}-{parts[1]}'
    folder = os.path.join(out_dir, scene_clip)
    os.makedirs(folder, exist_ok=True)

    with open(json_path) as f:
        tracked = json.load(f)

    written = 0
    for person_id, frames in tracked.items():
        rows = []
        for frame, det in sorted(frames.items(), key=lambda kv: int(kv[0])):
            kp = np.asarray(det['keypoints'], np.float64).reshape(-1, 3)
            if kp.shape[0] != n_joints:
                raise ValueError(
                    f'{name}: person {person_id} frame {frame} has '
                    f'{kp.shape[0]} keypoints, expected {n_joints}')
            rows.append(np.concatenate([[float(frame)],
                                        kp[:, :2].reshape(-1)]))
        if not rows:
            continue
        arr = np.stack(rows)
        path = os.path.join(folder, f'{int(person_id):04d}.csv')
        with open(path, 'w') as f:
            for row in arr:
                f.write('%d,' % row[0])
                f.write(','.join('%.4f' % v for v in row[1:]))
                f.write('\n')
        written += 1
    return written


def convert_split(json_dir: str, out_dir: str) -> int:
    """Convert every tracked-person JSON in a directory; returns total
    actor CSVs written."""
    total = 0
    for fname in sorted(os.listdir(json_dir)):
        if fname.endswith('.json'):
            total += tracked_json_to_trajectories(
                os.path.join(json_dir, fname), out_dir)
    return total


def main() -> None:
    import argparse
    p = argparse.ArgumentParser(
        description='AlphaPose tracked-person JSON -> CSV trajectories')
    p.add_argument('--json-dir', required=True,
                   help='directory of *_alphapose_tracked_person.json')
    p.add_argument('--out', required=True,
                   help='output trajectories/ directory')
    a = p.parse_args()
    n = convert_split(a.json_dir, a.out)
    print(f'wrote {n} actor trajectory files to {a.out}')


if __name__ == '__main__':
    main()
