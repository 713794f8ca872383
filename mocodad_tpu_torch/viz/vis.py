"""Skeleton and anomaly-score visualization.

The port's copy of `mocodad_tpu/viz/vis.py` (reference visualize/vis.py,
`ClipVisualizer` :26-264, and visualize/extract_frames.py): COCO-17
skeletons drawn over a clip's extracted frames, with a per-frame anomaly
score strip, exported as mp4 or gif.  matplotlib, and cv2 for frame
extraction, are imported inside the functions that use them.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

# COCO-17 skeleton bone list (ref: visualize/vis.py:31-34)
COCO17_BONES = [
    (0, 1), (0, 2), (1, 3), (2, 4),           # head
    (5, 6), (5, 7), (7, 9), (6, 8), (8, 10),  # arms
    (5, 11), (6, 12), (11, 12),               # torso
    (11, 13), (13, 15), (12, 14), (14, 16),   # legs
]


def extract_frames(video_path: str, out_dir: str,
                   every: int = 1) -> int:
    """Dump video frames as numbered .jpg files
    (ref: visualize/extract_frames.py:10-25)."""
    import cv2
    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    i = saved = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if i % every == 0:
            cv2.imwrite(os.path.join(out_dir, f'{i:06d}.jpg'), frame)
            saved += 1
        i += 1
    cap.release()
    return saved


class ClipVisualizer:
    """Animate per-actor skeleton trajectories over a clip, with optional
    per-frame anomaly-score strip and ground-truth shading."""

    def __init__(self, trajectories: Dict[str, np.ndarray],
                 frames_dir: Optional[str] = None,
                 vid_res: Sequence[int] = (640, 360),
                 scores: Optional[np.ndarray] = None,
                 gt: Optional[np.ndarray] = None,
                 bones=COCO17_BONES):
        """trajectories: {person_id: (T, 34) image-space coordinates} with
        row t corresponding to clip frame t (zeros = missing)."""
        self.trajectories = trajectories
        self.frames_dir = frames_dir
        self.vid_res = vid_res
        self.scores = scores
        self.gt = gt
        self.bones = bones
        self.n_frames = max(t.shape[0] for t in trajectories.values())

    def _frame_image(self, idx: int):
        if self.frames_dir is None:
            return None
        for pattern in (f'{idx:06d}.jpg', f'{idx}.jpg', f'{idx:04d}.jpg'):
            path = os.path.join(self.frames_dir, pattern)
            if os.path.exists(path):
                import matplotlib.image as mpimg
                return mpimg.imread(path)
        return None

    def _draw_frame(self, ax, idx: int):
        ax.clear()
        img = self._frame_image(idx)
        if img is not None:
            ax.imshow(img)
        else:
            ax.set_xlim(0, self.vid_res[0])
            ax.set_ylim(self.vid_res[1], 0)
        for pid, coords in self.trajectories.items():
            if idx >= coords.shape[0]:
                continue
            kp = coords[idx].reshape(-1, 2)
            if not np.any(kp):
                continue
            visible = np.any(kp != 0, axis=1)
            ax.scatter(kp[visible, 0], kp[visible, 1], s=8)
            for a, b in self.bones:
                if a < len(kp) and b < len(kp) and visible[a] and visible[b]:
                    ax.plot([kp[a, 0], kp[b, 0]], [kp[a, 1], kp[b, 1]],
                            linewidth=1)
        ax.set_title(f'frame {idx}')
        ax.axis('off')

    def animate(self, out_path: Optional[str] = None, fps: int = 10,
                score_strip: bool = True):
        """Build the animation; saves mp4/gif when out_path is given."""
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        from matplotlib.animation import FuncAnimation

        has_scores = score_strip and self.scores is not None
        if has_scores:
            fig, (ax, ax_s) = plt.subplots(
                2, 1, figsize=(8, 7), height_ratios=[4, 1])
            ax_s.plot(self.scores, linewidth=1)
            if self.gt is not None:
                ax_s.fill_between(np.arange(len(self.gt)), 0,
                                  np.max(self.scores) * self.gt,
                                  alpha=0.3, step='mid')
            cursor = ax_s.axvline(0)
            ax_s.set_xlabel('frame')
            ax_s.set_ylabel('anomaly score')
        else:
            fig, ax = plt.subplots(figsize=(8, 6))
            cursor = None

        def update(idx):
            self._draw_frame(ax, idx)
            if cursor is not None:
                cursor.set_xdata([idx, idx])
            return []

        anim = FuncAnimation(fig, update, frames=self.n_frames,
                             interval=1000 / fps)
        if out_path:
            if out_path.endswith('.gif'):
                anim.save(out_path, writer='pillow', fps=fps)
            else:
                anim.save(out_path, fps=fps)
            plt.close(fig)
        return anim

    def save_frame(self, idx: int, out_path: str):
        """Render a single frame to an image file."""
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(8, 6))
        self._draw_frame(ax, idx)
        fig.savefig(out_path, bbox_inches='tight')
        plt.close(fig)
