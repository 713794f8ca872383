"""Anomaly-score post-processing: window losses -> frame-level AUC-ROC.

Behavioural counterpart of MoCoDAD.post_processing
(the reference's models/mocodad.py:337-430): per transformation x clip x
actor, scatter window losses onto the frame timeline, nanmax over windows,
optional absence padding, actor aggregation (mean + log1p amplitude), HR
masking, shift + gaussian smoothing, transform averaging, AUC.

Host-side NumPy, as in the reference — the arrays here are tiny relative
to the device work, and the control flow is ragged (per-clip / per-actor
grouping).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from mocodad_tpu_torch.eval.auc import roc_auc_score
from mocodad_tpu_torch.eval.scoring import (compute_var_matrix,
                                            get_avenue_mask,
                                            get_hr_ubnormal_mask, pad_scores,
                                            score_process)


def clip_frame_scores(out_sc: np.ndarray, meta_sc: np.ndarray,
                      frames_sc: np.ndarray, n_frames: int,
                      gt: Optional[np.ndarray] = None,
                      pad_size: int = -1) -> np.ndarray:
    """Per-frame anomaly scores for ONE clip under ONE transformation
    (the inner block of `post_processing`; ref models/mocodad.py:386-401):
    per actor, scatter window losses onto the frame timeline, nanmax over
    covering windows, optional absence padding (needs `gt` for the
    presence intervals), then actor aggregation mean + log1p amplitude.
    Actor-less clips score all-normal (the reference crashes there)."""
    figs_ids = sorted(set(meta_sc[:, 2].tolist()))
    error_per_person = []
    for fig in figs_ids:
        cond_fig = meta_sc[:, 2] == fig
        out_fig, frames_fig = out_sc[cond_fig], frames_sc[cond_fig]
        loss_matrix = compute_var_matrix(out_fig, frames_fig, n_frames)
        fig_loss = np.nanmax(loss_matrix, axis=0)
        if pad_size != -1:
            if gt is None:
                raise ValueError('pad_size != -1 requires the gt mask '
                                 '(absence intervals come from it)')
            fig_loss = pad_scores(fig_loss, gt, pad_size)
        error_per_person.append(fig_loss)

    if not error_per_person:
        return np.zeros(n_frames)
    clip_score = np.stack(error_per_person, axis=0)
    clip_log = np.log1p(clip_score)
    return (np.mean(clip_score, axis=0)
            + (np.amax(clip_log, axis=0) - np.amin(clip_log, axis=0)))


def post_processing(out: np.ndarray, trans: np.ndarray, meta: np.ndarray,
                    frames: np.ndarray, *, gt_path: str, num_transform: int,
                    dataset_name: str, split: str, use_hr: bool,
                    pad_size: int, filter_kernel_size: float,
                    frames_shift: int,
                    hr_masks_root: Optional[str] = None,
                    return_scores: bool = False):
    """Compute frame-level AUC from per-window losses.

    out: (W,) per-window anomaly score (the selected sample's loss).
    trans: (W,) transform index; meta: (W, 4) [scene, clip, person, start];
    frames: (W, T) 1-indexed frame numbers.
    """
    out = np.asarray(out)
    if out.ndim != 1:
        raise ValueError(
            "post_processing expects per-window scalar losses "
            "(model_return_value='loss'); got shape %r" % (out.shape,))

    all_gts = sorted(f for f in os.listdir(gt_path) if f.endswith('.npy'))
    scene_clips = [(int(f.split('_')[0]), int(f.split('_')[1].split('.')[0]))
                   for f in all_gts]
    # load each gt mask once, not once per transformation
    gt_arrays = [np.load(os.path.join(gt_path, f)) for f in all_gts]

    hr_ubnormal = {}
    if use_hr and dataset_name == 'UBnormal':
        kwargs = {'masks_root': hr_masks_root} if hr_masks_root else {}
        hr_ubnormal = get_hr_ubnormal_mask(split, **kwargs)
    hr_avenue = get_avenue_mask() if dataset_name == 'HR-Avenue' else {}

    model_scores_transf = {}
    dataset_gt_transf = {}

    for transformation in range(num_transform):
        cond = trans == transformation
        out_t, meta_t, frames_t = out[cond], meta[cond], frames[cond]

        dataset_gt = []
        model_scores = []
        for idx, (scene_idx, clip_idx) in enumerate(scene_clips):
            gt = gt_arrays[idx]
            n_frames = gt.shape[0]

            cond_sc = (meta_t[:, 0] == scene_idx) & (meta_t[:, 1] == clip_idx)
            out_sc, meta_sc, frames_sc = (out_t[cond_sc], meta_t[cond_sc],
                                          frames_t[cond_sc])

            clip_score = clip_frame_scores(out_sc, meta_sc, frames_sc,
                                           n_frames, gt=gt,
                                           pad_size=pad_size)

            if (scene_idx, clip_idx) in hr_ubnormal:
                m = hr_ubnormal[(scene_idx, clip_idx)]
                clip_score, gt = clip_score[m], gt[m]
            if clip_idx in hr_avenue:
                m = np.array(hr_avenue[clip_idx]) == 1
                clip_score, gt = clip_score[m], gt[m]

            clip_score = score_process(clip_score, frames_shift,
                                       filter_kernel_size)
            model_scores.append(clip_score)
            dataset_gt.append(gt)

        model_scores_transf[transformation] = np.concatenate(model_scores)
        dataset_gt_transf[transformation] = np.concatenate(dataset_gt)

    pds = np.mean(np.stack(list(model_scores_transf.values()), 0), 0)
    gt = dataset_gt_transf[0]
    auc = roc_auc_score(gt, pds)
    if return_scores:
        return auc, pds, gt
    return auc


def post_processing_from_config(out, trans, meta, frames, cfg,
                                **overrides) -> float:
    # num_transform: 0 selects the old_aug (random-temporal-crop) training
    # path; its windows are stored once under trans index 0, so scoring
    # always iterates at least one transform (same clamp as the loaders,
    # training/loop.py and data/pipeline.py)
    kwargs = dict(gt_path=cfg.gt_path, num_transform=max(cfg.num_transform, 1),
                  dataset_name=cfg.dataset_choice, split=cfg.split,
                  use_hr=cfg.use_hr, pad_size=cfg.pad_size,
                  filter_kernel_size=cfg.filter_kernel_size,
                  frames_shift=cfg.frames_shift,
                  hr_masks_root=cfg.extras.get('hr_masks_root'))
    kwargs.update(overrides)
    return post_processing(out, trans, meta, frames, **kwargs)
