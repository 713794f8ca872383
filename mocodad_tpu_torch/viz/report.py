"""Anomaly-score analysis report: per-clip score-vs-GT figures, the
per-clip statistics table and one self-contained HTML page.

The port's copy of `mocodad_tpu/viz/report.py` (the counterpart of the
reference's visualize/visualize.ipynb and its streamlit WebApp,
visualize/vis.py:14-24), on the port's `eval/scoring`.  matplotlib is
imported inside the functions that draw.  The JAX package's streamlit
wrapper (viz/webapp.py) has no copy here.
"""

from __future__ import annotations

import base64
import html
import io
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from mocodad_tpu_torch.eval.scoring import (compute_var_matrix,
                                            score_process)


def per_person_scores(out: np.ndarray, trans: np.ndarray, meta: np.ndarray,
                      frames: np.ndarray, gt_path: str,
                      transformation: int = 0
                      ) -> Dict[Tuple[int, int], Dict]:
    """Group per-window losses into per-clip, per-person frame score rows
    (the `error_per_person` matrix the reference notebook loads from .npy,
    visualize.ipynb cell 6)."""
    out, trans = np.asarray(out), np.asarray(trans)
    meta, frames = np.asarray(meta), np.asarray(frames)
    all_gts = sorted(f for f in os.listdir(gt_path) if f.endswith('.npy'))
    cond_t = trans == transformation
    out_t, meta_t, frames_t = out[cond_t], meta[cond_t], frames[cond_t]

    clips = {}
    for fname in all_gts:
        scene_idx = int(fname.split('_')[0])
        clip_idx = int(fname.split('_')[1].split('.')[0])
        gt = np.load(os.path.join(gt_path, fname))
        n_frames = gt.shape[0]
        cond = (meta_t[:, 0] == scene_idx) & (meta_t[:, 1] == clip_idx)
        out_sc, meta_sc, frames_sc = out_t[cond], meta_t[cond], frames_t[cond]
        persons = sorted(set(meta_sc[:, 2].tolist()))
        rows = []
        for fig in persons:
            c = meta_sc[:, 2] == fig
            m = compute_var_matrix(out_sc[c], frames_sc[c], n_frames)
            with np.errstate(all='ignore'):
                rows.append(np.nan_to_num(np.nanmax(m, axis=0)))
        epp = (np.stack(rows, 0) if rows else np.zeros((0, n_frames)))
        clips[(scene_idx, clip_idx)] = dict(error_per_person=epp, gt=gt,
                                            persons=persons)
    return clips


def clip_score_figure(error_per_person: np.ndarray, gt: np.ndarray,
                      out_path: Optional[str] = None, *,
                      frames_shift: int = 0, kernel_size: float = 10.0,
                      log_scale: bool = False, title: str = ''):
    """Per-person score curves + smoothed clip score + GT shading
    (visualize.ipynb cells 11-12)."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    n_frames = gt.shape[0]
    fr = np.arange(n_frames)
    fig, ax = plt.subplots(figsize=(12, 5))
    for i in range(error_per_person.shape[0]):
        ax.plot(fr, error_per_person[i], linewidth=1.2,
                label=f'Person {i + 1}')
    if error_per_person.shape[0]:
        raw = np.amax(error_per_person, axis=0)
        if frames_shift >= 1:  # score_process requires shift >= 1
            clip = score_process(raw, frames_shift, kernel_size)
        else:
            from mocodad_tpu_torch.eval.scoring import gaussian_filter1d
            clip = gaussian_filter1d(raw, kernel_size)
        ax.plot(fr, clip, 'k--', linewidth=2.5, label='clip score')
        top = max(float(np.max(error_per_person)), float(np.max(clip)), 1e-9)
    else:
        top = 1.0
    ax.fill_between(fr, 0, top * gt, alpha=0.2, color='red', step='mid',
                    label='ground truth')
    if log_scale:
        ax.set_yscale('log')
    ax.set_xlabel('frame')
    ax.set_ylabel('anomaly score')
    ax.set_title(title)
    if error_per_person.shape[0] <= 10:
        ax.legend(fontsize=8)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=110)
        plt.close(fig)
        return out_path
    return fig


def hr_stats(gt_path: str, hr_masks: Optional[Dict] = None) -> List[Dict]:
    """Per-clip frame statistics (visualize.ipynb cells 17-30): length,
    HR-discarded frames, % discarded, % abnormality."""
    rows = []
    for fname in sorted(os.listdir(gt_path)):
        if not fname.endswith('.npy'):
            continue
        scene_idx = int(fname.split('_')[0])
        clip_idx = int(fname.split('_')[1].split('.')[0])
        gt = np.load(os.path.join(gt_path, fname))
        mask = None
        if hr_masks:
            mask = hr_masks.get((scene_idx, clip_idx))
        discarded = int(np.sum(~np.asarray(mask, bool))) if mask is not None \
            else 0
        rows.append(dict(
            clip=f'{scene_idx}_{clip_idx}', length=int(gt.shape[0]),
            discarded=discarded,
            pct_discarded=round(100.0 * discarded / gt.shape[0], 2),
            pct_abnormal=round(100.0 * float(np.mean(gt > 0)), 2)))
    return rows


def stats_to_latex(rows: List[Dict], out_path: Optional[str] = None) -> str:
    """LaTeX table of the per-clip stats (the notebook's longtable)."""
    header = (r'\textbf{Clip} & \textbf{Length} & \textbf{Discarded} & '
              r'\textbf{\% discarded} & \textbf{\% abnormality} \\')
    lines = [r'\begin{tabular}{lrrrr}', r'\toprule', header, r'\midrule']
    for r in rows:
        lines.append(rf"\verb|{r['clip']}| & {r['length']} & "
                     rf"{r['discarded']} & {r['pct_discarded']} & "
                     rf"{r['pct_abnormal']} \\")
    lines += [r'\bottomrule', r'\end{tabular}']
    text = '\n'.join(lines)
    if out_path:
        with open(out_path, 'w') as f:
            f.write(text)
    return text


def _fig_to_b64(fig) -> str:
    buf = io.BytesIO()
    fig.savefig(buf, format='png', dpi=110)
    import matplotlib.pyplot as plt
    plt.close(fig)
    return base64.b64encode(buf.getvalue()).decode()


def html_report(out: np.ndarray, trans: np.ndarray, meta: np.ndarray,
                frames: np.ndarray, gt_path: str, out_path: str, *,
                frames_shift: int = 0, kernel_size: float = 10.0,
                title: str = 'MoCoDAD anomaly-score report',
                auc: Optional[float] = None,
                max_clips: Optional[int] = None) -> str:
    """One self-contained HTML page: per-clip score-vs-GT figures + the
    per-clip stats table — the serverless equivalent of the reference's
    streamlit WebApp + analysis notebook."""
    clips = per_person_scores(out, trans, meta, frames, gt_path)
    stats = hr_stats(gt_path)

    parts = [f'<html><head><meta charset="utf-8"><title>{html.escape(title)}'
             '</title><style>body{font-family:sans-serif;max-width:1100px;'
             'margin:2em auto}img{max-width:100%}table{border-collapse:'
             'collapse}td,th{border:1px solid #999;padding:4px 10px}'
             '</style></head><body>',
             f'<h1>{html.escape(title)}</h1>']
    if auc is not None:
        parts.append(f'<p><b>frame-level AUC-ROC: {auc:.4f}</b></p>')

    parts.append('<h2>Per-clip statistics</h2><table><tr><th>clip</th>'
                 '<th>frames</th><th>discarded</th><th>% discarded</th>'
                 '<th>% abnormal</th></tr>')
    for r in stats:
        parts.append(f"<tr><td>{r['clip']}</td><td>{r['length']}</td>"
                     f"<td>{r['discarded']}</td><td>{r['pct_discarded']}</td>"
                     f"<td>{r['pct_abnormal']}</td></tr>")
    parts.append('</table>')

    for i, ((scene, clip), d) in enumerate(sorted(clips.items())):
        if max_clips is not None and i >= max_clips:
            parts.append(f'<p>... {len(clips) - max_clips} more clips '
                         'omitted (max_clips)</p>')
            break
        fig = clip_score_figure(d['error_per_person'], d['gt'],
                                frames_shift=frames_shift,
                                kernel_size=kernel_size,
                                title=f'scene {scene} clip {clip}')
        parts.append(f'<h2>scene {scene} clip {clip}</h2>'
                     f'<img src="data:image/png;base64,{_fig_to_b64(fig)}"/>')
    parts.append('</body></html>')
    text = '\n'.join(parts)
    with open(out_path, 'w') as f:
        f.write(text)
    return out_path


def report_from_saved_tensors(cfg, out_path: Optional[str] = None,
                              **kwargs) -> str:
    """Build the HTML report from a predict run's saved_tensors cache —
    mirrors `eval --load_tensors` but renders analyses instead of AUC."""
    from mocodad_tpu_torch.config import effective_n_generated_samples
    from mocodad_tpu_torch.eval.harness import post_processing_from_config
    from mocodad_tpu_torch.utils.tensors import load_tensors
    t = load_tensors(cfg.ckpt_dir, cfg.split, cfg.aggregation_strategy,
                     effective_n_generated_samples(cfg))
    # caches written under model_return_value 'pose'/'all' hold poses in
    # 'prediction' and the scalar loss route in a separate 'loss' tensor
    # (pack_prediction_tensors) — scoring always wants the losses
    pred = t.get('loss', t['prediction'])
    auc = post_processing_from_config(pred, t['trans'],
                                      t['metadata'], t['frames'], cfg)
    out_path = out_path or os.path.join(cfg.ckpt_dir,
                                        f'report_{cfg.split}.html')
    return html_report(pred, t['trans'], t['metadata'],
                       t['frames'], cfg.gt_path, out_path,
                       frames_shift=cfg.frames_shift,
                       kernel_size=cfg.filter_kernel_size, auc=auc,
                       **kwargs)
