from mocodad_tpu_torch.viz.report import (  # noqa: F401
    clip_score_figure, hr_stats, html_report, per_person_scores,
    report_from_saved_tensors, stats_to_latex)
from mocodad_tpu_torch.viz.vis import (  # noqa: F401
    ClipVisualizer, COCO17_BONES)
