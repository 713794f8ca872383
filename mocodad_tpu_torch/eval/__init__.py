from mocodad_tpu_torch.eval.auc import roc_auc_score  # noqa: F401
from mocodad_tpu_torch.eval.scoring import (  # noqa: F401
    compute_var_matrix, gaussian_filter1d, pad_scores, score_process)
from mocodad_tpu_torch.eval.harness import (  # noqa: F401
    clip_frame_scores, post_processing, post_processing_from_config)
