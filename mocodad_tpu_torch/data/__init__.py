from mocodad_tpu_torch.data.pipeline import (  # noqa: F401
    PoseWindows, build_dataset, make_loader, num_batches)
from mocodad_tpu_torch.data.transforms import (  # noqa: F401
    affine_transform_matrices, apply_affine_batch, transformed_gt_data)
from mocodad_tpu_torch.data.prefetch import prefetch, to_device  # noqa: F401
