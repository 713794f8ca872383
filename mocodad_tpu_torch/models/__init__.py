from mocodad_tpu_torch.models.mocodad import (  # noqa: F401
    MoCoDADModel, MoCoDADNet, build_model)
