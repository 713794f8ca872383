"""MoCoDAD in PyTorch with a hand-written CUDA denoiser for NVIDIA Hopper.

The counterpart of the JAX package `mocodad_tpu`, module for module at the
same paths.  It imports neither JAX nor any module of the JAX package.
"""

from mocodad_tpu_torch.config import Config, flagship_config, load_config  # noqa: F401
from mocodad_tpu_torch.device import resolve_device  # noqa: F401
