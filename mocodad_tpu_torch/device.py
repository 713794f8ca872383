"""Device selection for the port's entry points.

Every entry point takes an explicit `device`.  `None` means the GPU; when
CUDA is absent the call raises instead of carrying on on the CPU, so a run
never reports host numbers under the name of the card.  The CPU is used
only when the caller asks for it (`device='cpu'`), as the tests do.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """'cuda' unless the caller names another device; raises when CUDA is
    asked for (explicitly or by default) and is not available."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                'CUDA is not available; pass device="cpu" (or --device cpu '
                'on the command line) to run on the CPU')
        # f32 on the card means f32: no TF32 in matmuls or convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != 'cpu':
        raise ValueError(f'unsupported device {dev}')
    return dev
