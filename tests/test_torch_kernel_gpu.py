"""The CUDA denoiser kernel on the card, against its plain version.

These tests need a CUDA device and skip without one (the kernel has no
CPU mode).  They import neither JAX nor the JAX package, so they also run
where only the port is installed:

    python -m pytest -q --noconftest -m gpu tests/test_torch_kernel_gpu.py
"""

import numpy as np
import pytest
import torch

from mocodad_tpu_torch.config import flagship_config
from mocodad_tpu_torch.device import resolve_device
from mocodad_tpu_torch.models.mocodad import MoCoDADModel, seeded_state
from mocodad_tpu_torch.ops import pallas_unet as P

pytestmark = pytest.mark.gpu

# float32 on both sides; the kernel sums in another order than cuBLAS and
# contracts multiply-adds into FMAs
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope='module')
def folded():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; the kernel has no CPU mode')
    dev = resolve_device('cuda')
    model = MoCoDADModel(flagship_config())
    net = seeded_state(model.build_net(), seed=0).to(dev).eval()
    return model.fold(net)


def _inputs(n, seed):
    g = torch.Generator(device='cuda').manual_seed(seed)
    x = torch.randn((2, 51, n), generator=g, device='cuda')
    semb = torch.nn.functional.silu(
        torch.randn((16, n), generator=g, device='cuda'))
    return x, semb


@pytest.mark.parametrize('n', [1, 8, 1031, 4096])
def test_kernel_matches_plain_version(folded, n):
    x, semb = _inputs(n, seed=n)
    before = P.DENOISER.launches
    got = P.denoise(x, semb, folded)
    assert P.DENOISER.launches == before + 1
    want = P.denoise_reference(x, semb, folded)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_wrapper_rejects_what_the_kernel_does_not_take(folded):
    x, semb = _inputs(16, seed=1)
    with pytest.raises(ValueError, match='float32'):
        P.DENOISER(x.double(), semb, folded)
    with pytest.raises(ValueError, match='contiguous'):
        P.DENOISER(x.transpose(0, 1).contiguous().transpose(0, 1), semb,
                   folded)
    with pytest.raises(ValueError, match=r'\(2, 51, N\)'):
        P.DENOISER(x[:, :50].contiguous(), semb, folded)
    with pytest.raises(ValueError, match='silu_emb_en'):
        P.DENOISER(x, semb[:, :8].contiguous(), folded)


def test_generate_runs_through_the_kernel(folded):
    model = MoCoDADModel(flagship_config(n_generated_samples=4))
    net = seeded_state(model.build_net(), seed=0).to('cuda').eval()
    data = torch.randn((8, 2, 6, 17), device='cuda',
                       generator=torch.Generator('cuda').manual_seed(3))
    before = P.DENOISER.launches
    sel, loss = model.generate(net, data,
                               torch.Generator('cuda').manual_seed(4))
    assert P.DENOISER.launches == before + 9
    assert sel.shape == (8, 2, 3, 17) and loss.shape == (8,)
    assert np.isfinite(loss.cpu().numpy()).all()
