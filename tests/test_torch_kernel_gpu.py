"""The CUDA denoiser kernels on the card, against their plain versions:
B1 in float32 and bfloat16 (the tensor-core kernels, 3xTF32 and bf16, and
the FMA design kept as their yardstick), B2 (grouped, bfloat16) and B3
(DMA-pipelined, float32 and bfloat16).

These tests need a CUDA device and skip without one (the kernel has no
CPU mode).  They import neither JAX nor the JAX package, so they also run
where only the port is installed:

    python -m pytest -q --noconftest -m gpu tests/test_torch_kernel_gpu.py
"""

import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from mocodad_tpu_torch.config import flagship_config
from mocodad_tpu_torch.device import resolve_device
from mocodad_tpu_torch.models.mocodad import MoCoDADModel, seeded_state
from mocodad_tpu_torch.ops import build, dma_unet as D, grouped_unet as G
from mocodad_tpu_torch.ops import pallas_unet as P

pytestmark = pytest.mark.gpu

# float32 on both sides; the kernel sums in another order than cuBLAS,
# contracts multiply-adds into FMAs and (the tensor-core kernel) takes each
# product as 3xTF32, about 2^-21 relative
RTOL, ATOL = 1e-4, 1e-5
# bfloat16 on both sides at the same rounding points: a sum taken in
# another order can round the other way (2^-8 relative) and later layers
# carry the flip.  Max |diff| within 3 % of max |want|; mean |diff| within
# 0.2 % of mean |want| (chip_smoke.py holds N = 51,200 to 0.1 %; a single
# row averages over too few elements for that)
BF16_MAX_REL, BF16_MEAN_REL = 3e-2, 2e-3
NS = [1, 8, 1031, 4096]


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
    kernels = (P.DENOISER, P.DENOISER_F32_FMA)
    before = [k.launches for k in kernels]
    got = P.denoise(x, semb, folded)
    assert [k.launches for k in kernels] == [before[0] + 1, before[1]]
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
    kernels = (P.DENOISER, P.DENOISER_F32_FMA)
    before = [k.launches for k in kernels]
    sel, loss = model.generate(net, data,
                               torch.Generator('cuda').manual_seed(4))
    assert [k.launches for k in kernels] == [before[0] + 9, before[1]]
    assert sel.shape == (8, 2, 3, 17) and loss.shape == (8,)
    assert np.isfinite(loss.cpu().numpy()).all()


@pytest.mark.parametrize('n', NS)
def test_f32_fma_kernel_matches_plain_version(folded, n):
    x, semb = _inputs(n, seed=n + 5)
    before = P.DENOISER_F32_FMA.launches
    got = P.DENOISER_F32_FMA(x, semb, folded)
    assert P.DENOISER_F32_FMA.launches == before + 1
    want = P.denoise_reference(x, semb, folded)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_tc32_wrapper_rejects_what_the_kernel_does_not_take(folded):
    x, semb = _inputs(16, seed=6)
    with pytest.raises(ValueError, match='x_ctn must be float32'):
        P.DENOISER(x.bfloat16(), semb, folded)
    with pytest.raises(ValueError, match='silu_emb_en must be float32'):
        P.DENOISER(x, semb.bfloat16(), folded)
    with pytest.raises(ValueError, match=r'\(2, 51, N\)'):
        P.DENOISER(x[:, :50].contiguous(), semb, folded)
    with pytest.raises(ValueError, match='CUDA tensor'):
        P.DENOISER(x.cpu(), semb.cpu(), folded)
    with pytest.raises(ValueError, match='contiguous'):
        P.DENOISER(x.transpose(0, 1).contiguous().transpose(0, 1), semb,
                   folded)


def _sass(kernel):
    kernel.load()
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    assert os.path.exists(tool), 'cuobjdump not found'
    return subprocess.run([tool, '-sass', build.library_path(kernel.source)],
                          capture_output=True, text=True, check=True).stdout


def test_tc32_library_runs_3xtf32_on_the_tensor_cores(folded):
    """The float32 library's SASS holds TF32 HMMAs, and no bf16 or f16
    ones: every product runs on the tensor cores in TF32 (three of them
    per product, which the f32 check at rtol 1e-4 shows)."""
    sass = _sass(P.DENOISER)
    assert re.search(r'HMMA\.1688\.F32\.TF32', sass)
    assert not re.search(r'HMMA\.\d+\.F32\.(BF16|F16)', sass)


def _bf16_close(got, want):
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    assert torch.isfinite(got).all()
    assert float(diff.max()) <= BF16_MAX_REL * float(want.abs().max())
    assert float(diff.mean()) <= BF16_MEAN_REL * float(want.abs().mean())


@pytest.mark.parametrize('n', NS)
def test_bf16_kernel_matches_plain_version(folded, n):
    x, semb = _inputs(n, seed=n + 1)
    xb = x.bfloat16()
    kernels = (P.DENOISER, P.DENOISER_F32_FMA, P.DENOISER_BF16,
               P.DENOISER_BF16_FMA)
    before = [k.launches for k in kernels]
    got = P.denoise(xb, semb, folded)
    assert [k.launches for k in kernels] == \
        [before[0], before[1], before[2] + 1, before[3]]
    assert got.dtype == torch.bfloat16
    want = P.denoise_reference(xb, semb, folded, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    _bf16_close(got, want)


@pytest.mark.parametrize('n', NS)
def test_bf16_fma_kernel_matches_plain_version(folded, n):
    x, semb = _inputs(n, seed=n + 4)
    xb = x.bfloat16()
    before = P.DENOISER_BF16_FMA.launches
    got = P.DENOISER_BF16_FMA(xb, semb, folded)
    assert P.DENOISER_BF16_FMA.launches == before + 1
    want = P.denoise_reference(xb, semb, folded, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    _bf16_close(got, want)


def test_tc_wrapper_rejects_what_the_kernel_does_not_take(folded):
    x, semb = _inputs(16, seed=5)
    xb = x.bfloat16()
    with pytest.raises(ValueError, match='x_ctn must be bfloat16'):
        P.DENOISER_BF16(x, semb, folded)
    with pytest.raises(ValueError, match=r'\(2, 51, N\)'):
        P.DENOISER_BF16(xb[:, :50].contiguous(), semb, folded)
    with pytest.raises(ValueError, match='CUDA tensor'):
        P.DENOISER_BF16(xb.cpu(), semb.cpu(), folded)
    with pytest.raises(ValueError, match='contiguous'):
        P.DENOISER_BF16(xb.transpose(0, 1).contiguous().transpose(0, 1),
                        semb, folded)


def test_tc_library_runs_on_the_tensor_cores(folded):
    """The built library's SASS holds HMMA (mma.sync) instructions."""
    assert 'HMMA' in _sass(P.DENOISER_BF16)


@pytest.mark.parametrize('n', NS)
def test_grouped_kernel_matches_plain_version(folded, n):
    x, semb = _inputs(n, seed=n + 2)
    xb, sb = x.bfloat16(), semb.bfloat16()
    before = G.GROUPED.launches
    got = G.denoise_grouped(xb, sb, folded)
    assert G.GROUPED.launches == before + 5
    assert got.dtype == torch.bfloat16
    want = G.grouped_reference(xb, sb, folded)
    torch.cuda.synchronize()
    _bf16_close(got, want)


@pytest.mark.parametrize('n', NS)
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_dma_kernel_matches_plain_version(folded, dtype, n):
    x, semb = _inputs(n, seed=n + 3)
    kernel = {torch.float32: D.DMA_PIPELINED_F32,
              torch.bfloat16: D.DMA_PIPELINED}[dtype]
    before = kernel.launches
    got = D.denoise_dma(x, semb, folded, compute_dtype=dtype)
    assert kernel.launches == before + 1
    assert got.dtype == torch.float32
    want = D.dma_reference(x, semb, folded, dtype)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        # B3 runs the table of B1's FMA design: the same sums in the
        # same order
        torch.testing.assert_close(got, P.DENOISER_F32_FMA(x, semb, folded),
                                   rtol=0, atol=0)
    else:
        _bf16_close(got, want)


def test_new_wrappers_reject_what_the_kernels_do_not_take(folded):
    x, semb = _inputs(16, seed=2)
    xb, sb = x.bfloat16(), semb.bfloat16()
    with pytest.raises(ValueError, match='bfloat16'):
        P.DENOISER_BF16(x, semb, folded)
    with pytest.raises(ValueError, match='silu_emb_en must be float32'):
        P.DENOISER_BF16(xb, sb, folded)
    with pytest.raises(ValueError, match='silu_emb_en must be bfloat16'):
        G.GROUPED(xb, semb, folded)
    with pytest.raises(ValueError, match=r'\(2, 51, N\)'):
        G.GROUPED(xb[:, :50].contiguous(), sb, folded)
    with pytest.raises(ValueError, match='x_ctn must be float32'):
        D.DMA_PIPELINED(xb, semb, folded)
    with pytest.raises(ValueError, match='contiguous'):
        D.DMA_PIPELINED_F32(x.transpose(0, 1).contiguous().transpose(0, 1),
                            semb, folded)
    with pytest.raises(ValueError, match='CUDA tensor'):
        D.DMA_PIPELINED(x.cpu(), semb.cpu(), folded)


def test_generate_bf16_runs_through_the_bf16_kernel(folded):
    cfg = flagship_config(n_generated_samples=4)
    cfg.extras['eval_dtype'] = 'bfloat16'
    model = MoCoDADModel(cfg)
    net = seeded_state(model.build_net(), seed=0).to('cuda').eval()
    data = torch.randn((8, 2, 6, 17), device='cuda',
                       generator=torch.Generator('cuda').manual_seed(3))
    kernels = (P.DENOISER, P.DENOISER_F32_FMA, P.DENOISER_BF16,
               P.DENOISER_BF16_FMA)
    before = [k.launches for k in kernels]
    sel, loss = model.generate(net, data,
                               torch.Generator('cuda').manual_seed(4))
    assert [k.launches for k in kernels] == \
        [before[0], before[1], before[2] + 9, before[3]]
    assert sel.dtype == loss.dtype == torch.float32
    assert sel.shape == (8, 2, 3, 17) and loss.shape == (8,)
    assert np.isfinite(loss.cpu().numpy()).all()
