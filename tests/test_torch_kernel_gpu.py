"""The CUDA denoiser kernels on the card, against their plain versions:
B1 in float32 and bfloat16 (each the wgmma kernel and its mma.sync
yardstick),
B2 (grouped, bfloat16) and B3 (DMA-pipelined, float32 and bfloat16), each
on the tensor cores and in the FMA design kept as its yardstick.

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
    kernels = (P.DENOISER, P.DENOISER_F32_MMA, P.DENOISER_F32_FMA)
    before = [k.launches for k in kernels]
    got = P.denoise(x, semb, folded)
    assert [k.launches for k in kernels] == \
        [before[0] + 1, before[1], before[2]]
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
    kernels = (P.DENOISER, P.DENOISER_F32_MMA, P.DENOISER_F32_FMA)
    before = [k.launches for k in kernels]
    sel, loss = model.generate(net, data,
                               torch.Generator('cuda').manual_seed(4))
    assert [k.launches for k in kernels] == \
        [before[0] + 9, before[1], before[2]]
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
    """The float32 mma.sync yardstick's SASS holds TF32 HMMAs, and no bf16
    or f16 ones: every product runs on the tensor cores in TF32 (three of
    them per product, which the f32 check at rtol 1e-4 shows)."""
    sass = _sass(P.DENOISER_F32_MMA)
    assert re.search(r'HMMA\.1688\.F32\.TF32', sass)
    assert not re.search(r'HMMA\.\d+\.F32\.(BF16|F16)', sass)


def test_wg32_library_runs_3xtf32_on_warpgroup_mma(folded):
    """The float32 main path's library holds TF32 HGMMA (wgmma)
    instructions with f32 sums for its channel and residual mixes, its
    graph mixes' TF32 HMMAs, and no bf16 or f16 product."""
    sass = _sass(P.DENOISER)
    assert re.search(r'HGMMA\.64x(16|32|64|128)x8\.F32\.TF32', sass)
    assert re.search(r'HMMA\.1688\.F32\.TF32', sass)
    assert not re.search(r'H[G]?MMA\.[\dx]+\.F32\.(BF16|F16)', sass)


@pytest.mark.parametrize('n', [51200, 1031, 12800, 25600])
def test_wg32_kernel_matches_plain_version(folded, n):
    """B1 float32 on wgmma at the main path's N = 51,200, a ragged N, the
    serve path's 12,800 and a rank's 25,600, against the plain version and
    beside its mma.sync yardstick (each launch counted on its own
    wrapper)."""
    x, semb = _inputs(n, seed=n + 11)
    want = P.denoise_reference(x, semb, folded)
    for kernel in (P.DENOISER, P.DENOISER_F32_MMA):
        before = [k.launches for k in (P.DENOISER, P.DENOISER_F32_MMA)]
        got = kernel(x, semb, folded)
        assert [k.launches for k in (P.DENOISER, P.DENOISER_F32_MMA)] == \
            [b + (k is kernel) for b, k in zip(
                before, (P.DENOISER, P.DENOISER_F32_MMA))]
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('n', NS)
def test_f32_mma_kernel_matches_plain_version(folded, n):
    x, semb = _inputs(n, seed=n + 12)
    before = P.DENOISER_F32_MMA.launches
    got = P.DENOISER_F32_MMA(x, semb, folded)
    assert P.DENOISER_F32_MMA.launches == before + 1
    want = P.denoise_reference(x, semb, folded)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_f32_mma_wrapper_rejects_what_the_kernel_does_not_take(folded):
    x, semb = _inputs(16, seed=13)
    with pytest.raises(ValueError, match='x_ctn must be float32'):
        P.DENOISER_F32_MMA(x.bfloat16(), semb, folded)
    with pytest.raises(ValueError, match='CUDA tensor'):
        P.DENOISER_F32_MMA(x.cpu(), semb.cpu(), folded)
    with pytest.raises(ValueError, match=r'\(2, 51, N\)'):
        P.DENOISER_F32_MMA(x[:, :50].contiguous(), semb, folded)


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
               P.DENOISER_BF16_MMA, P.DENOISER_BF16_FMA)
    before = [k.launches for k in kernels]
    got = P.denoise(xb, semb, folded)
    assert [k.launches for k in kernels] == \
        [before[0], before[1], before[2] + 1, before[3], before[4]]
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
    """The mma.sync yardstick's SASS holds HMMA (mma.sync) instructions."""
    assert 'HMMA' in _sass(P.DENOISER_BF16_MMA)


def test_wg_library_runs_on_warpgroup_mma(folded):
    """The bfloat16 main path's library holds HGMMA (wgmma) instructions
    with bf16 inputs and f32 sums, and its graph mixes' bf16 HMMAs."""
    sass = _sass(P.DENOISER_BF16)
    assert re.search(r'HGMMA\.64x(16|32|64)x16\.F32\.BF16', sass)
    assert re.search(r'HMMA\.16816\.F32\.BF16', sass)


@pytest.mark.parametrize('n', NS)
def test_bf16_mma_kernel_matches_plain_version(folded, n):
    x, semb = _inputs(n, seed=n + 9)
    xb = x.bfloat16()
    before = P.DENOISER_BF16_MMA.launches
    got = P.DENOISER_BF16_MMA(xb, semb, folded)
    assert P.DENOISER_BF16_MMA.launches == before + 1
    want = P.denoise_reference(xb, semb, folded, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    _bf16_close(got, want)


@pytest.mark.parametrize('n', NS)
def test_grouped_kernel_matches_plain_version(folded, n):
    x, semb = _inputs(n, seed=n + 2)
    xb, sb = x.bfloat16(), semb.bfloat16()
    kernels = (G.GROUPED, G.GROUPED_FMA)
    before = [k.launches for k in kernels]
    got = G.denoise_grouped(xb, sb, folded)
    assert [k.launches for k in kernels] == [before[0] + 5, before[1]]
    assert got.dtype == torch.bfloat16
    want = G.grouped_reference(xb, sb, folded)
    torch.cuda.synchronize()
    _bf16_close(got, want)


@pytest.mark.parametrize('n', NS)
def test_grouped_fma_kernel_matches_plain_version(folded, n):
    x, semb = _inputs(n, seed=n + 7)
    xb, sb = x.bfloat16(), semb.bfloat16()
    before = G.GROUPED_FMA.launches
    got = G.GROUPED_FMA(xb, sb, folded)
    assert G.GROUPED_FMA.launches == before + 5
    want = G.grouped_reference(xb, sb, folded)
    torch.cuda.synchronize()
    _bf16_close(got, want)


@pytest.mark.parametrize('n', NS)
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_dma_kernel_matches_plain_version(folded, dtype, n):
    x, semb = _inputs(n, seed=n + 3)
    kernel, fma = {torch.float32: (D.DMA_PIPELINED_F32,
                                   D.DMA_PIPELINED_F32_FMA),
                   torch.bfloat16: (D.DMA_PIPELINED,
                                    D.DMA_PIPELINED_FMA)}[dtype]
    before = (kernel.launches, fma.launches)
    got = D.denoise_dma(x, semb, folded, compute_dtype=dtype)
    assert (kernel.launches, fma.launches) == (before[0] + 1, before[1])
    assert got.dtype == torch.float32
    want = D.dma_reference(x, semb, folded, dtype)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        # B3 at float32 is B1's mma.sync 3xTF32 kernel on its plan: the
        # same sums in the same order
        torch.testing.assert_close(got, P.DENOISER_F32_MMA(x, semb, folded),
                                   rtol=0, atol=0)
    else:
        _bf16_close(got, want)
        # the mma.sync B1's ops on its plan; only eps is left unrounded
        torch.testing.assert_close(
            got.bfloat16(), P.DENOISER_BF16_MMA(x.bfloat16(), semb, folded),
            rtol=0, atol=0)


@pytest.mark.parametrize('n', NS)
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_dma_fma_kernel_matches_plain_version(folded, dtype, n):
    x, semb = _inputs(n, seed=n + 8)
    kernel = {torch.float32: D.DMA_PIPELINED_F32_FMA,
              torch.bfloat16: D.DMA_PIPELINED_FMA}[dtype]
    before = kernel.launches
    got = kernel(x, semb, folded)
    assert kernel.launches == before + 1
    want = D.dma_reference(x, semb, folded, dtype)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        # the FMA design of B3 runs the table of B1's FMA design
        torch.testing.assert_close(got, P.DENOISER_F32_FMA(x, semb, folded),
                                   rtol=0, atol=0)
    else:
        _bf16_close(got, want)


@pytest.mark.parametrize('kernel', [G.GROUPED, D.DMA_PIPELINED],
                         ids=['grouped', 'dma_bf16'])
def test_new_tc_libraries_run_on_the_tensor_cores(folded, kernel):
    """The B2 and B3 bfloat16 libraries' SASS holds bf16 HMMAs."""
    assert re.search(r'HMMA\.16816\.F32\.BF16', _sass(kernel))


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
    with pytest.raises(ValueError, match='x_ctn must be float32'):
        D.DMA_PIPELINED_F32(xb, semb, folded)
    with pytest.raises(ValueError, match='contiguous'):
        G.GROUPED(xb.transpose(0, 1).contiguous().transpose(0, 1), sb,
                  folded)
    with pytest.raises(ValueError, match='silu_emb_en must be float32'):
        D.DMA_PIPELINED(x, sb, folded)


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


# B1 at the frame counts of the other strategies: T = 4 (inject with two
# conditioning frames of six) and T = 6 (concat and the others at seg_len
# 6), both kernels, at fewer rows per tile than the flagship's
FRAMES = {4: dict(conditioning_indices=[0, 1]),
          6: dict(conditioning_strategy='concat')}


# and the other frame counts B1 at bfloat16 takes: inject with 5, 4 or 1
# conditioning frames of six
BF16_FRAMES = {1: dict(conditioning_indices=[0, 1, 2, 3, 4]),
               2: dict(conditioning_indices=[0, 1, 2, 3]), 3: {},
               5: dict(conditioning_indices=[0]), **FRAMES}


def _model_at(t):
    cfg = flagship_config(n_generated_samples=4, **BF16_FRAMES[t])
    model = MoCoDADModel(cfg)
    net = seeded_state(model.build_net(), seed=t).to('cuda').eval()
    return model, net


@pytest.mark.parametrize('n', [1031, 4096])
@pytest.mark.parametrize('t', [4, 6])
def test_both_kernels_at_more_frames(folded, t, n):
    model, net = _model_at(t)
    fold = model.fold(net)
    g = torch.Generator(device='cuda').manual_seed(t + n)
    x = torch.randn((2, 17 * t, n), generator=g, device='cuda')
    semb = torch.nn.functional.silu(
        torch.randn((16, n), generator=g, device='cuda'))
    before = (P.DENOISER.launches, P.DENOISER_BF16.launches)
    got = P.denoise(x, semb, fold)
    got16 = P.denoise(x.bfloat16(), semb, fold)
    assert (P.DENOISER.launches, P.DENOISER_BF16.launches) == \
        (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, P.denoise_reference(x, semb, fold),
                               rtol=RTOL, atol=ATOL)
    _bf16_close(got16, P.denoise_reference(x.bfloat16(), semb, fold,
                                           compute_dtype=torch.bfloat16))
    assert P.tc_plan(fold, x.device).rows == 2
    assert P.tc32_plan(fold, x.device).rows == (2 if t == 4 else 1)


@pytest.mark.parametrize('t', sorted(BF16_FRAMES))
def test_wg_kernel_at_every_frame_count(folded, t):
    """B1 bfloat16 (the wgmma kernel, 4 rows per tile up to T = 3, 2 above)
    and its mma.sync yardstick against the plain version at T = 1-6 at a
    ragged N."""
    model, net = _model_at(t)
    fold = model.fold(net)
    assert fold.n_frames == t
    g = torch.Generator(device='cuda').manual_seed(t + 40)
    xb = torch.randn((2, 17 * t, 1031), generator=g, device='cuda').bfloat16()
    semb = torch.nn.functional.silu(
        torch.randn((16, 1031), generator=g, device='cuda'))
    want = P.denoise_reference(xb, semb, fold, compute_dtype=torch.bfloat16)
    for kernel in (P.DENOISER_BF16, P.DENOISER_BF16_MMA):
        got = kernel(xb, semb, fold)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all()
        _bf16_close(got, want)
    assert P.wg_plan(fold, xb.device).rows == (4 if t <= 3 else 2)


@pytest.mark.parametrize('t', sorted(BF16_FRAMES))
def test_wg32_kernel_at_every_frame_count(folded, t):
    """B1 float32 on wgmma (2 rows per tile up to T = 4, 1 above) against
    the plain version at T = 1-6 at a ragged N and at N = 51,200."""
    model, net = _model_at(t)
    fold = model.fold(net)
    assert fold.n_frames == t
    g = torch.Generator(device='cuda').manual_seed(t + 50)
    for n in (1031, 51200):
        x = torch.randn((2, 17 * t, n), generator=g, device='cuda')
        semb = torch.nn.functional.silu(
            torch.randn((16, n), generator=g, device='cuda'))
        got = P.DENOISER(x, semb, fold)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, P.denoise_reference(x, semb, fold),
                                   rtol=RTOL, atol=ATOL)
    assert P.wg32_plan(fold, x.device).rows == (2 if t <= 4 else 1)


def test_generate_concat_runs_through_the_kernel(folded):
    model, net = _model_at(6)
    data = torch.randn((8, 2, 6, 17), device='cuda',
                       generator=torch.Generator('cuda').manual_seed(5))
    before = P.DENOISER.launches
    sel, loss = model.generate(net, data,
                               torch.Generator('cuda').manual_seed(6))
    assert P.DENOISER.launches == before + 9
    assert sel.shape == (8, 2, 3, 17) and torch.isfinite(loss).all()


def test_stream_scorer_on_the_card(tmp_path):
    """The streaming scorer on the card: losses come back into pinned host
    buffers behind one CUDA event per batch, at most max_pending_batches
    are in flight at a launch and after it, and every launch runs B1 once
    per DDPM step."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; the kernel has no CPU mode')
    from mocodad_tpu_torch.data import scalers as S
    from mocodad_tpu_torch.serve import StreamScorer
    cfg = flagship_config(n_generated_samples=2, num_transform=5,
                          ckpt_dir=str(tmp_path), vid_res=[640, 360],
                          use_hr=False, frames_shift=2, filter_kernel_size=5)
    rs = np.random.RandomState(0)
    _, scaler = S.scale_trajectories(rs.uniform(-0.5, 0.5, (512, 34)),
                                     strategy='robust')
    S.save_scaler(scaler, str(tmp_path / 'local_robust.npz'))
    net = seeded_state(MoCoDADModel(cfg).build_net(), seed=0)
    scorer = StreamScorer(cfg, net, batch_size=20, flush_every=20,
                          max_pending_batches=2)
    in_flight, step = [], scorer._step

    def spy(*a, **k):
        in_flight.append(len(scorer._pending_dev))
        return step(*a, **k)

    scorer._step = spy
    before = P.DENOISER.launches
    for frame in range(1, 30):
        for person in range(2):
            scorer.push(0, 0, person, frame,
                        rs.uniform(100, 300, (17, 2)).astype(np.float32))
            assert len(scorer._pending_dev) <= 2
            for b in scorer._pending_dev:
                assert b.done is not None and b.loss.is_pinned()
    assert in_flight and max(in_flight) <= 1
    assert P.DENOISER.launches - before == 9 * len(in_flight)
    scores = scorer.finalize_clip(0, 0, n_frames=30)
    assert scores.shape == (30,) and np.isfinite(scores).all()
    assert not scorer._pending_dev and scorer.pending == 0
