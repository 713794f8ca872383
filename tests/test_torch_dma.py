"""B3, the DMA-pipelined denoiser: the port's plain version against the JAX
repository's probe `build_dma_pipelined_denoiser`
(tools/perf/probe_dma_pipeline.py) in interpret mode, in float32 and in
bfloat16, on a ragged N, and the wrapper's routing on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (bf16_stats, dma_probe, jax_model,
                         seeded_variables, torch_model, torch_net)
from mocodad_tpu_torch.ops import dma_unet as D
from mocodad_tpu_torch.ops import pallas_unet as P

# float32: the same function, sums in another order
RTOL, ATOL = 1e-4, 1e-5
# bfloat16: as tests/test_torch_denoiser_bf16.py (eps is float32 here, so
# the last rounding is not there to flip)
MAX_REL, MEAN_REL = 1.5e-2, 1e-3


@pytest.fixture(scope='module')
def probe():
    """The probe imported from its file; its import-time edits of sys.path
    and the environment are undone."""
    return dma_probe()


@pytest.fixture(scope='module')
def weights():
    jm = jax_model()
    variables = seeded_variables(jm, seed=6)
    tm = torch_model()
    return variables, tm.fold(torch_net(tm, variables))


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 51, n)).astype(np.float32)
    s = rng.standard_normal((16, n)).astype(np.float32)
    return x, (s / (1 + np.exp(-s))).astype(np.float32)     # silu


def _jax(probe, variables, x, semb, cdt):
    fn = probe.build_dma_pipelined_denoiser(
        variables['params']['model'], variables['batch_stats']['model'],
        c_in=2, n_frames=3, n_joints=17, embedding_dim=16, nb=8,
        compute_dtype=cdt, interpret=True)
    out = fn(jnp.asarray(x), jnp.asarray(semb))
    assert out.dtype == jnp.float32
    return np.asarray(out)


def test_f32_plain_version_matches_probe(probe, weights):
    variables, folded = weights
    x, semb = _inputs(12, seed=1)
    want = _jax(probe, variables, x, semb, jnp.float32)
    got = D.dma_reference(torch.from_numpy(x), torch.from_numpy(semb),
                          folded, compute_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, RTOL, ATOL)
    # in float32 B3 computes B1's function
    np.testing.assert_array_equal(
        got.numpy(), P.denoise_reference(torch.from_numpy(x),
                                         torch.from_numpy(semb),
                                         folded).numpy())


def test_bf16_plain_version_matches_probe(probe, weights):
    variables, folded = weights
    x, semb = _inputs(12, seed=2)
    want = _jax(probe, variables, x, semb, jnp.bfloat16)
    got = D.dma_reference(torch.from_numpy(x), torch.from_numpy(semb),
                          folded, compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    max_rel, mean_rel = bf16_stats(got.numpy(), want)
    assert max_rel <= MAX_REL and mean_rel <= MEAN_REL, (max_rel, mean_rel)


def test_wrapper_routes_by_device(weights):
    _, folded = weights
    x, semb = _inputs(5, seed=3)
    xt, st = torch.from_numpy(x), torch.from_numpy(semb)
    before = (D.DMA_PIPELINED.launches, D.DMA_PIPELINED_F32.launches)
    got = D.denoise_dma(xt, st, folded)
    assert got.dtype == torch.float32 and got.shape == (2, 51, 5)
    torch.testing.assert_close(got, D.dma_reference(xt, st, folded),
                               rtol=0, atol=0)
    assert (D.DMA_PIPELINED.launches, D.DMA_PIPELINED_F32.launches) == before
    for kernel in (D.DMA_PIPELINED, D.DMA_PIPELINED_F32):
        with pytest.raises(ValueError, match='CUDA tensor'):
            kernel(xt, st, folded)
