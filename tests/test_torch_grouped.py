"""B2, the layer-grouped denoiser: the port's plain version against the JAX
repository's probe `grouped` (tools/perf/probe_grouped_pallas.py) in
interpret mode, on the probe's own weights, and the wrapper's routing on
the CPU.

The probe runs TPU code at module level from its `# ---- parity +
timing` marker on, so only its source up to that marker is executed, with
NB = 8 and `pallas_call` in interpret mode (`_torch_port.grouped_probe`);
both are restored after the module's tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import bf16_stats, grouped_probe, torch_model, torch_net
from mocodad_tpu_torch.ops import grouped_unet as G
from mocodad_tpu_torch.ops import pallas_unet as P

# bfloat16 on both sides at the same rounding points (B2's), sums in
# another order: as tests/test_torch_denoiser_bf16.py
MAX_REL, MEAN_REL = 1.5e-2, 1e-3


@pytest.fixture(scope='module')
def probe():
    """The probe's namespace: its Config, variables, folded layers and
    `grouped`, built with NB = 8 and every pallas_call interpreted."""
    yield from grouped_probe()


@pytest.fixture(scope='module')
def folded(probe):
    """The probe's own variables in the port (its Config is the tests'
    flagship architecture)."""
    variables = jax.device_get(probe['variables'])
    tm = torch_model()
    return tm.fold(torch_net(tm, variables))


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 51, n)).astype(np.float32)
    s = rng.standard_normal((16, n)).astype(np.float32)
    semb = (s / (1 + np.exp(-s))).astype(np.float32)          # silu
    return (torch.from_numpy(x).bfloat16(),
            torch.from_numpy(semb).bfloat16())


def test_plain_version_matches_probe(probe, folded):
    x, semb = _inputs(16, seed=1)
    want = probe['grouped'](jnp.asarray(x.float().numpy(), jnp.bfloat16),
                            jnp.asarray(semb.float().numpy(), jnp.bfloat16))
    assert want.dtype == jnp.bfloat16 and want.shape == (2, 51, 16)
    got = G.grouped_reference(x, semb, folded)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 51, 16)
    max_rel, mean_rel = bf16_stats(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)))
    assert max_rel <= MAX_REL and mean_rel <= MEAN_REL, (max_rel, mean_rel)


def test_groups_match_probe_kernels(probe, folded):
    """K1 alone, on the same bfloat16 inputs: the two group outputs that
    cross device memory agree before anything is carried on."""
    x, semb = _inputs(8, seed=2)
    xj = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    sj = jnp.asarray(semb.float().numpy(), jnp.bfloat16)
    d1_j, f1_j = probe['K1'](xj, sj)
    fw = P.compute_weights(folded, torch.bfloat16)
    with torch.no_grad():
        d1, f1 = G.group_k1(x.float(), semb.float(), fw)
    # the probe's f1 is (T*V_b, C, N); the port's (C, T*V_b, N)
    for got, want in ((d1, d1_j), (f1, jnp.swapaxes(f1_j, 0, 1))):
        max_rel, mean_rel = bf16_stats(got.numpy(),
                                       np.asarray(want.astype(jnp.float32)))
        assert max_rel <= MAX_REL and mean_rel <= MEAN_REL, (max_rel,
                                                             mean_rel)


def test_ragged_columns_are_independent(folded):
    x, semb = _inputs(13, seed=3)
    full = G.grouped_reference(x, semb, folded)
    part = G.grouped_reference(x[:, :, :5].contiguous(),
                               semb[:, :5].contiguous(), folded)
    np.testing.assert_allclose(full[:, :, :5].float().numpy(),
                               part.float().numpy(), rtol=0, atol=0)


def test_wrapper_routes_by_device(folded):
    x, semb = _inputs(4, seed=4)
    before = G.GROUPED.launches
    out = G.denoise_grouped(x, semb, folded)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 51, 4)
    assert G.GROUPED.launches == before        # the CPU never launches
    with pytest.raises(ValueError, match='CUDA tensor'):
        G.GROUPED(x, semb, folded)


def test_intermediate_bytes(folded):
    # d1 (32 x 51), f1 (32 x 36), d2 (64 x 36), f2 (64 x 30), f3 (64 x 36),
    # f4 (32 x 51) bfloat16 values per row, each written once and read
    # once
    per_row = 32 * 51 + 32 * 36 + 64 * 36 + 64 * 30 + 64 * 36 + 32 * 51
    assert G.intermediate_bytes(folded, 100) == 2 * 2 * per_row * 100
