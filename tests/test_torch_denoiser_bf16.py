"""B1 at bfloat16: the port's plain version (matrices rounded to bfloat16,
float32 accumulation, B1's rounding points) against the JAX Pallas kernel
at compute_dtype=bfloat16 in interpret mode, and the routing of a bfloat16
fold on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (bf16_stats, jax_model, seeded_variables,
                         torch_model, torch_net)
from mocodad_tpu.ops.pallas_unet import build_pallas_denoiser
from mocodad_tpu_torch.ops import pallas_unet as P

# bfloat16 on both sides at the same rounding points, sums in another
# order: a sum near a rounding boundary can round the other way (2^-8
# relative) and later layers carry the flip forward.  Max |diff| within
# 1.5 % of the largest output; mean |diff| within 0.1 % of the mean output
# (the float32 function is 0.24-0.26 % away on this mean, so the bound
# tells the two apart).
MAX_REL, MEAN_REL = 1.5e-2, 1e-3


@pytest.fixture(scope='module')
def weights():
    jm = jax_model()
    variables = seeded_variables(jm, seed=5)
    tm = torch_model()
    net = torch_net(tm, variables)
    denoise = build_pallas_denoiser(
        variables['params']['model'], variables['batch_stats']['model'],
        c_in=2, n_frames=3, n_joints=17, embedding_dim=16, nb=8,
        compute_dtype=jnp.bfloat16, interpret=True)
    return denoise, tm.fold(net)


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 51, n)).astype(np.float32)
    s = rng.standard_normal((16, n)).astype(np.float32)
    return x, (s / (1 + np.exp(-s))).astype(np.float32)     # silu


@pytest.mark.parametrize('n', [16, 13], ids=['aligned', 'ragged'])
def test_bf16_plain_version_matches_pallas_interpret(weights, n):
    denoise, folded = weights
    x, semb = _inputs(n, seed=n)
    want = denoise(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(semb))
    assert want.dtype == jnp.bfloat16
    got = P.denoise_reference(torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(semb), folded,
                              compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 51, n)
    max_rel, mean_rel = bf16_stats(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)))
    assert max_rel <= MAX_REL and mean_rel <= MEAN_REL, (max_rel, mean_rel)


def test_bf16_rounds_the_matrices_and_keeps_the_vectors(weights):
    _, folded = weights
    fw = P.compute_weights(folded, torch.bfloat16)
    assert P.compute_weights(folded, torch.bfloat16) is fw
    assert P.compute_weights(folded, torch.float32) is folded
    for w, w0 in zip(fw.gcn, folded.gcn):
        for a, a0 in ((w.k2, w0.k2), (w.w2, w0.w2), (w.we2, w0.we2)):
            assert torch.equal(a, a0.bfloat16().float())
        assert w.bias is w0.bias and w.eb is w0.eb and w.slope == w0.slope
    for j, j0 in zip(fw.joint, folded.joint):
        assert torch.equal(j.d2, j0.d2.bfloat16().float())
        assert j.rs is j0.rs and j.rt is j0.rt


def test_bf16_fold_routes_to_the_bf16_plain_version(weights):
    _, folded = weights
    x, semb = _inputs(8, seed=3)
    xb = torch.from_numpy(x).bfloat16()
    before = (P.DENOISER.launches, P.DENOISER_BF16.launches)
    got = P.denoise(xb, torch.from_numpy(semb), folded)
    want = P.denoise_reference(xb, torch.from_numpy(semb), folded,
                               compute_dtype=torch.bfloat16)
    assert (P.DENOISER.launches, P.DENOISER_BF16.launches) == before
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match='CUDA tensor'):
        P.DENOISER_BF16(xb, torch.from_numpy(semb), folded)
    with pytest.raises(ValueError, match='compute dtype'):
        P.denoise_reference(xb.half(), torch.from_numpy(semb), folded,
                            compute_dtype=torch.float16)
