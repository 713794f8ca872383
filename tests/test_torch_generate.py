"""Multi-sample generation: the port's `generate` against the JAX
package's on the flagship architecture, fed the same gaussians."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_model, trained_variables, torch_model, torch_net

# float32 through a 9-step chain on both sides; the JAX path reassociates
# narrowing layers (ops/fast_unet.py), the port keeps B1's association
RTOL, ATOL = 1e-4, 1e-5
B, S = 4, 3


@pytest.fixture(scope='module')
def models():
    jm = jax_model(n_generated_samples=S)
    variables = trained_variables(jm, seed=11)
    tm = torch_model(n_generated_samples=S)
    net = torch_net(tm, variables)
    gen = jax.jit(lambda v, d, nz: jm.generate(v, d, jax.random.key(0),
                                               noise_override=nz))
    return variables, gen, tm, net


def _noise(seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((b * s, 2, 3, 17)).astype(np.float32)
    zs = rng.standard_normal((9, b * s, 2, 3, 17)).astype(np.float32)
    return x0, zs


def _both(models, data, noise):
    variables, gen, tm, net = models
    sel_j, loss_j = gen(variables, jnp.asarray(data),
                        tuple(jnp.asarray(n) for n in noise))
    sel_t, loss_t = tm.generate(net, torch.from_numpy(data),
                                noise_override=tuple(torch.from_numpy(n)
                                                     for n in noise))
    return (np.asarray(sel_j), np.asarray(loss_j), sel_t.numpy(),
            loss_t.numpy())


def test_generate_matches_jax_under_injected_noise(models):
    data = np.random.default_rng(1).standard_normal(
        (B, 2, 6, 17)).astype(np.float32)
    sel_j, loss_j, sel_t, loss_t = _both(models, data, _noise(2))
    assert sel_t.shape == (B, 2, 3, 17) and loss_t.shape == (B,)
    np.testing.assert_allclose(loss_t, loss_j, RTOL, ATOL)
    np.testing.assert_allclose(sel_t, sel_j, RTOL, ATOL)


def test_generate_pairs_windows_correctly(models):
    """Ported from tests/test_pallas_unet.py:98-123.  Each window is scaled
    by a distinct power of four in shuffled order, so its loss is
    dominated by its own target: the per-window loss ranks follow the
    scales only if the b-major fold (row = b*S + s) pairs every window's
    samples with its own target."""
    b = 8
    base = np.random.default_rng(1).standard_normal(
        (b, 2, 6, 17)).astype(np.float32)
    scales = (4.0 ** np.arange(b))[[3, 6, 0, 5, 1, 7, 2, 4]]
    data = (base * scales[:, None, None, None]).astype(np.float32)
    _, loss_j, _, loss_t = _both(models, data, _noise(3, b=b))
    np.testing.assert_array_equal(np.argsort(loss_t), np.argsort(scales))
    np.testing.assert_array_equal(np.argsort(loss_t), np.argsort(loss_j))


def test_generate_draws_from_the_generator(models):
    _, _, tm, net = models
    data = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, 2, 6, 17)).astype(np.float32))
    runs = [tm.generate(net, data, torch.Generator().manual_seed(seed))[1]
            for seed in (7, 7, 8)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert not torch.equal(runs[0], runs[2])
    assert torch.isfinite(runs[0]).all()
    with pytest.raises(ValueError, match='Generator'):
        tm.generate(net, data)


# the 'bf16' case keeps its id from before bfloat16 was ported: it now
# holds an eval_dtype the port does not take (the JAX package rejects
# float16 too, mocodad_tpu/models/mocodad.py:154-156); a sampler other than
# ddpm or ddim is a ValueError in both packages (:212-215); the 'latent'
# case keeps its id from before the latent variant was ported: it now holds
# a latent config with another strategy than inject, a ValueError in both
# packages (mocodad_tpu/models/mocodad_latent.py:110-112)
@pytest.mark.parametrize('kw, error', [
    ({'extras': {'eval_dtype': 'float16'}}, NotImplementedError),
    ({'extras': {'sampler': 'euler'}}, ValueError),
    ({'diffusion_on_latent': True, 'conditioning_strategy': 'concat'},
     ValueError)],
    ids=['bf16', 'euler', 'latent'])
def test_options_outside_the_slice_raise(kw, error):
    from mocodad_tpu.config import Config as JaxConfig
    from mocodad_tpu.models import build_model as jax_build_model
    from mocodad_tpu_torch.config import Config
    from mocodad_tpu_torch.models.mocodad import build_model
    from _torch_port import CFG_KW
    cfg = Config(**{**CFG_KW, **kw})
    with pytest.raises(error):
        build_model(cfg)
    if error is ValueError:
        with pytest.raises(error):
            jax_build_model(JaxConfig(**{**CFG_KW, **kw}))
