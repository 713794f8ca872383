"""Schedule tables and sample aggregation: the port against the JAX
package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)
from mocodad_tpu import diffusion as jdiff
from mocodad_tpu.models import losses as jlosses
from mocodad_tpu_torch import diffusion as tdiff
from mocodad_tpu_torch.models import losses as tlosses


@pytest.mark.parametrize('steps', [10, 50])
@pytest.mark.parametrize('kind', ['cosine', 'linear'])
def test_schedule_tables_bit_equal(steps, kind):
    j = jdiff.make_schedule(steps, kind)
    t = tdiff.make_schedule(steps, kind)
    for name in ('beta', 'alpha', 'alpha_hat'):
        a, b = getattr(j, name), getattr(t, name)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_ddpm_step_coefficients_match_jax_float32():
    s = tdiff.make_schedule(10)
    for t in range(1, 10):
        a, a_hat, beta = (jnp.float32(s.alpha[t]), jnp.float32(s.alpha_hat[t]),
                          jnp.float32(s.beta[t]))
        want = (1.0 / jnp.sqrt(a), (1.0 - a) / jnp.sqrt(1.0 - a_hat),
                jnp.sqrt(beta))
        got = tdiff.ddpm_step_coefficients(s, t)
        assert got == tuple(float(np.float32(w)) for w in want)


STRATEGIES = ['best', 'worst', 'mean', 'median', 'mean_pose', 'median_pose',
              'all', 'quantile:0.25']


@pytest.mark.parametrize('loss_kind', ['smooth_l1', 'l1', 'mse'])
@pytest.mark.parametrize('strategy', STRATEGIES)
def test_aggregate_matches_jax_with_nans(strategy, loss_kind):
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((6, 5, 2, 3, 4)).astype(np.float32) * 2
    target = rng.standard_normal((5, 2, 3, 4)).astype(np.float32)
    xs[2, 1, 0, 0, 0] = np.nan              # one NaN sample of window 1
    xs[:, 3, 1, 2, 3] = np.nan              # every sample of window 3
    sel_j, loss_j = jlosses.aggregate(strategy, loss_kind, jnp.asarray(xs),
                                      jnp.asarray(target))
    sel_t, loss_t = tlosses.aggregate(strategy, loss_kind,
                                      torch.from_numpy(xs),
                                      torch.from_numpy(target))
    # the same float32 reductions; only summation order differs
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j),
                               rtol=1e-6, atol=1e-7)
    assert (sel_j is None) == (sel_t is None)
    if sel_j is not None:
        np.testing.assert_allclose(sel_t.numpy(), np.asarray(sel_j),
                                   rtol=1e-6, atol=1e-7)


def test_random_aggregation_draws_from_the_generator():
    rng = np.random.default_rng(4)
    xs = torch.from_numpy(rng.standard_normal((4, 8, 2, 3)).astype(
        np.float32))
    target = torch.zeros(8, 2, 3)
    sel, loss = tlosses.aggregate('random', 'mse', xs, target,
                                  generator=torch.Generator().manual_seed(0))
    per = tlosses.per_sample_losses('mse', xs, target)
    # each window's pick is one of its own samples, with that sample's loss
    for b in range(8):
        i = int(torch.nonzero((xs[:, b] == sel[b]).flatten(1).all(1))[0])
        assert loss[b] == per[i, b]
    with pytest.raises(ValueError):
        tlosses.aggregate('random', 'mse', xs, target)
