"""The port's samplers against the JAX package: the DDIM timesteps and
coefficients, `generate` with `sampler: ddim` at float32 under the same
gaussians, the antithetic mirror fold and its draws, and the bfloat16
chain at T = 6 frames (concat) beside the JAX package's bfloat16
`generate()`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (jax_model, seeded_variables, torch_model, torch_net,
                         trained_variables)
from mocodad_tpu import diffusion as JD
from mocodad_tpu.models import mocodad as JM
from mocodad_tpu_torch import diffusion as D
from mocodad_tpu_torch.models import mocodad as M

# float32 through the chain on both sides, as tests/test_torch_generate.py
RTOL, ATOL = 1e-4, 1e-5
B, S = 2, 3


@pytest.mark.parametrize('noise_steps, n_steps', [(10, 3), (10, 9), (10, 1),
                                                  (10, 20), (100, 7)])
def test_ddim_timesteps_and_plan_match_jax(noise_steps, n_steps):
    ts = D.ddim_timesteps(noise_steps, n_steps)
    np.testing.assert_array_equal(ts, JD.ddim_timesteps(noise_steps,
                                                        n_steps))
    sched, jsched = D.make_schedule(noise_steps), JD.make_schedule(noise_steps)
    for eta in (0.0, 0.5, 1.0):
        for got, want in zip(D.ddim_plan(sched, ts, eta),
                             JD.ddim_plan(jsched, ts, eta)):
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('eta', [0.0, 0.5], ids=['eta0', 'eta0.5'])
def test_ddim_generate_matches_jax(eta):
    kw = dict(n_generated_samples=S,
              extras={'sampler': 'ddim', 'ddim_steps': 3, 'ddim_eta': eta})
    jm, tm = jax_model(**kw), torch_model(**kw)
    variables = trained_variables(jm, seed=17)
    net = torch_net(tm, variables)
    ts, plan = tm.chain_steps()
    assert list(ts) == [9, 5, 1] and plan is not None
    rng = np.random.default_rng(4)
    data = rng.standard_normal((B, 2, 6, 17)).astype(np.float32)
    x0 = rng.standard_normal((B * S, 2, 3, 17)).astype(np.float32)
    zs = rng.standard_normal((3, B * S, 2, 3, 17)).astype(np.float32)
    sel_j, loss_j = jax.jit(lambda v, d, a, z: jm.generate(
        v, d, jax.random.key(0), noise_override=(a, z)))(
            variables, jnp.asarray(data), jnp.asarray(x0), jnp.asarray(zs))
    sel_t, loss_t = tm.generate(net, torch.from_numpy(data),
                                noise_override=(torch.from_numpy(x0),
                                                torch.from_numpy(zs)))
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), RTOL, ATOL)
    np.testing.assert_allclose(sel_t.numpy(), np.asarray(sel_j), RTOL, ATOL)
    with pytest.raises(ValueError, match=r'\(3, 6, 2, 3, 17\)'):
        tm.generate(net, torch.from_numpy(data),
                    noise_override=(torch.from_numpy(x0),
                                    torch.from_numpy(np.zeros(
                                        (9, B * S, 2, 3, 17), np.float32))))


@pytest.mark.parametrize('s', [4, 5], ids=['even', 'odd'])
def test_mirror_fold_matches_jax(s):
    half = np.random.default_rng(s).standard_normal(
        (3, (s + 1) // 2, 2, 51)).astype(np.float32)
    got = M._mirror_fold(torch.from_numpy(half), s).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        JM._mirror_fold(jnp.asarray(half), s)))
    assert got.shape == (3 * s, 2, 51)


def test_antithetic_draws_come_in_mirrored_pairs(monkeypatch):
    """With the denoiser returning 0 the chain is linear in its draws, so
    every step's input keeps the antithetic structure of x0 and of each z
    exactly: per window, sample s + h is -(sample s) for s < S - h (h =
    ceil(S/2)), and the first h samples differ."""
    tm = torch_model(n_generated_samples=S, extras={'antithetic': True})
    net = tm.build_net().eval()
    seen = []

    def zero_eps(x, semb, folded):
        seen.append(x.clone())
        return torch.zeros_like(x)
    monkeypatch.setattr(M, 'denoise', zero_eps)
    data = torch.randn((B, 2, 6, 17), generator=torch.Generator()
                       .manual_seed(0))
    tm.generate(net, data, torch.Generator().manual_seed(1))
    assert len(seen) == 9
    h = (S + 1) // 2
    for x in seen:
        x = x.reshape(2, 51, B, S)
        torch.testing.assert_close(x[..., h:], -x[..., :S - h], rtol=0,
                                   atol=0)
        assert not torch.equal(x[..., 0], x[..., 1])
    # and not with noise_override, as in the JAX package
    seen.clear()
    noise = (torch.zeros((B * S, 2, 3, 17)), torch.ones((9, B * S, 2, 3, 17)))
    tm.generate(net, data, noise_override=noise)
    assert torch.equal(seen[-1][..., 0], seen[-1][..., 2])


def test_bf16_concat_chain_against_jax_xla_generate():
    """concat at seg_len 6 (the U-Net at T = 6 frames), eval_dtype
    bfloat16: the port's chain (tests/test_torch_generate_bf16_xla.py's
    function: the update in float32 then rounded, the encoder-free
    silu(t_emb) in float32, the conditioning frames rounded as they enter)
    beside the JAX package's bfloat16 `generate()` (every variable cast,
    the update in bfloat16), on the same weights and gaussians, B = 8,
    S = 3.  Per-window loss max |diff| / max |loss| measured on the CPU:
    9.4e-3, 1.32e-2 and 3.0e-3 for seeds 21-23, above the 1e-2 that the
    same comparison holds at T = 3 (tests/test_torch_generate_bf16_xla.py):
    at T = 6 the JAX function also rounds the conditioning half of every
    input and twice the positions per layer.  Held within 2e-2; the
    float32 chains agree within 1e-4 (tests/test_torch_strategies.py)."""
    kw = dict(conditioning_strategy='concat', n_generated_samples=S,
              extras={'eval_dtype': 'bfloat16'})
    jm, tm = jax_model(**kw), torch_model(**kw)
    rels = []
    for seed in (21, 22, 23):
        variables = seeded_variables(jm, seed=seed)
        net = torch_net(tm, variables)
        rng = np.random.default_rng(seed)
        data = rng.standard_normal((8, 2, 6, 17)).astype(np.float32)
        x0 = rng.standard_normal((8 * S, 2, 3, 17)).astype(np.float32)
        zs = rng.standard_normal((9, 8 * S, 2, 3, 17)).astype(np.float32)
        _, loss_j = jax.jit(lambda v, d, a, z: jm.generate(
            v, d, jax.random.key(0), noise_override=(a, z)))(
                variables, jnp.asarray(data), jnp.asarray(x0),
                jnp.asarray(zs))
        _, loss_t = tm.generate(net, torch.from_numpy(data),
                                noise_override=(torch.from_numpy(x0),
                                                torch.from_numpy(zs)))
        loss_j = np.asarray(loss_j, np.float64)
        assert np.isfinite(loss_t.numpy()).all()
        rels.append(np.abs(loss_t.numpy() - loss_j).max()
                    / np.abs(loss_j).max())
    assert max(rels) <= 2e-2, rels
