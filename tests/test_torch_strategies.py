"""Every conditioning strategy of the port against the JAX package on the
same weights: the frame gathers of `models/frames.py` in both layouts, the
multi-sample `generate` at float32 under the same gaussians, one train-mode
`loss` with its gradients, and the E_unet condition encoder.

The strategies run at seg_len 6: concat, inbetween_imp (every 2nd frame
conditions), random_imp (3 random frames) and no_condition feed the U-Net
all 6 frames; inject with E_unet feeds it the 3 corrupted ones.  For
random_imp both models' `frame_order` is replaced by one NumPy order, so
the two packages see the same frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (jax_model, seeded_variables, torch_model,
                         trained_variables)
from mocodad_tpu.models import frames as JF
from mocodad_tpu_torch.models import frames as F
from mocodad_tpu_torch.utils.weights import state_dict_from_jax

# float32 through the chain on both sides, as tests/test_torch_generate.py
RTOL, ATOL = 1e-4, 1e-5
# one train-mode step, as tests/test_torch_train_step.py
LOSS_RTOL, GRAD_REL, GRAD_FLOOR = 1e-5, 1e-4, 1e-6
BN_FED_BIASES = ('tcn.0.bias', 'residual.0.bias', 'block.0.bias')
B, S, B_LOSS = 2, 2, 8
STRATEGIES = {
    'concat': dict(conditioning_strategy='concat'),
    'inbetween_imp': dict(conditioning_strategy='inbetween_imp',
                          conditioning_indices=2),
    'random_imp': dict(conditioning_strategy='random_imp',
                       conditioning_indices=3),
    'no_condition': dict(conditioning_strategy='no_condition'),
    'inject_e_unet': dict(conditioning_architecture='E_unet'),
}
_CACHE = {}


def _random_orders(batch, seed):
    """(B, 6) random_imp orders from the JAX package's own sampler."""
    return np.array(JF.random_order(jax.random.key(seed), batch, 6, 3))


def _setup(name):
    """(JAX model, port model, `trained_variables`, port net holding them)
    of one strategy, built once per process."""
    if name not in _CACHE:
        kw = dict(STRATEGIES[name], n_generated_samples=S)
        jm, tm = jax_model(**kw), torch_model(**kw)
        variables = trained_variables(jm, seed=13)
        net = tm.build_net()
        net.load_state_dict(state_dict_from_jax(variables), strict=True)
        _CACHE[name] = (jm, tm, variables, net)
    return _CACHE[name]


def _use_order(monkeypatch, jm, tm, order):
    """Both models' frame order replaced by one NumPy order."""
    monkeypatch.setattr(jm, 'frame_order',
                        lambda rng, batch: jnp.asarray(order))
    monkeypatch.setattr(tm, 'frame_order',
                        lambda gen, batch, device=None:
                        torch.from_numpy(order))


@pytest.mark.parametrize('per_window', [False, True],
                         ids=['static', 'per_window'])
@pytest.mark.parametrize('strategy', ['concat', 'inject', 'no_condition',
                                      'random_imp', 'inbetween_imp'])
def test_frames_match_jax_bit_for_bit(strategy, per_window):
    """select_frames, assemble_input and extract_corrupt against the JAX
    package's, and the chain-layout assemble_ctn / extract_ctn against
    them on the b-major fold."""
    rng = np.random.default_rng(3)
    b, v = 4, 17
    n_cond = 0 if strategy == 'no_condition' else 3
    data = rng.standard_normal((b, 2, 6, v)).astype(np.float32)
    order = (_random_orders(b, 4) if per_window else
             np.array([0, 2, 4, 1, 3, 5], np.int64))
    if strategy == 'no_condition':
        order = np.broadcast_to(np.arange(6), order.shape).copy()
    jc, jx = JF.select_frames(jnp.asarray(data), jnp.asarray(order), n_cond)
    tc, tx = F.select_frames(torch.from_numpy(data), order, n_cond)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    if n_cond:
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    noisy = rng.standard_normal(tx.shape).astype(np.float32)
    j_in = JF.assemble_input(strategy, jc, jnp.asarray(noisy),
                             jnp.asarray(order), n_cond)
    t_in = F.assemble_input(strategy, tc, torch.from_numpy(noisy), order,
                            n_cond)
    np.testing.assert_array_equal(t_in.numpy(), np.asarray(j_in))
    pred = rng.standard_normal(t_in.shape).astype(np.float32)
    j_out = JF.extract_corrupt(strategy, jnp.asarray(pred),
                               jnp.asarray(order), n_cond)
    t_out = F.extract_corrupt(strategy, torch.from_numpy(pred), order,
                              n_cond)
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    # the chain's layout, S samples per window folded b-major
    s = 3
    col = F.column_order(torch.from_numpy(order), s)

    def tiled(a):
        return F.to_ctn(torch.from_numpy(np.asarray(a)).repeat_interleave(
            s, 0))
    got_in = F.assemble_ctn(strategy, None if tc is None else tiled(tc),
                            tiled(noisy), col, n_cond, v)
    assert got_in.is_contiguous()
    np.testing.assert_array_equal(got_in.numpy(), tiled(t_in).numpy())
    got_out = F.extract_ctn(strategy, tiled(pred), col, n_cond, v)
    np.testing.assert_array_equal(got_out.numpy(), tiled(t_out).numpy())


def test_random_order_puts_the_conditioning_frames_first():
    """Per window: n_cond distinct positions, then the rest, each group
    sorted; every subset of positions turns up."""
    g = torch.Generator().manual_seed(0)
    order = F.random_order(g, 400, 6, 3).numpy()
    assert order.shape == (400, 6)
    for o in order:
        assert sorted(o) == list(range(6))
        assert list(o[:3]) == sorted(o[:3]) and list(o[3:]) == sorted(o[3:])
    assert len({tuple(o[:3]) for o in order}) == 20      # C(6, 3)


def _noise(tm, seed, b=B, s=S, steps=9):
    rng = np.random.default_rng(seed)
    shape = (b * s, 2, tm.n_frames_corrupt, 17)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal((steps,) + shape).astype(np.float32))


@pytest.mark.parametrize('name', list(STRATEGIES))
def test_generate_matches_jax_under_injected_noise(name, monkeypatch):
    jm, tm, variables, net = _setup(name)
    data = np.random.default_rng(1).standard_normal(
        (B, 2, 6, 17)).astype(np.float32)
    if name == 'random_imp':
        _use_order(monkeypatch, jm, tm, _random_orders(B, 6))
    noise = _noise(tm, 2)
    gen = jax.jit(lambda v, d, nz: jm.generate(v, d, jax.random.key(0),
                                               noise_override=nz))
    sel_j, loss_j = gen(variables, jnp.asarray(data),
                        tuple(map(jnp.asarray, noise)))
    sel_t, loss_t = tm.generate(net.eval(), torch.from_numpy(data),
                                noise_override=tuple(map(torch.from_numpy,
                                                         noise)))
    assert loss_t.shape == (B,) and torch.isfinite(loss_t).all()
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), RTOL, ATOL)
    np.testing.assert_allclose(sel_t.numpy(), np.asarray(sel_j), RTOL, ATOL)


@pytest.mark.parametrize('name', list(STRATEGIES))
def test_loss_and_gradients_match_jax(name, monkeypatch):
    """One train-mode loss and every parameter's gradient against JAX
    `loss(train=True)` and `jax.grad`, on the same weights, data, frame
    order and (t, eps).  The weights are `seeded_variables`, as in
    tests/test_torch_train_step.py: from the JAX package's own init (every
    BatchNorm at identity) flax's float32 gradients land up to 9 % of a
    tensor's largest gradient away from float64 at these shapes (its
    variance is E[x^2] - E[x]^2), where the port's stay within 2e-6."""
    jm, tm, _, _ = _setup(name)
    variables = seeded_variables(jm, seed=3)
    rng = np.random.default_rng(5)
    data = rng.standard_normal((B_LOSS, 2, 6, 17)).astype(np.float32)
    t = rng.integers(1, 10, B_LOSS).astype(np.int32)
    eps = rng.standard_normal(
        (B_LOSS, 2, tm.n_frames_corrupt, 17)).astype(np.float32)
    if name == 'random_imp':
        _use_order(monkeypatch, jm, tm, _random_orders(B_LOSS, 7))

    def f(params):
        loss, metrics, _ = jm.loss(
            {'params': params, 'batch_stats': variables['batch_stats']},
            jnp.asarray(data), jax.random.key(0), train=True,
            noise_override=(t, eps))
        return loss, metrics
    grads, jmet = jax.jit(jax.grad(f, has_aux=True))(variables['params'])
    jgrads = state_dict_from_jax({'params': jax.device_get(grads)})
    net = tm.build_net()
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    net.train()
    loss, metrics = tm.loss(net, torch.from_numpy(data),
                            noise_override=(torch.from_numpy(t),
                                            torch.from_numpy(eps)))
    loss.backward()
    assert set(metrics) == set(jmet)
    for k, v in jmet.items():
        np.testing.assert_allclose(float(metrics[k]), float(v),
                                   rtol=LOSS_RTOL, err_msg=k)
    params = dict(net.named_parameters())
    assert set(params) == set(jgrads)
    g_max = max(float(g.abs().max()) for g in jgrads.values())
    for k, want in jgrads.items():
        got = params[k].grad
        err = float((got - want.reshape(got.shape)).abs().max())
        if k.endswith(BN_FED_BIASES):
            assert max(float(got.abs().max()), err) <= GRAD_REL * g_max, k
            continue
        assert err <= max(GRAD_REL * float(want.abs().max()),
                          GRAD_FLOOR * g_max), (k, err)


def test_e_unet_gives_no_reconstruction_loss():
    """E_unet returns (latent, []) and no reconstruction: its loss has no
    'loss_recons', in both packages; the AE's has."""
    _, tm, _, net = _setup('inject_e_unet')
    data = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (4, 2, 6, 17)).astype(np.float32))
    _, metrics = tm.loss(net.train(), data, torch.Generator().manual_seed(0))
    assert set(metrics) == {'loss_noise', 'loss'}
    ae = torch_model()
    _, metrics = ae.loss(ae.build_net(), data,
                         torch.Generator().manual_seed(0))
    assert set(metrics) == {'loss_noise', 'loss_recons', 'loss'}


@pytest.mark.parametrize('name', ['inject_e_unet', 'no_condition'])
def test_weights_load_with_strict_names(name):
    """state_dict_from_jax covers the E_unet encoder and a net with no
    encoder: every key the port's net has, and no other."""
    _, tm, variables, net = _setup(name)
    sd = state_dict_from_jax(variables)
    assert set(sd) == set(net.state_dict()) - {
        k for k in net.state_dict() if k.endswith('num_batches_tracked')}
    has_encoder = any(k.startswith('condition_encoder.') for k in sd)
    assert has_encoder == (name == 'inject_e_unet')
    assert (net.condition_encoder is None) == (name == 'no_condition')
