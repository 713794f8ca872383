"""One training step of the port against the JAX package on the same
weights, data and noise: the loss and its metrics against JAX
`model.loss(train=True)`, every parameter's gradient against `jax.grad`,
the BatchNorm running statistics against flax's `mutated` (flax updates
the running variance with the BIASED batch variance, torch's
`nn.BatchNorm2d` with the unbiased one), a sample mask with zeros, three
Adam steps at optax's staircase learning rate with the EMA, and the
`train_dtype: bfloat16` contract of tests/test_model.py:326-396.

Weights are `seeded_variables` of `CFG_KW`; B = 16; the timesteps and the
forward noise are drawn with NumPy and handed to both packages as
`noise_override = (t, eps)`.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import (CFG_KW, jax_model, seeded_variables, torch_model)
from mocodad_tpu.data import affine_transform_matrices as jax_mats
from mocodad_tpu.data import apply_affine_batch as jax_affine
from mocodad_tpu.training.ema import ema_update as jax_ema_update
from mocodad_tpu.training.loop import monitored_metric_for as jax_monitored
from mocodad_tpu_torch.config import Config as TorchConfig
from mocodad_tpu_torch.models.mocodad import MoCoDADModel as TorchModel
from mocodad_tpu_torch.nn import FlaxBatchNorm2d
from mocodad_tpu_torch.training.ema import EMA_DECAY
from mocodad_tpu_torch.training.loop import Trainer, monitored_metric_for
from mocodad_tpu_torch.utils.weights import state_dict_from_jax

B = 16
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4       # max |Δ| per tensor over max |g| of that tensor
# or, for a tensor whose gradient is a sum that cancels to a small value
# (the PReLU slopes), over the largest gradient of the step
GRAD_FLOOR = 1e-6
# The bias of a 1x1 conv followed by a train-mode BatchNorm has a true
# gradient of 0 (the BatchNorm removes any shift): both packages compute
# rounding noise there, so those tensors are held to GRAD_REL times the
# largest gradient of the step, and their values to the same bound.
BN_FED_BIASES = ('tcn.0.bias', 'residual.0.bias', 'block.0.bias')
STATS_TOL = 1e-6      # running mean / var, absolute
# three Adam steps of lr = 1e-3: the two packages' float32 gradients differ
# in the last bits, and Adam scales each element's gradient by its own
# running magnitude, so an element whose gradient is near 0 turns that
# rounding into a visible share of a step.  Per tensor, max |Δ| within 20 %
# of one step and mean |Δ| within 0.1 % of one step (measured 4.2e-5 and
# 1.4e-7).  The BatchNorm-fed biases, whose gradients are rounding noise,
# take steps of noise in both packages, so they are held only to the most
# that three steps can move apart.
ADAM_MAX_TOL, ADAM_MEAN_TOL = 2e-4, 1e-6
EMA_TOL = 5e-7      # a few float32 ulps of the BatchNorm scales near 1


def _inputs(seed):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((B, 2, 6, 17)).astype(np.float32)
    t = rng.integers(1, CFG_KW['noise_steps'], B).astype(np.int32)
    eps = rng.standard_normal((B, 2, 3, 17)).astype(np.float32)
    return data, t, eps


def _net(tm, variables):
    net = tm.build_net()
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    return net.train()


def _jax_step(jm, variables, data, t, eps, mask=None):
    """(loss, metrics, grads as a reference-named dict, mutated stats)."""
    def f(params):
        loss, metrics, mutated = jm.loss(
            {'params': params, 'batch_stats': variables['batch_stats']},
            data, jax.random.key(0), train=True, sample_mask=mask,
            noise_override=(t, eps))
        return loss, (metrics, mutated)
    grads, (metrics, mutated) = jax.jit(jax.grad(f, has_aux=True))(
        variables['params'])
    loss = metrics['loss']
    g = state_dict_from_jax({'params': jax.device_get(grads)})
    stats = state_dict_from_jax({'params': variables['params'],
                                 'batch_stats': jax.device_get(
                                     mutated['batch_stats'])})
    stats = {k: v for k, v in stats.items() if k.endswith(('running_mean',
                                                           'running_var'))}
    return float(loss), {k: float(v) for k, v in metrics.items()}, g, stats


def _torch_step(tm, net, data, t, eps, mask=None):
    loss, metrics = tm.loss(
        net, torch.from_numpy(data),
        sample_mask=None if mask is None else torch.from_numpy(mask),
        noise_override=(torch.from_numpy(t), torch.from_numpy(eps)))
    net.zero_grad()
    loss.backward()
    return loss, metrics


@pytest.fixture(scope='module')
def models():
    jm, tm = jax_model(), torch_model()
    return jm, tm, seeded_variables(jm, seed=3)


def _assert_step(jm, tm, variables, mask=None):
    data, t, eps = _inputs(5)
    jl, jmet, jgrads, jstats = _jax_step(jm, variables, data, t, eps,
                                         None if mask is None
                                         else jnp.asarray(mask))
    net = _net(tm, variables)
    loss, metrics = _torch_step(tm, net, data, t, eps, mask)
    assert set(metrics) == set(jmet) == {'loss_noise', 'loss_recons', 'loss'}
    np.testing.assert_allclose(float(loss.detach()), jl, rtol=LOSS_RTOL)
    for k, v in jmet.items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=LOSS_RTOL,
                                   err_msg=k)
    params = dict(net.named_parameters())
    assert set(params) == set(jgrads)
    g_max = max(float(g.abs().max()) for g in jgrads.values())
    for k, want in jgrads.items():
        got = params[k].grad
        assert got is not None and got.dtype == torch.float32, k
        err = (got - want.reshape(got.shape)).abs().max()
        if k.endswith(BN_FED_BIASES):
            assert max(float(got.abs().max()), float(err)) \
                <= GRAD_REL * g_max, k
            continue
        assert err <= max(GRAD_REL * float(want.abs().max()),
                          GRAD_FLOOR * g_max), (k, float(err))
    buffers = dict(net.named_buffers())
    assert set(jstats) == {k for k in buffers if 'running' in k}
    for k, want in jstats.items():
        err = (buffers[k] - want).abs().max()
        assert err <= STATS_TOL, (k, float(err))


def test_train_step_matches_jax(models):
    _assert_step(*models)


def test_train_step_with_sample_mask(models):
    mask = np.ones(B, np.float32)
    mask[[2, 7, 11, 15]] = 0.0
    _assert_step(*models, mask=mask)


def test_torch_running_var_update_would_differ(models):
    """The same step with torch's own train-mode BatchNorm: the running
    means still match flax's, the running variances do not (unbiased
    against biased), which is what FlaxBatchNorm2d fixes."""
    jm, tm, variables = models
    data, t, eps = _inputs(5)
    *_, jstats = _jax_step(jm, variables, data, t, eps)
    net = _net(tm, variables)
    bns = [m for m in net.modules() if isinstance(m, FlaxBatchNorm2d)]
    assert bns and all(isinstance(m, torch.nn.BatchNorm2d) for m in bns)
    for m in bns:
        m.forward = types.MethodType(torch.nn.BatchNorm2d.forward, m)
    _torch_step(tm, net, data, t, eps)
    buffers = dict(net.named_buffers())
    mean_err = max(float((buffers[k] - v).abs().max())
                   for k, v in jstats.items() if k.endswith('mean'))
    var_err = max(float((buffers[k] - v).abs().max())
                  for k, v in jstats.items() if k.endswith('var'))
    assert mean_err <= STATS_TOL
    assert var_err > 10 * STATS_TOL, var_err


def _trans(seed):
    return np.random.default_rng(seed).integers(0, 5, B).astype(np.int32)


def test_three_adam_steps_with_staircase_lr_and_ema(models):
    jm, _, variables = models
    steps, steps_per_epoch, lr = 3, 2, 1e-3
    batches = [(_inputs(20 + k), _trans(30 + k)) for k in range(steps)]

    cfg = TorchConfig(**{**CFG_KW, 'opt_lr': lr, 'use_ema': True,
                         'num_transform': 5})
    noise = {k: (torch.from_numpy(b[0][1]), torch.from_numpy(b[0][2]))
             for k, b in enumerate(batches)}
    trainer = Trainer(cfg, device='cpu', noise_fn=lambda s, n: noise[s])
    trainer.init_state(steps_per_epoch)
    trainer.net.load_state_dict(state_dict_from_jax(variables), strict=True)
    trainer.ema = {k: p.detach().clone()
                   for k, p in trainer.net.named_parameters()}

    schedule = optax.exponential_decay(lr, steps_per_epoch, 0.99,
                                       staircase=True)
    opt = optax.adam(schedule)
    mats = jnp.asarray(jax_mats(5))
    params, stats = variables['params'], variables['batch_stats']
    opt_state = opt.init(params)
    ema = jax.tree_util.tree_map(jnp.copy, params)

    @jax.jit
    def jax_step(params, stats, opt_state, ema, data, trans, t, eps):
        data = jax_affine(data, mats, trans)

        def f(p):
            loss, metrics, mutated = jm.loss(
                {'params': p, 'batch_stats': stats}, data, jax.random.key(0),
                train=True, sample_mask=jnp.ones(B),
                noise_override=(t, eps))
            return loss, mutated['batch_stats']
        grads, stats = jax.grad(f, has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, stats, opt_state, jax_ema_update(ema, params)

    for k, ((data, t, eps), trans) in enumerate(batches):
        params, stats, opt_state, ema = jax_step(
            params, stats, opt_state, ema, data, trans, t, eps)
        trainer.train_step(torch.from_numpy(data), torch.from_numpy(trans),
                           torch.ones(B))
        # the lr the k-th update used: optax's count is k before it
        np.testing.assert_allclose(trainer.opt.param_groups[0]['lr'],
                                   float(schedule(k)), rtol=1e-6)
        assert trainer.step == k + 1
    assert trainer.lr_at(2) == pytest.approx(lr * 0.99)

    # the parameters; the running statistics of the BatchNorms behind the
    # noise-driven biases inherit their noise (the one-step tests hold
    # the statistics)
    want = state_dict_from_jax({'params': jax.device_get(params)})
    got = dict(trainer.net.named_parameters())
    assert set(want) == set(got)
    for k, v in want.items():
        err = float((got[k].detach() - v.reshape(got[k].shape)).abs().max())
        if k.endswith(BN_FED_BIASES):
            assert err <= 2 * steps * lr, (k, err)
            continue
        mean = float((got[k].detach() - v.reshape(got[k].shape)).abs()
                     .mean())
        assert err <= ADAM_MAX_TOL and mean <= ADAM_MEAN_TOL, (k, err, mean)
    want_ema = state_dict_from_jax({'params': jax.device_get(ema)})
    assert set(want_ema) == set(trainer.ema)
    for k, v in want_ema.items():
        err = float((trainer.ema[k] - v.reshape(trainer.ema[k].shape))
                    .abs().max())
        tol = 2 * steps * lr if k.endswith(BN_FED_BIASES) else ADAM_MAX_TOL
        assert err <= EMA_TOL + tol * (1 - EMA_DECAY), (k, err)


def test_ema_update_matches_jax():
    """The EMA's update rule on tensors far from each other, against JAX's
    `ema_update` (decay 0.9999)."""
    from mocodad_tpu_torch.training.ema import ema_init, ema_update
    rng = np.random.default_rng(0)
    net = torch.nn.Linear(8, 4)
    ema = {k: torch.from_numpy(rng.standard_normal(tuple(p.shape))
                               .astype(np.float32))
           for k, p in net.named_parameters()}
    want = jax_ema_update({k: jnp.asarray(v.numpy()) for k, v in ema.items()},
                          {k: jnp.asarray(p.detach().numpy())
                           for k, p in net.named_parameters()})
    ema_update(ema, net)
    for k, v in want.items():
        np.testing.assert_allclose(ema[k].numpy(), np.asarray(v), rtol=1e-6,
                                   atol=1e-7)
    copy = ema_init(net)
    assert all(copy[k].data_ptr() != p.data_ptr()
               for k, p in net.named_parameters())


@pytest.mark.parametrize('kw', [dict(validation=True), dict(validation=False),
                                dict(diffusion_on_latent=True,
                                     stage='pretrain')])
def test_monitored_metric_matches_jax(kw):
    from mocodad_tpu.config import Config as JaxConfig
    assert monitored_metric_for(TorchConfig(**kw)) == \
        jax_monitored(JaxConfig(**kw))


def test_train_dtype_bf16_contract(models):
    """`train_dtype: bfloat16`: float32 grads, running statistics and loss
    while the net computes in bfloat16; the loss within 2e-2 of the float32
    step's, the gradients' cosine above 0.99, and the running statistics
    updated as float32 accumulators (tests/test_model.py:326-396)."""
    _, tm, variables = models
    cfg16 = TorchConfig(**CFG_KW)
    cfg16.extras['train_dtype'] = 'bfloat16'
    tm16 = TorchModel(cfg16)
    assert tm16.train_dtype == torch.bfloat16
    assert tm16.eval_dtype == torch.float32
    data, t, eps = _inputs(5)

    def step(model):
        net = _net(model, variables)
        loss, metrics = _torch_step(model, net, data, t, eps)
        g = torch.cat([p.grad.ravel() for p in net.parameters()])
        return net, loss.detach(), metrics, g

    _, l32, _, g32 = step(tm)
    net16, l16, met16, g16 = step(tm16)
    assert l16.dtype == torch.float32 and g16.dtype == torch.float32
    assert all(v.dtype == torch.float32 for v in met16.values())
    assert all(p.dtype == torch.float32 for p in net16.parameters())
    assert all(b.dtype == torch.float32 for k, b in net16.named_buffers()
               if 'running' in k)
    assert abs(float(l16) - float(l32)) / abs(float(l32)) < 2e-2
    cos = float(g32 @ g16 / (g32.norm() * g16.norm()))
    assert cos > 0.99, cos

    # and the JAX package's bfloat16 step, closer still: both round at the
    # same points, in sums of another order (measured on seeds 3-5: loss
    # within 3.8e-4 to 1.1e-3, gradient cosine 0.99950-0.99956)
    from mocodad_tpu.config import Config as JaxConfig
    from mocodad_tpu.models import MoCoDADModel as JaxModel
    jcfg = JaxConfig(**CFG_KW)
    jcfg.extras['train_dtype'] = 'bfloat16'
    jl16, _, jg16, _ = _jax_step(JaxModel(jcfg), variables, data, t, eps)
    names = [k for k, _ in net16.named_parameters()]
    jg = torch.cat([jg16[k].ravel() for k in names])
    assert abs(float(l16) - jl16) / jl16 < 3e-3
    assert float(g16 @ jg / (g16.norm() * jg.norm())) > 0.999

    delta = 2.0 ** -12

    def means_after(v):
        net = _net(tm16, variables)
        for k, b in net.named_buffers():
            if k.endswith('running_mean'):
                b.fill_(v)
        tm16.loss(net, torch.from_numpy(data),
                  noise_override=(torch.from_numpy(t),
                                  torch.from_numpy(eps)))
        return [b.clone() for k, b in net.named_buffers()
                if k.endswith('running_mean')]

    for a, b in zip(means_after(1.0 + delta), means_after(0.0)):
        got = float((a - b).ravel()[0])
        assert abs(got - 0.9 * (1.0 + delta)) < delta / 4, got
