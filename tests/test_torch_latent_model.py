"""The latent model of the port against the JAX package's
`MoCoDADLatentModel` on the same seeded weights, data and gaussians: the
loss of both stages with its gradients, running statistics and a sample
mask, the `train_dtype: bfloat16` contract, `generate` of both stages
(DDPM, DDIM at eta 0 and 0.5, every aggregation, antithetic draws), its
float32 result at `eval_dtype: bfloat16`, and the two configuration
errors.

The JAX latent loss draws t and the latent noise from its key (it takes
no `noise_override`): the test draws the same with the JAX package's own
functions and hands them to the port as `noise_override = (t, eps)`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from _torch_port import CFG_KW, seeded_variables
from mocodad_tpu.config import Config as JaxConfig
from mocodad_tpu.diffusion import sample_timesteps as jax_timesteps
from mocodad_tpu.models import MoCoDADLatentModel as JaxLatent
from mocodad_tpu_torch.config import Config as TorchConfig
from mocodad_tpu_torch.models.mocodad import build_model
from mocodad_tpu_torch.models.mocodad_latent import MoCoDADLatentModel
from mocodad_tpu_torch.utils.weights import state_dict_from_jax

B, S, D = 16, 3, 16
HIDDEN = [16, 32, 16]
LOSS_RTOL = 1e-5
GRAD_REL, GRAD_FLOOR = 1e-4, 1e-6   # as tests/test_torch_train_step.py
STATS_TOL = 1e-6
# per-window losses of generate: max |diff| over the largest loss
GEN_REL = 1e-5
# train_dtype bfloat16 (seeded_variables seeds 7-9, measured on the CPU):
# the loss within 7e-5 to 1.3e-3 of the float32 step's, the gradients'
# cosine 0.9877-0.9995 (pretrain) and 0.9999 (diffusion); against the JAX
# package's bfloat16 step the loss within 2.5e-4 to 1.7e-3 and the cosine
# 0.9973-0.9993 (pretrain) and 0.9999 (diffusion).  The pretrain stage's
# bottleneck rounds the whole window through a 16-wide code.
BF16_COS_F32, BF16_COS_JAX = 0.98, 0.995
# biases whose shift a train-mode BatchNorm removes: a true gradient of 0
BN_FED_BIASES = ('tcn.0.bias', 'residual.0.bias', 'block.0.bias')


def _kw(stage, **kw):
    return dict(CFG_KW, diffusion_on_latent=True, stage=stage,
                latent_embedding_dim=D, hidden_sizes=HIDDEN,
                n_generated_samples=S, **kw)


def _pair(stage, seed=7, **kw):
    """(JAX model, port model, JAX variables, port net in train mode)."""
    jm = JaxLatent(JaxConfig(**_kw(stage, **kw)))
    tm = build_model(TorchConfig(**_kw(stage, **kw)))
    assert isinstance(tm, MoCoDADLatentModel)
    variables = seeded_variables(jm, seed=seed)
    net = tm.build_net()
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jm, tm, variables, net.train()


def _data(seed=5, b=B):
    return np.random.default_rng(seed).standard_normal(
        (b, 2, 6, 17)).astype(np.float32)


def _jax_draws(key, b, noise_steps=10):
    """The t and latent eps that the JAX latent loss draws from `key`
    (mocodad_tpu/models/mocodad_latent.py:172-181)."""
    _, r_t, r_noise, _ = jax.random.split(key, 4)
    t = jax_timesteps(r_t, b, noise_steps)
    eps = jax.random.normal(r_noise, (b, D), dtype=jnp.float32)
    return np.asarray(t), np.asarray(eps)


def _jax_loss(jm, variables, data, key, mask=None):
    def f(params):
        loss, metrics, mutated = jm.loss(
            {'params': params, 'batch_stats': variables['batch_stats']},
            jnp.asarray(data), key, train=True, sample_mask=mask)
        return loss, (metrics, mutated)
    grads, (metrics, mutated) = jax.jit(jax.grad(f, has_aux=True))(
        variables['params'])
    g = state_dict_from_jax({'params': jax.device_get(grads)})
    stats = state_dict_from_jax({'params': variables['params'],
                                 'batch_stats': jax.device_get(
                                     mutated['batch_stats'])})
    stats = {k: v for k, v in stats.items() if 'running' in k}
    return {k: float(v) for k, v in metrics.items()}, g, stats


def _torch_loss(tm, net, data, t, eps, mask=None):
    loss, metrics = tm.loss(
        net, torch.from_numpy(data),
        sample_mask=None if mask is None else torch.from_numpy(mask),
        noise_override=(torch.from_numpy(t), torch.from_numpy(eps)))
    net.zero_grad()
    loss.backward()
    return loss, metrics


@pytest.mark.parametrize('masked', [False, True], ids=['nomask', 'mask'])
@pytest.mark.parametrize('stage', ['pretrain', 'diffusion'])
def test_loss_grads_and_stats_match_jax(stage, masked):
    jm, tm, variables, net = _pair(stage)
    data, key = _data(), jax.random.key(11)
    mask = None
    if masked:
        mask = np.ones(B, np.float32)
        mask[[1, 6, 12]] = 0.0
    jmet, jgrads, jstats = _jax_loss(jm, variables, data, key,
                                     None if mask is None
                                     else jnp.asarray(mask))
    t, eps = _jax_draws(key, B)
    loss, metrics = _torch_loss(tm, net, data, t, eps, mask)
    want = ({'loss_unet', 'loss_recons', 'loss'} if stage == 'pretrain'
            else {'loss_noise', 'loss'})
    assert set(metrics) == set(jmet) == want
    for k, v in jmet.items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=LOSS_RTOL,
                                   err_msg=k)
    params = dict(net.named_parameters())
    assert set(params) == set(jgrads)
    g_max = max(float(g.abs().max()) for g in jgrads.values())
    for k, want_g in jgrads.items():
        got = params[k].grad
        if got is None:
            # the diffusion stage leaves the AE's decoder off the loss:
            # JAX's gradient there is 0, autograd computes none
            assert stage == 'diffusion' and k.startswith(
                ('condition_encoder.decoder.',
                 'condition_encoder.rev_btlnk.')), k
            assert not want_g.any(), k
            continue
        assert got.dtype == torch.float32, k
        err = float((got - want_g.reshape(got.shape)).abs().max())
        if k.endswith(BN_FED_BIASES):
            assert err <= GRAD_REL * g_max, (k, err)
            continue
        assert err <= max(GRAD_REL * float(want_g.abs().max()),
                          GRAD_FLOOR * g_max), (k, err)
    buffers = dict(net.named_buffers())
    assert set(jstats) == {k for k in buffers if 'running' in k}
    for k, want_s in jstats.items():
        err = float((buffers[k] - want_s).abs().max())
        assert err <= STATS_TOL, (k, err)


@pytest.mark.parametrize('stage', ['pretrain', 'diffusion'])
def test_train_dtype_bf16_contract(stage):
    """`train_dtype: bfloat16`: float32 loss, gradients and running
    statistics while the net computes in bfloat16; the loss and gradients
    near the float32 step's and nearer the JAX package's bfloat16 step,
    which rounds at the same points (the pretrain target is the float32
    window on both sides)."""
    jm, tm, variables, net = _pair(stage)
    extras = {'train_dtype': 'bfloat16'}
    jm16 = JaxLatent(JaxConfig(**_kw(stage, extras=extras)))
    tm16 = build_model(TorchConfig(**_kw(stage, extras=extras)))
    assert tm16.train_dtype == torch.bfloat16
    data, key = _data(), jax.random.key(11)
    t, eps = _jax_draws(key, B)

    def step(model):
        n = model.build_net()
        n.load_state_dict(state_dict_from_jax(variables), strict=True)
        loss, metrics = _torch_loss(model, n.train(), data, t, eps)
        g = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad)
                       .ravel() for p in n.parameters()])
        return n, loss.detach(), metrics, g

    _, l32, _, g32 = step(tm)
    net16, l16, met16, g16 = step(tm16)
    assert l16.dtype == torch.float32 and g16.dtype == torch.float32
    assert all(v.dtype == torch.float32 for v in met16.values())
    assert all(p.dtype == torch.float32 for p in net16.parameters())
    assert all(b.dtype == torch.float32 for k, b in net16.named_buffers()
               if 'running' in k)
    assert abs(float(l16) - float(l32)) / abs(float(l32)) < 2e-2
    assert float(g32 @ g16 / (g32.norm() * g16.norm())) > BF16_COS_F32

    jmet16, jg16, _ = _jax_loss(jm16, variables, data, key)
    names = [k for k, _ in net16.named_parameters()]
    jg = torch.cat([jg16[k].ravel() for k in names])
    assert abs(float(l16) - jmet16['loss']) / jmet16['loss'] < 3e-3
    assert float(g16 @ jg / (g16.norm() * jg.norm())) > BF16_COS_JAX


def _jax_generate(jm, variables, data, noise=None):
    fn = jax.jit(lambda v, d, nz: jm.generate(v, d, jax.random.key(0),
                                              noise_override=nz))
    return fn(variables, jnp.asarray(data),
              None if noise is None else tuple(map(jnp.asarray, noise)))


def _noise(n_steps, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B * S, D)).astype(np.float32),
            rng.standard_normal((n_steps, B * S, D)).astype(np.float32))


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= GEN_REL * np.abs(want).max(), \
        np.abs(got - want).max() / np.abs(want).max()


AGGREGATIONS = ('best', 'worst', 'mean', 'median', 'mean_pose',
                'median_pose', 'all', 'quantile:0.25')


@pytest.mark.parametrize('aggr', AGGREGATIONS)
def test_generate_ddpm_every_aggregation(aggr):
    jm, tm, variables, net = _pair('diffusion', seed=9,
                                   aggregation_strategy=aggr)
    net.eval()
    data, noise = _data(b=B), _noise(9)
    sel_j, loss_j = _jax_generate(jm, variables, data, noise)
    sel_t, loss_t = tm.generate(net, torch.from_numpy(data),
                                noise_override=tuple(map(torch.from_numpy,
                                                         noise)))
    _close(loss_t.numpy(), loss_j)
    assert (sel_t is None) == (sel_j is None)
    if sel_t is not None:
        _close(sel_t.numpy(), sel_j)


@pytest.mark.parametrize('eta', [0.0, 0.5], ids=['eta0', 'eta0.5'])
def test_generate_ddim(eta):
    extras = {'sampler': 'ddim', 'ddim_steps': 3, 'ddim_eta': eta}
    jm, tm, variables, net = _pair('diffusion', seed=9, extras=extras)
    net.eval()
    data, noise = _data(b=B), _noise(3)
    sel_j, loss_j = _jax_generate(jm, variables, data, noise)
    sel_t, loss_t = tm.generate(net, torch.from_numpy(data),
                                noise_override=tuple(map(torch.from_numpy,
                                                         noise)))
    _close(loss_t.numpy(), loss_j)
    _close(sel_t.numpy(), sel_j)
    with pytest.raises(ValueError, match=r'\(3, 48, 16\)'):
        tm.generate(net, torch.from_numpy(data),
                    noise_override=(torch.from_numpy(noise[0]),
                                    torch.zeros((9, B * S, D))))


def test_antithetic_latent_draws():
    """Antithetic draws: with the latent denoiser returning 0 the chain is
    linear in its draws, so per window sample s + h is -(sample s) (h =
    ceil(S/2)); under noise_override the draws are the given ones, on both
    sides, as without antithetic."""
    jm, tm, variables, net = _pair('diffusion', seed=9,
                                   extras={'antithetic': True})
    net.eval()
    data = torch.from_numpy(_data(b=4))
    real = net.denoise_latent
    net.denoise_latent = lambda z, t, c: torch.zeros_like(z)
    sel, _ = tm.generate(net, data, torch.Generator().manual_seed(1),
                         aggr_strategy='all')
    h = (S + 1) // 2
    torch.testing.assert_close(sel[:, h:], -sel[:, :S - h], rtol=0, atol=0)
    assert not torch.equal(sel[:, 0], sel[:, 1])
    net.denoise_latent = real
    data, noise = _data(b=B), _noise(9)
    _, loss_j = _jax_generate(jm, variables, data, noise)
    _, loss_t = tm.generate(net, torch.from_numpy(data),
                            noise_override=tuple(map(torch.from_numpy,
                                                     noise)))
    _close(loss_t.numpy(), loss_j)


def test_pretrain_generate_returns_pose_and_none():
    jm, tm, variables, net = _pair('pretrain', seed=9)
    assert tm.model_return_value == 'pose' == jm.model_return_value
    net.eval()
    data = _data(b=B)
    pose_j, none_j = _jax_generate(jm, variables, data)
    pose_t, none_t = tm.generate(net, torch.from_numpy(data))
    assert none_j is None and none_t is None
    assert pose_t.shape == (B, 2, 3, 17)
    np.testing.assert_allclose(pose_t.numpy(), np.asarray(pose_j),
                               rtol=2e-4, atol=2e-5)
    assert tm.fold(net) is None


def test_eval_dtype_bf16_gives_the_float32_result():
    """The JAX latent generate casts nothing, so `eval_dtype` does not
    apply: at bfloat16 the port computes the float32 result bit for bit,
    and it matches JAX's float32 generate."""
    jm, tm, variables, net = _pair('diffusion', seed=9)
    tm16 = build_model(TorchConfig(**_kw('diffusion', extras={
        'eval_dtype': 'bfloat16'})))
    assert tm16.eval_dtype == torch.bfloat16
    net.eval()
    data, noise = _data(b=B), _noise(9)
    args = (net, torch.from_numpy(data))
    nz = tuple(map(torch.from_numpy, noise))
    sel32, loss32 = tm.generate(*args, noise_override=nz)
    sel16, loss16 = tm16.generate(*args, noise_override=nz)
    assert loss16.dtype == sel16.dtype == torch.float32
    assert torch.equal(loss16, loss32) and torch.equal(sel16, sel32)
    _close(loss16.numpy(), _jax_generate(jm, variables, data, noise)[1])


def test_configuration_errors_match_jax():
    for kw in (dict(conditioning_strategy='concat'),
               dict(hidden_sizes=[16, 32])):
        for make in (lambda c: JaxLatent(JaxConfig(**c)),
                     lambda c: build_model(TorchConfig(**c))):
            c = _kw('diffusion')
            c.update(kw)
            with pytest.raises(ValueError):
                make(c)


def _branch_witness(monkeypatch, tm, variables, data, t, eps):
    """(the port's float32 gradients, the float64 gradients on the same
    activation branches, the plain float64 gradients, how many PReLU /
    ReLU inputs plain float64 puts on the other side of 0).  A PReLU or ReLU input within float32 rounding of 0
    can land on either side in float32 and in float64: the gradients
    upstream of it then differ by the two slopes' difference, which is a
    choice of branch, not rounding.  The float64 pass here replays the
    float32 pass's branches; a third pass, plain float64, counts the
    inputs that change side."""
    masks, mode = [], ['record']

    def act(self, x):
        w = self.weight if isinstance(self, nn.PReLU) else x.new_zeros(())
        if mode[0] == 'replay':
            m = masks.pop(0)
        else:
            m = x.detach() > 0
            masks.append(m)
        return torch.where(m, x, w * x)
    monkeypatch.setattr(nn.PReLU, 'forward', act)
    monkeypatch.setattr(nn.ReLU, 'forward', act)

    def grads(dtype):
        n = tm.build_net()
        n.load_state_dict(state_dict_from_jax(variables), strict=True)
        n = n.train().to(dtype)
        loss, _ = tm.loss(n, torch.from_numpy(data).to(dtype),
                          noise_override=(torch.from_numpy(t),
                                          torch.from_numpy(eps).to(dtype)))
        loss.backward()
        return {k: p.grad.double() for k, p in n.named_parameters()
                if p.grad is not None}

    g32 = grads(torch.float32)
    branches = list(masks)
    mode[0] = 'replay'
    g64 = grads(torch.float64)
    mode[0] = 'record'
    masks.clear()
    plain = grads(torch.float64)
    flips = sum(int((a != b).sum()) for a, b in zip(branches, masks))
    return g32, g64, plain, flips


def _grad_excess(got, want):
    """The largest ratio of |got - want| to the bound that
    test_loss_grads_and_stats_match_jax holds each tensor to."""
    g_max = max(float(v.abs().max()) for v in want.values())
    worst = 0.0
    for k, v in want.items():
        err = float((got[k].reshape(v.shape) - v).abs().max())
        bound = (GRAD_REL * g_max if k.endswith(BN_FED_BIASES)
                 else max(GRAD_REL * float(v.abs().max()), GRAD_FLOOR * g_max))
        worst = max(worst, err / bound)
    return worst


@pytest.mark.parametrize('seed', range(1, 10))
@pytest.mark.parametrize('stage', ['pretrain', 'diffusion'])
def test_grads_match_float64_on_the_same_branches(monkeypatch, stage, seed):
    """ROADMAP §C2.  At every seeded_variables seed 1-9 the port's float32
    gradients keep within the loss test's bounds (GRAD_REL, GRAD_FLOOR) of
    float64 taking the same PReLU / ReLU branches (measured on the CPU:
    at most 0.11 of the bound), with at most one activation input that
    plain float64 puts on the other side of 0."""
    jm, tm, variables, _ = _pair(stage, seed=seed)
    key = jax.random.key(11)
    t, eps = _jax_draws(key, B)
    g32, g64, _, flips = _branch_witness(monkeypatch, tm, variables,
                                         _data(), t, eps)
    assert set(g32) == set(g64)
    assert _grad_excess(g32, g64) <= 1.0
    assert flips <= 1


def test_pretrain_gradients_that_cancel_at_seed_3(monkeypatch):
    """ROADMAP §C2.  At seeded_variables seed 3 one PReLU input of the
    pretrain stage's U-Net (in st_gcnnsd1) lies within float32 rounding of
    0, and which side float32 puts it on depends on the order of the
    batch's sums, in either package.  The port's float32 puts it on
    float64's side in both of the test's batch orders: it keeps within
    the loss test's bounds of plain float64, no input changing side.
    JAX's float32 takes the other side with the batch permuted (measured
    on the CPU: its gradients upstream of it then sit 327 times the loss
    test's bound from plain float64, and from the port's).  So at this
    seed the loss test compares branches, not rounding: there the gap
    between the packages is JAX's branch.  (With torch's own BatchNorm
    in the port, before the written-out one of `global_batch_norm`, it was
    the port's float32 that took the other side, in the test's order.)"""
    jm, tm, variables, _ = _pair('pretrain', seed=3)
    key = jax.random.key(11)
    t, eps = _jax_draws(key, B)
    for order in (np.arange(B), np.random.default_rng(2).permutation(B)):
        data = np.ascontiguousarray(_data()[order])
        g32, g64, plain, flips = _branch_witness(monkeypatch, tm, variables,
                                                 data, t, eps)
        assert _grad_excess(g32, g64) <= 1.0 and flips == 0
        assert _grad_excess(g32, plain) <= 1.0
    _, jgrads, _ = _jax_loss(jm, variables, data, key)
    jg = {k: torch.from_numpy(np.asarray(v)).double()
          for k, v in jgrads.items()}
    assert _grad_excess(jg, plain) > 1.0 and _grad_excess(g32, jg) > 1.0


def _gap_table():
    """ROADMAP §C2's table: for each stage, seed 1-9 (and seed 3 with the
    batch permuted), the PReLU / ReLU inputs that change side, and the
    largest gap over the loss test's bound of the port's gradients from
    float64 on its branches and from plain float64, of JAX's from plain
    float64, and of the port's from JAX's."""
    mp = pytest.MonkeyPatch()
    key = jax.random.key(11)
    t, eps = _jax_draws(key, B)
    for stage, seed in [(s, n) for s in ('pretrain', 'diffusion')
                        for n in range(1, 10)]:
        jm, tm, variables, _ = _pair(stage, seed=seed)
        for order in ((0, 2) if (stage, seed) == ('pretrain', 3) else (0,)):
            perm = (np.random.default_rng(order).permutation(B) if order
                    else np.arange(B))
            data = np.ascontiguousarray(_data()[perm])
            g32, g64, plain, flips = _branch_witness(mp, tm, variables, data,
                                                     t, eps)
            mp.undo()
            _, jg, _ = _jax_loss(jm, variables, data, key)
            jg = {k: torch.from_numpy(np.asarray(v)).double()
                  for k, v in jg.items() if k in g32}
            print(f'{stage} seed {seed} order {order}: flips {flips}, '
                  f'port/f64-on-its-branches {_grad_excess(g32, g64):.3f}, '
                  f'port/f64 {_grad_excess(g32, plain):.2f}, '
                  f'jax/f64 {_grad_excess(jg, plain):.2f}, '
                  f'port/jax {_grad_excess(g32, jg):.2f}', flush=True)


if __name__ == '__main__':
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_latent_model.py
    _gap_table()
