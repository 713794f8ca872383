"""Training on two ranks (two CPU processes over gloo) computes what one
process computes, and what the JAX package computes on the global batch.

One train step at W = 2 against JAX `jax.grad(model.loss)` on the same
global batch of B = 16 (`seeded_variables` of `CFG_KW`, NumPy (t, eps)),
with a sample mask whose zeros all fall on rank 1: the loss and metrics,
every gradient (summed over the ranks) and the BatchNorm running
statistics (global, the same on both ranks).  Then three Adam steps with
the EMA, bit-equal across the ranks and within tolerance of W = 1; one
step of each latent stage at W = 2 against W = 1; and `Trainer.fit` at
W = 2, where rank 0 alone writes the checkpoints and the log.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

from _torch_dist import adam_steps, fit_run, one_step, run_ranks
from _torch_port import CFG_KW, jax_model, seeded_variables
from mocodad_tpu_torch.nn.stsgcn import FlaxBatchNorm2d
from mocodad_tpu_torch.utils.weights import state_dict_from_jax

B = 16
LOSS_RTOL = 1e-5
GRAD_REL, GRAD_FLOOR = 1e-4, 1e-6   # as tests/test_torch_train_step.py
STATS_TOL = 1e-6
BN_FED_BIASES = ('tcn.0.bias', 'residual.0.bias', 'block.0.bias')
# three Adam steps at W = 2 against W = 1 (the gradients differ only in
# float32 summation order): as tests/test_torch_train_step.py holds the
# port against JAX, per tensor max |diff| within 20 % of one step and mean
# |diff| within 0.1 % of one step, the BatchNorm-fed biases (true gradient
# 0, steps on rounding noise) within the most three steps can move apart
ADAM_MAX_TOL, ADAM_MEAN_TOL = 2e-4, 1e-6
LR, STEPS = 1e-3, 3
FIT_RTOL = 1e-3
LATENT_KW = dict(diffusion_on_latent=True, latent_embedding_dim=16,
                 hidden_sizes=[16, 32, 16], seed=4)
MASK_ZEROS = [9, 12, 15]    # all on rank 1 (rows 8-15)

_BODY = '''
from _torch_dist import adam_steps, fit_run, one_step
OUT['step'] = one_step(INPUTS['kw'], INPUTS['sd'], INPUTS['data'],
                       INPUTS['mask'], INPUTS['noise'], mesh)
OUT['adam'] = adam_steps(INPUTS['adam_kw'], INPUTS['sd'], INPUTS['batches'],
                         mesh)
OUT['latent'] = {stage: one_step(kw, sd, INPUTS['data'], INPUTS['mask'],
                                 noise, mesh)
                 for stage, (kw, sd, noise) in INPUTS['latent'].items()}
OUT['fit'] = fit_run(INPUTS['fit_kw'], INPUTS['fit_arrays'], 2, mesh)
'''


def _latent_case(stage, rng):
    from mocodad_tpu_torch.config import Config
    from mocodad_tpu_torch.models.mocodad import build_model
    kw = dict(CFG_KW, stage=stage, **LATENT_KW)
    torch.manual_seed(11)
    sd = build_model(Config(**kw)).build_net().state_dict()
    noise = (rng.integers(1, CFG_KW['noise_steps'], B).astype(np.int64),
             rng.standard_normal((B, 16)).astype(np.float32))
    return kw, sd, noise


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp('dist_train')
    jm = jax_model()
    variables = seeded_variables(jm, seed=3)
    rng = np.random.default_rng(5)
    data = rng.standard_normal((B, 2, 6, 17)).astype(np.float32)
    t = rng.integers(1, CFG_KW['noise_steps'], B).astype(np.int32)
    eps = rng.standard_normal((B, 2, 3, 17)).astype(np.float32)
    mask = np.ones(B, np.float32)
    mask[MASK_ZEROS] = 0.0
    batches = []
    for k in range(STEPS):
        r = np.random.default_rng(20 + k)
        batches.append((
            r.standard_normal((B, 2, 6, 17)).astype(np.float32),
            r.integers(0, 5, B).astype(np.int32),
            (np.arange(B) != 13 - k).astype(np.float32),
            (r.integers(1, CFG_KW['noise_steps'], B).astype(np.int64),
             r.standard_normal((B, 2, 3, 17)).astype(np.float32))))
    fr = np.random.default_rng(8)
    n = 27   # 2 views -> 54 window-views: 4 batches of 16, the last padded
    fit_arrays = {
        'data': fr.standard_normal((n, 2, 6, 17)).astype(np.float32),
        'meta': np.stack([np.zeros(n), np.zeros(n), np.arange(n),
                          np.arange(n)], 1).astype(np.int64),
        'frames': np.tile(np.arange(6, dtype=np.int32), (n, 1))}
    inputs = {
        'kw': dict(CFG_KW), 'sd': state_dict_from_jax(variables),
        'data': data, 'mask': mask, 'noise': (t.astype(np.int64), eps),
        'adam_kw': dict(CFG_KW, opt_lr=LR, use_ema=True, num_transform=5),
        'batches': batches,
        'latent': {s: _latent_case(s, rng) for s in ('pretrain',
                                                      'diffusion')},
        'fit_kw': dict(CFG_KW, batch_size=B, num_transform=2, opt_lr=LR,
                       validation=False, seed=2,
                       ckpt_dir=str(root / 'fit2'),
                       extras={'log_every_n_steps': 1})}
    inputs['fit_arrays'] = fit_arrays
    ranks = run_ranks(root / 'work', _BODY, inputs)
    one = {'adam': adam_steps(inputs['adam_kw'], inputs['sd'], batches),
           'latent': {s: one_step(kw, sd, data, mask, noise)
                      for s, (kw, sd, noise) in inputs['latent'].items()},
           'fit': fit_run(dict(inputs['fit_kw'],
                               ckpt_dir=str(root / 'fit1')), fit_arrays, 2)}
    return jm, variables, inputs, ranks, one, root


def _jax_step(jm, variables, data, t, eps, mask):
    def f(params):
        loss, metrics, mutated = jm.loss(
            {'params': params, 'batch_stats': variables['batch_stats']},
            data, jax.random.key(0), train=True, sample_mask=mask,
            noise_override=(t, eps))
        return loss, (metrics, mutated)
    grads, (metrics, mutated) = jax.jit(jax.grad(f, has_aux=True))(
        variables['params'])
    g = state_dict_from_jax({'params': jax.device_get(grads)})
    stats = state_dict_from_jax({'params': variables['params'],
                                 'batch_stats': jax.device_get(
                                     mutated['batch_stats'])})
    stats = {k: v for k, v in stats.items()
             if k.endswith(('running_mean', 'running_var'))}
    return {k: float(v) for k, v in metrics.items()}, g, stats


def _assert_equal_across_ranks(ranks, key):
    a, b = (r[key] for r in ranks)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_step_matches_jax_on_the_global_batch(runs):
    jm, variables, inputs, ranks, _, _ = runs
    t, eps = inputs['noise']
    jmet, jgrads, jstats = _jax_step(jm, variables, inputs['data'], t, eps,
                                     inputs['mask'])
    steps = [r['step'] for r in ranks]
    # each rank's loss is its share of the global loss; the metrics are
    # the global values on both ranks
    np.testing.assert_allclose(sum(s['loss'] for s in steps), jmet['loss'],
                               rtol=LOSS_RTOL)
    for s in steps:
        assert set(s['metrics']) == set(jmet)
        for k, v in jmet.items():
            np.testing.assert_allclose(s['metrics'][k], v, rtol=LOSS_RTOL,
                                       err_msg=k)
    # rank 1 holds every masked row: its share is smaller than rank 0's
    assert steps[1]['loss'] < steps[0]['loss']
    _assert_equal_across_ranks(steps, 'grads')
    _assert_equal_across_ranks(steps, 'stats')
    grads = steps[0]['grads']
    assert set(grads) == set(jgrads)
    g_max = max(float(g.abs().max()) for g in jgrads.values())
    for k, want in jgrads.items():
        got = grads[k]
        err = float((got - want.reshape(got.shape)).abs().max())
        if k.endswith(BN_FED_BIASES):
            assert max(float(got.abs().max()), err) <= GRAD_REL * g_max, k
            continue
        assert err <= max(GRAD_REL * float(want.abs().max()),
                          GRAD_FLOOR * g_max), (k, err)
    stats = steps[0]['stats']
    assert set(jstats) == set(stats)
    for k, want in jstats.items():
        assert float((stats[k] - want).abs().max()) <= STATS_TOL, k


def test_one_rank_statistics_would_differ(runs):
    """The same step with each rank normalizing by its own rows (no
    `sync_batch_norms`): the running statistics leave JAX's global ones,
    which is what the global BatchNorm fixes."""
    from mocodad_tpu_torch.config import Config
    from mocodad_tpu_torch.models.mocodad import build_model
    jm, variables, inputs, ranks, _, _ = runs
    t, eps = inputs['noise']
    _, _, jstats = _jax_step(jm, variables, inputs['data'], t, eps,
                             inputs['mask'])
    model = build_model(Config(**inputs['kw']))
    net = model.build_net()
    net.load_state_dict(inputs['sd'])
    net.train()
    assert all(m.mesh is None for m in net.modules()
               if isinstance(m, FlaxBatchNorm2d))
    model.loss(net, torch.from_numpy(inputs['data'][:B // 2]),
               noise_override=(torch.from_numpy(t[:B // 2]),
                               torch.from_numpy(eps[:B // 2])))
    buffers = dict(net.named_buffers())
    err = max(float((buffers[k] - v).abs().max()) for k, v in jstats.items())
    assert err > 100 * STATS_TOL, err


def test_three_adam_steps_agree_across_ranks_and_with_one(runs):
    _, _, _, ranks, one, _ = runs
    adam = [r['adam'] for r in ranks]
    for key in ('params', 'ema', 'buffers'):
        _assert_equal_across_ranks(adam, key)
    assert adam[0]['metrics'] == adam[1]['metrics']
    for got, want in zip(adam[0]['metrics'], one['adam']['metrics']):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                       err_msg=k)
    for k, want in one['adam']['params'].items():
        d = (adam[0]['params'][k] - want).abs()
        if k.endswith(BN_FED_BIASES):
            assert float(d.max()) <= 2 * STEPS * LR, k
            continue
        assert float(d.max()) <= ADAM_MAX_TOL, (k, float(d.max()))
        assert float(d.mean()) <= ADAM_MEAN_TOL, (k, float(d.mean()))
    for k, want in one['adam']['buffers'].items():
        if 'running' in k and not k.endswith('num_batches_tracked'):
            got = adam[0]['buffers'][k]
            # the statistics of the BatchNorms behind the noise-driven
            # biases inherit their noise (as tests/test_torch_train_step.py)
            assert float((got - want).abs().max()) <= 2 * STEPS * LR, k


@pytest.mark.parametrize('stage', ['pretrain', 'diffusion'])
def test_latent_stage_step_matches_one_rank(runs, stage):
    _, _, _, ranks, one, _ = runs
    steps = [r['latent'][stage] for r in ranks]
    want = one['latent'][stage]
    _assert_equal_across_ranks(steps, 'grads')
    _assert_equal_across_ranks(steps, 'stats')
    np.testing.assert_allclose(sum(s['loss'] for s in steps), want['loss'],
                               rtol=LOSS_RTOL)
    for k, v in want['metrics'].items():
        np.testing.assert_allclose(steps[0]['metrics'][k], v,
                                   rtol=LOSS_RTOL, err_msg=k)
    grads = steps[0]['grads']
    assert set(grads) == set(want['grads'])
    if stage == 'diffusion':
        assert all(k.startswith('denoiser.') for k in grads)
    g_max = max(float(g.abs().max()) for g in want['grads'].values())
    for k, w in want['grads'].items():
        err = float((grads[k] - w).abs().max())
        assert err <= max(GRAD_REL * float(w.abs().max()),
                          GRAD_FLOOR * g_max), (k, err)
    for k, w in want['stats'].items():
        assert float((steps[0]['stats'][k] - w).abs().max()) <= STATS_TOL, k


def _names(files):
    """File names without the monitored value Lightning-style names carry
    (the two runs' epoch means agree to LOSS_RTOL, not to 6 digits)."""
    return sorted(re.sub(r'=[-0-9.e]+(\.ckpt)', r'\1', f) for f in files)


def test_fit_rank0_alone_writes(runs):
    _, _, inputs, ranks, one, root = runs
    fits = [r['fit'] for r in ranks]
    assert fits[0]['writes'] and not fits[1]['writes']
    assert _names(fits[0]['writes']) == _names(one['fit']['writes'])
    assert _names(os.listdir(root / 'fit2')) == \
        _names(os.listdir(root / 'fit1'))
    with open(root / 'fit2' / 'metrics.csv') as f:
        lines = f.read().splitlines()
    with open(root / 'fit1' / 'metrics.csv') as f:
        assert len(lines) == len(f.read().splitlines())
    assert sum(',epoch_end,' in x for x in lines) == 2
    # 8 Adam steps carry the summation-order differences of each step
    # forward (a step near a zero gradient can take the other sign), so
    # the epoch means are held loosely (measured 6.5e-5 relative); the
    # three-step test above holds the steps themselves
    for got, want in zip(fits[0]['history'], one['fit']['history']):
        assert got['step'] == want['step'] == 4 * (got['epoch'] + 1)
        for k in ('loss', 'loss_noise', 'loss_recons'):
            np.testing.assert_allclose(got[k], want[k], rtol=FIT_RTOL,
                                       err_msg=k)
    timing = ('train_seconds', 'windows_per_s', 'val_seconds')
    assert [{k: v for k, v in h.items() if k not in timing}
            for h in fits[0]['history']] == \
        [{k: v for k, v in h.items() if k not in timing}
         for h in fits[1]['history']]
    _assert_equal_across_ranks(fits, 'params')
