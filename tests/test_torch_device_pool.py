"""The window pool and K train steps per dispatch in the port, against its
host-batch path and against the JAX package (the counterparts of
tests/test_training.py:195-290 and tests/test_return_value.py:235-265).

With `device_data: true` the training windows sit on the device and each
step gets only its rows' indices, views and mask; the fit must follow the
host-batch trajectory (same shuffles, same per-step seeds, the same
gathered windows), at one rank and at two gloo ranks.  With
`steps_per_dispatch: 4` over 10 batches an epoch (2 groups of 4, then 2
steps one by one) the fit must equal K = 1's; on the CPU a group is K
steps in a loop (on the card one CUDA graph replay:
tests/test_torch_step_graph_gpu.py), and a K = 4 fit resumed after its
first epoch must end where the uninterrupted one does.  The
`device_data` and `steps_per_dispatch` rules and their errors are held
against the JAX Trainer's on the same cases.
`run_inference` with the pool must give the host batches' results, reuse
its pool for the same dataset and evict it for another.  Last, the port's
pool / K = 4 fit against the JAX Trainer's pool / K = 4 fit from the same
weights with the same per-step noise.
"""

import os

import jax
import numpy as np
import pytest
import torch

from _torch_dist import fit_run, run_ranks
from _torch_port import CFG_KW, seeded_variables
from mocodad_tpu.config import Config as JaxConfig
from mocodad_tpu.data import make_loader as jax_make_loader
from mocodad_tpu.data.pipeline import PoseWindows as JaxWindows
from mocodad_tpu.diffusion import sample_timesteps as jax_timesteps
from mocodad_tpu.parallel import make_mesh as jax_mesh
from mocodad_tpu.training.loop import Trainer as JaxTrainer
from mocodad_tpu_torch.config import Config
from mocodad_tpu_torch.data import PoseWindows, make_loader
from mocodad_tpu_torch.models.mocodad import build_model
from mocodad_tpu_torch.parallel.mesh import Mesh
from mocodad_tpu_torch.training.inference import (PoolCache, run_inference,
                                                  use_device_pool)
from mocodad_tpu_torch.training.loop import Trainer
from mocodad_tpu_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(1)
# the pool gathers the very windows a host batch carries, and K steps in a
# loop are K steps: the JAX package holds both to 1e-6
POOL_TOL = 1e-6
LOSS_RTOL = 1e-5        # as tests/test_torch_train_step.py
# the port's fit against JAX's over 2 epochs of 5 steps.  Adam's first
# steps are about lr x sign(g): on these windows some elements of the
# graph mixes and 1x1 convs have gradients at float32 rounding level, and
# the two packages step them in opposite directions from step 1 on (the
# same on host batches; step 2's loss lands 1.5e-4 apart), and the steps
# after carry it: the logged steps and epoch means land up to 8.5e-4 to
# 1.0e-3 apart, whichever float32 BatchNorm the port takes (torch's
# `batch_norm`, the normalization written out in tensor ops, or its
# closed-form backward).  So they are held within 2e-3 (a wrong draw or
# window moves a loss by percents), and the parameters as chip_smoke.py's
# train_agree holds them: no element further apart than the steps can
# move it each way (1.1 lr a step).  The flipped elements then keep
# stepping apart, so the mean |diff| over every parameter but the
# BatchNorm-fed biases, which train_agree holds within 2 % of a step after
# 3 steps, is held within 10 % of a step after these 10 (measured 6.0e-5)
FIT_RTOL = 2e-3
TRAIN_STEP_MAX, TRAIN_PARAM_MEAN = 1.1, 1e-4
BN_FED_BIASES = ('tcn.0.bias', 'residual.0.bias', 'block.0.bias')


def _windows(n, seed, num_transform=2, old_aug=False, cls=PoseWindows):
    rng = np.random.default_rng(seed)
    return cls(data=rng.normal(size=(n, 2, 6, 17)).astype(np.float32) * 0.1,
               meta=np.stack([np.zeros(n), np.zeros(n), np.arange(n),
                              np.arange(n)], 1).astype(np.int64),
               frames=np.tile(np.arange(1, 7, dtype=np.int32), (n, 1)),
               num_transform=num_transform, old_aug=old_aug)


def _kw(tmp, name, **extras):
    return dict(CFG_KW, batch_size=32, num_transform=2, opt_lr=1e-3, seed=0,
                use_ema=True, validation=False,
                ckpt_dir=os.path.join(str(tmp), name),
                extras={'log_every_n_steps': 2, **extras})


def _fit(tmp, name, ds, n_epochs=2, **extras):
    kw = _kw(tmp, name, **extras)
    os.makedirs(kw['ckpt_dir'], exist_ok=True)
    trainer = Trainer(Config(**kw), device='cpu')
    trainer.fit(ds, None, n_epochs=n_epochs)
    return trainer


def _params(trainer):
    return {k: p.detach().clone() for k, p in trainer.net.named_parameters()}


def _assert_close(a, b, tol=POOL_TOL):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=tol,
                                   atol=tol, err_msg=k)


def test_make_loader_yields_jax_indices():
    """Index-only batches: JAX's keys, dtypes and values, the rows the data
    path would gather, and the padding that wraps the shuffled order."""
    ds = _windows(45, 0, num_transform=3)
    jds = _windows(45, 0, num_transform=3, cls=JaxWindows)
    ours = list(make_loader(ds, 32, shuffle=True, seed=4,
                            yield_indices=True))
    theirs = list(jax_make_loader(jds, 32, shuffle=True, seed=4,
                                  yield_indices=True))
    data = list(make_loader(ds, 32, shuffle=True, seed=4))
    assert len(ours) == len(theirs) == len(data) == 5
    for a, b, d in zip(ours, theirs, data):
        assert set(a) == set(b) == {'idx', 'trans', 'mask'}
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert (a['idx'].dtype, a['trans'].dtype, a['mask'].dtype) == \
            (np.int32, np.int32, np.float32)
        np.testing.assert_array_equal(ds.data[a['idx']], d['data'])
        np.testing.assert_array_equal(a['trans'], d['trans'])
    assert ours[-1]['mask'].sum() == 135 - 4 * 32


def test_make_loader_refuses_indices_with_old_aug():
    ds = _windows(8, 0, num_transform=0, old_aug=True)
    jds = _windows(8, 0, num_transform=0, old_aug=True, cls=JaxWindows)
    with pytest.raises(ValueError):
        next(jax_make_loader(jds, 4, yield_indices=True))
    with pytest.raises(ValueError, match='old_aug'):
        next(make_loader(ds, 4, yield_indices=True))


# (device_data, device_data_cap_gb, old_aug) -> what both Trainers decide
POOL_CASES = [
    ('auto', None, False), ('auto', 1e-9, False), (True, None, False),
    ('true', None, False), ('on', None, False), (False, None, False),
    ('off', None, False), ('0', None, False), ('auto', None, True),
    (False, None, True), (True, None, True), ('ture', None, True),
    ('sometimes', None, False)]


def _outcome(fn):
    try:
        return fn()
    except ValueError:
        return ValueError


@pytest.mark.parametrize('mode,cap,old_aug', POOL_CASES)
def test_device_data_rules_match_jax(tmp_path, mode, cap, old_aug):
    extras = {'device_data': mode}
    if cap is not None:
        extras['device_data_cap_gb'] = cap
    n_trans = 0 if old_aug else 2
    jt = JaxTrainer(JaxConfig(**_kw(tmp_path, 'j', **extras)),
                    mesh=jax_mesh(1))
    want = _outcome(lambda: jt._use_device_pool(_windows(
        8, 0, n_trans, old_aug, JaxWindows)))
    t = Trainer(Config(**_kw(tmp_path, 't', **extras)), device='cpu')
    got = _outcome(lambda: t._use_device_pool(_windows(8, 0, n_trans,
                                                       old_aug)))
    assert got == want


# (steps_per_dispatch, pool mode) -> what both Trainers decide on one rank
DISPATCH_CASES = [('auto', True), ('auto', False), (1, False), (4, True),
                  ('4', True), (0, True), (-2, True), (4, False)]


@pytest.mark.parametrize('value,pool', DISPATCH_CASES)
def test_steps_per_dispatch_rules_match_jax(tmp_path, value, pool):
    extras = {'steps_per_dispatch': value}
    jt = JaxTrainer(JaxConfig(**_kw(tmp_path, 'j', **extras)),
                    mesh=jax_mesh(1))
    t = Trainer(Config(**_kw(tmp_path, 't', **extras)), device='cpu')
    want = _outcome(lambda: jt.steps_per_dispatch(pool))
    assert _outcome(lambda: t.steps_per_dispatch(pool)) == want
    if value == 'auto':
        assert want == (8 if pool else 1)


def test_steps_per_dispatch_is_single_process(tmp_path):
    """On a mesh of two ranks 'auto' is 1, and K > 1 raises (the JAX rule
    on several processes, loop.py:205-210)."""
    two = Mesh(world=2, rank=0, device=torch.device('cpu'))
    t = Trainer(Config(**_kw(tmp_path, 'a')), mesh=two)
    assert t.steps_per_dispatch(True) == 1
    t = Trainer(Config(**_kw(tmp_path, 'b', steps_per_dispatch=4)), mesh=two)
    with pytest.raises(ValueError, match='single-process only'):
        t.steps_per_dispatch(True)


def test_use_device_pool_cap():
    ds = _windows(10, 0)
    assert use_device_pool(ds, 'auto', ds.data.nbytes / 1e9)
    assert not use_device_pool(ds, 'auto', 0.99 * ds.data.nbytes / 1e9)
    assert use_device_pool(ds, 'yes', 0.0)


@pytest.fixture(scope='module')
def fits(tmp_path_factory):
    """Host batches, the pool at K = 1, and the pool at K = 4 over 160
    windows x 2 views (10 batches of 32 an epoch), 2 epochs each."""
    tmp = tmp_path_factory.mktemp('pool_fits')
    ds = _windows(160, 3)
    return {name: _fit(tmp, name, ds, **extras) for name, extras in (
        ('host', {'device_data': False}),
        ('pool', {'device_data': True, 'steps_per_dispatch': 1}),
        ('k4', {'device_data': True, 'steps_per_dispatch': 4}))}


def test_pool_fit_matches_host_batches(fits):
    host, pool = fits['host'], fits['pool']
    assert host.step == pool.step == 20
    _assert_close(_params(pool), _params(host))
    for a, b in zip(pool.history, host.history):
        for k in ('loss', 'loss_noise', 'loss_recons'):
            np.testing.assert_allclose(a[k], b[k], rtol=POOL_TOL, err_msg=k)
    assert pool.pool is None and pool.graph_captures == 0


def test_k4_fit_matches_k1(fits):
    """2 groups of 4 and 2 single steps an epoch: the same 20 steps."""
    one, four = fits['pool'], fits['k4']
    assert one.step == four.step == 20
    _assert_close(_params(four), _params(one))
    for a, b in zip(four.history, one.history):
        for k in ('loss', 'loss_noise', 'loss_recons', 'lr'):
            np.testing.assert_allclose(a[k], b[k], rtol=POOL_TOL, err_msg=k)
        assert a['graph_replays'] == 0       # on the CPU: steps in a loop
    # a logged line is the dispatch's last step (JAX loop.py:568-576):
    # after the groups end at steps 4 and 8, then steps 9 and 10
    with open(os.path.join(four.cfg.ckpt_dir, 'metrics.csv')) as f:
        logged = [ln.split(',')[1] for ln in f.read().splitlines()
                  if ln.startswith('0,') and 'epoch_end' not in ln]
    assert logged == ['4', '8', '10']


def test_k4_fit_resumes_where_it_stopped(fits, tmp_path):
    """One epoch at K = 4, then a new trainer resumed from last.ckpt for
    the second: the uninterrupted K = 4 run's parameters and Adam state,
    bit for bit (the step counts and the learning rate are restored for
    the groups to draw and step as before)."""
    ds = _windows(160, 3)
    extras = {'device_data': True, 'steps_per_dispatch': 4}
    _fit(tmp_path, 'resumed', ds, n_epochs=1, **extras)
    kw = _kw(tmp_path, 'resumed', **extras)
    second = Trainer(Config(**kw), device='cpu')
    second.fit(ds, None, n_epochs=2, resume='auto')
    full = fits['k4']
    assert second.step == full.step == 20
    _assert_close(_params(second), _params(full), 0)
    a, b = second.opt.state_dict(), full.opt.state_dict()
    assert a['param_groups'][0]['lr'] == b['param_groups'][0]['lr']
    for i, state in b['state'].items():
        for k, v in state.items():
            torch.testing.assert_close(a['state'][i][k], v, rtol=0, atol=0)


def test_pool_fit_on_two_ranks(tmp_path):
    """At W = 2 over gloo every rank holds the whole pool and takes its
    half of each batch's indices: the pool fit equals the host-batch fit
    of the same two ranks."""
    ds = _windows(27, 8)
    arrays = {k: getattr(ds, k) for k in ('data', 'meta', 'frames')}
    kw = dict(CFG_KW, batch_size=16, num_transform=2, opt_lr=1e-3,
              validation=False, seed=2, extras={'log_every_n_steps': 1})
    inputs = {'arrays': arrays, 'kw': {
        name: dict(kw, ckpt_dir=str(tmp_path / f'{name}{{r}}'),
                   extras=dict(kw['extras'], device_data=name == 'pool'))
        for name in ('host', 'pool')}}
    body = '''
from _torch_dist import fit_run
for name, kw in INPUTS['kw'].items():
    kw = dict(kw, ckpt_dir=kw['ckpt_dir'].format(r=RANK))
    OUT[name] = fit_run(kw, INPUTS['arrays'], 2, mesh)
'''
    ranks = run_ranks(tmp_path / 'work', body, inputs)
    for r in ranks:
        _assert_close(r['pool']['params'], r['host']['params'])
        timing = ('train_seconds', 'windows_per_s', 'val_seconds')
        for a, b in zip(r['pool']['history'], r['host']['history']):
            for k in ('loss', 'loss_noise', 'loss_recons'):
                np.testing.assert_allclose(a[k], b[k], rtol=POOL_TOL)
            assert {k for k in a if k not in timing} == \
                {k for k in b if k not in timing}
    _assert_close(ranks[0]['pool']['params'], ranks[1]['pool']['params'], 0)
    one = fit_run(dict(inputs['kw']['pool'],
                       ckpt_dir=str(tmp_path / 'one')), arrays, 2)
    assert [h['step'] for h in one['history']] == \
        [h['step'] for h in ranks[0]['pool']['history']] == [4, 8]


def _eval_setup(num_transform=2):
    cfg = Config(**dict(CFG_KW, num_transform=num_transform,
                        model_return_value='pose'))
    model = build_model(cfg)
    torch.manual_seed(3)
    net = model.build_net().eval()
    return model, net


def test_eval_pool_matches_host_batches():
    """`run_inference` with the pool: the host batches' losses, poses,
    views, meta and frames (both draw from the same seeded generator), on
    the loss route too; the cache reuses the pool for the same dataset
    and evicts it for another."""
    model, net = _eval_setup()
    ds = _windows(40, 5)
    dev = torch.device('cpu')
    host = run_inference(model, net, ds, 32, 4, dev, device_data=False)
    cache = PoolCache()
    pool = run_inference(model, net, ds, 32, 4, dev, device_data=True,
                         pools=cache)
    assert pool['loss'].shape == (80,) and pool['pose'] is not None
    for k in ('loss', 'pose'):
        np.testing.assert_allclose(pool[k], host[k], rtol=POOL_TOL,
                                   atol=POOL_TOL, err_msg=k)
    for k in ('trans', 'meta', 'frames'):
        np.testing.assert_array_equal(pool[k], host[k], err_msg=k)
    first = cache.get(ds.data, dev)
    loss_only = run_inference(model, net, ds, 32, 4, dev, with_pose=False,
                              pools=cache)
    assert cache.uploads == 1 and cache.get(ds.data, dev) is first
    np.testing.assert_array_equal(loss_only['loss'], pool['loss'])
    assert loss_only['pose'] is None
    other = _windows(40, 5)                 # equal values, a new buffer
    run_inference(model, net, other, 32, 4, dev, pools=cache)
    assert cache.uploads == 2 and cache.get(other.data, dev) is not first
    assert cache.get(other.data, dev) is cache.get(other.data, dev)


def test_eval_pool_refused_with_old_aug():
    model, net = _eval_setup(num_transform=0)
    ds = _windows(8, 5, num_transform=0, old_aug=True)
    with pytest.raises(ValueError, match='old_aug'):
        run_inference(model, net, ds, 4, 0, torch.device('cpu'),
                      device_data=True)
    r = run_inference(model, net, ds, 4, 0, torch.device('cpu'))
    assert r['loss'].shape == (8,)


def _jax_noise(seed, step, rows):
    """The (t, eps) the JAX train step at `step` draws in `model.loss`
    (fold_in(key(seed), step), split in 4: order, t, noise, dropout)."""
    _, r_t, r_noise, _ = jax.random.split(
        jax.random.fold_in(jax.random.key(seed), step), 4)
    return (torch.from_numpy(np.array(jax_timesteps(r_t, rows, 10))).long(),
            torch.from_numpy(np.array(jax.random.normal(
                r_noise, (rows, 2, 3, 17)))))


def test_pool_k4_fit_matches_jax(tmp_path):
    """The port's pool / K = 4 fit against the JAX Trainer's pool / K = 4
    fit: the same seeded weights, shuffles and per-step noise, 2 epochs of
    5 steps (a group of 4 and one step)."""
    ds, jds = _windows(160, 6), _windows(160, 6, cls=JaxWindows)
    extras = {'device_data': True, 'steps_per_dispatch': 4,
              'log_every_n_steps': 1}
    kw = dict(_kw(tmp_path, 'jax', **extras), batch_size=64)
    jt = JaxTrainer(JaxConfig(**kw), mesh=jax_mesh(1))
    variables = seeded_variables(jt.model, seed=3)
    jt.model.init_variables = lambda rng: jax.tree_util.tree_map(
        jax.numpy.asarray, variables)
    os.makedirs(kw['ckpt_dir'])
    state = jt.fit(jds, n_epochs=2)

    kw = dict(_kw(tmp_path, 'torch', **extras), batch_size=64)
    os.makedirs(kw['ckpt_dir'])
    trainer = Trainer(Config(**kw), device='cpu',
                      noise_fn=lambda step, rows: _jax_noise(0, step, rows))
    build = trainer.model.build_net

    def seeded_net():
        net = build()
        net.load_state_dict(state_dict_from_jax(variables), strict=True)
        return net
    trainer.model.build_net = seeded_net
    trainer.fit(ds, None, n_epochs=2)
    assert int(state.step) == trainer.step == 10

    def lines(cfg):
        with open(os.path.join(cfg.ckpt_dir, 'metrics.csv')) as f:
            return [(ln.split(',')[1], dict(x.split('=') for x in
                                            ln.split(',')[2:]))
                    for ln in f.read().splitlines()]
    ours, theirs = lines(trainer.cfg), lines(jt.cfg)
    # both log a group's last step (4, then the tail's 5; 9, 10)
    assert [s for s, _ in ours] == [s for s, _ in theirs] == \
        ['4', '5', 'epoch_end', '9', '10', 'epoch_end']
    for (_, a), (_, b) in zip(ours, theirs):
        for k in ('loss', 'loss_noise', 'loss_recons'):
            np.testing.assert_allclose(float(a[k]), float(b[k]),
                                       rtol=FIT_RTOL, err_msg=k)
    want = state_dict_from_jax({'params': jax.device_get(state.params)})
    lr, steps = 1e-3, 10
    kept = []
    for k, p in trainer.net.named_parameters():
        d = (p.detach() - want[k].reshape(p.shape)).abs()
        assert float(d.max()) <= 2 * steps * TRAIN_STEP_MAX * lr, k
        if not k.endswith(BN_FED_BIASES):
            kept.append(d.reshape(-1))
    assert float(torch.cat(kept).mean()) <= TRAIN_PARAM_MEAN
