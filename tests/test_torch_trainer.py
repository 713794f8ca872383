"""`Trainer.fit` of the port on the CPU: two epochs over a small synthetic
set with the validation AUC each epoch, the metrics log, the top-2
checkpoints against the JAX package's `TopKCheckpointManager` for the same
metric sequence, resume from last.ckpt, and the checkpoints read back by
the port's eval (`restore_and_infer`), the EMA copy included."""

import copy
import json
import os

import numpy as np
import pytest
import torch

from _torch_port import CFG_KW
from mocodad_tpu.training.checkpoint import \
    TopKCheckpointManager as JaxTopK
from mocodad_tpu_torch.config import Config
from mocodad_tpu_torch.data import build_dataset, synthetic
from mocodad_tpu_torch.training.checkpoint import TopKCheckpointManager
from mocodad_tpu_torch.training.inference import restore_and_infer
from mocodad_tpu_torch.training.loop import Trainer
from mocodad_tpu_torch.utils.weights import load_checkpoint_state_dict

torch.set_num_threads(1)
LR = 1e-3


def _cfg(root, name, **kw):
    data = os.path.join(root, 'data')
    return Config(**{**CFG_KW, 'data_dir': data,
                     'ckpt_dir': os.path.join(root, name), 'split': 'train',
                     'validation': True, 'use_hr': False, 'batch_size': 64,
                     'num_transform': 2, 'seed': 0, 'opt_lr': LR,
                     'use_ema': True,
                     'gt_path': os.path.join(data, 'validating',
                                             'test_frame_mask'),
                     'extras': {'log_every_n_steps': 2}, **kw})


def _datasets(cfg):
    os.makedirs(cfg.ckpt_dir, exist_ok=True)
    return (build_dataset(cfg, split='train'),
            build_dataset(cfg, split='validation'))


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Run 'full': 3 epochs.  Run 'resumed': 2 epochs, then a new trainer
    resumed from last.ckpt up to 3."""
    root = str(tmp_path_factory.mktemp('fit'))
    synthetic.generate(os.path.join(root, 'data'), seed=0, n_scenes=1,
                       n_clips_per_split=2, n_actors=2, n_frames=40)
    out = {}
    cfg = _cfg(root, 'full')
    train, val = _datasets(cfg)
    full = Trainer(cfg, device='cpu')
    full.fit(train, val, n_epochs=3)
    out['full'] = (cfg, full, train, val)

    cfg = _cfg(root, 'resumed')
    train, val = _datasets(cfg)
    first = Trainer(cfg, device='cpu')
    first.fit(train, val, n_epochs=2)
    saved = torch.load(os.path.join(cfg.ckpt_dir, 'last.ckpt'),
                       weights_only=False)
    second = Trainer(cfg, device='cpu')
    second.fit(train, val, n_epochs=3, resume='auto')
    out['resumed'] = (cfg, first, second, saved)
    return out


def test_fit_trains_logs_and_validates(runs):
    cfg, trainer, train, _ = runs['full']
    steps = -(-len(train) // cfg.batch_size)
    assert steps >= 3
    h = trainer.history
    assert [e['epoch'] for e in h] == [0, 1, 2]
    assert [e['step'] for e in h] == [steps, 2 * steps, 3 * steps]
    for e in h:
        assert np.isfinite([e['loss'], e['loss_noise'],
                            e['loss_recons']]).all()
        assert 0.0 <= e['AUC'] <= 1.0
        assert e['windows_per_s'] > 0 and e['val_seconds'] > 0
        # the staircase lr at the epoch's end (optax, staircase=True)
        assert e['lr'] == pytest.approx(LR * 0.99 ** (e['epoch'] + 1))
    assert trainer.net.training
    with open(os.path.join(cfg.ckpt_dir, 'metrics.csv')) as f:
        lines = f.read().splitlines()
    assert sum(',epoch_end,' in ln for ln in lines) == 3
    assert any(ln.startswith('0,2,loss_noise=') for ln in lines)


def test_topk_files_follow_jax(runs, tmp_path):
    """The files fit() left behind are those JAX's manager leaves for the
    same AUC sequence."""
    cfg, trainer, _, _ = runs['full']
    jdir = str(tmp_path / 'jax')
    jax_mgr = JaxTopK(jdir, 'AUC', 'max', k=2)
    for e in trainer.history:
        jax_mgr.save({'w': np.zeros(1)}, e['epoch'], e['AUC'])
    ours = sorted(f for f in os.listdir(cfg.ckpt_dir)
                  if 'ckpt' in f or f == 'topk.json')
    assert ours == sorted(os.listdir(jdir))
    for name in ('topk.json', 'best_weights.ckpt.json', 'last.ckpt.json'):
        with open(os.path.join(cfg.ckpt_dir, name)) as a, \
                open(os.path.join(jdir, name)) as b:
            assert json.load(a) == json.load(b), name


@pytest.mark.parametrize('mode', ['max', 'min'])
def test_topk_manager_matches_jax(tmp_path, mode):
    values = [0.5, 0.7, 0.6, 0.8, 0.55, 0.8, 0.2]
    ours = TopKCheckpointManager(str(tmp_path / 'ours'), 'AUC', mode, k=2)
    theirs = JaxTopK(str(tmp_path / 'jax'), 'AUC', mode, k=2)
    for epoch, v in enumerate(values):
        assert os.path.basename(ours.save({'w': torch.zeros(1)}, epoch, v)) \
            == os.path.basename(theirs.save({'w': np.zeros(1)}, epoch, v))
        assert sorted(os.listdir(ours.ckpt_dir)) == \
            sorted(os.listdir(theirs.ckpt_dir))
        assert ours.best == theirs.best
    again = TopKCheckpointManager(ours.ckpt_dir, 'AUC', mode, k=2)
    again.restore_index()
    assert again.entries == ours.entries
    other = TopKCheckpointManager(ours.ckpt_dir, 'loss_noise', mode, k=2)
    other.restore_index()
    assert other.entries == []


def test_resume_continues_with_the_same_state(runs):
    cfg, first, second, saved = runs['resumed']
    assert [e['epoch'] for e in first.history] == [0, 1]
    assert [e['epoch'] for e in second.history] == [2]
    assert second.history[0]['step'] == 3 * first.steps_per_epoch
    # last.ckpt after epoch 1 held the first run's step and Adam state
    opt = saved['optimizer_states'][0]
    assert saved['step'] == first.step
    assert set(opt['state']) == set(first.opt.state_dict()['state'])
    # the resumed run ends where the uninterrupted one does: same draws
    # (seeded per step), same shuffles (seeded per epoch), same Adam state
    _, full, _, _ = runs['full']
    for (k, p), (_, q) in zip(full.net.named_parameters(),
                              second.net.named_parameters()):
        torch.testing.assert_close(q, p, rtol=0, atol=0, msg=k)
    for k in full.ema:
        torch.testing.assert_close(second.ema[k], full.ema[k], rtol=0,
                                   atol=0, msg=k)
    assert second.history[0]['AUC'] == full.history[2]['AUC']


def test_restore_state_sets_the_saved_optimizer_state(runs, tmp_path):
    cfg, first, _, saved = runs['resumed']
    path = str(tmp_path / 'last.ckpt')
    torch.save(saved, path)          # no sidecar: the epoch comes from step
    t = Trainer(cfg, device='cpu')
    t.init_state(first.steps_per_epoch)
    assert t.restore_state(path) == 2
    assert t.step == saved['step']
    got = t.opt.state_dict()
    want = saved['optimizer_states'][0]
    assert got['param_groups'] == want['param_groups']
    for i, st in want['state'].items():
        for k, v in st.items():
            torch.testing.assert_close(got['state'][i][k], v, rtol=0, atol=0)


def test_checkpoints_load_into_the_eval(runs):
    cfg, trainer, _, _ = runs['full']
    raw = torch.load(os.path.join(cfg.ckpt_dir, 'best_weights.ckpt'),
                     weights_only=False)
    assert set(raw) == {'state_dict', 'state_dict_ema', 'optimizer_states',
                        'step'}
    ecfg = copy.deepcopy(cfg)
    ecfg.split, ecfg.load_ckpt = 'test', 'best_weights.ckpt'
    ecfg.gt_path = os.path.join(cfg.data_dir, 'testing', 'test_frame_mask')
    for use_ema in (False, True):
        ecfg.use_ema = use_ema
        model, ds, res = restore_and_infer(ecfg, device='cpu')
        assert res['loss'].shape == (len(ds),)
        assert np.isfinite(res['loss']).all()
    # the EMA payload is the EMA parameters with the live BN statistics
    sd = load_checkpoint_state_dict(os.path.join(cfg.ckpt_dir, 'last.ckpt'),
                                    use_ema=True)
    live = trainer.net.state_dict()
    for k, v in sd.items():
        want = trainer.ema[k] if k in trainer.ema else live[k]
        torch.testing.assert_close(v, want, rtol=0, atol=0, msg=k)
    assert any(not torch.equal(trainer.ema[k], p)
               for k, p in trainer.net.named_parameters())
