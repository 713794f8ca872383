"""The JAX Trainer's last keys in the port: `use_wandb` / `log_model`,
`profile_dir` and `debug_nans` (mocodad_tpu/training/loop.py:85-100,
:527-528, :604-629; the counterparts of tests/test_training.py:293-350).

wandb is not installed: the mirror is driven through a stub module in
`sys.modules` (init, one log per epoch with its step, the last.ckpt
artifact after each save), and the disabled branch through an import
that fails.  `profile_dir` must leave a torch.profiler trace of the first
epoch with the epoch's range in it.  `debug_nans` must raise
`FloatingPointError` on a batch with a NaN, naming the step, in the port
at one step per dispatch and inside a group of 4, and the JAX Trainer
must raise the same error class on the same windows.  Last, the train CLI
on two ranks refuses several steps per dispatch in the JAX package's
words.
"""

import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch
import yaml

from _torch_dist import REPO, communicate, env
from _torch_port import CFG_KW
from mocodad_tpu.config import Config as JaxConfig
from mocodad_tpu.data.pipeline import PoseWindows as JaxWindows
from mocodad_tpu.parallel import make_mesh as jax_mesh
from mocodad_tpu.training.loop import Trainer as JaxTrainer
from mocodad_tpu_torch.config import Config
from mocodad_tpu_torch.data import PoseWindows, make_loader
from mocodad_tpu_torch.training.loop import EPOCH_SPAN, Trainer

torch.set_num_threads(1)


def _windows(n, seed=4, cls=PoseWindows, num_transform=1):
    rng = np.random.default_rng(seed)
    return cls(data=rng.normal(size=(n, 2, 6, 17)).astype(np.float32) * 0.1,
               meta=np.zeros((n, 4), np.int64),
               frames=np.tile(np.arange(1, 7, dtype=np.int32), (n, 1)),
               num_transform=num_transform)


def _kw(tmp, **kw):
    extras = kw.pop('extras', {})
    return dict(CFG_KW, batch_size=16, num_transform=1, opt_lr=1e-3, seed=0,
                validation=False, ckpt_dir=str(tmp),
                extras={'log_every_n_steps': 2, **extras}, **kw)


def _stub_wandb(calls, fail_upload=False):
    class Run:
        def log(self, means, step=None):
            calls['log'].append((dict(means), step))

        def log_artifact(self, art):
            if fail_upload:
                raise RuntimeError('upload refused')
            calls['artifacts'].append(art)

    class Artifact:
        def __init__(self, name, type=None):
            self.name, self.type, self.files = name, type, []

        def add_file(self, path):
            assert os.path.exists(path), path
            self.files.append(path)

    stub = types.ModuleType('wandb')
    stub.init = lambda **kw: (calls['init'].append(kw), Run())[1]
    stub.Artifact = Artifact
    return stub


def test_wandb_mirror_with_stub(tmp_path, monkeypatch):
    calls = {'init': [], 'log': [], 'artifacts': []}
    monkeypatch.setitem(sys.modules, 'wandb', _stub_wandb(calls))
    cfg = Config(**_kw(tmp_path, use_wandb=True, project_name='p',
                       group_name='g', dir_name='run', wandb_entity='e',
                       extras={'log_model': True}))
    trainer = Trainer(cfg, device='cpu')
    trainer.fit(_windows(48), None, n_epochs=2)
    assert len(calls['init']) == 1
    init = calls['init'][0]
    assert (init['project'], init['group'], init['entity'], init['name']) \
        == ('p', 'g', 'e', 'run')
    assert init['config']['batch_size'] == 16
    # one log per epoch: its means, at the step the epoch ended on
    assert [step for _, step in calls['log']] == [3, 6]
    assert calls['log'][1][0]['loss_noise'] == \
        trainer.history[1]['loss_noise']
    # last.ckpt after each save, as JAX names and types it
    assert [(a.name, a.type) for a in calls['artifacts']] == \
        [('model-run', 'model')] * 2
    assert all(a.files == [os.path.join(str(tmp_path), 'last.ckpt')]
               for a in calls['artifacts'])


def test_wandb_log_model_failure_is_reported(tmp_path, monkeypatch, capsys):
    calls = {'init': [], 'log': [], 'artifacts': []}
    monkeypatch.setitem(sys.modules, 'wandb',
                        _stub_wandb(calls, fail_upload=True))
    cfg = Config(**_kw(tmp_path, use_wandb=True,
                       extras={'log_model': True}))
    Trainer(cfg, device='cpu').fit(_windows(16), None, n_epochs=1)
    assert 'wandb log_model failed (upload refused)' in \
        capsys.readouterr().err
    assert len(calls['log']) == 1 and not calls['artifacts']


def test_wandb_disabled_when_it_does_not_import(tmp_path, monkeypatch,
                                                capsys):
    monkeypatch.setitem(sys.modules, 'wandb', None)   # import fails
    cfg = Config(**_kw(tmp_path, use_wandb=True,
                       extras={'log_model': True}))
    trainer = Trainer(cfg, device='cpu')
    assert capsys.readouterr().err.startswith('wandb disabled (')
    trainer.fit(_windows(16), None, n_epochs=1)     # trains all the same
    assert os.path.exists(os.path.join(str(tmp_path), 'last.ckpt'))
    assert 'wandb' not in capsys.readouterr().err


def test_profile_dir_writes_a_trace_of_the_first_epoch(tmp_path):
    prof = tmp_path / 'trace'
    cfg = Config(**_kw(tmp_path / 'ckpt', extras={
        'profile_dir': str(prof), 'device_data': True,
        'steps_per_dispatch': 2}))
    os.makedirs(cfg.ckpt_dir)
    trainer = Trainer(cfg, device='cpu')
    trainer.fit(_windows(48), None, n_epochs=2)
    files = [f for f in os.listdir(prof) if f.endswith('.pt.trace.json')]
    assert len(files) == 1, files
    with open(prof / files[0]) as f:
        events = json.load(f)['traceEvents']
    spans = [e for e in events if e.get('name') == EPOCH_SPAN]
    # epoch 0 alone: the profiler stops after its validation
    assert len(spans) == 1
    # once per trainer, as the JAX loop clears its key
    trainer.fit(_windows(16), None, n_epochs=1)
    assert len(os.listdir(prof)) == 1


def _nan_at_step(ds, cfg, step):
    """Put a NaN in a window that epoch 0's step `step` draws."""
    batches = list(make_loader(ds, cfg.batch_size, shuffle=True,
                               seed=cfg.seed, yield_indices=True))
    ds.data[batches[step]['idx'][3], 0, 2, 5] = np.nan


@pytest.mark.parametrize('k', [1, 4])
def test_debug_nans_raises_naming_the_step(tmp_path, k):
    """At one step per dispatch and inside a group of 4 (steps 0-3 of
    epoch 0 are one group; the NaN is in step 2)."""
    cfg = Config(**_kw(tmp_path, extras={
        'debug_nans': True, 'device_data': True, 'steps_per_dispatch': k}))
    ds = _windows(96)
    _nan_at_step(ds, cfg, 2)
    trainer = Trainer(cfg, device='cpu')
    with pytest.raises(FloatingPointError, match='at step 2$'):
        trainer.fit(ds, None, n_epochs=1)


def test_without_debug_nans_the_nan_trains_through(tmp_path):
    cfg = Config(**_kw(tmp_path))
    ds = _windows(96)
    _nan_at_step(ds, cfg, 2)
    trainer = Trainer(cfg, device='cpu')
    trainer.fit(ds, None, n_epochs=1)
    assert np.isnan(trainer.history[0]['loss'])


def test_jax_debug_nans_raises_on_the_same_windows(tmp_path):
    """The JAX Trainer's `debug_nans` (jax_debug_nans) on the windows the
    port's test above refuses: the same error class."""
    cfg = Config(**_kw(tmp_path))
    ds = _windows(96)
    _nan_at_step(ds, cfg, 2)
    jds = JaxWindows(data=ds.data, meta=ds.meta, frames=ds.frames,
                     num_transform=1)
    kw = _kw(tmp_path, extras={'debug_nans': True, 'device_data': False})
    try:
        jt = JaxTrainer(JaxConfig(**kw), mesh=jax_mesh(1))
        with pytest.raises(FloatingPointError):
            jt.fit(jds, n_epochs=1)
    finally:
        jax.config.update('jax_debug_nans', False)


def test_train_cli_refuses_grouped_steps_on_two_ranks(tmp_path):
    from mocodad_tpu_torch.data import synthetic
    synthetic.generate(str(tmp_path / 'data'), seed=0, n_scenes=1,
                       n_clips_per_split=1, n_actors=1, n_frames=30)
    with open(os.path.join(REPO, 'config', 'UBnormal',
                           'mocodad_train.yaml')) as f:
        raw = yaml.safe_load(f)
    raw.update(data_dir=str(tmp_path / 'data'), exp_dir=str(tmp_path / 'exp'),
               use_hr=False, validation=False, batch_size=16,
               num_transform=1, n_epochs=1, steps_per_dispatch=4)
    path = tmp_path / 'train.yaml'
    with open(path, 'w') as f:
        yaml.safe_dump(raw, f)
    proc = subprocess.Popen(
        [sys.executable, 'train_MoCoDAD_torch.py', '-c', str(path),
         '--device', 'cpu', '--n-devices', '2'], cwd=REPO, env=env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    out, err = communicate([proc])[0]
    assert proc.returncode != 0
    assert 'steps_per_dispatch > 1 is single-process only' in err, err[-3000:]
