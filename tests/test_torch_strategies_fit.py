"""`Trainer.fit` of the port on the CPU for every conditioning strategy and
the E_unet encoder: one epoch on a small synthetic set, the validation
AUC through `generate`, finite losses, and the reconstruction term only
where the AE encoder gives one."""

import os

import numpy as np
import pytest
import torch

from _torch_port import CFG_KW
from mocodad_tpu_torch.config import Config
from mocodad_tpu_torch.data import build_dataset, synthetic
from mocodad_tpu_torch.training.loop import Trainer

torch.set_num_threads(1)
STRATEGIES = {
    'concat': dict(conditioning_strategy='concat'),
    'inbetween_imp': dict(conditioning_strategy='inbetween_imp',
                          conditioning_indices=2),
    'random_imp': dict(conditioning_strategy='random_imp',
                       conditioning_indices=3),
    'no_condition': dict(conditioning_strategy='no_condition'),
    'inject_e_unet': dict(conditioning_architecture='E_unet'),
}


@pytest.fixture(scope='module')
def data_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('strategies_fit'))
    synthetic.generate(os.path.join(root, 'data'), seed=0, n_scenes=1,
                       n_clips_per_split=2, n_actors=2, n_frames=40)
    return root


@pytest.mark.parametrize('name', list(STRATEGIES))
def test_fit_runs_every_strategy(data_dir, name):
    data = os.path.join(data_dir, 'data')
    cfg = Config(**{**CFG_KW, **STRATEGIES[name], 'data_dir': data,
                    'ckpt_dir': os.path.join(data_dir, name),
                    'split': 'train', 'validation': True, 'use_hr': False,
                    'batch_size': 64, 'num_transform': 2, 'seed': 0,
                    'gt_path': os.path.join(data, 'validating',
                                            'test_frame_mask')})
    os.makedirs(cfg.ckpt_dir, exist_ok=True)
    train = build_dataset(cfg, split='train')
    val = build_dataset(cfg, split='validation')
    trainer = Trainer(cfg, device='cpu')
    trainer.fit(train, val, n_epochs=1)
    (epoch,) = trainer.history
    assert np.isfinite([epoch['loss'], epoch['loss_noise']]).all()
    assert 0.0 <= epoch['AUC'] <= 1.0
    assert 'loss_recons' not in epoch
    assert os.path.exists(os.path.join(cfg.ckpt_dir, 'best_weights.ckpt'))
