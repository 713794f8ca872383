"""The port's predict CLI (predict_MoCoDAD_torch.py) on the CPU: the saved
prediction tensors against `restore_and_infer` on the same config, the same
tensors from a JAX-package msgpack checkpoint of the same weights, the
scoring replay of what it saved, and the refusal to run without CUDA unless
--device cpu is given."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import predict_MoCoDAD_torch as cli
from mocodad_tpu.training.checkpoint import save_checkpoint
from mocodad_tpu_torch.config import load_config
from mocodad_tpu_torch.data import build_dataset, synthetic
from mocodad_tpu_torch.eval.harness import post_processing_from_config
from mocodad_tpu_torch.models.mocodad import MoCoDADModel, seeded_state
from mocodad_tpu_torch.training.inference import restore_and_infer
from mocodad_tpu_torch.utils.tensors import load_tensors
from mocodad_tpu_torch.utils.weights import variables_from_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)


def _yaml(root, name, **kw):
    with open(os.path.join(REPO, 'config', 'UBnormal',
                           'mocodad_test.yaml')) as f:
        raw = yaml.safe_load(f)
    raw.update(data_dir=str(root / 'data'), exp_dir=str(root / 'exp'),
               test_path=str(root / 'data' / 'testing' / 'test_frame_mask'),
               use_hr=False, n_generated_samples=2, noise_steps=4,
               batch_size=32, num_transform=2, vid_res=[640, 360],
               save_tensors=False, **kw)
    path = root / f'{name}.yaml'
    with open(path, 'w') as f:
        yaml.safe_dump(raw, f)
    return str(path)


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    """A torch checkpoint and a JAX-package msgpack checkpoint of the same
    seeded weights, each behind its own config."""
    root = tmp_path_factory.mktemp('predict_cli')
    synthetic.generate(str(root / 'data'), seed=1, n_scenes=1,
                       n_clips_per_split=2, n_actors=2, n_frames=30)
    torch_yaml = _yaml(root, 'torch')
    cfg = load_config(torch_yaml)
    os.makedirs(cfg.ckpt_dir, exist_ok=True)
    build_dataset(cfg, split='train')          # fits + saves the scaler
    net = seeded_state(MoCoDADModel(cfg).build_net(), seed=2)
    torch.save({'state_dict': net.state_dict()},
               os.path.join(cfg.ckpt_dir, cfg.load_ckpt))
    save_checkpoint(os.path.join(cfg.ckpt_dir, 'jax_state.ckpt'),
                    variables_from_state_dict(net.state_dict()))
    return torch_yaml, _yaml(root, 'jax', load_ckpt='jax_state.ckpt'), cfg


def test_predict_saves_restore_and_infer_tensors(setup):
    torch_yaml, _, _ = setup
    path = cli.main(['-c', torch_yaml, '--device', 'cpu'])
    cfg = load_config(torch_yaml)
    assert path.endswith('saved_tensors_test_best_2')
    saved = load_tensors(cfg.ckpt_dir, 'test', 'best', 2)
    _, ds, res = restore_and_infer(cfg, device='cpu')
    np.testing.assert_array_equal(saved['prediction'], res['loss'])
    np.testing.assert_array_equal(saved['metadata'], res['meta'])
    np.testing.assert_array_equal(saved['frames'], res['frames'])
    np.testing.assert_array_equal(saved['trans'], res['trans'])
    assert saved['gt_data'].shape == (len(ds),) + ds.data.shape[1:]
    assert np.isfinite(saved['prediction']).all()
    # the scoring replay of the saved losses gives the run's AUC
    auc = post_processing_from_config(res['loss'], res['trans'],
                                      res['meta'], res['frames'], cfg)
    assert post_processing_from_config(
        saved['prediction'], saved['trans'], saved['metadata'],
        saved['frames'], cfg) == auc and 0.0 <= auc <= 1.0


def test_predict_from_a_jax_checkpoint(setup):
    torch_yaml, jax_yaml, _ = setup
    torch_path = cli.main(['-c', torch_yaml, '--device', 'cpu'])
    want = {k: np.load(os.path.join(torch_path, k + '.npy'))
            for k in ('prediction', 'trans', 'metadata')}
    jax_path = cli.main(['-c', jax_yaml, '--device', 'cpu',
                         '--eval-profile', 'full'])
    assert jax_path == torch_path
    for k, v in want.items():
        np.testing.assert_array_equal(
            np.load(os.path.join(jax_path, k + '.npy')), v)


def test_predict_refuses_without_cuda(setup):
    if torch.cuda.is_available():
        pytest.skip('CUDA is present: the default device is usable')
    env = dict(os.environ, OMP_NUM_THREADS='1')
    env.pop('PYTHONPATH', None)
    proc = subprocess.run([sys.executable, 'predict_MoCoDAD_torch.py', '-c',
                           setup[0]], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and 'pass device="cpu"' in proc.stderr
    assert 'saved tensors' not in proc.stdout
