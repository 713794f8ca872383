"""The port's eval CLI end to end on the CPU: a YAML config and a
reference-named checkpoint in, the frame-level AUC out, then the
`load_tensors` replay of the tensors it saved, and the refusal to run
without CUDA unless `--device cpu` is given."""

import os
import re
import subprocess
import sys

import pytest
import torch
import yaml

from mocodad_tpu_torch.config import load_config
from mocodad_tpu_torch.data import build_dataset, synthetic
from mocodad_tpu_torch.models.mocodad import MoCoDADModel, seeded_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)


def _cli(yaml_path, *args):
    env = dict(os.environ, OMP_NUM_THREADS='1')
    env.pop('PYTHONPATH', None)
    return subprocess.run(
        [sys.executable, 'eval_MoCoDAD_torch.py', '-c', str(yaml_path), *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def _auc(proc):
    assert proc.returncode == 0, proc.stdout + proc.stderr
    found = re.findall(r'AUC score: ([0-9.]+)', proc.stdout)
    assert len(found) == 1, proc.stdout
    return float(found[0])


@pytest.fixture(scope='module')
def config_path(tmp_path_factory):
    root = tmp_path_factory.mktemp('cli')
    synthetic.generate(str(root / 'data'), seed=0, n_scenes=1,
                       n_clips_per_split=2, n_actors=2, n_frames=40)
    with open(os.path.join(REPO, 'config', 'UBnormal',
                           'mocodad_test.yaml')) as f:
        raw = yaml.safe_load(f)
    raw.update(data_dir=str(root / 'data'), exp_dir=str(root / 'exp'),
               test_path=str(root / 'data' / 'testing' / 'test_frame_mask'),
               use_hr=False, n_generated_samples=2, batch_size=64,
               num_transform=2, save_tensors=True)
    path = root / 'test.yaml'
    with open(path, 'w') as f:
        yaml.safe_dump(raw, f)
    cfg = load_config(str(path))
    os.makedirs(cfg.ckpt_dir, exist_ok=True)
    build_dataset(cfg, split='train')          # fits + saves the scaler
    model = MoCoDADModel(cfg)
    net = seeded_state(model.build_net(), seed=0)
    torch.save({'state_dict': net.state_dict()},
               os.path.join(cfg.ckpt_dir, cfg.load_ckpt))
    return path, raw


def test_eval_cli_on_cpu_then_tensor_replay(config_path):
    path, raw = config_path
    auc = _auc(_cli(path, '--device', 'cpu'))
    assert 0.0 <= auc <= 1.0
    replay = path.parent / 'replay.yaml'
    with open(replay, 'w') as f:
        yaml.safe_dump(dict(raw, load_tensors=True), f)
    # scoring-only replay of the saved losses gives the same AUC
    assert _auc(_cli(replay)) == auc


def test_eval_cli_refuses_without_cuda(config_path):
    if torch.cuda.is_available():
        pytest.skip('CUDA is present: the default device is usable')
    path, _ = config_path
    proc = _cli(path)
    assert proc.returncode != 0
    assert 'pass device="cpu"' in proc.stderr
    assert 'AUC score' not in proc.stdout
