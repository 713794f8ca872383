"""The port's train CLI end to end on the CPU: two epochs with validation
from the shipped train config (cut to a small synthetic set), the
checkpoints it writes read by the port's eval CLI, `--resume` from
last.ckpt, and the refusal to run without CUDA unless `--device cpu` is
given."""

import os
import re
import subprocess
import sys

import pytest
import torch
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, yaml_path, *args):
    env = dict(os.environ, OMP_NUM_THREADS='1')
    env.pop('PYTHONPATH', None)
    return subprocess.run(
        [sys.executable, script, '-c', str(yaml_path), *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def _yaml(root, name, shipped, **kw):
    with open(os.path.join(REPO, 'config', 'UBnormal', shipped)) as f:
        raw = yaml.safe_load(f)
    data = str(root / 'data')
    raw.update(data_dir=data, exp_dir=str(root / 'exp'),
               dir_name='train_experiment', use_hr=False,
               n_generated_samples=2, batch_size=64, num_transform=2, **kw)
    path = root / name
    with open(path, 'w') as f:
        yaml.safe_dump(raw, f)
    return path


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp('train_cli')
    from mocodad_tpu_torch.data import synthetic
    synthetic.generate(str(root / 'data'), seed=0, n_scenes=1,
                       n_clips_per_split=2, n_actors=2, n_frames=40)
    path = _yaml(root, 'train.yaml', 'mocodad_train.yaml', n_epochs=2,
                 test_path=str(root / 'data' / 'validating' /
                               'test_frame_mask'),
                 log_every_n_steps=2)
    proc = _run('train_MoCoDAD_torch.py', path, '--device', 'cpu')
    return root, path, proc


def test_train_cli_writes_checkpoints(trained):
    root, _, proc = trained
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'checkpointing on AUC (max)' in proc.stdout
    epochs = re.findall(r'\[epoch (\d)\] .*AUC=', proc.stdout)
    assert epochs == ['0', '1'], proc.stdout
    ckpt_dir = root / 'exp' / 'UBnormal' / 'train_experiment'
    names = set(os.listdir(ckpt_dir))
    assert {'last.ckpt', 'best_weights.ckpt', 'topk.json', 'metrics.csv',
            'config.yaml'} <= names
    assert sum(n.startswith('epoch=') and n.endswith('.ckpt')
               for n in names) == 2


def test_eval_cli_reads_the_trained_checkpoint(trained):
    root, _, proc = trained
    assert proc.returncode == 0, proc.stdout + proc.stderr
    path = _yaml(root, 'test.yaml', 'mocodad_test.yaml',
                 test_path=str(root / 'data' / 'testing' / 'test_frame_mask'),
                 save_tensors=False)
    ev = _run('eval_MoCoDAD_torch.py', path, '--device', 'cpu')
    assert ev.returncode == 0, ev.stdout + ev.stderr
    auc = float(re.findall(r'AUC score: ([0-9.]+)', ev.stdout)[0])
    assert 0.0 <= auc <= 1.0


def test_train_cli_resumes_from_last(trained):
    root, path, proc = trained
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(path) as f:
        raw = yaml.safe_load(f)
    raw['n_epochs'] = 3
    more = root / 'train3.yaml'
    with open(more, 'w') as f:
        yaml.safe_dump(raw, f)
    res = _run('train_MoCoDAD_torch.py', more, '--device', 'cpu', '--resume')
    assert res.returncode == 0, res.stdout + res.stderr
    assert re.search(r'resumed from .*last\.ckpt at epoch 2', res.stdout)
    assert re.findall(r'\[epoch (\d)\]', res.stdout) == ['2']


def test_train_cli_refuses_without_cuda(trained):
    if torch.cuda.is_available():
        pytest.skip('CUDA is present: the default device is usable')
    _, path, _ = trained
    proc = _run('train_MoCoDAD_torch.py', path)
    assert proc.returncode != 0
    assert 'pass device="cpu"' in proc.stderr
