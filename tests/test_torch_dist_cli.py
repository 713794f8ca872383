"""The port's CLIs on two ranks: `--device cpu --n-devices 2` spawns two
CPU processes over gloo and gives what `--n-devices 1` gives.

train_MoCoDAD_torch.py writes the same files (rank 0 alone writes them:
one metrics.csv line per step and epoch, not two) with the same losses;
eval_MoCoDAD_torch.py prints the same AUC on the trained checkpoint;
predict_MoCoDAD_torch.py saves the same tensors; a rank that raises makes
the CLI exit non-zero.
"""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import yaml

from _torch_dist import REPO, communicate, env

# the epoch means of two runs whose steps differ in float32 summation
# order (tests/test_torch_dist_train.py)
FIT_RTOL = 1e-3
REL = 1e-6


def _start(script, yaml_path, *args, extra_env=None):
    return subprocess.Popen(
        [sys.executable, script, '-c', str(yaml_path), '--device', 'cpu',
         *args], cwd=REPO, env={**env(), **(extra_env or {})},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)


def _run_all(*calls, joined=None):
    """Run the calls side by side; `joined` = the index of the one that
    joins a group of one rank through the MOCODAD_* variables."""
    procs = [_start(*c, extra_env=None if i != joined else {
        'MOCODAD_COORDINATOR': 'file://' + str(c[1]) + '.rendezvous',
        'MOCODAD_NUM_PROCESSES': '1', 'MOCODAD_PROCESS_ID': '0'})
        for i, c in enumerate(calls)]
    return [subprocess.CompletedProcess(p.args, p.returncode, o, e)
            for p, (o, e) in zip(procs, communicate(procs))]


def _yaml(root, name, shipped, **kw):
    with open(os.path.join(REPO, 'config', 'UBnormal', shipped)) as f:
        raw = yaml.safe_load(f)
    raw.update(data_dir=str(root / 'data'), exp_dir=str(root / 'exp'),
               use_hr=False, n_generated_samples=2, batch_size=64,
               num_transform=2)
    raw.update(kw)
    path = root / name
    with open(path, 'w') as f:
        yaml.safe_dump(raw, f)
    return path


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp('dist_cli')
    from mocodad_tpu_torch.data import synthetic
    synthetic.generate(str(root / 'data'), seed=0, n_scenes=1,
                       n_clips_per_split=2, n_actors=2, n_frames=40)
    val_gt = str(root / 'data' / 'validating' / 'test_frame_mask')
    train = {w: _yaml(root, f'train{w}.yaml', 'mocodad_train.yaml',
                      n_epochs=2, dir_name=f'train{w}', test_path=val_gt,
                      log_every_n_steps=2) for w in (1, 2)}
    trained = _run_all(*[('train_MoCoDAD_torch.py', train[w], '--n-devices',
                          str(w)) for w in (1, 2)])
    for p in trained:
        assert p.returncode == 0, p.stdout + p.stderr
    test_gt = str(root / 'data' / 'testing' / 'test_frame_mask')
    test = _yaml(root, 'test.yaml', 'mocodad_test.yaml', dir_name='train2',
                 test_path=test_gt, save_tensors=False)
    odd = _yaml(root, 'odd.yaml', 'mocodad_test.yaml', dir_name='train2',
                test_path=test_gt, save_tensors=False, batch_size=63)
    # predict writes into ckpt_dir: each width its own copy of it
    pred = {}
    for w in (1, 2):
        shutil.copytree(root / 'exp' / 'UBnormal' / 'train2',
                        root / 'exp' / 'UBnormal' / f'predict{w}')
        pred[w] = _yaml(root, f'predict{w}.yaml', 'mocodad_test.yaml',
                        dir_name=f'predict{w}', test_path=test_gt)
    evals = _run_all(
        *[('eval_MoCoDAD_torch.py', test, '--n-devices', str(w))
          for w in (1, 2)],
        *[('predict_MoCoDAD_torch.py', pred[w], '--n-devices', str(w))
          for w in (1, 2)],
        ('eval_MoCoDAD_torch.py', odd, '--n-devices', '2'),
        ('eval_MoCoDAD_torch.py', test), joined=5)
    return root, trained, evals


def _auc(out):
    return float(re.findall(r'AUC score: ([0-9.]+)', out)[0])


def _epoch_lines(path):
    with open(path) as f:
        return [dict(kv.split('=') for kv in line.split(',')[2:])
                for line in f.read().splitlines() if ',epoch_end,' in line]


def test_train_on_two_ranks_writes_what_one_writes(runs):
    root, trained, _ = runs
    one, two = (root / 'exp' / 'UBnormal' / f'train{w}' for w in (1, 2))

    def names(d):
        return sorted(re.sub(r'=[-0-9.e]+(\.ckpt)', r'\1', f)
                      for f in os.listdir(d))
    assert names(one) == names(two)
    assert sum(n.startswith('epoch=') and n.endswith('.ckpt')
               for n in names(two)) == 2
    with open(one / 'metrics.csv') as f1, open(two / 'metrics.csv') as f2:
        assert len(f1.readlines()) == len(f2.readlines())
    lines1, lines2 = _epoch_lines(one / 'metrics.csv'), \
        _epoch_lines(two / 'metrics.csv')
    assert len(lines2) == 2
    for a, b in zip(lines1, lines2):
        for k in ('loss', 'loss_noise', 'loss_recons'):
            np.testing.assert_allclose(float(b[k]), float(a[k]),
                                       rtol=FIT_RTOL, err_msg=k)
    # rank 0 alone prints the epoch lines
    assert re.findall(r'\[epoch (\d)\]', trained[1].stdout) == ['0', '1']


def test_eval_on_two_ranks_prints_the_same_auc(runs):
    _, _, evals = runs
    for p in evals[:2]:
        assert p.returncode == 0, p.stdout + p.stderr
    assert evals[1].stdout.count('AUC score') == 1
    assert _auc(evals[0].stdout) == _auc(evals[1].stdout)


def test_eval_joined_to_a_group_of_one_prints_the_same_auc(runs):
    """MOCODAD_COORDINATOR / _NUM_PROCESSES / _PROCESS_ID: the CLI joins
    that group (here of one rank) instead of running alone."""
    _, _, evals = runs
    p = evals[5]
    assert p.returncode == 0, p.stdout + p.stderr
    assert 'joined a group as rank 0 of 1' in p.stderr
    assert 'joined a group' not in evals[0].stderr
    assert _auc(p.stdout) == _auc(evals[0].stdout)


def test_predict_on_two_ranks_saves_the_same_tensors(runs):
    _, _, evals = runs
    paths = []
    for p in evals[2:4]:
        assert p.returncode == 0, p.stdout + p.stderr
        assert p.stdout.count('saved tensors to') == 1
        paths.append(p.stdout.split('saved tensors to ')[-1].strip())
    for name in ('prediction', 'trans', 'metadata', 'frames', 'gt_data'):
        a, b = (np.load(os.path.join(d, f'{name}.npy')) for d in paths)
        if name == 'prediction':
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= REL * np.abs(a).max()
        else:
            np.testing.assert_array_equal(a, b)


def test_a_failed_rank_fails_the_cli(runs):
    _, _, evals = runs
    p = evals[4]
    assert p.returncode != 0
    assert 'must be divisible by the mesh' in p.stderr
    assert 'a rank exited with code' in p.stderr
