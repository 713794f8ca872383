"""The port's score report and skeleton drawing (mocodad_tpu_torch/viz/)
against the JAX package's on the same split and losses, and the eval CLI's
`--report` on the live and the load_tensors route."""

import base64
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

pytest.importorskip('matplotlib')

from mocodad_tpu import viz as jviz  # noqa: E402
from mocodad_tpu_torch import viz as tviz  # noqa: E402
from mocodad_tpu_torch.config import load_config  # noqa: E402
from mocodad_tpu_torch.data import build_dataset, synthetic  # noqa: E402
from mocodad_tpu_torch.models.mocodad import (MoCoDADModel,  # noqa: E402
                                              seeded_state)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)


@pytest.fixture(scope='module')
def split(tmp_path_factory):
    """A synthetic split (2 clips x 2 actors), a config of the shipped
    flagship test YAML on it, and per-window losses of its 2 views."""
    root = tmp_path_factory.mktemp('report')
    synthetic.generate(str(root / 'data'), seed=0, n_scenes=1,
                       n_clips_per_split=2, n_actors=2, n_frames=40)
    with open(os.path.join(REPO, 'config', 'UBnormal',
                           'mocodad_test.yaml')) as f:
        raw = yaml.safe_load(f)
    raw.update(data_dir=str(root / 'data'), exp_dir=str(root / 'exp'),
               test_path=str(root / 'data' / 'testing' / 'test_frame_mask'),
               use_hr=False, n_generated_samples=2, batch_size=64,
               num_transform=2, save_tensors=True, frames_shift=3,
               filter_kernel_size=4)
    path = root / 'test.yaml'
    with open(path, 'w') as f:
        yaml.safe_dump(raw, f)
    cfg = load_config(str(path))
    os.makedirs(cfg.ckpt_dir, exist_ok=True)
    build_dataset(cfg, split='train')          # fits + saves the scaler
    ds = build_dataset(cfg, split='test')
    n = ds.num_samples
    out = np.random.default_rng(3).gamma(2.0, 1.0, 2 * n)
    trans = np.repeat(np.arange(2), n).astype(np.int32)
    meta = np.concatenate([ds.meta] * 2)
    frames = np.concatenate([ds.frames] * 2)
    return root, path, raw, cfg, (out, trans, meta, frames)


@pytest.mark.parametrize('transformation', [0, 1])
def test_per_person_scores_equal_jax(split, transformation):
    *_, cfg, windows = split
    got = tviz.per_person_scores(*windows, cfg.gt_path,
                                 transformation=transformation)
    want = jviz.per_person_scores(*windows, cfg.gt_path,
                                  transformation=transformation)
    assert sorted(got) == sorted(want) and len(got) == 2
    for key, w in want.items():
        g = got[key]
        assert g['persons'] == w['persons']
        np.testing.assert_array_equal(g['error_per_person'],
                                      w['error_per_person'])
        np.testing.assert_array_equal(g['gt'], w['gt'])
        assert g['error_per_person'].shape[0] == 2


def test_hr_stats_and_latex_equal_jax(split, tmp_path):
    *_, cfg, _ = split
    masks = {(1, 1): np.arange(40) % 3 != 0}
    for hr in (None, masks):
        rows = tviz.hr_stats(cfg.gt_path, hr)
        assert rows == jviz.hr_stats(cfg.gt_path, hr)
        path = str(tmp_path / 'stats.tex')
        text = tviz.stats_to_latex(rows, path)
        assert text == jviz.stats_to_latex(rows)
        with open(path) as f:
            assert f.read() == text
    assert tviz.hr_stats(cfg.gt_path, masks)[0]['discarded'] == 14


def _strip_images(text):
    return re.sub(r'base64,[A-Za-z0-9+/=]+', 'base64,', text)


def test_html_report_same_sections_and_auc(split, tmp_path):
    *_, cfg, windows = split
    kw = dict(frames_shift=3, kernel_size=4.0, auc=0.8765)
    got = tviz.html_report(*windows, cfg.gt_path, str(tmp_path / 't.html'),
                           **kw)
    want = jviz.html_report(*windows, cfg.gt_path, str(tmp_path / 'j.html'),
                            **kw)
    with open(got) as f:
        g = f.read()
    with open(want) as f:
        w = f.read()
    assert _strip_images(g) == _strip_images(w)
    assert 'frame-level AUC-ROC: 0.8765' in g
    assert re.findall(r'<h2>scene \d+ clip \d+</h2>', g) == \
        ['<h2>scene 1 clip 1</h2>', '<h2>scene 1 clip 2</h2>']
    png = base64.b64decode(re.findall(r'base64,([A-Za-z0-9+/=]+)', g)[0])
    assert png[:8] == b'\x89PNG\r\n\x1a\n'
    one = tviz.html_report(*windows, cfg.gt_path, str(tmp_path / 'm.html'),
                           max_clips=1, **kw)
    with open(one) as f:
        assert '1 more clips omitted' in f.read()


def _cli(yaml_path, *args):
    env = dict(os.environ, OMP_NUM_THREADS='1')
    env.pop('PYTHONPATH', None)
    proc = subprocess.run(
        [sys.executable, 'eval_MoCoDAD_torch.py', '-c', str(yaml_path),
         '--device', 'cpu', *args], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc


def test_eval_cli_report_live_and_replay(split):
    root, path, raw, cfg, _ = split
    net = seeded_state(MoCoDADModel(cfg).build_net(), seed=0)
    torch.save({'state_dict': net.state_dict()},
               os.path.join(cfg.ckpt_dir, cfg.load_ckpt))
    report = os.path.join(cfg.ckpt_dir, 'report_test.html')
    for route, yaml_path in (('live', path), ('load_tensors', None)):
        if route == 'load_tensors':
            os.remove(report)
            yaml_path = root / 'replay.yaml'
            with open(yaml_path, 'w') as f:
                yaml.safe_dump(dict(raw, load_tensors=True), f)
        proc = _cli(yaml_path, '--report')
        auc = float(re.findall(r'AUC score: ([0-9.]+)', proc.stdout)[-1])
        assert f'report written to {report}' in proc.stdout
        with open(report) as f:
            text = f.read()
        assert f'frame-level AUC-ROC: {auc:.4f}' in text
        assert text.count('<img src="data:image/png;base64,') == 2
    # without the flag, no report
    os.remove(report)
    _cli(path)
    assert not os.path.exists(report)


def test_clip_visualizer_draws_the_same_lines(tmp_path):
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    rng = np.random.default_rng(5)
    coords = rng.uniform(20, 300, (6, 34)).astype(np.float32)
    coords[2, 4:6] = 0.0            # a missing joint cuts its bones
    trajs = {'1': coords, '2': coords[::-1] + 5}
    scores = rng.random(6)
    lines = []
    for mod in (tviz, jviz):
        vis = mod.ClipVisualizer(trajs, vid_res=(320, 320), scores=scores,
                                 gt=np.r_[0, 0, 1, 1, 0, 0])
        fig, ax = plt.subplots()
        vis._draw_frame(ax, 2)
        lines.append([ln.get_xydata() for ln in ax.get_lines()])
        plt.close(fig)
        out = str(tmp_path / f'{mod.__name__}.png')
        vis.save_frame(2, out)
        assert os.path.getsize(out) > 1000
    assert len(lines[0]) == len(lines[1]) == 2 * 16 - 2
    for a, b in zip(*lines):
        np.testing.assert_array_equal(a, b)
    assert tviz.COCO17_BONES == jviz.COCO17_BONES
