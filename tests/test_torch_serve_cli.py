"""The port's serve CLI (serve_MoCoDAD_torch.py) on the CPU: the JSON-lines
protocol on a pose stream with malformed lines mixed in, the scores it
writes against a StreamScorer fed the same poses, overload and missing-mask
error lines, the startup check of --max-queue-windows, and the refusal to
run without CUDA unless --device cpu is given."""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import serve_MoCoDAD_torch as cli
from mocodad_tpu_torch.config import load_config
from mocodad_tpu_torch.data import build_dataset, synthetic
from mocodad_tpu_torch.data import trajectories as T
from mocodad_tpu_torch.models.mocodad import MoCoDADModel, seeded_state
from mocodad_tpu_torch.serve import StreamScorer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)

MALFORMED = ['not json', '[1, 2]', '{"type": "pose", "scene": 1}',
             '{"type": "pose", "scene": 1, "clip": 1, "person": 0, '
             '"frame": 3, "keypoints": [[1, 2], [3]]}',
             '{"type": "pose", "scene": "x", "clip": 1, "person": 0, '
             '"frame": 3, "keypoints": []}',
             '{"type": "pose", "scene": 1, "clip": 1, "person": 0, '
             '"frame": 0, "keypoints": ' + json.dumps([[1.0, 2.0]] * 17) + '}',
             '{"type": "end_clip", "scene": 1}',
             '{"type": "wave"}', '']


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp('serve_cli')
    data = root / 'data'
    synthetic.generate(str(data), seed=2, n_scenes=1, n_clips_per_split=2,
                       n_actors=2, n_frames=30)
    with open(os.path.join(REPO, 'config', 'UBnormal',
                           'mocodad_test.yaml')) as f:
        raw = yaml.safe_load(f)
    raw.update(data_dir=str(data), exp_dir=str(root / 'exp'),
               test_path=str(data / 'testing' / 'test_frame_mask'),
               use_hr=False, n_generated_samples=2, noise_steps=4,
               num_transform=2, vid_res=[640, 360], seed=3,
               frames_shift=3, filter_kernel_size=4)
    path = root / 'test.yaml'
    with open(path, 'w') as f:
        yaml.safe_dump(raw, f)
    cfg = load_config(str(path))
    os.makedirs(cfg.ckpt_dir, exist_ok=True)
    build_dataset(cfg, split='train')          # fits + saves the scaler
    net = seeded_state(MoCoDADModel(cfg).build_net(), seed=1)
    torch.save({'state_dict': net.state_dict()},
               os.path.join(cfg.ckpt_dir, cfg.load_ckpt))
    return path, raw, cfg, _stream(data)


def _stream(data):
    """The test split's poses as protocol messages, then one end_clip per
    clip with its frame count."""
    trajs = T.load_trajectories(str(data / 'testing' / 'trajectories'),
                                split='test')
    lines, clips = [], {}
    for t in trajs.values():
        scene, clip = map(int, t.trajectory_id.split('_')[0].split('-'))
        clips[(scene, clip)] = max(clips.get((scene, clip), 0),
                                   int(t.frames.max()))
        for i in range(len(t)):
            lines.append({'type': 'pose', 'scene': scene, 'clip': clip,
                          'person': int(t.person_id),
                          'frame': int(t.frames[i]),
                          'keypoints': t.coordinates[i].reshape(-1, 2)
                          .tolist()})
    ends = [{'type': 'end_clip', 'scene': s, 'clip': c, 'n_frames': n}
            for (s, c), n in sorted(clips.items())]
    return lines, ends


def _serve(cfg, text, **kw):
    out, err = io.StringIO(), io.StringIO()
    saved, sys.stderr = sys.stderr, err
    try:
        cli.serve(cfg, io.StringIO(text), out, kw.pop('batch_size', 16),
                  kw.pop('flush_every', None), device='cpu', **kw)
    finally:
        sys.stderr = saved
    return [json.loads(x) for x in out.getvalue().splitlines()], \
        err.getvalue()


def test_serve_scores_a_stream_with_malformed_lines(setup):
    _, _, cfg, (poses, ends) = setup
    lines = [json.dumps(m) for m in poses]
    # the malformed lines land between valid poses
    step = len(lines) // len(MALFORMED)
    for i, bad in enumerate(MALFORMED):
        lines.insert(i * (step + 1), bad)
    text = '\n'.join(lines + [json.dumps(e) for e in ends]) + '\n'
    out, err = _serve(cfg, text, flush_every=16)
    assert [o['type'] for o in out] == ['scores'] * len(ends)
    assert err.count('skipping malformed') == len(MALFORMED) - 2
    assert "unknown message type 'wave'" in err

    scorer = StreamScorer(cfg, batch_size=16, flush_every=16, device='cpu')
    for m in poses:
        scorer.push(m['scene'], m['clip'], m['person'], m['frame'],
                    np.asarray(m['keypoints'], np.float32))
    for o, e in zip(out, ends):
        assert (o['scene'], o['clip']) == (e['scene'], e['clip'])
        want = scorer.finalize_clip(e['scene'], e['clip'], e['n_frames'])
        assert len(o['scores']) == e['n_frames']
        np.testing.assert_allclose(o['scores'], want, rtol=0, atol=5e-7)
        assert max(o['scores']) > 0


def test_serve_reports_overload_and_keeps_running(setup):
    _, _, cfg, (poses, ends) = setup
    text = '\n'.join(json.dumps(m) for m in poses + ends[:1]) + '\n'
    out, _ = _serve(cfg, text, batch_size=16, max_queue_windows=8)
    errors = [o for o in out if o['type'] == 'error']
    assert errors and all(o['error'] == 'overloaded' for o in errors)
    assert all('max_queue_windows=8' in o['detail'] for o in errors)
    assert {'scene', 'clip', 'person', 'frame'} <= set(errors[0])
    assert out[-1]['type'] == 'scores'
    assert len(out[-1]['scores']) == ends[0]['n_frames']


def test_serve_missing_gt_mask_fails_the_clip_only(setup, tmp_path):
    _, _, cfg, (poses, ends) = setup
    cfg = load_config(str(setup[0]))
    cfg.pad_size, cfg.gt_path = 2, str(tmp_path)       # no masks there
    np.save(tmp_path / f'{ends[1]["scene"]}_{ends[1]["clip"]}.npy',
            np.zeros(ends[1]['n_frames'], np.int64))
    text = '\n'.join(json.dumps(m) for m in poses + ends) + '\n'
    out, err = _serve(cfg, text)
    assert out[0] == {'type': 'error', 'scene': ends[0]['scene'],
                      'clip': ends[0]['clip'],
                      'error': 'gt mask unavailable for absence padding'}
    assert 'cannot load gt mask' in err
    assert out[1]['type'] == 'scores'
    assert len(out[1]['scores']) == ends[1]['n_frames']


def _run(*args, stdin=''):
    env = dict(os.environ, OMP_NUM_THREADS='1')
    env.pop('PYTHONPATH', None)
    return subprocess.run([sys.executable, 'serve_MoCoDAD_torch.py', *args],
                          cwd=REPO, env=env, input=stdin,
                          capture_output=True, text=True, timeout=300)


def test_serve_cli_process_on_cpu(setup, tmp_path):
    """The CLI as a process, on the same config written as JSON (the form
    a machine without PyYAML reads)."""
    _, raw, _, (poses, ends) = setup
    path = tmp_path / 'test.json'
    path.write_text(json.dumps(raw))
    text = '\n'.join(json.dumps(m) for m in poses + ends[:1]) + '\n'
    proc = _run('-c', str(path), '--device', 'cpu', '--batch-size', '32',
                '--eval-profile', 'fast', stdin=text)
    assert proc.returncode == 0, proc.stderr
    out = [json.loads(x) for x in proc.stdout.splitlines()]
    assert [o['type'] for o in out] == ['scores']
    assert np.isfinite(out[0]['scores']).all()


def test_serve_cli_startup_checks(setup):
    path = str(setup[0])
    proc = _run('-c', path, '--device', 'cpu', '--batch-size', '32',
                '--max-queue-windows', '16')
    assert proc.returncode == 2
    assert '--max-queue-windows (16) must be >= --batch-size (32)' in \
        proc.stderr
    if not torch.cuda.is_available():
        proc = _run('-c', path, stdin='')
        assert proc.returncode != 0 and 'pass device="cpu"' in proc.stderr
