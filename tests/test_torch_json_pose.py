"""The JSON-pose data path in the port (mocodad_tpu_torch/data/json_pose.py,
data/convert.py and build_dataset's dispatch) against the JAX package's, on
a synthetic AlphaPose tracked-person JSON set: windows, kp18 remap, every
normalization, the tracked-JSON -> CSV converter, and kp18 / headless on
the robust CSV path."""

import json
import os

import numpy as np
import pytest
import torch

from mocodad_tpu.config import Config as JaxConfig
from mocodad_tpu.data import build_dataset as jax_build_dataset
from mocodad_tpu.data import convert as jax_convert
from mocodad_tpu.data import json_pose as J
from mocodad_tpu_torch.config import Config
from mocodad_tpu_torch.data import build_dataset, convert, json_pose as P
from mocodad_tpu_torch.data import synthetic

torch.set_num_threads(1)

NORMS = ('markovitz', 'robust', 'stan', 'bbox')


def _tracked(path, scene, clip, persons, n_frames, rng, missing=()):
    """One `{scene}_{clip}_alphapose_tracked_person.json`: per person, per
    frame, 17 (x, y, confidence) keypoints, a few of them zero."""
    tracked = {}
    for pid in persons:
        frames = {}
        for f in range(1, n_frames + 1):
            if f in missing:
                continue
            kp = np.concatenate([rng.uniform(10, 600, (17, 2)),
                                 rng.uniform(0.2, 1.0, (17, 1))], 1)
            kp[rng.random(17) < 0.05, :2] = 0.0
            frames[str(f)] = {'keypoints': kp.reshape(-1).tolist(),
                              'scores': float(rng.random())}
        tracked[str(pid)] = frames
    with open(os.path.join(path, f'{scene:02d}_{clip:04d}_alphapose_'
                                 'tracked_person.json'), 'w') as f:
        json.dump(tracked, f)


@pytest.fixture(scope='module')
def json_root(tmp_path_factory):
    """pose/{training,testing}/tracked_person/ as init_args lays them out."""
    root = tmp_path_factory.mktemp('json_pose')
    rng = np.random.default_rng(11)
    for split, clips in (('training', (1, 2)), ('testing', (3,))):
        d = root / 'pose' / split / 'tracked_person'
        d.mkdir(parents=True)
        for clip in clips:
            _tracked(str(d), 1, clip, (1, 2), 24, rng,
                     missing=(9, 10) if clip == 2 else ())
    return root


def _pose_path(root, split):
    return str(root / 'pose' / split / 'tracked_person')


def test_keypoints17_to_coco18_matches_jax():
    kp = np.random.default_rng(0).standard_normal((3, 4, 17, 3))
    np.testing.assert_array_equal(P.keypoints17_to_coco18(kp),
                                  J.keypoints17_to_coco18(kp))
    assert P.keypoints17_to_coco18(kp).shape == (3, 4, 18, 3)


@pytest.mark.parametrize('norm', NORMS + ('none',))
@pytest.mark.parametrize('kp18, headless', [(True, False), (False, True)],
                         ids=['kp18', 'headless'])
def test_json_pose_windows_match_jax(json_root, norm, kp18, headless):
    kw = dict(path_to_json=_pose_path(json_root, 'training'), seg_len=6,
              seg_stride=2, start_ofst=1, normalize=norm != 'none',
              normalization_strategy=norm if norm != 'none' else 'markovitz',
              kp18_format=kp18, headless=headless, vid_res=[640, 360],
              symm_range=True, hip_center=norm == 'markovitz',
              sub_mean=False, return_mean=False)
    got, want = P.json_pose_windows(**kw), J.json_pose_windows(**kw)
    assert got[0].shape[0] > 0
    assert got[0].shape[1:] == (3, 6, 14 if headless else 18)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    if norm == 'robust':
        for k in ('center_', 'scale_'):
            np.testing.assert_array_equal(getattr(got[3], k),
                                          getattr(want[3], k))


def test_json_windowing_and_debug_duplication_match_jax(json_root):
    kw = dict(path_to_json=_pose_path(json_root, 'training'), seg_len=6,
              seg_stride=1, normalize=False, kp18_format=False,
              num_clips=1)
    got, want = P.json_pose_windows(**kw), J.json_pose_windows(**kw)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    keys = [0, 1, 2, 3, 4, 5, 8, 9, 10, 11, 12, 13]
    for start, th in ((0, 2), (4, 2), (4, 1)):
        assert P.is_seg_continuous(keys, start, 6, th) == \
            J.is_seg_continuous(keys, start, 6, th)


@pytest.mark.parametrize('norm', ('markovitz', 'stan', 'bbox', 'none'))
def test_build_dataset_json_dispatch_matches_jax(json_root, tmp_path, norm):
    """build_dataset with a normalization other than robust reads the JSON
    tracks through `pose_path`, as the JAX build_dataset does."""
    kw = dict(data_dir=str(json_root), ckpt_dir=str(tmp_path), seg_len=6,
              seg_stride=2, num_coords=2, num_transform=2,
              normalization_strategy=norm, kp18_format=True,
              vid_res=[640, 360], hip_center=True,
              pose_path={s: _pose_path(json_root, d) for s, d in (
                  ('train', 'training'), ('test', 'testing'))})
    for split in ('train', 'test'):
        got = build_dataset(Config(**kw), split)
        want = jax_build_dataset(JaxConfig(**kw), split)
        assert got.data.shape[1:] == (2, 6, 18) and got.num_samples > 0
        assert got.num_transform == want.num_transform == 2
        np.testing.assert_array_equal(got.data, want.data)
        np.testing.assert_array_equal(got.meta, want.meta)
        np.testing.assert_array_equal(got.frames, want.frames)


def test_convert_split_matches_jax(json_root, tmp_path):
    src = _pose_path(json_root, 'training')
    n_port = convert.convert_split(src, str(tmp_path / 'port'))
    n_jax = jax_convert.convert_split(src, str(tmp_path / 'jax'))
    assert n_port == n_jax == 4
    for d in sorted(os.listdir(tmp_path / 'jax')):
        for f in sorted(os.listdir(tmp_path / 'jax' / d)):
            assert (tmp_path / 'port' / d / f).read_bytes() == \
                (tmp_path / 'jax' / d / f).read_bytes()


@pytest.mark.parametrize('joint_kw', [
    dict(kp18_format=True), dict(headless=True),
    dict(kp18_format=True, headless=True)],
    ids=['kp18', 'headless', 'kp18_headless'])
def test_robust_csv_joints_match_jax(tmp_path, joint_kw):
    synthetic.generate(str(tmp_path / 'data'), seed=3, n_clips_per_split=1,
                       n_actors=2, n_frames=30)
    kw = dict(data_dir=str(tmp_path / 'data'), seg_len=6, num_coords=2,
              num_transform=2, seg_stride=2, vid_res=[640, 360],
              **joint_kw)
    for d in ('p', 'j'):
        (tmp_path / d).mkdir()
    for split in ('train', 'test'):
        got = build_dataset(Config(ckpt_dir=str(tmp_path / 'p'), **kw),
                            split)
        want = jax_build_dataset(JaxConfig(ckpt_dir=str(tmp_path / 'j'),
                                           **kw), split)
        np.testing.assert_array_equal(got.data, want.data)
        np.testing.assert_array_equal(got.meta, want.meta)
