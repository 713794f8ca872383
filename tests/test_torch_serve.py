"""The port's streaming scorer (mocodad_tpu_torch/serve.py) on the CPU:
streamed windows bit-equal to the port's offline windows, scores against
the JAX package's StreamScorer on the same weights and the same per-flush
noise, and the guardrail, drop, overload and in-flight-bound cases of
tests/test_serve.py, with the three fixes the port builds in (the sizing
knobs checked before the model build and the restore, flush_every stored as
an int, drop_clip draining only up to the clip's last in-flight batch)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import seeded_variables
from mocodad_tpu.config import Config as JaxConfig
from mocodad_tpu.data.transforms import apply_affine_batch as jax_affine
from mocodad_tpu.data.transforms import affine_transform_matrices
from mocodad_tpu.models import build_model as jax_build_model
from mocodad_tpu.serve import OverloadError as JaxOverloadError
from mocodad_tpu.serve import StreamScorer as JaxStreamScorer
from mocodad_tpu_torch.config import Config
from mocodad_tpu_torch.data import build_dataset, synthetic
from mocodad_tpu_torch.data import trajectories as T
from mocodad_tpu_torch.eval.harness import post_processing
from mocodad_tpu_torch.models.mocodad import MoCoDADModel
from mocodad_tpu_torch.serve import OverloadError, StreamScorer
from mocodad_tpu_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(1)

# float32 through a 4-step chain and the scoring chain on both sides (the
# port's generate holds the JAX one at 1e-4 / 1e-5, test_torch_generate.py)
RTOL, ATOL = 1e-4, 1e-5
SCORER_KW = dict(device='cpu')


@pytest.fixture(scope='module')
def synth(tmp_path_factory):
    d = tmp_path_factory.mktemp('serve_data')
    synthetic.generate(str(d), seed=5, n_clips_per_split=2, n_actors=2,
                       n_frames=48)
    return str(d)


def _kw(synth, ckpt_dir, **kw):
    """tests/test_serve.py's _cfg, as keyword arguments of either
    package's Config."""
    base = dict(
        split='train', data_dir=synth, exp_dir=str(ckpt_dir),
        ckpt_dir=str(ckpt_dir), dataset_choice='UBnormal', seg_len=6,
        conditioning_strategy='inject', conditioning_indices=[0, 1, 2],
        conditioning_architecture='AE', channels=[8, 4, 8],
        embedding_dim=8, h_dim=8, latent_dim=8, dropout=0.0,
        noise_steps=5, opt_lr=1e-3, batch_size=64, num_coords=2,
        num_transform=2, seg_stride=1, n_generated_samples=2,
        aggregation_strategy='best', model_return_value='loss',
        vid_res=[640, 360], normalization_strategy='robust',
        use_hr=False, validation=False, seed=7,
        filter_kernel_size=4, frames_shift=3, pad_size=-1,
        test_path=os.path.join(synth, 'testing', 'test_frame_mask'),
        gt_path=os.path.join(synth, 'testing', 'test_frame_mask'))
    base.update(kw)
    return base


def _cfg(synth, ckpt_dir, **kw):
    return Config(**_kw(synth, ckpt_dir, **kw))


@pytest.fixture(scope='module')
def fitted(synth, tmp_path_factory):
    """The train split's build saves the robust scaler the scorer loads."""
    cfg = _cfg(synth, tmp_path_factory.mktemp('serve_ckpt'))
    build_dataset(cfg, 'train')
    return cfg


def _net(cfg, seed=0):
    """A port network with seeded weights, and the same weights as the JAX
    package's variables tree."""
    variables = seeded_variables(jax_build_model(JaxConfig(**cfg.__dict__)),
                                 seed=seed)
    net = MoCoDADModel(cfg).build_net()
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    return net, variables


def _stream_test_split(scorer, synth):
    """Push the test split's raw CSV tracks in the offline loader's
    trajectory order."""
    trajs = T.load_trajectories(os.path.join(synth, 'testing',
                                             'trajectories'), split='test')
    for t in trajs.values():
        scene, clip = map(int, t.trajectory_id.split('_')[0].split('-'))
        for i in range(len(t)):
            scorer.push(scene, clip, int(t.person_id), int(t.frames[i]),
                        t.coordinates[i].reshape(-1, 2))


def _clips(cfg):
    out = []
    for f in sorted(f for f in os.listdir(cfg.gt_path) if f.endswith('.npy')):
        scene, clip = int(f.split('_')[0]), int(f.split('_')[1][:-4])
        out.append((scene, clip,
                    np.load(os.path.join(cfg.gt_path, f)).shape[0]))
    return out


@pytest.mark.parametrize('joint_kw, n_joints', [
    ({}, 17), (dict(kp18_format=True), 18), (dict(headless=True), 14),
    (dict(kp18_format=True, headless=True), 14)],
    ids=['plain', 'kp18', 'headless', 'kp18_headless'])
def test_streamed_windows_equal_offline(synth, fitted, joint_kw, n_joints):
    cfg = _cfg(synth, fitted.ckpt_dir, **joint_kw)
    ds = build_dataset(cfg, 'test')
    assert ds.data.shape[1:] == (2, 6, n_joints)
    scorer = StreamScorer(cfg, _net(cfg)[0], batch_size=32, **SCORER_KW)
    _stream_test_split(scorer, synth)
    sel = [i for i, tr in enumerate(scorer._q_trans) if tr == 0]
    np.testing.assert_array_equal(
        np.stack([scorer._q_data[i] for i in sel]), ds.data)
    np.testing.assert_array_equal(
        np.stack([scorer._q_meta[i] for i in sel]), ds.meta)
    np.testing.assert_array_equal(
        np.stack([scorer._q_frames[i] for i in sel]), ds.frames)
    assert scorer.pending == ds.data.shape[0] * cfg.num_transform


def test_finalize_matches_post_processing(synth, fitted):
    """The same fabricated window losses through the scorer's store and
    the offline chain give the same per-clip scores, exactly."""
    cfg = fitted
    ds = build_dataset(cfg, 'test')
    n = ds.num_samples
    losses = np.random.default_rng(0).gamma(2.0, 1.0,
                                            size=n * cfg.num_transform)
    trans = np.repeat(np.arange(cfg.num_transform), n).astype(np.int64)
    meta = np.concatenate([ds.meta] * cfg.num_transform)
    frames = np.concatenate([ds.frames] * cfg.num_transform)
    _, pds, _ = post_processing(
        losses, trans, meta, frames, gt_path=cfg.gt_path,
        num_transform=cfg.num_transform, dataset_name=cfg.dataset_choice,
        split='test', use_hr=False, pad_size=-1,
        filter_kernel_size=cfg.filter_kernel_size,
        frames_shift=cfg.frames_shift, return_scores=True)
    scorer = StreamScorer(cfg, _net(cfg)[0], batch_size=32, **SCORER_KW)
    for i in range(losses.shape[0]):
        r = scorer._scored[(int(meta[i, 0]), int(meta[i, 1]))]
        r['loss'].append(float(losses[i]))
        r['trans'].append(int(trans[i]))
        r['meta'].append(meta[i])
        r['frames'].append(frames[i])
    chunks = [scorer.finalize_clip(s, c, nf) for s, c, nf in _clips(cfg)]
    np.testing.assert_allclose(np.concatenate(chunks), pds, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Against the JAX StreamScorer: same weights, same per-flush noise
# ---------------------------------------------------------------------------

def _noise(batch_idx, rows, cfg):
    """(x0, zs) of one flush, from a NumPy seed of its flush index."""
    tc, steps = cfg.seg_len - 3, cfg.noise_steps - 1
    rng = np.random.default_rng(100 + batch_idx)
    return (rng.standard_normal((rows, 2, tc, 17)).astype(np.float32),
            rng.standard_normal((steps, rows, 2, tc, 17)).astype(np.float32))


def _pair(cfg, batch_size, **kw):
    """(port scorer, JAX scorer) on the same weights, each flush fed
    _noise(flush index) through its device step."""
    net, variables = _net(cfg, seed=3)
    rows = batch_size * cfg.n_generated_samples
    port = StreamScorer(cfg, net, batch_size=batch_size, **kw, **SCORER_KW)
    step = port._step
    port._step = lambda d, t, i: step(d, t, i, noise_override=tuple(
        torch.from_numpy(a) for a in _noise(i, rows, cfg)))

    jcfg = JaxConfig(**cfg.__dict__)
    jx = JaxStreamScorer(jcfg, variables=variables, batch_size=batch_size,
                         **kw)
    model, mats = jx.model, jnp.asarray(affine_transform_matrices(
        cfg.num_transform))

    @jax.jit
    def gen(v, data, trans, x0, zs):
        data = jax_affine(data, mats, trans)
        return model.generate(v, data, jax.random.key(0),
                              noise_override=(x0, zs))[1]

    jx._step = lambda v, data, trans, rng, i: gen(
        v, data, trans, *_noise(i, rows, cfg))
    return port, jx


def test_scores_match_jax(synth, fitted):
    cfg = fitted
    port, jx = _pair(cfg, batch_size=16, flush_every=16)
    _stream_test_split(port, synth)
    _stream_test_split(jx, synth)
    (s0, c0, n0), _ = _clips(cfg)
    np.testing.assert_allclose(port.partial_scores(s0, c0, n0),
                               jx.partial_scores(s0, c0, n0), RTOL, ATOL)
    assert port._batch_idx == jx._batch_idx > 2
    for scene, clip, nf in _clips(cfg):
        got = port.finalize_clip(scene, clip, nf)
        want = jx.finalize_clip(scene, clip, nf)
        assert got.shape == (nf,) and np.isfinite(got).all()
        assert got.max() > 0
        np.testing.assert_allclose(got, want, RTOL, ATOL)
    assert not port._scored and not port._tracks and port.pending == 0


def test_overload_at_the_same_push_as_jax(synth, fitted):
    """A queue cap below the batch: both scorers refuse the same pushes,
    and what they accept scores the same."""
    cfg = fitted
    port, jx = _pair(cfg, batch_size=16, max_queue_windows=10)
    rs = np.random.RandomState(4)
    refused = {'port': [], 'jax': []}
    for k in range(24):
        person, frame = k % 2, k // 2 + 1
        kp = rs.rand(17, 2).astype(np.float32) * 100 + 10
        for name, scorer, err in (('port', port, OverloadError),
                                  ('jax', jx, JaxOverloadError)):
            try:
                scorer.push(1, 1, person, frame, kp)
            except err:
                refused[name].append(k)
        if k == 17:
            port.flush(force=True)
            jx.flush(force=True)
    assert refused['port'] == refused['jax'] and refused['port']
    assert port.pending == jx.pending
    np.testing.assert_allclose(port.finalize_clip(1, 1, 16),
                               jx.finalize_clip(1, 1, 16), RTOL, ATOL)


# ---------------------------------------------------------------------------
# The port alone: guardrails, drop, overload and the in-flight bound
# ---------------------------------------------------------------------------

def _rand_kp(rs):
    return rs.uniform(100, 300, (17, 2)).astype(np.float32)


@pytest.mark.parametrize('kw, error', [
    (dict(num_coords=6), NotImplementedError),
    (dict(num_transform=0), NotImplementedError),
    (dict(diffusion_on_latent=True, stage='pretrain'), NotImplementedError),
    (dict(aggregation_strategy='all'), ValueError),
    (dict(use_hr=True), NotImplementedError),
    (dict(normalization_strategy='markovitz'), NotImplementedError)],
    ids=['global', 'old_aug', 'latent_pretrain', 'all', 'hr', 'json'])
def test_config_guardrails(synth, fitted, kw, error):
    with pytest.raises(error):
        StreamScorer(_cfg(synth, fitted.ckpt_dir, **kw), None, **SCORER_KW)


@pytest.mark.parametrize('knob', [
    dict(batch_size=0), dict(flush_every=0), dict(max_pending_batches=0),
    dict(max_queue_windows=1)])
def test_sizing_knobs_checked_before_build_and_restore(synth, fitted,
                                                       tmp_path, knob):
    """A bad knob raises ValueError before the device is resolved (the
    default 'cuda' would raise without a card), before the model build and
    before the restore of a checkpoint that does not exist."""
    cfg = _cfg(synth, tmp_path, load_ckpt='missing.ckpt')
    with pytest.raises(ValueError):
        StreamScorer(cfg, None, **knob)


def test_flush_every_stored_as_int(synth, fitted):
    cfg = fitted
    scorer = StreamScorer(cfg, _net(cfg)[0], batch_size=8, flush_every=7.9,
                          **SCORER_KW)
    assert scorer.flush_every == 7 and type(scorer.flush_every) is int
    rs = np.random.default_rng(0)
    for f in range(cfg.seg_len + 2):
        scorer.push(0, 0, 1, f + 1, _rand_kp(rs))
    # 3 windows x 2 views = 6 pending: below 7, nothing ran
    assert scorer.pending == 6 and not scorer._pending_dev
    scorer.push(0, 0, 1, cfg.seg_len + 3, _rand_kp(rs))
    assert scorer.pending == 0 and len(scorer._pending_dev) == 1


def test_pad_size_finalize_needs_gt_before_inference(synth, fitted):
    cfg = _cfg(synth, fitted.ckpt_dir, pad_size=2)
    scorer = StreamScorer(cfg, _net(cfg)[0], batch_size=8, **SCORER_KW)
    rs = np.random.default_rng(3)
    for f in range(cfg.seg_len):
        scorer.push(0, 0, 1, f + 1, _rand_kp(rs))
    pend = scorer.pending
    assert pend > 0
    with pytest.raises(ValueError):
        scorer.finalize_clip(0, 0, n_frames=10)
    assert scorer.pending == pend, 'a doomed finalize ran inference'


def test_drop_clip_drains_only_up_to_its_last_batch(synth, fitted):
    """Three batches in flight, the dropped clip in the first alone: one
    drain, the other two stay in flight; an unrelated clip drains none."""
    cfg = fitted
    scorer = StreamScorer(cfg, _net(cfg)[0], batch_size=4, **SCORER_KW)
    rs = np.random.default_rng(1)
    for clip in (5, 6, 7):
        for f in range(cfg.seg_len + 1):     # 2 windows x 2 views
            scorer.push(0, clip, 1, f + 1, _rand_kp(rs))
        scorer.flush()
    assert len(scorer._pending_dev) == 3
    scorer.drop_clip(0, 9)
    assert len(scorer._pending_dev) == 3
    scorer.drop_clip(0, 5)
    assert len(scorer._pending_dev) == 2
    assert (0, 5) not in scorer._scored and (0, 6) not in scorer._scored
    scorer.drop_clip(0, 7)
    assert not scorer._pending_dev and (0, 6) in scorer._scored


def test_drop_clip_frees_state(synth, fitted):
    cfg = fitted
    scorer = StreamScorer(cfg, _net(cfg)[0], batch_size=8, **SCORER_KW)
    rs = np.random.default_rng(0)
    for f in range(cfg.seg_len + 2):
        scorer.push(0, 0, 1, f + 1, _rand_kp(rs))
        scorer.push(0, 1, 1, f + 1, _rand_kp(rs))
    assert scorer.pending > 0
    scorer.drop_clip(0, 0)
    assert all(k[:2] != (0, 0) for k in scorer._tracks)
    assert (0, 0) not in scorer._scored
    assert all(not (int(m[0]) == 0 and int(m[1]) == 0)
               for m in scorer._q_meta), 'queued windows leaked'
    scores = scorer.finalize_clip(0, 1, n_frames=cfg.seg_len + 2)
    assert np.isfinite(scores).all()
    assert (0, 0) not in scorer._scored and not scorer._tracks


def test_push_rejects_wrong_arity_keypoints(synth, fitted):
    cfg = fitted
    scorer = StreamScorer(cfg, _net(cfg)[0], batch_size=8, **SCORER_KW)
    rs = np.random.default_rng(0)
    for f in range(3):
        scorer.push(0, 0, 1, f + 1, _rand_kp(rs))
    for bad in (np.zeros((0,), np.float32), np.zeros((17, 3), np.float32)):
        with pytest.raises(ValueError):
            scorer.push(0, 0, 1, 4, bad)
    with pytest.raises(ValueError):
        scorer.push(0, 0, 1, 0, np.full((17, 2), 150.0, np.float32))
    for f in range(3, cfg.seg_len + 2):
        scorer.push(0, 0, 1, f + 1, _rand_kp(rs))
    assert scorer.pending > 0


def test_inflight_bound_holds_at_launch_time(synth, fitted):
    """Sustained pushes with auto-flush: never more than
    max_pending_batches - 1 batches in flight when a batch launches, so
    never more than max_pending_batches after it; every window-view is
    scored once."""
    cfg = fitted
    scorer = StreamScorer(cfg, _net(cfg)[0], batch_size=8, flush_every=8,
                          max_pending_batches=2, **SCORER_KW)
    at_launch, max_seen = [], 0
    step = scorer._step

    def spy(*a, **k):
        at_launch.append(len(scorer._pending_dev))
        return step(*a, **k)

    scorer._step = spy
    rs = np.random.RandomState(3)
    for frame in range(1, 40):
        for person in range(2):
            scorer.push(1, 1, person, frame,
                        rs.rand(17, 2).astype(np.float32) * 100 + 10)
            max_seen = max(max_seen, len(scorer._pending_dev))
    assert at_launch and max(at_launch) <= 1 and max_seen <= 2
    scored = len(scorer._scored[(1, 1)]['loss']) + scorer.pending + \
        sum(b.n for b in scorer._pending_dev)
    assert scored == 2 * (39 - cfg.seg_len + 1) * cfg.num_transform
    scores = scorer.finalize_clip(1, 1, n_frames=40)
    assert scores.shape == (40,) and np.all(np.isfinite(scores))
    assert not scorer._pending_dev and not scorer._q_data


def test_warmup_frames_always_accepted_under_overload(synth, fitted):
    cfg = fitted
    scorer = StreamScorer(cfg, _net(cfg)[0], batch_size=32,
                          max_queue_windows=2, **SCORER_KW)
    rs = np.random.RandomState(7)

    def push(person, frame):
        scorer.push(1, 1, person, frame,
                    rs.rand(17, 2).astype(np.float32) * 100 + 10)

    for frame in range(1, 7):
        push(0, frame)
    assert scorer.pending == 2
    with pytest.raises(OverloadError):
        push(0, 7)
    for frame in range(1, 6):
        push(9, frame)
    assert scorer.pending == 2
    assert len(scorer._tracks[(1, 1, 9)].frames) == 5
    with pytest.raises(OverloadError):
        push(9, 6)


def test_overload_refusal_is_deterministic_and_recoverable(synth, fitted):
    cfg = fitted
    scorer = StreamScorer(cfg, _net(cfg)[0], batch_size=32,
                          max_queue_windows=6, **SCORER_KW)
    rs = np.random.RandomState(4)

    def push_frame(frame):
        scorer.push(1, 1, 0, frame,
                    rs.rand(17, 2).astype(np.float32) * 100 + 10)

    for frame in range(1, 9):
        push_frame(frame)
    assert scorer.pending == 6
    before = (len(scorer._tracks[(1, 1, 0)].frames), scorer.pending)
    with pytest.raises(OverloadError, match='max_queue_windows=6'):
        push_frame(9)
    assert (len(scorer._tracks[(1, 1, 0)].frames), scorer.pending) == before
    scorer.flush(force=True)
    assert scorer.pending == 0
    push_frame(9)
    assert scorer.pending == 2
    scores = scorer.finalize_clip(1, 1, n_frames=12)
    assert scores.shape == (12,) and np.all(np.isfinite(scores))


def test_restores_checkpoint_with_ema(synth, fitted, tmp_path):
    """net=None restores cfg.ckpt_dir/cfg.load_ckpt, the EMA weights under
    use_ema, and scores as the same weights passed in."""
    cfg = fitted
    net, _ = _net(cfg, seed=4)
    raw = {k: torch.zeros_like(v) for k, v in net.state_dict().items()}
    ckpt_dir = tmp_path
    torch.save({'state_dict': raw, 'state_dict_ema': net.state_dict()},
               ckpt_dir / 'ema.ckpt')
    for f in os.listdir(cfg.ckpt_dir):
        if f.endswith('.npz'):
            (ckpt_dir / f).write_bytes(
                open(os.path.join(cfg.ckpt_dir, f), 'rb').read())
    ecfg = _cfg(synth, ckpt_dir, load_ckpt='ema.ckpt', use_ema=True)
    restored = StreamScorer(ecfg, None, batch_size=16, **SCORER_KW)
    given = StreamScorer(ecfg, net, batch_size=16, **SCORER_KW)
    for k, v in given.net.state_dict().items():
        torch.testing.assert_close(restored.net.state_dict()[k], v,
                                   rtol=0, atol=0)
    rs = np.random.default_rng(2)
    for f in range(cfg.seg_len + 3):
        kp = _rand_kp(rs)
        restored.push(0, 0, 1, f + 1, kp)
        given.push(0, 0, 1, f + 1, kp)
    np.testing.assert_array_equal(restored.finalize_clip(0, 0, 12),
                                  given.finalize_clip(0, 0, 12))


def test_scorer_raises_without_cuda(synth, fitted):
    if torch.cuda.is_available():
        pytest.skip('CUDA is present: the default device is usable')
    cfg = fitted
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        StreamScorer(cfg, _net(cfg)[0])


def test_probe_overload_bounds_hold_on_cpu(synth, fitted):
    """tools/perf/probe_serve_latency.sustained_overload, which chip_smoke.py
    runs on the card at batch 256, at a small batch on the CPU over two
    replays of the test split: every push lands, the in-flight and queue
    bounds hold."""
    from mocodad_tpu_torch.tools.perf.probe_serve_latency import (
        stream_poses, sustained_overload, window_views)
    cfg = fitted
    poses = stream_poses(synth)
    r = sustained_overload(cfg, _net(cfg)[0], poses, batch=8, reps=2,
                           device='cpu')
    assert r['bounds_held'] and r['max_inflight'] == 2
    assert r['pushes'] == 2 * len(poses)
    # 2 views per window, so the queue meets the batch of 8 exactly: full
    # batches only, the last few views dropped with their clips
    n = window_views(poses, cfg.seg_len, cfg.num_transform)
    assert r['launches'] == 2 * n // 8
    assert r['max_inflight_at_launch'] == 1
    assert r['max_queue'] < 8 + cfg.num_transform


@pytest.mark.parametrize('policy', ['flush_every_256', 'end_clip',
                                    'whatif_plain_flush'])
def test_probe_policies_on_cpu(synth, fitted, policy, monkeypatch):
    """The probe's steady state at a batch of 8 on the CPU: the serve CLI's
    loop scores every window-view of each replay under each flush policy,
    and finalize_clip ends every clip with finite scores."""
    from mocodad_tpu_torch.tools.perf import probe_serve_latency as P
    monkeypatch.setattr(P, 'BATCH', 8)
    monkeypatch.setitem(P.POLICIES, 'flush_every_256', (8, False))
    cfg = fitted
    poses = P.stream_poses(synth)
    ends = P.clip_ends(poses, cfg.gt_path)
    assert len(ends) == len(_clips(cfg))
    seen = []
    clip_scores = StreamScorer._clip_scores

    def spy(self, key, n_frames, gt, smooth, pad_size=None):
        views = len(self._scored[key]['loss'])
        scores = clip_scores(self, key, n_frames, gt, smooth, pad_size)
        seen.append((key, views, scores))
        return scores

    monkeypatch.setattr(StreamScorer, '_clip_scores', spy)
    r, scorer = P.steady(cfg, _net(cfg)[0], poses, ends, policy, runs=1,
                         reps=2, device='cpu')
    n = P.window_views(poses, cfg.seg_len, cfg.num_transform)
    assert r['window_views'] == 2 * n
    # each clip of each replay ended once, its every window-view scored
    assert sorted(k for k, _, _ in seen) == sorted(
        (s + off, c) for s, c, _ in _clips(cfg) for off in (0, P.SCENE_STRIDE))
    assert sum(v for _, v, _ in seen) == 2 * n
    assert all(np.isfinite(x).all() and x.shape == (48,) for *_, x in seen)
    assert r['launches'] >= -(-2 * n // 8)
    assert not scorer._scored and not scorer._tracks and not scorer.pending
