"""The streaming scorer's throughput and latency on the card
(mocodad_tpu_torch/serve.py), at the flagship's sampling settings: 50
samples x 9 DDPM steps, 5 affine views per window, batches of 256
window-views (12,800 fold rows per launch of B1).

    python3 -m mocodad_tpu_torch.tools.perf.probe_serve_latency
    python3 -m mocodad_tpu_torch.tools.perf.probe_serve_latency \\
        --dtype bfloat16

Traffic: the synthetic test split that chip_smoke.py serves
(data/synthetic.py, seed 0: 2 scenes x 3 clips x 3 actors, tracks of
90-116 frames; 1,845 poses, 8,775 window-views), its poses in arrival
order (frame by frame across the 18 tracks of the 6 clips), and each clip
ended by finalize_clip right after its last pose, as the serve CLI does
on an `end_clip` line.  A run replays the split REPS = 3 times with the
scenes renumbered, so every replay streams new clips.  The JSON lines
themselves are not parsed here (chip_smoke.py's serve_cli runs the CLI).

Reports, for each eval_dtype asked for:
  * steady state, window-views per second of every one of RUNS = 3 runs
    and their spread (max / min - 1), under the serve CLI's two flush
    policies:
      flush_every_256  `--flush-every 256`: a forced flush as soon as 256
                       window-views pend (the views past 256 go out as a
                       padded batch of their own, the JAX scorer's rule);
      end_clip         the CLI's default: windows queue until a clip
                       ends, and its finalize_clip flushes them all;
    and, as a what-if only (ROADMAP D1; no entry point flushes so), a
    plain flush() after every frame, which launches full batches only;
  * end_clip latency: finalize_clip's ms as the CLI calls it (the flush
    and the drain of what is pending included), p50 and max, per policy;
  * finalize_clip's ms on one clip of the split with its batches already
    drained (the host scoring alone), p50 and max over the split's clips;
  * where the time of a flush_every_256 run goes: the host seconds inside
    the device steps (`_step`), inside the drains (`_drain_one`) and in
    the rest, then the same run under torch.profiler (device busy ms,
    idle share, the host's largest calls by their own time);
  * per-flush latency with one batch pending (240 window-views of the
    split padded to 256): flush(force=True) and the drain, p50 / min /
    max over 9 flushes;
  * sustained overload: one replay pushed as fast as the host makes the
    pushes with flush_every = 256 and max_pending_batches = 2; per-push
    p50, p99 and max, and the largest in-flight count and host queue
    seen, which must stay within their bounds (2 batches; batch_size + 5
    window-views).
Weights are seeded, the scaler is fitted on the split's training part;
the card's name and power limit head the output.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mocodad_tpu_torch.config import Config, flagship_config
from mocodad_tpu_torch.data import build_dataset, synthetic
from mocodad_tpu_torch.data import trajectories as T
from mocodad_tpu_torch.device import resolve_device
from mocodad_tpu_torch.models.mocodad import MoCoDADModel, seeded_state
from mocodad_tpu_torch.serve import StreamScorer

BATCH = 256
VIEWS = 5
SCENE_STRIDE = 1000     # replay r streams scene s as s + r * SCENE_STRIDE
RUNS, REPS = 3, 3       # timed runs per policy, replays of the split per run
# policy -> (flush_every, a plain flush() after every frame)
POLICIES = {'flush_every_256': (BATCH, False), 'end_clip': (None, False),
            'whatif_plain_flush': (None, True)}


def make_split(work: str) -> str:
    """chip_smoke.py's synthetic dataset under `work`; returns its root."""
    data_dir = os.path.join(work, 'data')
    synthetic.generate(data_dir, seed=0, n_scenes=2, n_clips_per_split=3,
                       n_actors=3, n_frames=120)
    return data_dir


def serve_config(data_dir: str, ckpt_dir: str, eval_dtype: str) -> Config:
    """The flagship architecture at the test-time sampling settings, with
    the robust scaler fitted on the split's training part and saved under
    `ckpt_dir`."""
    cfg = flagship_config(
        split='test', n_generated_samples=50, num_transform=VIEWS,
        data_dir=data_dir, ckpt_dir=ckpt_dir,
        gt_path=os.path.join(data_dir, 'testing', 'test_frame_mask'),
        vid_res=[640, 360], use_hr=False)
    cfg.extras['eval_dtype'] = eval_dtype
    os.makedirs(ckpt_dir, exist_ok=True)
    build_dataset(cfg, split='train')      # fits + saves the scaler
    return cfg


def stream_poses(data_dir: str):
    """The test split's raw CSV poses as (scene, clip, person, frame,
    keypoints), frame by frame across every track, as trackers on live
    cameras send them."""
    trajs = T.load_trajectories(os.path.join(data_dir, 'testing',
                                             'trajectories'), split='test')
    out = []
    for t in trajs.values():
        scene, clip = map(int, t.trajectory_id.split('_')[0].split('-'))
        for i in range(len(t)):
            out.append((int(t.frames[i]), scene, clip, int(t.person_id),
                        t.coordinates[i].reshape(-1, 2).astype(np.float32)))
    out.sort(key=lambda r: r[:4])
    return [(s, c, p, f, kp) for f, s, c, p, kp in out]


def clip_ends(poses, gt_path: str) -> Dict[int, int]:
    """The index of each clip's last pose -> the clip's frame count (its
    gt mask's length), where the serve CLI's `end_clip` line comes."""
    last = {(s, c): i for i, (s, c, _, _, _) in enumerate(poses)}
    return {i: np.load(os.path.join(gt_path, f'{s}_{c}.npy')).shape[0]
            for (s, c), i in last.items()}


def window_views(poses, seg_len: int, views: int) -> int:
    """Window-views one replay of `poses` enqueues: each track's windows
    over its arrival positions (stride 1) times the views."""
    n: Dict[tuple, int] = {}
    for s, c, p, _, _ in poses:
        n[(s, c, p)] = n.get((s, c, p), 0) + 1
    return views * sum(max(0, k - seg_len + 1) for k in n.values())


def sync(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def warm(scorer: StreamScorer) -> None:
    """B1's plan for the scorer's fold, built before anything is timed."""
    cfg, b = scorer.cfg, scorer.batch_size
    scorer._step(torch.zeros((b, cfg.num_coords, cfg.seg_len, cfg.n_joints),
                             device=scorer.device),
                 torch.zeros(b, dtype=torch.long, device=scorer.device), -1)
    sync(scorer.device)


def serve_run(scorer: StreamScorer, poses, ends: Dict[int, int], reps: int,
              per_frame: bool, end_ms: Optional[List[float]] = None) -> None:
    """The serve CLI's loop over `reps` replays of `poses`: each pose
    pushed as it arrives, each clip finalized right after its last pose
    (with its ms in `end_ms`), and with `per_frame` a plain flush() before
    each new frame's poses."""
    for r in range(reps):
        off, frame = r * SCENE_STRIDE, None
        for i, (s, c, p, f, kp) in enumerate(poses):
            if per_frame and f != frame:
                scorer.flush()
                frame = f
            scorer.push(s + off, c, p, f, kp)
            if i in ends:
                t0 = time.perf_counter()
                scorer.finalize_clip(s + off, c, ends[i])
                if end_ms is not None:
                    end_ms.append((time.perf_counter() - t0) * 1e3)


def steady(cfg: Config, net, poses, ends: Dict[int, int], policy: str,
           runs: int, reps: int, device='cuda'
           ) -> Tuple[Dict, StreamScorer]:
    """`runs` timed runs of `reps` replays under one flush policy, on one
    warmed scorer: every run's window-views/s, their spread, B1's launches
    per run and the end_clip latency's p50 and max; and the scorer."""
    flush_every, per_frame = POLICIES[policy]
    scorer = StreamScorer(cfg, net, batch_size=BATCH, flush_every=flush_every,
                          device=device)
    warm(scorer)
    n = reps * window_views(poses, cfg.seg_len, cfg.num_transform)
    rates, end_ms, launched = [], [], scorer._batch_idx
    for _ in range(runs):
        sync(device)
        t0 = time.perf_counter()
        serve_run(scorer, poses, ends, reps, per_frame, end_ms)
        rates.append(n / (time.perf_counter() - t0))
    end_ms = np.sort(end_ms)
    return dict(window_views=n, launches=(scorer._batch_idx - launched) // runs,
                window_views_per_s=json.dumps([round(r, 1) for r in rates]),
                spread=max(rates) / min(rates) - 1,
                end_clip_p50_ms=float(end_ms[len(end_ms) // 2]),
                end_clip_max_ms=float(end_ms[-1])), scorer


def finalize_only(scorer: StreamScorer, poses, ends: Dict[int, int]
                  ) -> Dict:
    """One replay pushed and drained, then each clip's finalize_clip
    timed: the host scoring chain of one clip of the split alone."""
    off = SCENE_STRIDE * 100
    for s, c, p, f, kp in poses:
        scorer.push(s + off, c, p, f, kp)
    scorer.flush(force=True)
    scorer._drain()
    ms, finite = [], True
    for i, n_frames in ends.items():
        s, c = poses[i][:2]
        t0 = time.perf_counter()
        scores = scorer.finalize_clip(s + off, c, n_frames)
        ms.append((time.perf_counter() - t0) * 1e3)
        finite = finite and bool(np.isfinite(scores).all())
    ms = np.sort(ms)
    return dict(finalize_clips=len(ms), finalize_p50_ms=float(ms[len(ms) // 2]),
                finalize_max_ms=float(ms[-1]), finalize_finite=finite)


def flush_latency(scorer: StreamScorer, poses, n: int = 10) -> Dict:
    """flush(force=True) and the drain, each time 240 window-views pend
    (no auto-flush); the first of the `n` is dropped."""
    off, lat, pending = SCENE_STRIDE * 200, [], 0
    clips = set()
    for s, c, p, f, kp in poses:
        scorer.push(s + off, c, p, f, kp)
        clips.add((s + off, c))
        if scorer.pending >= BATCH - 16:
            pending = scorer.pending
            sync(scorer.device)
            t0 = time.perf_counter()
            scorer.flush(force=True)
            scorer._drain()
            lat.append(time.perf_counter() - t0)
            if len(lat) == n:
                break
    for s, c in clips:
        scorer.drop_clip(s, c)
    lat = np.sort(lat[1:]) * 1e3
    return dict(flush_window_views=pending, flush_p50_ms=float(
        lat[len(lat) // 2]), flush_min_ms=float(lat[0]),
        flush_max_ms=float(lat[-1]))


def sustained_overload(cfg: Config, net, poses, batch: int = BATCH,
                       reps: int = 1, device='cuda') -> Dict:
    """Pushes `reps` replays of `poses` as fast as the host makes them
    (auto-flush at every full batch, at most 2 batches in flight), no clip
    ended.  Returns the per-push seconds' p50, p99 and max, the largest
    in-flight count seen after a push and at a launch, the largest host
    queue, and whether the bounds held."""
    scorer = StreamScorer(cfg, net, batch_size=batch, flush_every=batch,
                          max_pending_batches=2, device=device)
    at_launch = []
    step = scorer._step

    def spy(*a, **k):
        at_launch.append(len(scorer._pending_dev))
        return step(*a, **k)

    scorer._step = spy
    lat, inflight, queue, clips = [], 0, 0, set()
    for r in range(reps):
        off = r * SCENE_STRIDE
        for s, c, p, f, kp in poses:
            t0 = time.perf_counter()
            scorer.push(s + off, c, p, f, kp)
            lat.append(time.perf_counter() - t0)
            inflight = max(inflight, len(scorer._pending_dev))
            queue = max(queue, scorer.pending)
            clips.add((s + off, c))
    launches = len(at_launch)
    for s, c in clips:
        scorer.drop_clip(s, c)
    views = cfg.num_transform
    lat = np.sort(np.asarray(lat))
    return dict(pushes=len(lat), launches=launches,
                p50_ms=float(lat[len(lat) // 2] * 1e3),
                p99_ms=float(lat[int(len(lat) * 0.99)] * 1e3),
                max_ms=float(lat[-1] * 1e3), max_inflight=inflight,
                max_inflight_at_launch=max(at_launch, default=0),
                max_queue=queue,
                bounds_held=(inflight <= 2 and max(at_launch, default=0) <= 1
                             and queue < batch + views))


def where_the_time_goes(scorer: StreamScorer, poses, ends: Dict[int, int],
                        reps: int) -> Dict:
    """A run of the scorer's policy once more, with the host seconds
    inside the device steps (`_step`: staging done, generate's launches),
    inside the drains (`_drain_one`: waiting on a batch's event) and in
    the rest (pushes, window assembly, batching, scoring), then once more
    under torch.profiler: the device's busy ms and idle share, and the
    host's largest calls by their own time (CUDA runtime calls among
    them)."""
    from torch.profiler import ProfilerActivity, profile
    spent = {'step': 0.0, 'drain': 0.0}
    step, drain = scorer._step, scorer._drain_one

    def timed(key, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[key] += time.perf_counter() - t0
        return run

    scorer._step, scorer._drain_one = timed('step', step), \
        timed('drain', drain)
    sync(scorer.device)
    t0 = time.perf_counter()
    serve_run(scorer, poses, ends, reps, per_frame=False)
    seconds = time.perf_counter() - t0
    scorer._step, scorer._drain_one = step, drain
    out = dict(split_seconds=seconds, split_step_seconds=spent['step'],
               split_drain_seconds=spent['drain'],
               split_other_seconds=seconds - spent['step'] - spent['drain'])

    sync(scorer.device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve_run(scorer, poses, ends, reps, per_frame=False)
        seconds = time.perf_counter() - t0
    device_ms, host = 0.0, {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device_ms += e.self_device_time_total / 1e3
        else:
            host[e.key[:40]] = e.self_cpu_time_total / 1e3
    top = sorted(host.items(), key=lambda kv: -kv[1])[:8]
    out.update(profiled_seconds=seconds, device_busy_ms=device_ms,
               idle_share=1 - device_ms / (seconds * 1e3),
               host_top_ms=json.dumps([[k, round(v, 1)] for k, v in top]))
    return out


def measure(eval_dtype: str, data_dir: str, work: str, runs: int,
            reps: int, device='cuda') -> Dict:
    """Every number of the probe at one eval_dtype, on the card."""
    cfg = serve_config(data_dir, work, eval_dtype)
    net = seeded_state(MoCoDADModel(cfg).build_net(), seed=0)
    poses = stream_poses(data_dir)
    ends = clip_ends(poses, cfg.gt_path)

    # warm-up: cuDNN and the allocators, over one replay
    scorer = StreamScorer(cfg, net, batch_size=BATCH, device=device)
    warm(scorer)
    serve_run(scorer, poses, ends, 1, per_frame=False)

    out = {}
    for policy in POLICIES:
        r, scorer = steady(cfg, net, poses, ends, policy, runs, reps,
                           device)
        out.update({f'{policy}_{k}': v for k, v in r.items()})
        if policy == 'flush_every_256':
            out.update(where_the_time_goes(scorer, poses, ends, reps))
        elif policy == 'end_clip':
            out.update(finalize_only(scorer, poses, ends))
            out.update(flush_latency(scorer, poses))
    out.update({f'overload_{k}': v for k, v in
                sustained_overload(cfg, net, poses,
                                   device=device).items()})
    return out


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--dtype', choices=('float32', 'bfloat16', 'both'),
                   default='both')
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('probe_serve_latency: needs a CUDA device')
    resolve_device('cuda')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f'card: {card}', flush=True)
    dtypes = ('float32', 'bfloat16') if args.dtype == 'both' \
        else (args.dtype,)
    with tempfile.TemporaryDirectory(prefix='serve_probe_') as work:
        data_dir = make_split(work)
        for dtype in dtypes:
            r = measure(dtype, data_dir, os.path.join(work, dtype), RUNS,
                        REPS)
            print(f'[serve_probe] dtype={dtype} batch={BATCH} '
                  f'runs={RUNS} reps={REPS} ' +
                  ' '.join(f'{k}={v:.4f}' if isinstance(v, float)
                           else f'{k}={v}' for k, v in r.items()),
                  flush=True)
            if not (r['overload_bounds_held'] and r['finalize_finite']):
                raise SystemExit(f'probe_serve_latency ({dtype}): bounds '
                                 'not held or scores not finite')


if __name__ == '__main__':
    main()
