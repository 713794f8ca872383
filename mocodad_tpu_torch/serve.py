"""Online (streaming) anomaly scoring on the card.

The port's counterpart of `mocodad_tpu/serve.py`.  A deployment receives
pose tracks frame by frame (for example from an AlphaPose + PoseFlow
tracker on a live camera) and needs per-frame anomaly scores with bounded
latency.  `StreamScorer` gives them with the offline path's semantics:

* per-actor ring buffers assemble seg_len sliding windows as frames
  arrive, with the offline robust path's per-frame normalization
  (bbox-centre coordinates through `data/trajectories._to_bbox_centre`,
  then the train split's persisted scaler), then the kp18 remap and the
  headless cut as `data/robust.robust_pose_windows` applies them, so
  streamed windows are bit-equal to the offline windows of the same track;
* every window is scored under every affine view;
* pending window-views are batched to a fixed `batch_size` (a forced
  partial batch is padded by repeating its last row, and the padding is
  dropped on drain), so each flush runs `MoCoDADModel.generate` over
  batch_size x S fold rows: on a CUDA device through the kernel B1
  (`ops/pallas_unet.denoise`) 9 times per flush at the flagship's 10
  noise steps.  The network is folded once (`model.fold`), so B1's plan is
  built once.  The latent variant's diffusion stage runs its latent chain
  (`models/mocodad_latent.py`), which launches no kernel and has nothing to
  fold; its pretrain stage has no per-window loss and is refused;
* `finalize_clip` runs the offline scoring chain (eval/harness.py
  clip_frame_scores, shift + gaussian smoothing, view averaging) over the
  clip's window losses.

Pipelining.  JAX dispatches asynchronously and fetches a batch's losses
with `np.asarray`, which waits on that batch alone.  Here a batch's data
goes to the card through pinned host memory (a copy from pageable memory
would block the host), and its losses come back into a pinned host buffer
with a non-blocking copy followed by a recorded CUDA event: draining the
oldest batch waits on its event, not on the batches launched after it.

Random draws.  One `torch.Generator` on the device, seeded as
`training/inference.run_inference` seeds its own (`EVAL_DOMAIN_TAG`), so
its draws follow flush order.  The JAX scorer folds the batch index into
its key instead (mocodad_tpu/serve.py:238, :253); the two packages' random
streams differ anyway, and the tests inject the same noise into both.

Backpressure and overload, as the JAX scorer (mocodad_tpu/serve.py:41-63):

* device side: at most `max_pending_batches` launched batches are in
  flight; `flush` drains the oldest before each further launch;
* host side: a `push` whose window-views would take the queue past
  `max_queue_windows` first dispatches full batches, then refuses with
  `OverloadError` before recording anything.  Warm-up frames of a track
  shorter than seg_len enqueue nothing and are always accepted;
* per-clip score accumulators grow with scored windows; `finalize_clip`
  and `drop_clip` release them.

tools/perf/probe_serve_latency.py measures throughput, flush latency and
the overload per-push latency on the card.
"""

from __future__ import annotations

import collections
import os
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mocodad_tpu_torch.config import Config
from mocodad_tpu_torch.data.json_pose import keypoints17_to_coco18
from mocodad_tpu_torch.data.prefetch import to_device
from mocodad_tpu_torch.data.robust import scaler_artifact_path
from mocodad_tpu_torch.data.scalers import load_scaler, scale_trajectories
from mocodad_tpu_torch.data.trajectories import _to_bbox_centre
from mocodad_tpu_torch.data.transforms import (affine_transform_matrices,
                                               apply_affine_batch)
from mocodad_tpu_torch.device import resolve_device
from mocodad_tpu_torch.eval.harness import clip_frame_scores
from mocodad_tpu_torch.eval.scoring import score_process
from mocodad_tpu_torch.models.mocodad import MoCoDADNet, build_model
from mocodad_tpu_torch.training.inference import EVAL_DOMAIN_TAG
from mocodad_tpu_torch.utils.weights import load_checkpoint_state_dict


class OverloadError(RuntimeError):
    """Raised by `StreamScorer.push` when the pending-window queue cannot
    fit the new window's views even after dispatching full batches: the
    caller must `flush(force=True)` (or drop clips) before retrying.  The
    refused pose is not recorded, so retrying the same (frame, keypoints)
    keeps the track's windows equal to the offline path's; shedding it
    makes every later window of that actor span a frame gap."""


class _Track:
    __slots__ = ('frames', 'coords')

    def __init__(self):
        self.frames: List[int] = []
        self.coords: List[np.ndarray] = []   # raw (V*2,) image coords


class _InFlight(NamedTuple):
    """A launched batch: its losses (a pinned host buffer being filled by
    a non-blocking copy on a CUDA device, the losses themselves on the
    CPU), the event recorded after that copy (None on the CPU), and the
    valid rows' views, meta and frames."""
    loss: torch.Tensor
    done: Optional[torch.cuda.Event]
    trans: np.ndarray
    meta: np.ndarray
    frames: np.ndarray
    n: int


class StreamScorer:
    """Streaming per-frame anomaly scoring with the offline path's semantics.

    Parameters
    ----------
    cfg: a finalized Config (the YAML the offline CLIs read).
    net: the network (`MoCoDADModel.build_net()` with its weights); it is
        moved to `device` and put in eval mode.  None restores
        `cfg.ckpt_dir/cfg.load_ckpt` (a `torch.save` file or the JAX
        package's msgpack), the EMA weights under `cfg.use_ema`, as the
        eval CLI does.
    batch_size: window-views per launch.
    flush_every: run a (padded) batch as soon as this many window-views
        pend; None flushes only on demand and at finalize.
    max_pending_batches: bound on launched, undrained batches; `flush`
        drains the oldest beyond it before launching.
    max_queue_windows: bound on the host queue in window-view entries
        (each accepted window enqueues num_transform of them); defaults to
        64 x batch_size.
    device: None means CUDA, and raises without it; 'cpu' runs on the CPU.
    """

    def __init__(self, cfg: Config, net: Optional[MoCoDADNet] = None,
                 batch_size: int = 256,
                 flush_every: Optional[int] = None,
                 max_pending_batches: int = 8,
                 max_queue_windows: Optional[int] = None,
                 device=None):
        if cfg.num_coords not in (2, 3):
            raise NotImplementedError(
                'StreamScorer supports the local-coordinate path '
                '(num_coords 2/3); global bbox features (num_coords=6) '
                'are offline-only for now')
        if cfg.normalization_strategy != 'robust':
            raise NotImplementedError(
                'StreamScorer normalizes via the robust CSV path; '
                f'got normalization_strategy={cfg.normalization_strategy!r}')
        if cfg.aggregation_strategy == 'all':
            # a (B, S) loss matrix per batch; scoring needs one per window
            raise ValueError(
                "aggregation_strategy 'all' produces per-sample loss "
                'vectors; StreamScorer needs a scalar-per-window strategy '
                "(e.g. 'best', 'mean')")
        if cfg.use_hr or cfg.dataset_choice == 'HR-Avenue':
            # HR evaluation masks frames before smoothing, an offline
            # construct (eval/harness.py post_processing)
            raise NotImplementedError(
                'StreamScorer scores the full frame timeline; HR-masked '
                'evaluation (use_hr / HR-Avenue) is offline-only — run '
                'eval_MoCoDAD_torch.py for HR-masked scores')
        if cfg.num_transform < 1:
            # old_aug scores random temporal crops at test time
            raise NotImplementedError(
                'StreamScorer requires num_transform >= 1; the offline '
                'old_aug path (num_transform < 1) applies random '
                'temporal crops at test time and has no streaming '
                'equivalent')
        # the sizing knobs, before the model build and the restore
        self.batch_size = int(batch_size)
        if self.batch_size < 1:
            raise ValueError('batch_size must be >= 1')
        self.flush_every = None if flush_every is None else int(flush_every)
        if self.flush_every is not None and self.flush_every < 1:
            raise ValueError('flush_every must be >= 1 (or None)')
        self.max_pending_batches = int(max_pending_batches)
        if self.max_pending_batches < 1:
            raise ValueError('max_pending_batches must be >= 1')
        self.num_transform = cfg.num_transform
        self.max_queue_windows = (64 * self.batch_size
                                  if max_queue_windows is None
                                  else int(max_queue_windows))
        if self.max_queue_windows < self.num_transform:
            raise ValueError('max_queue_windows must fit at least one '
                             f'window x its {self.num_transform} views')

        self.cfg = cfg
        self.model = build_model(cfg)
        if not self.model.servable:
            # the latent pretrain stage generates reconstructions with no
            # per-window loss (mocodad_tpu/serve.py:178-186)
            raise NotImplementedError(
                "StreamScorer needs a per-window loss; the latent "
                "variant's 'pretrain' stage returns reconstructions only "
                "- serve the 'diffusion' stage (or the base model)")
        self.device = resolve_device(device)
        if net is None:
            net = self.model.build_net()
            net.load_state_dict(load_checkpoint_state_dict(
                os.path.join(cfg.ckpt_dir, cfg.load_ckpt),
                use_ema=cfg.use_ema), strict=True)
        self.net = net.to(self.device).eval()
        # None for the latent model, which runs no kernel
        self._folded = self.model.fold(self.net)

        self.scaler = load_scaler(scaler_artifact_path(
            cfg.ckpt_dir, 'local', cfg.normalization_strategy))
        self.vid_res = np.asarray(cfg.vid_res, dtype=np.float32)
        self._mats = torch.as_tensor(
            affine_transform_matrices(self.num_transform), device=self.device)
        self.seg_len = cfg.seg_len

        self._tracks: Dict[Tuple[int, int, int], _Track] = \
            collections.defaultdict(_Track)
        # pending window-views awaiting inference
        self._q_data: List[np.ndarray] = []    # (C, T, V)
        self._q_trans: List[int] = []
        self._q_meta: List[np.ndarray] = []    # (4,)
        self._q_frames: List[np.ndarray] = []  # (T,)
        # scored results (host) per clip
        self._scored: Dict[Tuple[int, int], Dict[str, list]] = \
            collections.defaultdict(lambda: {'loss': [], 'trans': [],
                                             'meta': [], 'frames': []})
        self._pending_dev: List[_InFlight] = []
        self._rng = torch.Generator(device=self.device).manual_seed(
            (int(cfg.seed) << 24) ^ EVAL_DOMAIN_TAG)
        self._batch_idx = 0

    # -- device step -------------------------------------------------------

    def _step(self, data: torch.Tensor, trans: torch.Tensor, batch_idx: int,
              noise_override=None) -> torch.Tensor:
        """One batch's per-window losses on the device: the affine views,
        then `window_losses` on the folded network.  `batch_idx` is the flush
        order of the batch; the draws come from the scorer's generator in
        that order, or from `noise_override` (generate's) when a test
        wraps this method."""
        data = apply_affine_batch(data, self._mats, trans.long())
        _, loss = self.model.window_losses(self.net, data, self._rng,
                                           noise_override=noise_override,
                                           folded=self._folded)
        return loss

    def _fetch(self, loss: torch.Tensor
               ) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
        """Start the losses' copy to the host without waiting for it."""
        if loss.device.type != 'cuda':
            return loss, None
        host = torch.empty(loss.shape, dtype=loss.dtype, pin_memory=True)
        host.copy_(loss, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(loss.device))
        return host, done

    # -- ingestion ----------------------------------------------------------

    def push(self, scene: int, clip: int, person: int, frame: int,
             keypoints: np.ndarray) -> None:
        """Feed one actor's pose for one frame.

        keypoints: (17, 2) raw image coordinates (the CSV column layout,
        ref utils/data.py:219-236); zeros mark missing joints.  Windows
        are emitted over arrival positions as the offline windowing does
        (data/windows.py with the eval split's stride 1)."""
        kp = np.asarray(keypoints, dtype=np.float32)
        # checked before the overload check, so a malformed message fails
        # with ValueError and triggers no flush
        if kp.shape != (17, 2):
            raise ValueError(
                f'keypoints must have shape (17, 2) (the CSV trajectory '
                f'layout, ref utils/data.py:219-236); got {kp.shape}')
        frame = int(frame)
        if frame < 1:
            # the scoring scatter writes at column frame-1: frame 0 would
            # wrap to the last column
            raise ValueError(
                f'frame numbers are 1-indexed (reference CSV contract, '
                f'ref utils/eval_utils.py:27-34); got {frame}')
        tr0 = self._tracks.get((scene, clip, person))
        would_enqueue = (len(tr0.frames) if tr0 is not None
                         else 0) >= self.seg_len - 1
        if (would_enqueue and len(self._q_data) + self.num_transform
                > self.max_queue_windows):
            self.flush()
            if (len(self._q_data) + self.num_transform
                    > self.max_queue_windows):
                raise OverloadError(
                    f'pending-window queue at {len(self._q_data)} '
                    f'(max_queue_windows={self.max_queue_windows}); '
                    'flush(force=True) runs a padded partial batch, or '
                    'finalize_clip()/drop_clip() to release state, '
                    'before retrying (a plain flush() is a no-op below '
                    'batch_size)')
        tr = self._tracks[(scene, clip, person)]
        tr.frames.append(frame)
        tr.coords.append(kp.reshape(-1))
        if len(tr.frames) > self.seg_len:
            del tr.frames[0], tr.coords[0]
        if len(tr.frames) == self.seg_len:
            self._enqueue_window(scene, clip, person, tr)
        if (self.flush_every is not None
                and len(self._q_data) >= self.flush_every):
            self.flush(force=True)

    def _enqueue_window(self, scene: int, clip: int, person: int,
                        tr: _Track) -> None:
        raw = np.stack(tr.coords)                           # (T, V*2)
        local = _to_bbox_centre(raw, self.vid_res)
        scaled, _ = scale_trajectories(local[None], scaler=self.scaler,
                                       strategy='robust')
        t, v = self.seg_len, raw.shape[1] // 2
        window = np.empty((t, v, 3), dtype=np.float32)
        window[..., :2] = scaled[0].reshape(t, v, 2)
        window[..., 2] = 1.0
        if self.cfg.kp18_format and v == 17:
            window = keypoints17_to_coco18(window)
        if self.cfg.headless:
            window = window[:, :14]
        data = np.transpose(window, (2, 0, 1))[:self.cfg.num_coords]

        meta = np.array([scene, clip, person, tr.frames[0]], dtype=np.int64)
        frames = np.asarray(tr.frames, dtype=np.int32)
        for trans in range(self.num_transform):
            self._q_data.append(data)
            self._q_trans.append(trans)
            self._q_meta.append(meta)
            self._q_frames.append(frames)

    # -- inference ----------------------------------------------------------

    @property
    def pending(self) -> int:
        return len(self._q_data)

    def flush(self, force: bool = False) -> None:
        """Launch the pending window-views in batches of batch_size; with
        force=True a final partial batch is padded to batch_size and its
        padding dropped on drain.  Returns without waiting on the card,
        except to drain the oldest batch beyond max_pending_batches."""
        b = self.batch_size
        while len(self._q_data) >= b or (force and self._q_data):
            n = min(b, len(self._q_data))
            data = np.stack(self._q_data[:n])
            trans = np.asarray(self._q_trans[:n], dtype=np.int64)
            meta = np.stack(self._q_meta[:n])
            frames = np.stack(self._q_frames[:n])
            del self._q_data[:n], self._q_trans[:n]
            del self._q_meta[:n], self._q_frames[:n]
            if n < b:
                pad = b - n
                data = np.concatenate([data, np.repeat(data[-1:], pad, 0)])
                trans = np.concatenate([trans,
                                        np.repeat(trans[-1:], pad, 0)])
            while len(self._pending_dev) >= self.max_pending_batches:
                # drain BEFORE the launch, so no more than
                # max_pending_batches are ever in flight
                self._drain_one()
            loss = self._step(to_device(data, self.device),
                              to_device(trans, self.device), self._batch_idx)
            self._batch_idx += 1
            self._pending_dev.append(_InFlight(*self._fetch(loss), trans[:n],
                                               meta, frames, n))

    def _drain_one(self) -> None:
        batch = self._pending_dev.pop(0)
        if batch.done is not None:
            batch.done.synchronize()        # this batch's copy alone
        loss = batch.loss.numpy()[:batch.n]
        for i in range(batch.n):
            r = self._scored[(int(batch.meta[i, 0]), int(batch.meta[i, 1]))]
            r['loss'].append(float(loss[i]))
            r['trans'].append(int(batch.trans[i]))
            r['meta'].append(batch.meta[i])
            r['frames'].append(batch.frames[i])

    def _drain(self) -> None:
        while self._pending_dev:
            self._drain_one()

    # -- scoring ------------------------------------------------------------

    def _clip_scores(self, key: Tuple[int, int], n_frames: int,
                     gt: Optional[np.ndarray], smooth: bool,
                     pad_size: Optional[int] = None) -> np.ndarray:
        r = self._scored.get(key)
        if r is None or not r['loss']:
            return np.zeros(n_frames)
        loss = np.asarray(r['loss'])
        trans = np.asarray(r['trans'])
        meta = np.stack(r['meta'])
        frames = np.stack(r['frames'])
        if pad_size is None:
            pad_size = self.cfg.pad_size
        per_view = []
        for transformation in range(self.num_transform):
            c = trans == transformation
            s = clip_frame_scores(loss[c], meta[c], frames[c], n_frames,
                                  gt=gt, pad_size=pad_size)
            if smooth:
                s = score_process(s, self.cfg.frames_shift,
                                  self.cfg.filter_kernel_size)
            per_view.append(s)
        return np.mean(np.stack(per_view, 0), 0)

    def partial_scores(self, scene: int, clip: int, n_frames: int
                       ) -> np.ndarray:
        """Provisional per-frame scores mid-clip (no absence padding or
        smoothing, which are clip-global).  Scores of recent frames still
        rise as later windows cover them."""
        self.flush(force=True)
        self._drain()
        return self._clip_scores((scene, clip), n_frames, gt=None,
                                 smooth=False, pad_size=-1)

    def finalize_clip(self, scene: int, clip: int, n_frames: int,
                      gt: Optional[np.ndarray] = None) -> np.ndarray:
        """Per-frame scores of a finished clip through the full offline
        chain (actor nanmax scatter, optional absence padding, mean +
        log1p amplitude, shift + gaussian smoothing, view averaging; ref
        models/mocodad.py:386-424).  Frees the clip's buffers."""
        # checked before any flush, so a doomed call runs no inference
        if self.cfg.pad_size != -1 and gt is None:
            raise ValueError('cfg.pad_size != -1: pass the gt mask (the '
                             'reference takes absence intervals from it)')
        self.flush(force=True)
        self._drain()
        scores = self._clip_scores((scene, clip), n_frames, gt=gt,
                                   smooth=True)
        self.drop_clip(scene, clip)
        return scores

    def drop_clip(self, scene: int, clip: int) -> None:
        """Free a clip's state without scoring it, at every stage a window
        can be in: queued host windows, in-flight batches (drained up to
        the last one that holds the clip, so its results land and are
        discarded), scored results and per-actor track buffers."""
        keep = [i for i, m in enumerate(self._q_meta)
                if not (int(m[0]) == scene and int(m[1]) == clip)]
        if len(keep) != len(self._q_meta):
            self._q_data = [self._q_data[i] for i in keep]
            self._q_trans = [self._q_trans[i] for i in keep]
            self._q_meta = [self._q_meta[i] for i in keep]
            self._q_frames = [self._q_frames[i] for i in keep]
        holds = [bool(np.any((b.meta[:b.n, 0] == scene)
                             & (b.meta[:b.n, 1] == clip)))
                 for b in self._pending_dev]
        if any(holds):
            for _ in range(len(holds) - holds[::-1].index(True)):
                self._drain_one()
        self._scored.pop((scene, clip), None)
        for key in [k for k in self._tracks
                    if k[0] == scene and k[1] == clip]:
            del self._tracks[key]
