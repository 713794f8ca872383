"""Streaming anomaly-scoring service with the PyTorch port (the counterpart
of serve_MoCoDAD.py: the same JSON-lines protocol, error lines and
startup checks).

    python serve_MoCoDAD_torch.py -c config/UBnormal/mocodad_test.yaml \\
        < poses.jsonl > scores.jsonl
    python serve_MoCoDAD_torch.py -c <config> --device cpu < poses.jsonl

Reads a JSON-lines pose stream on stdin and writes per-frame anomaly
scores per clip on stdout.  One JSON object per line:

  in:  {"type": "pose", "scene": 0, "clip": 1, "person": 2,
        "frame": 17, "keypoints": [[x, y], ... 17 entries ...]}
  in:  {"type": "end_clip", "scene": 0, "clip": 1, "n_frames": 60}
  out: {"type": "scores", "scene": 0, "clip": 1, "scores": [...]}
  out: {"type": "error", "error": "overloaded", "scene": 0, "clip": 1,
        "person": 2, "frame": 17, "detail": "..."}

An "overloaded" line means the scorer refused that pose at ingestion (the
host queue is at --max-queue-windows) and did not record it; a producer
that retries the same (frame, keypoints) later keeps the track's windows
equal to the offline path's.  Malformed lines and messages are reported on
stderr and skipped; the service keeps running.  With pad_size != -1 the gt
mask of each clip is read from cfg.gt_path, as the offline scorer does.

The checkpoint (ckpt_dir/load_ckpt) is a `torch.save` file or a JAX-package
msgpack checkpoint.  The default device is the GPU, and the script exits
with an error when CUDA is absent unless --device cpu is given.
"""

import argparse
import json
import os
import sys


def serve(cfg, fin, fout, batch_size: int, flush_every,
          max_queue_windows=None, device=None) -> None:
    """Run the protocol from `fin` to `fout` until `fin` ends."""
    import numpy as np

    from mocodad_tpu_torch.serve import OverloadError, StreamScorer

    scorer = StreamScorer(cfg, batch_size=batch_size,
                          flush_every=flush_every,
                          max_queue_windows=max_queue_windows, device=device)

    def emit(obj) -> None:
        fout.write(json.dumps(obj) + '\n')
        fout.flush()

    for line in fin:
        line = line.strip()
        if not line:
            continue
        try:
            msg = json.loads(line)
            if not isinstance(msg, dict):
                raise ValueError('message must be a JSON object')
        except ValueError as e:
            print(f'skipping malformed line ({e}): {line[:120]}',
                  file=sys.stderr)
            continue
        kind = msg.get('type')
        if kind == 'pose':
            # missing keys, non-numeric ids or ragged keypoints skip this
            # message, not the service
            try:
                scorer.push(int(msg['scene']), int(msg['clip']),
                            int(msg['person']), int(msg['frame']),
                            np.asarray(msg['keypoints'], dtype=np.float32))
            except OverloadError as e:
                emit({'type': 'error', 'error': 'overloaded',
                      'scene': msg.get('scene'), 'clip': msg.get('clip'),
                      'person': msg.get('person'),
                      'frame': msg.get('frame'), 'detail': str(e)})
            except (KeyError, TypeError, ValueError) as e:
                print(f'skipping malformed pose message ({e}): {line[:120]}',
                      file=sys.stderr)
        elif kind == 'end_clip':
            try:
                scene, clip = int(msg['scene']), int(msg['clip'])
                n_frames = int(msg['n_frames'])
            except (KeyError, TypeError, ValueError) as e:
                print(f'skipping malformed end_clip message ({e}): '
                      f'{line[:120]}', file=sys.stderr)
                continue
            gt = None
            if cfg.pad_size != -1:
                # a missing or corrupt mask fails this clip, not the service
                try:
                    gt = np.load(os.path.join(cfg.gt_path,
                                              f'{scene}_{clip}.npy'))
                except (OSError, ValueError) as e:
                    print(f'cannot load gt mask for clip {scene}_{clip}: '
                          f'{e}', file=sys.stderr)
                    scorer.drop_clip(scene, clip)
                    emit({'type': 'error', 'scene': scene, 'clip': clip,
                          'error': 'gt mask unavailable for absence '
                                   'padding'})
                    continue
            scores = scorer.finalize_clip(scene, clip, n_frames, gt=gt)
            emit({'type': 'scores', 'scene': scene, 'clip': clip,
                  'scores': [round(float(s), 6) for s in scores]})
        else:
            print(f'ignoring unknown message type {kind!r}',
                  file=sys.stderr)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description='MoCoDAD streaming scorer (PyTorch)')
    parser.add_argument('-c', '--config', type=str, required=True)
    parser.add_argument('--batch-size', type=int, default=256,
                        help='window-views per launch')
    parser.add_argument('--flush-every', type=int, default=None,
                        help='run inference once this many window-views '
                             'are pending (default: only at end_clip)')
    parser.add_argument('--max-queue-windows', type=int, default=None,
                        help='host-side pending queue cap in window-view '
                             'entries (default: 64 x batch-size); pushes '
                             'beyond it are refused with an "overloaded" '
                             'error line instead of growing memory')
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    from mocodad_tpu_torch.config import (add_eval_profile_arg,
                                          apply_eval_profile, load_config)
    add_eval_profile_arg(parser)
    cli = parser.parse_args(argv)

    if (cli.max_queue_windows is not None
            and cli.max_queue_windows < cli.batch_size):
        # a plain flush() only runs full batches, so a cap below the batch
        # would refuse every push past it: a sizing error, not load
        parser.error(
            f'--max-queue-windows ({cli.max_queue_windows}) must be >= '
            f'--batch-size ({cli.batch_size}): a cap below the static '
            'batch can never fill a batch, so every push past the cap '
            'would be refused')

    cfg = load_config(cli.config)
    apply_eval_profile(cfg, cli.eval_profile)
    serve(cfg, sys.stdin, sys.stdout, cli.batch_size, cli.flush_every,
          max_queue_windows=cli.max_queue_windows, device=cli.device)


if __name__ == '__main__':
    main()
