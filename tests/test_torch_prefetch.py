"""The port's batch prefetcher (mocodad_tpu_torch/data/prefetch.py), held to
what tests/test_prefetch.py asks of the JAX package's: order, the placement
hook in the producer thread, a prompt stop when the consumer walks away,
and the producer's errors raised to the consumer; and `run_inference`
behind it, which gives per-window losses equal to a loop without it."""

import threading
import time

import numpy as np
import pytest
import torch

from _torch_port import torch_model
from mocodad_tpu_torch.data import (PoseWindows, affine_transform_matrices,
                                    apply_affine_batch, make_loader)
from mocodad_tpu_torch.data.prefetch import prefetch, to_device
from mocodad_tpu_torch.models.mocodad import seeded_state
from mocodad_tpu_torch.training.inference import run_inference

torch.set_num_threads(1)


def test_prefetch_preserves_order_and_content():
    batches = [{'x': np.full((2,), i)} for i in range(10)]
    out = list(prefetch(iter(batches), depth=3))
    assert [int(b['x'][0]) for b in out] == list(range(10))


def test_prefetch_place_runs_in_producer():
    main = threading.get_ident()
    seen = []

    def place(b):
        seen.append(threading.get_ident())
        return {'x2': b['x'] * 2}

    batches = [{'x': np.ones(2) * i} for i in range(5)]
    out = list(prefetch(iter(batches), place=place))
    assert [float(b['x2'][0]) for b in out] == [0.0, 2.0, 4.0, 6.0, 8.0]
    assert seen and main not in seen


def test_prefetch_producer_stops_on_abandoned_iterator():
    started = threading.Event()
    produced = []

    def gen():
        for i in range(1000):
            started.set()
            produced.append(i)
            yield {'x': np.zeros(1)}

    it = prefetch(gen(), depth=1)
    next(it)
    assert started.wait(5)
    it.close()          # the consumer walks away mid-stream
    time.sleep(0.5)     # the producer must unblock and exit
    n = len(produced)
    time.sleep(0.3)
    assert len(produced) == n


def test_prefetch_propagates_worker_errors():
    def gen():
        yield {'x': np.zeros(1)}
        raise RuntimeError('boom')

    it = prefetch(gen())
    next(it)
    with pytest.raises(RuntimeError, match='boom'):
        list(it)


def test_to_device_on_the_cpu_keeps_values():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)[:, ::2]
    t = to_device(a, torch.device('cpu'))
    assert t.device.type == 'cpu'
    np.testing.assert_array_equal(t.numpy(), a)


def test_run_inference_behind_prefetch_equals_a_plain_loop():
    """Per-window losses of `run_inference` (batches from the producer
    thread) equal those of `generate` called batch by batch on the same
    views and noise."""
    tm = torch_model()
    net = seeded_state(tm.build_net(), seed=4).eval()
    rng = np.random.default_rng(0)
    n = 50
    ds = PoseWindows(data=rng.standard_normal((n, 2, 6, 17)).astype(
                         np.float32),
                     meta=np.zeros((n, 4), np.int64),
                     frames=np.zeros((n, 6), np.int32), num_transform=2)
    s = tm.n_generated_samples

    def noise(i, rows):
        g = np.random.default_rng(100 + i)
        return (torch.from_numpy(g.standard_normal((rows, 2, 3, 17))
                                 .astype(np.float32)),
                torch.from_numpy(g.standard_normal((9, rows, 2, 3, 17))
                                 .astype(np.float32)))

    res = run_inference(tm, net, ds, 16, 0, torch.device('cpu'),
                        noise_fn=noise)
    mats = torch.from_numpy(affine_transform_matrices(2))
    want = []
    for i, b in enumerate(make_loader(ds, 16)):
        data = apply_affine_batch(torch.from_numpy(b['data']), mats,
                                  torch.from_numpy(b['trans']).long())
        _, loss = tm.generate(net, data,
                              noise_override=noise(i, data.shape[0] * s))
        want.append(loss.numpy()[b['mask'] > 0])
    np.testing.assert_array_equal(res['loss'], np.concatenate(want))
    assert res['trans'].shape == (2 * n,)
