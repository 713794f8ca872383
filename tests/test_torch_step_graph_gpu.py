"""K train steps per dispatch as one CUDA graph on the card
(`training/step_graph.py`), against the eager steps of the window pool.

The graph is captured once per `fit` (again after a resume, whose
restored Adam state is made of new tensors) and replayed for each group
of K steps; the trailing steps of an epoch run eagerly.  Capturable Adam
computes its bias correction on the device in float32 where the eager
Adam takes Python floats, and cuDNN's backward is not bit-reproducible
on the card (the tests run under `cudnn.deterministic`, so each run
gives the same numbers), so the graph is held to the eager steps as
chip_smoke.py's train_agree holds the card to the CPU: each epoch's mean
loss within 1e-4 (measured 2.1e-5 and 9.6e-5 at inject, 2.0e-6 and
3.3e-5 at random_imp; a resumed run equal to the uninterrupted one), no
parameter further apart than the steps can move it each way (1.1 lr a
step).  These tests need a CUDA device and skip without one;
they import neither JAX nor the JAX package:

    python -m pytest -q --noconftest -m gpu tests/test_torch_step_graph_gpu.py
"""

import os

import numpy as np
import pytest
import torch

from mocodad_tpu_torch.config import Config, flagship_config
from mocodad_tpu_torch.data import PoseWindows, make_loader
from mocodad_tpu_torch.training.loop import Trainer

pytestmark = pytest.mark.gpu
LR, LOSS_RTOL, STEP_MAX = 1e-3, 1e-4, 1.1


@pytest.fixture(scope='module')
def ds():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: a CUDA graph has no CPU mode')
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    rng = np.random.default_rng(3)
    n = 160           # x 2 views at batch 32: 10 steps an epoch
    yield PoseWindows(
        data=rng.normal(size=(n, 2, 6, 17)).astype(np.float32) * 0.1,
        meta=np.zeros((n, 4), np.int64),
        frames=np.tile(np.arange(1, 7, dtype=np.int32), (n, 1)),
        num_transform=2)
    torch.backends.cudnn.deterministic = saved


def _cfg(tmp, name, k, **kw):
    extras = {'device_data': True, 'steps_per_dispatch': k,
              **kw.pop('extras', {})}
    path = os.path.join(str(tmp), name)
    os.makedirs(path, exist_ok=True)
    return flagship_config(batch_size=32, num_transform=2, opt_lr=LR,
                           validation=False, use_ema=True, ckpt_dir=path,
                           extras=extras, **kw)


def _fit(cfg: Config, ds, n_epochs, **kw) -> Trainer:
    trainer = Trainer(cfg, device='cuda')
    trainer.fit(ds, None, n_epochs=n_epochs, **kw)
    return trainer


def _assert_follows(graph: Trainer, eager: Trainer, steps: int):
    """`graph`'s epochs (all of them, or those after a resume) against
    the same epochs of `eager`, and the parameters at the end."""
    assert graph.step == eager.step == steps
    want = {h['epoch']: h for h in eager.history}
    assert graph.history
    for a in graph.history:
        b = want[a['epoch']]['loss']
        print(f'epoch {a["epoch"]} loss rel {abs(a["loss"] - b) / b:.3e}')
        np.testing.assert_allclose(a['loss'], b, rtol=LOSS_RTOL)
    want = dict(eager.net.named_parameters())
    for k, p in graph.net.named_parameters():
        d = float((p.detach() - want[k].detach()).abs().max())
        assert d <= 2 * steps * STEP_MAX * LR, (k, d)


@pytest.mark.parametrize('strategy', ['inject', 'random_imp'])
def test_graph_fit_follows_the_eager_pool_steps(ds, tmp_path, strategy):
    """2 groups of 4 replayed and 2 eager steps an epoch; random_imp
    draws a frame order per step, which the graph takes as an input."""
    kw = ({} if strategy == 'inject' else
          dict(conditioning_strategy='random_imp', conditioning_indices=3))
    eager = _fit(_cfg(tmp_path, 'eager', 1, **kw), ds, 2)
    graph = _fit(_cfg(tmp_path, 'graph', 4, **kw), ds, 2)
    assert eager.graph_captures == 0 and graph.graph_captures == 1
    assert [h['graph_replays'] for h in graph.history] == [2, 2]
    assert graph.pool is None            # released when the fit ends
    _assert_follows(graph, eager, 20)


def test_resume_captures_again(ds, tmp_path):
    full = _fit(_cfg(tmp_path, 'full', 4), ds, 2)
    cfg = _cfg(tmp_path, 'resumed', 4)
    _fit(cfg, ds, 1)
    second = _fit(cfg, ds, 2, resume='auto')
    assert second.graph_captures == 1
    assert [h['graph_replays'] for h in second.history] == [2]
    assert all(torch.is_tensor(st['step']) and st['step'].is_cuda
               for st in second.opt.state.values())
    _assert_follows(second, full, 20)


def test_debug_nans_names_the_step_in_a_replay(ds, tmp_path):
    cfg = _cfg(tmp_path, 'nan', 4, extras={'debug_nans': True})
    data = ds.data.copy()
    batch = list(make_loader(ds, 32, shuffle=True, seed=cfg.seed,
                             yield_indices=True))[2]
    data[batch['idx'][3], 0, 2, 5] = np.nan
    bad = PoseWindows(data=data, meta=ds.meta, frames=ds.frames,
                      num_transform=2)
    with pytest.raises(FloatingPointError, match='at step 2$'):
        _fit(cfg, bad, 1)
