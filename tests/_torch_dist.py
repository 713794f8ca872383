"""Worker processes for the data-parallel CPU tests of the port
(tests/test_torch_dist_*.py, tests/test_torch_parallel.py).

`run_ranks` starts one Python process per rank, each running the same
body: it imports the port only (never JAX), uses one torch thread, joins a
gloo group that rendezvouses through a file under the test's tmp_path
(no TCP port, so concurrent test workers cannot collide), makes its CPU
mesh, runs the body and saves the dict `OUT` to rank<r>.pt.  The parent
kills every rank on its own timeout, so a hung collective fails the test
instead of stalling the suite.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import textwrap
import uuid

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120

_HEAD = '''
import os, sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, os.path.join({repo!r}, 'tests'))
import torch
torch.set_num_threads(1)
from mocodad_tpu_torch.parallel import make_mesh, maybe_initialize
RANK, WORLD, WORK = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
assert maybe_initialize({url!r}, WORLD, RANK)
mesh = make_mesh(device='cpu')
INPUTS = torch.load(os.path.join(WORK, 'inputs.pt'), weights_only=False)
OUT = {{}}
'''

_TAIL = '''
bad = [m for m in sys.modules
       if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'mocodad_tpu')]
assert not bad, bad
torch.save(OUT, os.path.join(WORK, f'rank{RANK}.pt'))
torch.distributed.destroy_process_group()
'''


def env() -> dict:
    e = dict(os.environ, OMP_NUM_THREADS='1')
    for k in ('PYTHONPATH', 'MOCODAD_COORDINATOR', 'MOCODAD_NUM_PROCESSES',
              'MOCODAD_PROCESS_ID', 'MASTER_ADDR', 'RANK', 'WORLD_SIZE',
              'LOCAL_RANK'):
        e.pop(k, None)
    return e


def communicate(procs, timeout: float = TIMEOUT):
    """Wait for every process (each started with start_new_session=True);
    past `timeout` seconds kill every one, with its children, and raise.
    Returns their (stdout, stderr) pairs."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    except subprocess.TimeoutExpired:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
        for p in procs:
            p.communicate()
        raise
    return outs


def run_ranks(work, body: str, inputs: dict, world: int = 2,
              timeout: float = TIMEOUT) -> list:
    """Run `body` on `world` CPU ranks in `work` (a directory) with
    `inputs` (anything torch.save takes) as INPUTS; returns each rank's
    OUT.  The body sees RANK, WORLD, WORK, INPUTS, `mesh` and OUT."""
    work = str(work)
    os.makedirs(work, exist_ok=True)
    torch.save(inputs, os.path.join(work, 'inputs.pt'))
    url = 'file://' + os.path.join(work, f'rendezvous-{uuid.uuid4().hex}')
    script = os.path.join(work, 'rank_main.py')
    with open(script, 'w') as f:
        f.write(_HEAD.format(repo=REPO, url=url) + textwrap.dedent(body)
                + _TAIL)
    procs = [subprocess.Popen(
        [sys.executable, script, str(r), str(world), work], cwd=REPO,
        env=env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True) for r in range(world)]
    outs = communicate(procs, timeout)
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'rank {r} exited {p.returncode}:\n' \
            f'{out[-3000:]}\n{err[-5000:]}'
    return [torch.load(os.path.join(work, f'rank{r}.pt'), weights_only=False)
            for r in range(world)]


# ---- steps run the same way on one rank (mesh None) and on each of W ----

def one_step(cfg_kw: dict, sd: dict, data, mask, noise, mesh=None) -> dict:
    """One train-mode loss + backward of the configured model from state
    dict `sd` on the global batch `data` (the rank's rows of it on a mesh),
    the gradients summed over the ranks; returns the loss (the rank's
    share), the metrics, the gradients and the running statistics."""
    from mocodad_tpu_torch.config import Config
    from mocodad_tpu_torch.models.mocodad import build_model
    from mocodad_tpu_torch.nn.stsgcn import sync_batch_norms
    from mocodad_tpu_torch.parallel import local_rows, sum_gradients
    model = build_model(Config(**cfg_kw))
    net = model.build_net()
    net.load_state_dict(sd, strict=True)
    net.train()
    trainable = model.trainable_mask(net)
    for k, p in net.named_parameters():
        p.requires_grad_(trainable[k])
    sync_batch_norms(net, mesh)
    loss, metrics = model.loss(
        net, local_rows(torch.as_tensor(data), mesh),
        sample_mask=None if mask is None else local_rows(
            torch.as_tensor(mask), mesh),
        noise_override=tuple(torch.as_tensor(a) for a in noise), mesh=mesh)
    loss.backward()
    sum_gradients(net.parameters(), mesh)
    return {'loss': float(loss.detach()), 'metrics': {k: float(v)
                                             for k, v in metrics.items()},
            'grads': {k: p.grad.clone() for k, p in net.named_parameters()
                      if p.grad is not None},
            'stats': {k: b.clone() for k, b in net.named_buffers()
                      if 'running' in k}}


def adam_steps(cfg_kw: dict, sd: dict, batches, mesh=None) -> dict:
    """`Trainer.train_step` over `batches` [(data, trans, mask, (t, eps))],
    global, from `sd`, with the EMA; returns each step's metrics and the
    parameters, EMA and buffers after them."""
    from mocodad_tpu_torch.config import Config
    from mocodad_tpu_torch.parallel import local_rows
    from mocodad_tpu_torch.training.loop import Trainer
    noise = {k: tuple(torch.as_tensor(a) for a in b[3])
             for k, b in enumerate(batches)}
    trainer = Trainer(Config(**cfg_kw), device='cpu', mesh=mesh,
                      noise_fn=lambda step, rows: noise[step])
    trainer.init_state(steps_per_epoch=2)
    trainer.net.load_state_dict(sd, strict=True)
    trainer.ema = {k: p.detach().clone()
                   for k, p in trainer.net.named_parameters()}
    metrics = []
    for data, trans, mask, _ in batches:
        m = trainer.train_step(*(local_rows(torch.as_tensor(a), mesh)
                                 for a in (data, trans, mask)))
        metrics.append({k: float(v) for k, v in m.items()})
    return {'metrics': metrics,
            'params': {k: p.detach().clone()
                       for k, p in trainer.net.named_parameters()},
            'ema': {k: v.clone() for k, v in trainer.ema.items()},
            'buffers': {k: b.clone() for k, b in trainer.net.named_buffers()}}


def fit_run(cfg_kw: dict, arrays: dict, n_epochs: int, mesh=None) -> dict:
    """`Trainer.fit` without validation on the in-memory windows `arrays`
    (data, meta, frames) into cfg_kw's ckpt_dir; returns the epoch
    history, the final parameters and how many checkpoint files this
    process wrote."""
    from mocodad_tpu_torch.config import Config
    from mocodad_tpu_torch.data import PoseWindows
    from mocodad_tpu_torch.training import checkpoint
    from mocodad_tpu_torch.training.loop import Trainer
    writes = []
    save = checkpoint.save_checkpoint

    def counted(path, *a, **kw):
        writes.append(os.path.basename(path))
        return save(path, *a, **kw)

    checkpoint.save_checkpoint = counted
    try:
        cfg = Config(**cfg_kw)
        trainer = Trainer(cfg, device='cpu', mesh=mesh)
        trainer.fit(PoseWindows(num_transform=cfg.num_transform, **arrays),
                    None, n_epochs=n_epochs)
    finally:
        checkpoint.save_checkpoint = save
    return {'history': trainer.history, 'writes': writes,
            'params': {k: p.detach().clone()
                       for k, p in trainer.net.named_parameters()}}


def eval_case(case: dict, windows: dict, mesh=None) -> dict:
    """`run_inference` of the configured model from `case['sd']` over the
    windows (data, meta, frames) at `case['seed']`, with `case['noise']`
    (one global (x0, zs) per batch) or the model's own draws."""
    from mocodad_tpu_torch.config import Config
    from mocodad_tpu_torch.data import PoseWindows
    from mocodad_tpu_torch.models.mocodad import build_model
    from mocodad_tpu_torch.training.inference import run_inference
    cfg = Config(**case['kw'])
    model = build_model(cfg)
    net = model.build_net()
    net.load_state_dict(case['sd'], strict=True)
    net.eval()
    noise = case.get('noise')

    def noise_fn(i, rows):
        x0, zs = noise[i]
        assert x0.shape[0] == rows, (x0.shape, rows)
        return torch.from_numpy(x0), torch.from_numpy(zs)

    return run_inference(
        model, net, PoseWindows(num_transform=cfg.num_transform, **windows),
        cfg.batch_size, case['seed'], torch.device('cpu'),
        with_pose=case.get('with_pose'),
        noise_fn=None if noise is None else noise_fn, mesh=mesh)
