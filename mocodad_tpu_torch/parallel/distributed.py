"""Process groups, the rank's rows and the collectives of data parallelism.

Counterpart of `mocodad_tpu/parallel/distributed.py`.  Where one JAX
process drives every device of its host and XLA inserts the collectives,
the port runs one process per rank, each driving one device, and calls
the collectives itself:

- every rank builds the same seeded global batch and keeps its own
  contiguous block of rows (`local_rows`, `mesh.shard_batch`), as the JAX
  package's multi-process `shard_batch` does; random tensors are drawn at
  the global batch's size from the same seed on every rank, and each rank
  keeps its block, so the draws do not depend on the number of ranks;
- sums over ranks (`all_reduce_sum`; the BatchNorm's autograd Function,
  `nn/stsgcn._GlobalBatchNorm`, calls it in its forward and backward),
  the gradient sum of a train step (`sum_gradients`), the gather of
  per-rank results into global order (`all_gather_rows`) and the
  broadcast from rank 0 (`broadcast_`).

A gloo group is given host tensors: a CUDA tensor is copied to the host,
reduced there and copied back (two ranks that share one card run over
gloo).  Collectives are issued from the thread that runs the step (and
from autograd's backward), never from the prefetch thread.

`maybe_initialize` joins a group when the environment names one, and is a
no-op otherwise, so every entry point calls it unconditionally; `launch`
is the entry points' whole policy: join, or spawn N ranks, or run alone.
"""

from __future__ import annotations

import multiprocessing
import multiprocessing.connection
import os
import socket
import sys
import time
from typing import Any, Callable, Iterable, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from mocodad_tpu_torch.device import check_device_count


# ---- joining a group --------------------------------------------------------

def init_method(address: str) -> str:
    """A rendezvous URL: `host:port` becomes tcp://host:port; a URL with a
    scheme (tcp://, file://) is kept."""
    return address if '://' in address else f'tcp://{address}'


def env_group(env: Mapping[str, str] = os.environ
              ) -> Optional[Tuple[str, int, int]]:
    """(rendezvous URL, world size, rank) named by the environment, or None.

    MOCODAD_COORDINATOR (host:port or a URL), MOCODAD_NUM_PROCESSES and
    MOCODAD_PROCESS_ID, the JAX package's variables, come first; then
    torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK."""
    if env.get('MOCODAD_COORDINATOR'):
        missing = [k for k in ('MOCODAD_NUM_PROCESSES', 'MOCODAD_PROCESS_ID')
                   if k not in env]
        if missing:
            raise ValueError(f'MOCODAD_COORDINATOR is set but {missing} '
                             'are not')
        return (init_method(env['MOCODAD_COORDINATOR']),
                int(env['MOCODAD_NUM_PROCESSES']),
                int(env['MOCODAD_PROCESS_ID']))
    if env.get('MASTER_ADDR') and 'WORLD_SIZE' in env and 'RANK' in env:
        url = f"tcp://{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        return url, int(env['WORLD_SIZE']), int(env['RANK'])
    return None


def maybe_initialize(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Join the default process group when one is configured: by the
    arguments, else by the environment (`env_group`).  Returns True when
    this call joined; False, doing nothing, when nothing is configured or
    the process is in a group already.

    The default group is gloo: it carries the barriers and every
    collective of a gloo mesh.  `mesh.make_mesh` makes an NCCL group over
    the same ranks when each rank has a GPU of its own."""
    if dist.is_initialized():
        return False
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError('coordinator_address needs num_processes and '
                             'process_id')
        cfg = (init_method(coordinator_address), int(num_processes),
               int(process_id))
    else:
        cfg = env_group()
    if cfg is None:
        return False
    url, world, rank = cfg
    if not 0 <= rank < world:
        raise ValueError(f'process id {rank} outside a world of {world}')
    dist.init_process_group('gloo', init_method=url, world_size=world,
                            rank=rank)
    return True


def is_main_process() -> bool:
    """Rank 0 of the group, or the only process: the one that writes the
    logs, checkpoints and saved tensors, and prints the results."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank (no-op outside a group): before a rank reads a
    file that rank 0 wrote."""
    if dist.is_initialized():
        dist.barrier()


# ---- the rank's rows --------------------------------------------------------

def is_distributed(mesh) -> bool:
    """Whether `mesh` spans a process group (even of one rank); None and a
    mesh of this process alone do not."""
    return mesh is not None and mesh.group is not None


def global_rows(rows: int, mesh) -> int:
    """The global batch's rows when each rank holds `rows`."""
    return rows * (mesh.world if mesh is not None else 1)


def local_rows(x, mesh, dim: int = 0):
    """The rank's contiguous block of `x` (a tensor or an array) along
    `dim`, whose size there is the global batch's; `x` itself on a mesh
    of one rank."""
    if mesh is None or mesh.world == 1:
        return x
    n = x.shape[dim]
    if n % mesh.world:
        raise ValueError(f'{n} rows along dim {dim} do not split over '
                         f'{mesh.world} ranks')
    k = n // mesh.world
    return x[(slice(None),) * dim + (slice(mesh.rank * k,
                                           (mesh.rank + 1) * k),)]


# ---- collectives ------------------------------------------------------------

def _on_host(t: torch.Tensor, mesh) -> bool:
    return mesh.backend == 'gloo' and t.device.type != 'cpu'


def all_reduce_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of `t` over the ranks, as a new tensor on t's device; `t`
    itself outside a group.  No autograd."""
    if not is_distributed(mesh):
        return t
    buf = t.detach().to('cpu' if _on_host(t, mesh) else t.device,
                        copy=True)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf.to(t.device)


def sum_gradients(params: Iterable[torch.Tensor], mesh) -> None:
    """Sum the gradients of `params` over the ranks in place, in one
    collective over one flat buffer.  Each rank's loss is its share of the
    global mean (local sum over the global denominator), so the sum is the
    global gradient: nothing divides by the world size."""
    if not is_distributed(mesh):
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), mesh)
    for g, s in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(s.view_as(g))


def all_gather_rows(t: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """Every rank's `t`, concatenated along `dim` in rank order (the global
    order of the rows `local_rows` split), on every rank; `t` itself
    outside a group."""
    if not is_distributed(mesh):
        return t
    buf = t.detach().to('cpu' if _on_host(t, mesh) else t.device).contiguous()
    parts = [torch.empty_like(buf) for _ in range(mesh.world)]
    dist.all_gather(parts, buf, group=mesh.group)
    return torch.cat(parts, dim=dim).to(t.device)


def broadcast_(tensors: Iterable[torch.Tensor], mesh, src: int = 0) -> None:
    """Overwrite each tensor, in place, with rank `src`'s."""
    if not is_distributed(mesh):
        return
    for t in tensors:
        if not _on_host(t, mesh):
            dist.broadcast(t.detach(), src=src, group=mesh.group)
            continue
        buf = t.detach().cpu()
        dist.broadcast(buf, src=src, group=mesh.group)
        with torch.no_grad():
            t.copy_(buf)


# ---- launching ranks --------------------------------------------------------

def _free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, url: str, fn: Callable,
               args: tuple) -> None:
    os.environ.update(MOCODAD_COORDINATOR=url,
                      MOCODAD_NUM_PROCESSES=str(world),
                      MOCODAD_PROCESS_ID=str(rank), LOCAL_RANK=str(rank))
    maybe_initialize()
    fn(*args)
    dist.destroy_process_group()


def spawn(fn: Callable, args: tuple, world: int,
          url: Optional[str] = None, timeout: Optional[float] = None) -> int:
    """Run `fn(*args)` in `world` fresh processes (the spawn start method),
    rank i of a group that rendezvouses at `url` (default: a free localhost
    port), each with LOCAL_RANK = i.  Returns 0 when every rank exits 0;
    as soon as one fails, or `timeout` seconds pass, stops the others and
    returns the failed rank's exit code (1 on a timeout)."""
    ctx = multiprocessing.get_context('spawn')
    url = url or f'tcp://localhost:{_free_port()}'
    procs = [ctx.Process(target=_rank_main, args=(r, world, url, fn, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while True:
            codes = [p.exitcode for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                return failed[0]
            if all(c == 0 for c in codes):
                return 0
            if deadline is not None and time.monotonic() > deadline:
                return 1
            multiprocessing.connection.wait(
                [p.sentinel for p in procs if p.exitcode is None], 1.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()


def launch(fn: Callable[..., Any], args: tuple, n_devices: int,
           device=None, prepare: Optional[Callable[[], None]] = None) -> Any:
    """An entry point's ranks.  Under a group named by the environment
    (`maybe_initialize`: MOCODAD_* or torchrun), this process joins it and
    runs `fn(*args)` as its rank.  Otherwise, with `n_devices` > 1, it
    checks the device count, calls `prepare` (for example to build the
    kernels once), spawns `n_devices` ranks of `fn(*args)` and exits with
    the first failed rank's code.  Otherwise it runs `fn(*args)` alone.
    Returns `fn`'s result in the process that ran it."""
    if maybe_initialize():
        print(f'joined a group as rank {dist.get_rank()} of '
              f'{dist.get_world_size()}', file=sys.stderr, flush=True)
        try:
            return fn(*args)
        finally:
            dist.destroy_process_group()
    if n_devices > 1:
        check_device_count(n_devices, device)
        if prepare is not None:
            prepare()
        code = spawn(fn, args, n_devices)
        if code:
            print(f'a rank exited with code {code}', file=sys.stderr)
            sys.exit(code)
        return None
    return fn(*args)
