"""The port's data-parallel plumbing (mocodad_tpu_torch/parallel/) against
the JAX package's: `make_mesh`'s device-count error, `shard_batch`'s rows
and divisibility message against JAX `shard_batch` on `make_mesh(2)` and
`make_mesh(4)` (the 8-device virtual CPU mesh of tests/conftest.py),
`maybe_initialize`'s variables and its no-op, the row slicing, the
backend rule, the collectives on two CPU ranks, and `spawn` stopping
every rank when one fails."""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from _torch_dist import REPO, communicate, env, run_ranks
from mocodad_tpu.parallel import make_mesh as jax_make_mesh
from mocodad_tpu.parallel import shard_batch as jax_shard_batch
from mocodad_tpu_torch.parallel import (Mesh, backend_for, global_rows,
                                        local_rows, make_mesh,
                                        maybe_initialize, shard_batch)
from mocodad_tpu_torch.parallel import distributed as D
from mocodad_tpu_torch.parallel import mesh as M


def _batch(rows):
    rng = np.random.default_rng(rows)
    return {'data': rng.standard_normal((rows, 2, 6, 17)).astype(np.float32),
            'trans': np.arange(rows, dtype=np.int32) % 5,
            'mask': (np.arange(rows) < rows - 3).astype(np.float32)}


def test_device_count_error_has_the_jax_wording(monkeypatch):
    with pytest.raises(ValueError) as jerr:
        jax_make_mesh(len(jax.devices()) + 1)
    import mocodad_tpu_torch.device as DEV
    monkeypatch.setattr(M, 'resolve_device', lambda d=None:
                        torch.device('cuda'))
    monkeypatch.setattr(DEV, 'resolve_device', lambda d=None:
                        torch.device('cuda'))
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 8)
    with pytest.raises(ValueError) as terr:
        make_mesh(9)
    assert str(terr.value) == str(jerr.value) == 'requested 9 devices, have 8'


def test_mesh_without_a_group():
    mesh = make_mesh(device='cpu')
    assert mesh == Mesh(world=1, rank=0, device=torch.device('cpu'))
    assert make_mesh(1, device='cpu') == mesh
    with pytest.raises(ValueError, match='needs 2 processes'):
        make_mesh(2, device='cpu')
    with pytest.raises(RuntimeError if not torch.cuda.is_available()
                       else ValueError):
        make_mesh(2)


@pytest.mark.parametrize('world', [2, 4])
def test_shard_batch_rows_match_jax(world):
    batch = _batch(16)
    jmesh = jax_make_mesh(world)
    sharded = jax_shard_batch(batch, jmesh)
    for k, v in batch.items():
        shards = sorted(sharded[k].addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        assert len(shards) == world
        for rank, sh in enumerate(shards):
            got = shard_batch(batch, Mesh(world, rank, torch.device('cpu')))
            np.testing.assert_array_equal(got[k], np.asarray(sh.data))
            np.testing.assert_array_equal(
                local_rows(torch.from_numpy(v), Mesh(world, rank, 'cpu'))
                .numpy(), np.asarray(sh.data))


@pytest.mark.parametrize('world', [2, 4])
def test_shard_batch_divisibility_message_matches_jax(world):
    batch = _batch(4 * world + 1)
    with pytest.raises(ValueError) as jerr:
        jax_shard_batch(batch, jax_make_mesh(world))
    with pytest.raises(ValueError) as terr:
        shard_batch(batch, Mesh(world, 0, torch.device('cpu')))
    assert str(terr.value) == str(jerr.value)


def test_rows_of_one_rank_and_of_the_fold():
    x = torch.arange(24).reshape(2, 3, 4)
    assert local_rows(x, None) is x
    assert local_rows(x, Mesh(1, 0, 'cpu')) is x
    assert global_rows(5, None) == 5
    assert global_rows(5, Mesh(4, 1, 'cpu')) == 20
    np.testing.assert_array_equal(local_rows(x, Mesh(2, 1, 'cpu'), dim=2),
                                  x[:, :, 2:])
    with pytest.raises(ValueError, match='do not split'):
        local_rows(x, Mesh(2, 0, 'cpu'), dim=1)
    # b-major fold: a rank's windows are one run of columns
    b, s, world = 4, 3, 2
    cols = torch.arange(b * s)
    for rank in range(world):
        mine = local_rows(cols, Mesh(world, rank, 'cpu'))
        np.testing.assert_array_equal(mine // s, np.repeat(
            np.arange(rank * b // world, (rank + 1) * b // world), s))


def test_backend_follows_placement():
    cuda = [torch.device('cuda', i) for i in range(2)]
    assert backend_for(cuda) == 'nccl'
    assert backend_for([cuda[0], cuda[0]]) == 'gloo'
    assert backend_for([torch.device('cpu')] * 2) == 'gloo'


def test_env_group_reads_the_jax_and_torchrun_variables():
    assert D.env_group({}) is None
    assert D.env_group({'MOCODAD_COORDINATOR': 'host:1234',
                        'MOCODAD_NUM_PROCESSES': '4',
                        'MOCODAD_PROCESS_ID': '2'}) == \
        ('tcp://host:1234', 4, 2)
    assert D.env_group({'MOCODAD_COORDINATOR': 'file:///tmp/x',
                        'MOCODAD_NUM_PROCESSES': '2',
                        'MOCODAD_PROCESS_ID': '0',
                        'MASTER_ADDR': 'other', 'WORLD_SIZE': '8',
                        'RANK': '3'}) == ('file:///tmp/x', 2, 0)
    assert D.env_group({'MASTER_ADDR': 'n0', 'MASTER_PORT': '29400',
                        'WORLD_SIZE': '8', 'RANK': '3',
                        'LOCAL_RANK': '1'}) == ('tcp://n0:29400', 8, 3)
    with pytest.raises(ValueError, match='MOCODAD_PROCESS_ID'):
        D.env_group({'MOCODAD_COORDINATOR': 'h:1',
                     'MOCODAD_NUM_PROCESSES': '2'})


def test_maybe_initialize_is_a_no_op_without_variables(monkeypatch):
    for k in ('MOCODAD_COORDINATOR', 'MASTER_ADDR'):
        monkeypatch.delenv(k, raising=False)
    assert maybe_initialize() is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match='outside a world'):
        maybe_initialize('file:///nonexistent', 2, 2)


def test_collectives_on_two_ranks(tmp_path):
    """Sums, the gradient sum, the gather into global order and the
    broadcast from rank 0, on two gloo ranks."""
    outs = run_ranks(tmp_path, '''
        from mocodad_tpu_torch.parallel import (all_gather_rows,
            all_reduce_sum, is_main_process, replicate, sum_gradients)
        OUT['main'] = is_main_process()
        x = torch.arange(6.).reshape(2, 3) * (RANK + 1)
        OUT['sum'] = all_reduce_sum(x, mesh)
        OUT['x_kept'] = x.clone()
        lin = torch.nn.Linear(3, 2)
        torch.nn.init.constant_(lin.weight, float(RANK))
        replicate(lin, mesh)
        OUT['weight'] = lin.weight.detach().clone()
        lin(torch.ones(1, 3) * (RANK + 1)).sum().backward()
        sum_gradients(lin.parameters(), mesh)
        OUT['lin_grad'] = lin.weight.grad.clone()
        OUT['gather'] = all_gather_rows(x, mesh, dim=1)
    ''', {})
    assert [o['main'] for o in outs] == [True, False]
    base = torch.arange(6.).reshape(2, 3)
    for r, o in enumerate(outs):
        torch.testing.assert_close(o['sum'], 3 * base, rtol=0, atol=0)
        torch.testing.assert_close(o['x_kept'], base * (r + 1))
        torch.testing.assert_close(o['weight'], torch.zeros(2, 3))
        torch.testing.assert_close(o['lin_grad'], torch.full((2, 3), 3.0))
        torch.testing.assert_close(o['gather'],
                                   torch.cat([base, 2 * base], dim=1))


_SPAWN = '''
import os, sys, time
sys.path.insert(0, {repo!r})
import torch.distributed as dist
from mocodad_tpu_torch.parallel import spawn

def ok():
    dist.barrier()

def one_fails():
    if dist.get_rank() == 1:
        raise RuntimeError('rank 1 fails')
    dist.barrier()        # rank 0 would wait here for ever

if __name__ == '__main__':
    t0 = time.monotonic()
    codes = [spawn(ok, (), 2, url='file://' + sys.argv[1] + '/a'),
             spawn(one_fails, (), 2, url='file://' + sys.argv[1] + '/b')]
    print('CODES', codes[0], codes[1], round(time.monotonic() - t0, 1))
'''


def test_spawn_stops_every_rank_when_one_fails(tmp_path):
    script = tmp_path / 'spawn_main.py'
    script.write_text(textwrap.dedent(_SPAWN.format(repo=REPO)))
    p = subprocess.Popen([sys.executable, str(script), str(tmp_path)],
                         cwd=REPO, env=env(), stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True,
                         start_new_session=True)
    out, err = communicate([p])[0]
    assert p.returncode == 0, out + err
    line = [x for x in out.splitlines() if x.startswith('CODES')][0]
    ok, failed, seconds = line.split()[1:]
    assert ok == '0' and failed == '1', out + err
    assert 'rank 1 fails' in err
    assert float(seconds) < 90
