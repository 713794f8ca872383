"""The port stands alone: importing it loads neither JAX nor the JAX
package, and its entry points do not fall back to the CPU."""

import ast
import os
import re
import subprocess
import sys

import pytest
import torch

from mocodad_tpu_torch.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, 'mocodad_tpu_torch')
# `mocodad_tpu_torch` starts with `mocodad_tpu`: match the JAX package
# only as a whole name
_JAX_PKG = re.compile(r'^mocodad_tpu(\.|$)')
_FORBIDDEN = ('jax', 'flax', 'optax')


def _port_sources():
    files = [os.path.join(REPO, name) for name in (
        'eval_MoCoDAD_torch.py', 'train_MoCoDAD_torch.py',
        'serve_MoCoDAD_torch.py', 'predict_MoCoDAD_torch.py',
        'chip_smoke.py')]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith('.py')]
    return files


def test_import_leaves_jax_out():
    code = (
        'import sys\n'
        'import mocodad_tpu_torch, mocodad_tpu_torch.training.inference\n'
        'import mocodad_tpu_torch.ops.pallas_unet, mocodad_tpu_torch.data\n'
        'import mocodad_tpu_torch.ops.grouped_unet\n'
        'import mocodad_tpu_torch.ops.dma_unet\n'
        'import mocodad_tpu_torch.tools.perf.probe_grouped_pallas\n'
        'import mocodad_tpu_torch.tools.perf.probe_dma_pipeline\n'
        'import mocodad_tpu_torch.eval, mocodad_tpu_torch.utils.tensors\n'
        'import mocodad_tpu_torch.training.loop\n'
        'import mocodad_tpu_torch.training.step_graph\n'
        'import mocodad_tpu_torch.training.checkpoint\n'
        'import mocodad_tpu_torch.training.ema\n'
        'import mocodad_tpu_torch.data.prefetch\n'
        'import mocodad_tpu_torch.serve, mocodad_tpu_torch.utils.msgpack\n'
        'import mocodad_tpu_torch.data.json_pose\n'
        'import mocodad_tpu_torch.data.convert\n'
        'import mocodad_tpu_torch.tools.convert_checkpoint\n'
        'import mocodad_tpu_torch.tools.perf.probe_serve_latency\n'
        'import mocodad_tpu_torch.models.mocodad_latent\n'
        'import mocodad_tpu_torch.viz, mocodad_tpu_torch.viz.report\n'
        'import mocodad_tpu_torch.viz.vis\n'
        'import mocodad_tpu_torch.parallel\n'
        'import mocodad_tpu_torch.parallel.distributed\n'
        'import mocodad_tpu_torch.parallel.mesh\n'
        'import eval_MoCoDAD_torch, train_MoCoDAD_torch, chip_smoke\n'
        'import serve_MoCoDAD_torch, predict_MoCoDAD_torch\n'
        'bad = [m for m in sys.modules if m.split(".")[0] in '
        '("jax", "jaxlib", "flax", "optax", "mocodad_tpu")]\n'
        'print(bad)\n'
        'sys.exit(1 if bad else 0)\n')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize('path', _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_no_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or '']
        else:
            continue
        for name in names:
            assert not _JAX_PKG.match(name), f'{path}: imports {name}'
            assert name.split('.')[0] not in _FORBIDDEN, \
                f'{path}: imports {name}'


def test_device_defaults_to_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        assert resolve_device(None).type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            resolve_device('cuda')
    assert resolve_device('cpu') == torch.device('cpu')


def test_trainer_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip('CUDA is present: the default device is usable')
    from mocodad_tpu_torch.config import flagship_config
    from mocodad_tpu_torch.training.loop import Trainer
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        Trainer(flagship_config())


def test_latent_entry_points_raise_without_cuda(tmp_path):
    """The latent variant's trainer and eval route take no device from
    anywhere but the caller: without CUDA they raise, as the base
    model's do."""
    if torch.cuda.is_available():
        pytest.skip('CUDA is present: the default device is usable')
    from mocodad_tpu_torch.config import flagship_config
    from mocodad_tpu_torch.models.mocodad import build_model
    from mocodad_tpu_torch.models.mocodad_latent import MoCoDADLatentModel
    from mocodad_tpu_torch.training.inference import restore_and_infer
    from mocodad_tpu_torch.training.loop import Trainer
    for stage in ('pretrain', 'diffusion'):
        cfg = flagship_config(data_dir=str(tmp_path), ckpt_dir=str(tmp_path),
                              diffusion_on_latent=True, stage=stage)
        assert isinstance(build_model(cfg), MoCoDADLatentModel)
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            Trainer(cfg)
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            restore_and_infer(cfg)


def test_mesh_and_launcher_raise_without_cuda():
    """A data-parallel run on the card asks for CUDA like any other entry
    point: without it, the mesh, the device count check and the CLIs'
    launcher raise; nothing places CUDA ranks on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('CUDA is present: the default device is usable')
    from mocodad_tpu_torch.parallel import launch, make_mesh
    from mocodad_tpu_torch.device import check_device_count
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        make_mesh()
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        check_device_count(2)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        launch(print, (), 2, 'cuda')


def test_restore_and_infer_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('CUDA is present: the default device is usable')
    from mocodad_tpu_torch.config import flagship_config
    from mocodad_tpu_torch.training.inference import restore_and_infer
    cfg = flagship_config(data_dir=str(tmp_path), ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        restore_and_infer(cfg)
