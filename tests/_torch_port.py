"""Shared set-up of the parity tests between the JAX package and its PyTorch
port (tests/test_torch_*.py): one configuration, weights made in the JAX
package's variables layout, and the same weights as a port network.

Inputs and noise are made from a seed with NumPy and handed to both
packages.  JAX stays on the CPU (tests/conftest.py); the port runs on the
CPU with its kernels' plain versions.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from mocodad_tpu.config import Config as JaxConfig
from mocodad_tpu.models import MoCoDADModel as JaxModel
from mocodad_tpu_torch.config import Config as TorchConfig
from mocodad_tpu_torch.models.mocodad import MoCoDADModel as TorchModel
from mocodad_tpu_torch.utils.weights import state_dict_from_jax

# several test workers share a small host
torch.set_num_threads(1)

CFG_KW = dict(conditioning_strategy='inject', conditioning_indices=[0, 1, 2],
              seg_len=6, num_coords=2, embedding_dim=16, h_dim=32,
              latent_dim=16, channels=[32, 16, 32], dropout=0.0,
              noise_steps=10, n_generated_samples=2,
              aggregation_strategy='best', conditioning_architecture='AE')


def jax_model(**kw) -> JaxModel:
    return JaxModel(JaxConfig(**{**CFG_KW, **kw}))


def torch_model(**kw) -> TorchModel:
    return TorchModel(TorchConfig(**{**CFG_KW, **kw}))


def _to_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jax.device_get(tree))


def trained_variables(model: JaxModel, seed: int = 0):
    """The JAX package's own init plus one train-mode loss step, so the
    BatchNorm running statistics are non-trivial
    (the pattern of tests/test_pallas_unet.py:26-32)."""
    variables = model.init_variables(jax.random.key(seed))
    data = jax.random.normal(jax.random.key(9),
                             (16, model.num_coords, model.n_frames,
                              model.n_joints))
    loss = jax.jit(lambda v, d, k: model.loss(v, d, k, train=True)[2])
    mut = loss(variables, data, jax.random.key(10))
    return _to_np({'params': variables['params'],
                   'batch_stats': mut['batch_stats']})


def seeded_tree(shapes, seed: int = 0):
    """Fill a traced variables tree (jax.eval_shape of a flax init) with
    values drawn from a NumPy seed: weights uniform as at init, BatchNorm
    scale/shift and running statistics away from their identity values."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [str(getattr(p, 'key', '')) for p in path]
        shape = leaf.shape
        if names[0] == 'batch_stats':
            if names[-1] == 'mean':
                return (0.1 * rng.standard_normal(shape)).astype(np.float32)
            return (0.5 + rng.random(shape)).astype(np.float32)
        if names[-1] == 'negative_slope':
            return np.float32(0.25 + 0.1 * rng.random(shape))
        if 'BatchNorm' in names[-2] or names[-2].endswith('_bn'):
            if names[-1] == 'scale':
                return (1 + 0.1 * rng.standard_normal(shape)).astype(
                    np.float32)
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        fan = shape[-2] if len(shape) >= 2 else shape[0]
        bound = 1.0 / np.sqrt(fan)
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def seeded_variables(model: JaxModel, seed: int = 0):
    """A JAX model's variables tree filled by `seeded_tree`: BatchNorm
    statistics away from identity without a training step."""
    shapes = jax.eval_shape(model.init_variables, jax.random.key(0))
    return seeded_tree(shapes, seed=seed)


def bf16_stats(got, want):
    """(max |got - want| / max |want|, mean |got - want| / mean |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    return err.max() / np.abs(want).max(), err.mean() / np.abs(want).mean()


def sub_state_dict(variables, root: str, prefix: str, name=None):
    """The port's state dict of one submodule, from the `variables` of a
    flax module placed at params[root] (or params[root][name]); keys are
    returned without `prefix`."""
    params = variables['params']
    stats = variables.get('batch_stats', {})
    if name is not None:
        params, stats = {name: params}, {name: stats}
    sd = state_dict_from_jax({'params': {root: params},
                              'batch_stats': {root: stats}})
    assert all(k.startswith(prefix) for k in sd), list(sd)[:3]
    return {k[len(prefix):]: v for k, v in sd.items()}


def torch_net(model: TorchModel, variables):
    """The port's network holding the same weights, in eval mode."""
    net = model.build_net()
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    return net.eval()
