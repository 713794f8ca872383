"""Eval-mode forward of the port's modules against flax `apply`, float32,
on the same seeded weights (BatchNorm statistics away from identity)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import seeded_tree, sub_state_dict
from mocodad_tpu import nn as jnn
from mocodad_tpu_torch import nn as tnn

# as tests/test_fast_unet.py:54: float32 throughout, sums in another order
RTOL, ATOL = 2e-4, 2e-5


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _init(module, *args):
    shapes = jax.eval_shape(module.init, jax.random.key(0), *args)
    return seeded_tree(shapes, seed=3)


@pytest.mark.parametrize('c_in,c_out', [(16, 32), (32, 32)],
                         ids=['residual_conv', 'identity'])
def test_stgcnn_layer(c_in, c_out):
    x, emb = _x((4, c_in, 3, 17)), _x((4, 16), seed=2)
    flax_layer = jnn.STGCNNLayer(in_channels=c_in, out_channels=c_out,
                                 time_dim=3, joints_dim=17, dropout=0.0,
                                 emb_dim=16)
    v = _init(flax_layer, jnp.asarray(x), jnp.asarray(emb))
    want = flax_layer.apply(v, jnp.asarray(x), jnp.asarray(emb))
    layer = tnn.STGCNNLayer(c_in, c_out, 3, 17, 0.0, emb_dim=16).eval()
    layer.load_state_dict(sub_state_dict(v, 'model', 'model.st_gcnnsp1a.0.',
                                         name='p1a'), strict=True)
    with torch.no_grad():
        got = layer(torch.from_numpy(x), torch.from_numpy(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), RTOL, ATOL)


def test_joint_mix_layer():
    x = _x((4, 32, 3, 17))
    flax_layer = jnn.JointMixLayer(in_joints=17, out_joints=12, dropout=0.0)
    v = _init(flax_layer, jnp.asarray(x))
    want = flax_layer.apply(v, jnp.asarray(x))
    layer = tnn.JointMixLayer(17, 12, 0.0).eval()
    layer.load_state_dict(sub_state_dict(v, 'model', 'model.down1.',
                                         name='down1'), strict=True)
    with torch.no_grad():
        got = layer(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), RTOL, ATOL)


def test_stsae_condition_encoder():
    x = _x((4, 2, 3, 17))
    kw = dict(c_in=2, h_dim=32, latent_dim=16, n_frames=3, n_joints=17,
              layer_channels=(32, 16, 32), dropout=0.0)
    flax_enc = jnn.STSAE(**kw)
    v = _init(flax_enc, jnp.asarray(x))
    z_want, rec_want = flax_enc.apply(v, jnp.asarray(x))
    enc = tnn.STSAE(**kw).eval()
    enc.load_state_dict(sub_state_dict(v, 'condition_encoder',
                                       'condition_encoder.'), strict=True)
    with torch.no_grad():
        z, rec = enc(torch.from_numpy(x))
    np.testing.assert_allclose(z.numpy(), np.asarray(z_want), RTOL, ATOL)
    np.testing.assert_allclose(rec.numpy(), np.asarray(rec_want), RTOL, ATOL)


@pytest.mark.parametrize('n_joints', [14, 17, 18])
def test_stsae_unet(n_joints):
    x, cond = _x((4, 2, 3, n_joints)), _x((4, 16), seed=2)
    t = np.array([9, 5, 3, 1], np.int32)
    kw = dict(c_in=2, embedding_dim=16, n_frames=3, n_joints=n_joints,
              dropout=0.0, inject_condition=True)
    flax_unet = jnn.STSAEUnet(**kw)
    args = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    v = _init(flax_unet, *args)
    want, _ = jax.jit(flax_unet.apply)(v, *args)
    unet = tnn.STSAEUnet(**kw).eval()
    unet.load_state_dict(sub_state_dict(v, 'model', 'model.'), strict=True)
    with torch.no_grad():
        got, _ = unet(torch.from_numpy(x), torch.from_numpy(t),
                      torch.from_numpy(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), RTOL, ATOL)
