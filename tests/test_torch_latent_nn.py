"""The latent variant's modules against flax `apply`, float32, on the same
seeded weights: the MLP `Denoiser` (train mode with its running
statistics, and eval mode), the diffusion stage's STSEUnet with its linear
head and the pretrain stage's bottlenecked STSAEUnet, the sinusoidal
embedding at the latent variant's constant t = -1, and the weight bridge of
both stages' nets."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import CFG_KW, seeded_tree, seeded_variables, sub_state_dict
from mocodad_tpu import nn as jnn
from mocodad_tpu.config import Config as JaxConfig
from mocodad_tpu.models import MoCoDADLatentModel as JaxLatent
from mocodad_tpu.nn.components import sinusoidal_pos_encoding as \
    jax_sinusoidal
from mocodad_tpu.utils.torch_compat import export_torch_state_dict
from mocodad_tpu_torch import nn as tnn
from mocodad_tpu_torch.config import Config as TorchConfig
from mocodad_tpu_torch.models.mocodad import build_model
from mocodad_tpu_torch.models.mocodad_latent import (DIFFUSION_DOWN_CHANNELS,
                                                     MoCoDADLatentModel)
from mocodad_tpu_torch.utils.weights import (state_dict_from_jax,
                                             variables_from_state_dict)

# float32 throughout, sums in another order (tests/test_torch_nn.py)
RTOL, ATOL = 2e-4, 2e-5
STATS_TOL = 1e-6      # running mean / var, absolute
GRAD_REL = 1e-4       # max |diff| over the tensor's largest gradient
GRAD_FLOOR = 1e-6     # or over the step's largest (test_torch_train_step.py)
B, D, E = 16, 16, 16
HIDDEN = (16, 32, 32, 16)
LATENT_KW = dict(CFG_KW, diffusion_on_latent=True, latent_embedding_dim=D,
                 hidden_sizes=list(HIDDEN))


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _init(module, *args, seed=3):
    shapes = jax.eval_shape(module.init, jax.random.key(0), *args)
    return seeded_tree(shapes, seed=seed)


def _denoiser_inputs():
    x, cond = _x((B, D)), _x((B, E), seed=2)
    t = np.random.default_rng(4).integers(1, 10, B).astype(np.int32)
    return x, t, cond


@pytest.fixture(scope='module')
def denoiser():
    x, t, cond = _denoiser_inputs()
    flax_mod = jnn.Denoiser(input_size=D, hidden_sizes=HIDDEN, cond_size=E)
    v = _init(flax_mod, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    mod = tnn.Denoiser(D, HIDDEN, E)
    mod.load_state_dict(sub_state_dict(v, 'denoiser', 'denoiser.'),
                        strict=True)
    return flax_mod, v, mod


def test_denoiser_reference_names(denoiser):
    _, _, mod = denoiser
    names = set(mod.state_dict())
    assert {'net.0.0.weight', 'net.0.1.running_var', 'net.2.1.bias',
            'net.3.weight', 'net.3.bias', 'cond_layers.3.weight'} <= names
    assert not any(k.startswith('net.3.') and k.count('.') > 2
                   for k in names)


def test_denoiser_eval_mode(denoiser):
    flax_mod, v, mod = denoiser
    x, t, cond = _denoiser_inputs()
    want = flax_mod.apply(v, jnp.asarray(x), jnp.asarray(t),
                          jnp.asarray(cond))
    with torch.no_grad():
        got = mod.eval()(torch.from_numpy(x), torch.from_numpy(t),
                         torch.from_numpy(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), RTOL, ATOL)
    # without a condition: the time embedding alone
    want = flax_mod.apply(v, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), RTOL, ATOL)


def test_denoiser_train_mode_stats_and_grads(denoiser):
    """flax's train-mode BatchNorm on axis -1: the batch statistics with
    the biased variance, and the same into the running variance."""
    flax_mod, v, _ = denoiser
    x, t, cond = _denoiser_inputs()
    w = _x((B, HIDDEN[-1]), seed=5)

    def f(params):
        out, mut = flax_mod.apply(
            {'params': params, 'batch_stats': v['batch_stats']},
            jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond), train=True,
            mutable=['batch_stats'])
        return jnp.sum(out * w), (out, mut)
    grads, (want, mut) = jax.grad(f, has_aux=True)(v['params'])

    mod = tnn.Denoiser(D, HIDDEN, E)
    mod.load_state_dict(sub_state_dict(v, 'denoiser', 'denoiser.'),
                        strict=True)
    mod.train()
    got = mod(torch.from_numpy(x), torch.from_numpy(t),
              torch.from_numpy(cond))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), RTOL,
                               ATOL)
    stats = sub_state_dict({'params': v['params'],
                            'batch_stats': jax.device_get(
                                mut['batch_stats'])},
                           'denoiser', 'denoiser.')
    buffers = dict(mod.named_buffers())
    running = [k for k in stats if 'running' in k]
    assert len(running) == 2 * (len(HIDDEN) - 1)
    for k in running:
        err = float((buffers[k] - stats[k]).abs().max())
        assert err <= STATS_TOL, (k, err)
        assert not torch.allclose(buffers[k], sub_state_dict(
            v, 'denoiser', 'denoiser.')[k]), k
    g = sub_state_dict({'params': jax.device_get(grads)}, 'denoiser',
                       'denoiser.')
    params = dict(mod.named_parameters())
    assert set(g) == set(params)
    # a bias whose shift a later train-mode BatchNorm removes has a true
    # gradient of 0 (net.{i}.0.bias and cond_layers.{i}.bias but the
    # last): both packages compute rounding noise there, held over the
    # step's largest gradient
    g_max = max(float(a.abs().max()) for a in g.values())
    for k, want_g in g.items():
        err = float((params[k].grad - want_g).abs().max())
        assert err <= max(GRAD_REL * float(want_g.abs().max()),
                          GRAD_FLOOR * g_max), (k, err)


def test_sinusoidal_at_constant_t():
    """The latent variant's t = -1 as an integer tensor, against JAX's
    embedding of the same int32 -1, and the sign it carries."""
    for channels in (16, 256):
        want = jax_sinusoidal(jnp.full((3,), -1, jnp.int32),
                                           channels)
        got = tnn.sinusoidal_pos_encoding(torch.full((3,), -1,
                                                     dtype=torch.long),
                                          channels)
        assert got.dtype == torch.float32 and got.shape == (3, channels)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-7)
        # sin is odd and cos even: t = -1 is not t = 1
        plus = tnn.sinusoidal_pos_encoding(torch.ones(3, dtype=torch.long),
                                           channels)
        h = channels // 2
        torch.testing.assert_close(got[:, :h], -plus[:, :h])
        torch.testing.assert_close(got[:, h:], plus[:, h:])


UNETS = {
    'stseunet_head': (
        lambda: jnn.STSEUnet(c_in=2, embedding_dim=E, latent_dim=D,
                             n_frames=3, n_joints=17, dropout=0.0,
                             set_out_layer=True,
                             unet_down_channels=DIFFUSION_DOWN_CHANNELS),
        lambda: tnn.STSEUnet(c_in=2, embedding_dim=E, latent_dim=D,
                             n_frames=3, n_joints=17, dropout=0.0,
                             set_out_layer=True,
                             unet_down_channels=DIFFUSION_DOWN_CHANNELS)),
    'stsaeunet_bottleneck': (
        lambda: jnn.STSAEUnet(c_in=2, embedding_dim=E, latent_dim=D,
                              n_frames=3, n_joints=17, dropout=0.0,
                              inject_condition=True, use_bottleneck=True),
        lambda: tnn.STSAEUnet(c_in=2, embedding_dim=E, latent_dim=D,
                              n_frames=3, n_joints=17, dropout=0.0,
                              inject_condition=True, use_bottleneck=True)),
}


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('name', list(UNETS))
def test_latent_unets(name, train):
    """Both latent U-Nets at t = -1 with an injected condition, in eval
    mode and in train mode (the output and every running statistic)."""
    make_flax, make_torch = UNETS[name]
    x, cond = _x((8, 2, 3, 17)), _x((8, E), seed=2)
    t = np.full((8,), -1, np.int32)
    flax_mod = make_flax()
    args = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    v = _init(flax_mod, *args)
    mod = make_torch()
    mod.load_state_dict(sub_state_dict(v, 'model', 'model.'), strict=True)
    mod.train(train)
    if train:
        (want, _), mut = jax.jit(lambda v, *a: flax_mod.apply(
            v, *a, train=True, mutable=['batch_stats']))(v, *args)
    else:
        want, _ = jax.jit(flax_mod.apply)(v, *args)
    with torch.no_grad():
        got, _ = mod(torch.from_numpy(x), torch.from_numpy(t).long(),
                     torch.from_numpy(cond))
    shape = (8, D) if name == 'stseunet_head' else (8, 2, 3, 17)
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), RTOL, ATOL)
    if train:
        stats = sub_state_dict({'params': v['params'],
                                'batch_stats': jax.device_get(
                                    mut['batch_stats'])}, 'model', 'model.')
        buffers = dict(mod.named_buffers())
        running = [k for k in stats if 'running' in k]
        assert running and set(running) == {k for k in buffers
                                             if 'running' in k}
        for k in running:
            err = float((buffers[k] - stats[k]).abs().max())
            assert err <= STATS_TOL, (k, err)


@pytest.mark.parametrize('stage', ['pretrain', 'diffusion'])
def test_state_dict_bridge(stage):
    """state_dict_from_jax emits the JAX exporter's keys and values, the
    port's net loads them strictly, and variables_from_state_dict gives
    the JAX tree back (to_time_dim / rev_to_time_dim and the denoiser
    included)."""
    kw = dict(LATENT_KW, stage=stage)
    jm = JaxLatent(JaxConfig(**kw))
    v = seeded_variables(jm, seed=7)
    ours = state_dict_from_jax(v)
    theirs = export_torch_state_dict(v)
    assert sorted(ours) == sorted(theirs)
    for k, val in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), val, err_msg=k)
    heads = {'model.to_time_dim.weight', 'model.to_time_dim.bias'}
    if stage == 'pretrain':
        heads |= {'model.rev_to_time_dim.weight', 'model.rev_to_time_dim.bias'}
        assert not any(k.startswith('denoiser.') for k in ours)
    else:
        heads |= {'denoiser.net.0.1.running_mean', 'denoiser.net.3.weight'}
    assert heads <= set(ours)

    tm = build_model(TorchConfig(**kw))
    assert isinstance(tm, MoCoDADLatentModel)
    net = tm.build_net()
    net.load_state_dict(ours, strict=True)
    back = variables_from_state_dict(net.state_dict())
    flat_v = jax.tree_util.tree_flatten_with_path(v)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_v) == len(flat_b)
    for path, leaf in flat_v:
        np.testing.assert_array_equal(np.asarray(flat_b[path]).reshape(
            np.shape(leaf)), np.asarray(leaf), err_msg=str(path))


@pytest.mark.parametrize('stage', ['pretrain', 'diffusion'])
def test_convert_checkpoint_both_ways(stage, tmp_path):
    """tools/convert_checkpoint.py on latent checkpoints: a JAX msgpack
    train state to a reference .ckpt with the JAX exporter's tensors, and
    that .ckpt back to a msgpack that JAX `restore_variables` reads as the
    same variables (strict both ways)."""
    from mocodad_tpu.training.checkpoint import (restore_variables,
                                                 save_checkpoint)
    from mocodad_tpu_torch.tools import convert_checkpoint
    kw = dict(LATENT_KW, stage=stage)
    jm = JaxLatent(JaxConfig(**kw))
    v = seeded_variables(jm, seed=5)
    src, ref, back = (str(tmp_path / n) for n in ('jax.ckpt', 'ref.ckpt',
                                                  'flax.ckpt'))
    save_checkpoint(src, {'params': v['params'],
                          'batch_stats': v['batch_stats'],
                          'step': np.int32(3)})
    cfg = TorchConfig(**kw)
    n = convert_checkpoint.convert(cfg, 'to-torch', src, ref)
    sd = torch.load(ref, map_location='cpu', weights_only=True)['state_dict']
    want = export_torch_state_dict(v)
    assert n == len(want) and sorted(sd) == sorted(want)
    for k, val in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), val, err_msg=k)
    convert_checkpoint.convert(cfg, 'to-flax', ref, back)
    got = restore_variables(back, jm.init_variables(jax.random.key(0)))
    for a, b in zip(jax.tree_util.tree_leaves(v),
                    jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


@pytest.mark.parametrize('name', ['mocodad-latent_train.yaml',
                                  'mocodad-latent_test.yaml'])
def test_shipped_latent_configs_build(name):
    """The shipped latent configs build the latent model at their widths
    (latent 64, MLP [64, 128, 128, 64]) with the JAX model's parameter
    names and shapes."""
    import os
    from mocodad_tpu.config import load_config as jax_load
    from mocodad_tpu.models import build_model as jax_build
    from mocodad_tpu_torch.config import load_config
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'config', 'UBnormal', name)
    model = build_model(load_config(path, finalize=False))
    jm = jax_build(jax_load(path, finalize=False))
    assert isinstance(model, MoCoDADLatentModel)
    assert model.stage == jm.stage == ('pretrain' if 'train' in name
                                       else 'diffusion')
    assert model.latent_embedding_dim == 64
    assert model.hidden_sizes == (64, 128, 128, 64)
    shapes = jax.eval_shape(jm.init_variables, jax.random.key(0))
    want = {k: tuple(np.shape(a)) for k, a in export_torch_state_dict(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                               shapes)).items()}
    got = {k: tuple(t.shape) for k, t in model.build_net().state_dict()
           .items() if not k.endswith('num_batches_tracked')}
    assert got == want


@pytest.mark.parametrize('name', ['mocodad-latent_train.yaml',
                                  'mocodad-latent_test.yaml'])
def test_latent_config_is_the_shipped_yaml(name):
    """config.latent_config, which chip_smoke.py drives on a machine
    without PyYAML, sets every key it sets as the shipped YAML does."""
    import os
    import yaml
    from mocodad_tpu_torch.config import latent_config
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'config', 'UBnormal', name)
    with open(path) as f:
        raw = yaml.safe_load(f)
    test = dict(split='test', validation=False, use_hr=True,
                n_generated_samples=50, save_tensors=True)
    cfg = (latent_config() if 'train' in name
           else latent_config('diffusion', **test))
    keys = set(latent_config().__dict__) & set(raw)
    keys -= {'data_dir', 'exp_dir', 'test_path', 'dir_name', 'load_ckpt',
             'pretrained_model_ckpt_path', 'devices', 'accelerator',
             'project_name', 'wandb_entity', 'group_name', 'use_wandb',
             'create_experiment_dir', 'debug', 'load_tensors', 'num_workers'}
    assert len(keys) > 40
    for k in sorted(keys):
        assert getattr(cfg, k) == raw[k], k
