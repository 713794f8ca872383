"""Training the latent variant with the port against the JAX package: three
diffusion-stage steps of `Trainer` against the JAX `Trainer`'s own masked
step (Adam over every parameter, the updates of all but the denoiser
zeroed, the frozen encoders in train mode), `merge_matching` with a
tensor of another shape, and the pretrained transfer from a JAX msgpack
checkpoint and from the port's own checkpoint.

Both trainers start from the same seeded variables: a JAX msgpack of them
is each one's `pretrained_model_ckpt_path`, and each copies it in with its
own transfer code.  The JAX step draws t and the latent noise from
fold_in(key(seed), step); the test draws the same and hands them to the
port's trainer as its `noise_fn`.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_port import CFG_KW, seeded_variables
from mocodad_tpu.config import Config as JaxConfig
from mocodad_tpu.diffusion import sample_timesteps as jax_timesteps
from mocodad_tpu.models import MoCoDADLatentModel as JaxLatent
from mocodad_tpu.training.checkpoint import merge_matching as jax_merge
from mocodad_tpu.training.checkpoint import save_checkpoint as jax_save
from mocodad_tpu.training.loop import Trainer as JaxTrainer
from mocodad_tpu_torch.config import Config as TorchConfig
from mocodad_tpu_torch.training.checkpoint import merge_matching
from mocodad_tpu_torch.training.loop import Trainer
from mocodad_tpu_torch.utils.weights import state_dict_from_jax

B, D, STEPS, LR = 16, 16, 3, 1e-3
LOSS_RTOL = 1e-5
STATS_TOL = 1e-6
# three Adam steps (tests/test_torch_train_step.py): per tensor max |diff|
# within 20 % of one step, and the mean |diff| over all the denoiser's
# parameters within 0.1 % of one step.  Adam divides each element's
# gradient by its own running magnitude, so an element with a gradient
# near 0 turns rounding into a visible share of a step; the denoiser's
# tensors are small (16 BatchNorm biases), so the mean is taken over the
# whole denoiser.  A bias whose shift a later train-mode BatchNorm removes
# has a true gradient of 0 and steps on rounding noise in both packages,
# so it is held to the most three steps can move apart, and so is the
# running mean of the BatchNorm behind it.
ADAM_MAX_TOL, ADAM_MEAN_TOL = 2e-4, 1e-6


def _kw(stage, ckpt, **kw):
    return dict(CFG_KW, diffusion_on_latent=True, stage=stage,
                latent_embedding_dim=D, hidden_sizes=[16, 32, 16],
                opt_lr=LR, num_transform=2, seed=4,
                pretrained_model_ckpt_path=str(ckpt), **kw)


def _noise_free_bias(k):
    """Biases whose true gradient is 0: the denoiser's Linear biases in
    front of a BatchNorm and its condition biases but the last, and the
    GCN / joint-mix biases in front of theirs."""
    if k.startswith('denoiser.'):
        return k.endswith('.0.bias') or (
            k.startswith('denoiser.cond_layers.')
            and not k.startswith('denoiser.cond_layers.2.'))
    return k.endswith(('tcn.0.bias', 'residual.0.bias', 'block.0.bias'))


@pytest.fixture(scope='module')
def seeded(tmp_path_factory):
    """Seeded diffusion-stage variables and a JAX msgpack of them."""
    root = tmp_path_factory.mktemp('latent_train')
    jm = JaxLatent(JaxConfig(**_kw('diffusion', '')))
    variables = seeded_variables(jm, seed=7)
    path = root / 'seeded.msgpack'
    jax_save(str(path), {'params': variables['params'],
                         'batch_stats': variables['batch_stats']})
    return variables, path


def _batches():
    rng = np.random.default_rng(3)
    out = []
    for k in range(STEPS):
        mask = np.ones(B, np.float32)
        mask[k::7] = 0.0
        out.append((rng.standard_normal((B, 2, 6, 17)).astype(np.float32),
                    rng.integers(0, 2, B).astype(np.int32), mask))
    return out


def test_three_diffusion_steps_match_jax_masked_step(seeded):
    variables, path = seeded
    batches = _batches()
    jt = JaxTrainer(JaxConfig(**_kw('diffusion', path)), n_devices=1)
    state = jt.init_state(2, jax.random.key(4))
    step_fn = jt._build_train_step()
    rng = jax.random.key(4)
    noise, jax_losses = {}, []
    for k, (data, trans, mask) in enumerate(batches):
        _, r_t, r_noise, _ = jax.random.split(jax.random.fold_in(rng, k), 4)
        noise[k] = (torch.from_numpy(np.asarray(jax_timesteps(r_t, B, 10))),
                    torch.from_numpy(np.array(jax.random.normal(
                        r_noise, (B, D)))))
        state, metrics = step_fn(state, {'data': data, 'trans': trans,
                                         'mask': mask}, rng)
        jax_losses.append(float(metrics['loss']))
    jax_after = state_dict_from_jax({
        'params': jax.device_get(state.params),
        'batch_stats': jax.device_get(state.batch_stats)})

    trainer = Trainer(TorchConfig(**_kw('diffusion', path)), device='cpu',
                      noise_fn=lambda step, rows: noise[step])
    trainer.init_state(2)
    start = {k: v.clone() for k, v in trainer.net.state_dict().items()}
    for k, v in state_dict_from_jax(variables).items():
        torch.testing.assert_close(start[k], v, rtol=0, atol=0)
    # the optimizer holds the denoiser alone; the rest stops requiring
    # gradients but stays in train mode
    held = {id(p) for g in trainer.opt.param_groups for p in g['params']}
    for k, p in trainer.net.named_parameters():
        assert (id(p) in held) == p.requires_grad == k.startswith(
            'denoiser.'), k
    assert all(m.training for m in trainer.net.modules())
    losses = []
    for data, trans, mask in batches:
        losses.append(float(trainer.train_step(
            torch.from_numpy(data), torch.from_numpy(trans),
            torch.from_numpy(mask))['loss']))
    np.testing.assert_allclose(losses[0], jax_losses[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(losses, jax_losses, rtol=10 * LOSS_RTOL)

    after = trainer.net.state_dict()
    params = dict(trainer.net.named_parameters())
    moved, diffs = 0, []
    for k, got in after.items():
        if k.endswith('num_batches_tracked'):
            continue
        want = jax_after[k].reshape(got.shape)
        if k in params and not k.startswith('denoiser.'):
            # frozen: bit-equal to the start, on both sides
            assert torch.equal(got, start[k]), k
            assert torch.equal(want, start[k]), k
        elif k in params:
            moved += not torch.equal(got, start[k])
            err = float((got - want).abs().max())
            if _noise_free_bias(k):
                assert err <= 2 * STEPS * LR, (k, err)
                continue
            assert err <= ADAM_MAX_TOL, (k, err)
            diffs.append((got - want).abs().ravel())
        else:
            # running statistics: the frozen encoders' move as JAX's do;
            # the denoiser's running means take in the noise of the biases
            # in front of them (measured up to 2.7e-5, the rest 2.4e-7)
            assert not torch.equal(got, start[k]), k
            err = float((got - want).abs().max())
            tol = (2 * STEPS * LR if k.startswith('denoiser.')
                   and k.endswith('running_mean') else STATS_TOL)
            assert err <= tol, (k, err)
    assert moved == sum(k.startswith('denoiser.') for k in params)
    assert float(torch.cat(diffs).mean()) <= ADAM_MEAN_TOL


def test_merge_matching_keeps_mismatched_shapes(seeded):
    """A source with one tensor of another shape, one key missing and one
    extra: the target keeps its own tensor where JAX's merge_matching
    does, where load_state_dict(strict=False) would raise; the BatchNorm
    statistics come across."""
    variables, _ = seeded
    jm = JaxLatent(JaxConfig(**_kw('diffusion', '')))
    target = seeded_variables(jm, seed=8)
    src = {'params': jax.tree_util.tree_map(np.copy, variables['params']),
           'batch_stats': variables['batch_stats']}
    src['params']['model']['to_time_dim_kernel'] = np.zeros((1920, 8),
                                                            np.float32)
    del src['params']['denoiser']['c1_bias']
    src['params']['extra'] = {'kernel': np.ones((2, 2), np.float32)}
    want = state_dict_from_jax({
        'params': jax.device_get(jax_merge(target['params'],
                                           src['params'])),
        'batch_stats': jax.device_get(jax_merge(target['batch_stats'],
                                                src['batch_stats']))})

    tsd = state_dict_from_jax(target)
    ssd = state_dict_from_jax({'params': {k: v for k, v in
                                          src['params'].items()
                                          if k != 'extra'},
                               'batch_stats': src['batch_stats']})
    ssd['extra.weight'] = torch.ones(2, 2)
    got = merge_matching(tsd, ssd)
    assert set(got) == set(tsd)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
    torch.testing.assert_close(got['model.to_time_dim.weight'],
                               tsd['model.to_time_dim.weight'])
    torch.testing.assert_close(got['denoiser.cond_layers.1.bias'],
                               tsd['denoiser.cond_layers.1.bias'])
    torch.testing.assert_close(got['denoiser.net.0.1.running_var'],
                               ssd['denoiser.net.0.1.running_var'])
    net = Trainer(TorchConfig(**_kw('diffusion', '')),
                  device='cpu').model.build_net()
    with pytest.raises(RuntimeError, match='size mismatch'):
        net.load_state_dict(ssd, strict=False)


@pytest.fixture(scope='module')
def pretrained(tmp_path_factory):
    """Seeded pretrain-stage variables, as a JAX msgpack train state and as
    the port's own checkpoint of a pretrain trainer."""
    root = tmp_path_factory.mktemp('pretrained')
    jm = JaxLatent(JaxConfig(**_kw('pretrain', '')))
    variables = seeded_variables(jm, seed=9)
    msgpack = root / 'pretrain.msgpack'
    jax_save(str(msgpack), {'params': variables['params'],
                            'batch_stats': variables['batch_stats'],
                            'step': np.int32(5)})
    t = Trainer(TorchConfig(**_kw('pretrain', '')), device='cpu')
    t.init_state(1)
    t.net.load_state_dict(state_dict_from_jax(variables), strict=True)
    own = root / 'pretrain.ckpt'
    torch.save(t.payload(), own)
    return variables, msgpack, own


@pytest.mark.parametrize('source', ['jax_msgpack', 'port_checkpoint'])
def test_pretrained_transfer(pretrained, source):
    """The diffusion stage's encoders (the STSEUnet's down path and head,
    the condition encoder) take the pretrain weights AND BatchNorm
    statistics, as the JAX trainer's `_load_pretrained_into` gives them;
    the pretrain U-Net's up path and bottleneck have no place, and the
    denoiser keeps its fresh init."""
    variables, msgpack, own = pretrained
    path = msgpack if source == 'jax_msgpack' else own
    jt = JaxTrainer(JaxConfig(**_kw('diffusion', msgpack)), n_devices=1)
    jstate = jt.init_state(1, jax.random.key(4))
    want = state_dict_from_jax({
        'params': jax.device_get(jstate.params),
        'batch_stats': jax.device_get(jstate.batch_stats)})
    t = Trainer(TorchConfig(**_kw('diffusion', path)), device='cpu')
    t.init_state(1)
    got = t.net.state_dict()
    pre = state_dict_from_jax(variables)
    copied = [k for k in got if not k.startswith('denoiser.')
              and not k.endswith('num_batches_tracked')]
    assert copied and all(k in pre for k in copied)
    assert any(k.endswith('running_var') for k in copied)
    for k in copied:
        torch.testing.assert_close(got[k], pre[k], rtol=0, atol=0, msg=k)
        torch.testing.assert_close(got[k], want[k].reshape(got[k].shape),
                                   rtol=0, atol=0, msg=k)
    assert not any(k.startswith(('model.st_gcnnsu', 'model.up',
                                 'model.rev_to_time_dim')) for k in got)


def test_empty_pretrained_path_raises():
    t = Trainer(TorchConfig(**_kw('diffusion', '')), device='cpu')
    with pytest.raises(ValueError, match='Pretrained model checkpoint path'):
        t.init_state(1)
