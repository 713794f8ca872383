"""The JAX package's msgpack checkpoints in the port, without flax: the
port's codec (mocodad_tpu_torch/utils/msgpack.py) against flax's, a train
state written by the JAX `save_checkpoint` read by the port and run
through `generate` to the JAX losses, and the converter
(mocodad_tpu_torch/tools/convert_checkpoint.py) both ways, its `to-flax`
output read by the JAX `restore_variables`."""

import flax.serialization as ser
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import optax
import pytest
import torch

from _torch_port import CFG_KW, jax_model, seeded_variables, torch_model
from mocodad_tpu.training.checkpoint import (restore_variables,
                                             save_checkpoint)
from mocodad_tpu.training.loop import TrainState
from mocodad_tpu.utils.torch_compat import (convert_torch_state_dict,
                                            export_torch_state_dict)
from mocodad_tpu_torch.config import Config
from mocodad_tpu_torch.models.mocodad import seeded_state
from mocodad_tpu_torch.tools import convert_checkpoint
from mocodad_tpu_torch.training.checkpoint import (is_torch_checkpoint,
                                                   load_state_dict)
from mocodad_tpu_torch.utils import msgpack as M
from mocodad_tpu_torch.utils.weights import (load_checkpoint_state_dict,
                                             state_dict_from_jax,
                                             variables_from_state_dict)

# generate at float32 on both sides (tests/test_torch_generate.py)
RTOL, ATOL = 1e-4, 1e-5
B, S = 4, 2


@pytest.fixture(scope='module')
def variables():
    return seeded_variables(jax_model(n_generated_samples=S), seed=2)


@pytest.fixture(scope='module')
def jax_generate():
    """The JAX `generate` on injected noise, jitted once for the module."""
    jm = jax_model(n_generated_samples=S)
    return jax.jit(lambda v, data, x0, zs: jm.generate(
        v, data, jax.random.key(0), noise_override=(x0, zs))[1])


def _train_state(variables, ema):
    """A JAX train state as the JAX trainer writes it: Adam's state (a
    tuple, which flax writes as a map with keys '0', '1'), the step, and
    the EMA copy or None."""
    params = variables['params']
    opt_state = optax.adam(1e-3).init(params)
    return TrainState(params=params, batch_stats=variables['batch_stats'],
                      opt_state=opt_state, ema_params=ema,
                      step=jnp.asarray(12, jnp.int32))


def _leaves_equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb) and la
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_decoder_reads_what_flax_writes(variables):
    state = _train_state(variables, ema=variables['params'])
    blob = ser.to_bytes(state)
    got, want = M.unpackb(blob), ser.msgpack_restore(blob)
    assert set(got) == {'params', 'batch_stats', 'opt_state', 'ema_params',
                        'step'}
    assert set(got['opt_state']) == {'0', '1'}
    _leaves_equal(got, want)
    assert int(got['step']) == 12


def test_encoder_writes_flax_bytes_and_round_trips(variables):
    tree = ser.to_state_dict(_train_state(variables, ema=None))
    tree = jax.tree_util.tree_map(np.asarray, tree)
    tree.update(misc={'i': [0, -1, 200, -300, 70000, 2 ** 40], 'f': 0.25,
                      's': 'x' * 40, 'b': b'\x01' * 300, 't': True,
                      'n': None, 'np': np.float32(1.5)})
    blob = M.packb(tree)
    assert blob == msgpack.packb(tree, default=ser._msgpack_ext_pack,
                                 strict_types=True)
    back = M.unpackb(blob)
    _leaves_equal(back, ser.msgpack_restore(blob))
    assert back['misc']['np'].dtype == np.float32
    assert M.packb(back) == blob


@pytest.mark.parametrize('blob, what', [
    (msgpack.packb({'w': {'__msgpack_chunked_array__': True,
                          'shape': {'0': 2}}}), 'chunked'),
    (msgpack.packb({'w': msgpack.ExtType(9, b'abc')}), 'ext type 9'),
    (ser.msgpack_serialize({'w': 1 + 2j}), 'complex'),
    (ser.msgpack_serialize({'w': np.zeros(3, np.complex64)}), 'complex'),
    (b'\xc1', '0xc1'),
    (msgpack.packb({'w': 1})[:-1], 'truncated')],
    ids=['chunked', 'unknown_ext', 'complex', 'complex_array', 'never_used',
         'truncated'])
def test_decoder_refuses_what_it_does_not_read(blob, what):
    with pytest.raises(ValueError, match=what):
        M.unpackb(blob)


def _generate_losses(jax_generate, variables, sd):
    """Per-window losses of the JAX `generate` on `variables` and the port's
    on `sd`, on the same data and noise."""
    rng = np.random.default_rng(4)
    data = rng.standard_normal((B, 2, 6, 17)).astype(np.float32)
    x0 = rng.standard_normal((B * S, 2, 3, 17)).astype(np.float32)
    zs = rng.standard_normal((9, B * S, 2, 3, 17)).astype(np.float32)
    want = jax_generate(variables, jnp.asarray(data), jnp.asarray(x0),
                        jnp.asarray(zs))
    tm = torch_model(n_generated_samples=S)
    net = tm.build_net()
    net.load_state_dict(sd, strict=True)
    _, got = tm.generate(net.eval(), torch.from_numpy(data),
                         noise_override=(torch.from_numpy(x0),
                                         torch.from_numpy(zs)))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize('with_ema, use_ema', [
    (False, False), (True, False), (True, True), (False, True)],
    ids=['raw', 'ema_present_raw_taken', 'ema', 'ema_absent'])
def test_jax_checkpoint_runs_to_jax_losses(variables, jax_generate, tmp_path,
                                           capsys, with_ema, use_ema):
    """A JAX trainer's checkpoint, read by the port with strict=True, gives
    the JAX losses of the weights it should take: the EMA copy under
    use_ema when present, else the raw ones with a warning."""
    ema = seeded_variables(jax_model(n_generated_samples=S), seed=9)
    path = str(tmp_path / 'jax.ckpt')
    save_checkpoint(path, _train_state(
        variables, ema=ema['params'] if with_ema else None))
    assert not is_torch_checkpoint(path)
    sd = load_checkpoint_state_dict(path, use_ema=use_ema)
    taken = {'params': ema['params'] if with_ema and use_ema
             else variables['params'],
             'batch_stats': variables['batch_stats']}
    for k, v in state_dict_from_jax(taken).items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
    warned = 'carries no ema_params' in capsys.readouterr().err
    assert warned == (use_ema and not with_ema)
    got, want = _generate_losses(jax_generate, taken, sd)
    np.testing.assert_allclose(got, want, RTOL, ATOL)


def test_to_torch_matches_the_jax_exporter(variables, tmp_path):
    path, out = str(tmp_path / 'jax.ckpt'), str(tmp_path / 'ref.ckpt')
    save_checkpoint(path, _train_state(variables, ema=None))
    n = convert_checkpoint.convert(Config(**CFG_KW), 'to-torch', path, out)
    sd = torch.load(out, map_location='cpu', weights_only=True)['state_dict']
    want = export_torch_state_dict(variables)
    assert n == len(want) and sorted(sd) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_to_flax_is_read_by_jax_restore_variables(variables, tmp_path):
    ref, out = tmp_path / 'ref.ckpt', tmp_path / 'flax.ckpt'
    sd = state_dict_from_jax(variables)
    torch.save({'state_dict': sd, 'epoch': 3}, ref)
    convert_checkpoint.main(['to-flax', '-c', _yaml(tmp_path), '--ckpt',
                             str(ref), '--out', str(out)])
    assert not is_torch_checkpoint(str(out))
    jm = jax_model()
    back = restore_variables(str(out), jm.init_variables(jax.random.key(0)))
    _leaves_equal(back, variables)
    # the file holds exactly params and batch_stats, as flax would write
    # them, and reads back through the port to the same state dict
    assert set(load_state_dict(str(out))) == {'params', 'batch_stats'}
    for k, v in load_checkpoint_state_dict(str(out)).items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)


def _yaml(tmp_path):
    import yaml
    path = tmp_path / 'model.yaml'
    with open(path, 'w') as f:
        yaml.safe_dump(dict(CFG_KW), f)
    return str(path)


@pytest.mark.parametrize('edit', ['extra', 'missing', 'shape'])
def test_conversion_is_strict(variables, tmp_path, edit):
    sd = state_dict_from_jax(variables)
    if edit == 'extra':
        sd['model.unknown.weight'] = torch.zeros(2)
    elif edit == 'missing':
        sd.pop('model.down1.block.0.weight')
    else:
        sd['model.down1.block.0.weight'] = torch.zeros(3, 3, 1, 1)
    ref = tmp_path / 'ref.ckpt'
    torch.save({'state_dict': sd}, ref)
    for direction in ('to-flax', 'to-torch'):
        with pytest.raises(RuntimeError):
            convert_checkpoint.convert(Config(**CFG_KW), direction, str(ref),
                                       str(tmp_path / 'out'))
    with pytest.raises(ValueError, match='no flax counterpart'):
        variables_from_state_dict({'model.unknown.weight': torch.zeros(2)})


def test_to_flax_refuses_a_msgpack_input(variables, tmp_path):
    path = str(tmp_path / 'jax.ckpt')
    save_checkpoint(path, variables)
    with pytest.raises(SystemExit):
        convert_checkpoint.convert(Config(**CFG_KW), 'to-flax', path,
                                   str(tmp_path / 'out'))


@pytest.mark.parametrize('kw', [
    {}, dict(conditioning_architecture='E'),
    dict(conditioning_architecture='E_unet'),
    dict(conditioning_strategy='concat')], ids=['AE', 'E', 'E_unet', 'concat'])
def test_variables_from_state_dict_matches_jax(kw):
    """The port's state dict -> flax tree against the JAX package's
    convert_torch_state_dict, for every condition encoder, and back."""
    net = seeded_state(torch_model(**kw).build_net(), 1)
    got = variables_from_state_dict(net.state_dict())
    want = convert_torch_state_dict(net.state_dict())
    assert want.pop('_unmapped') == []
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    _leaves_equal(got, want)
    back = state_dict_from_jax(got)
    for k, v in net.state_dict().items():
        if not k.endswith('num_batches_tracked'):
            torch.testing.assert_close(back[k], v, rtol=0, atol=0)
