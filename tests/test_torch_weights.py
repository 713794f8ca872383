"""The weight bridge: the JAX package's variables tree -> the port's
reference-named state dict, and checkpoints read back by the port."""

import numpy as np
import pytest
import torch

from _torch_port import jax_model, torch_model, trained_variables
from mocodad_tpu.utils.torch_compat import export_torch_state_dict
from mocodad_tpu_torch.utils.weights import (load_checkpoint_state_dict,
                                             state_dict_from_jax)


@pytest.fixture(scope='module')
def variables():
    return trained_variables(jax_model())


def test_state_dict_matches_jax_exporter(variables):
    ours = state_dict_from_jax(variables)
    theirs = export_torch_state_dict(variables)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        assert tuple(ours[k].shape) == v.shape, k
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


def test_state_dict_loads_strict(variables):
    net = torch_model().build_net()
    missing, unexpected = net.load_state_dict(state_dict_from_jax(variables),
                                              strict=True)
    assert not missing and not unexpected
    # the running statistics came across (a train-mode step moved them)
    bn = net.model.st_gcnnsd3[0].tcn[1]
    np.testing.assert_array_equal(
        bn.running_var.numpy(),
        variables['batch_stats']['model']['d3_0']['tcn_bn']['var'])
    assert not np.allclose(bn.running_var.numpy(), 1.0)


@pytest.mark.parametrize('layout', ['lightning', 'bare', 'ema'])
def test_checkpoint_round_trip(variables, tmp_path, layout):
    sd = state_dict_from_jax(variables)
    path = tmp_path / 'model.ckpt'
    if layout == 'lightning':
        torch.save({'state_dict': sd, 'epoch': 3}, path)
    elif layout == 'bare':
        torch.save(sd, path)
    else:
        # an EMA payload beside zeroed raw weights: use_ema must pick it
        raw = {k: torch.zeros_like(v) for k, v in sd.items()}
        torch.save({'state_dict': raw, 'state_dict_ema': sd}, path)
    back = load_checkpoint_state_dict(str(path), use_ema=(layout == 'ema'))
    net = torch_model().build_net()
    net.load_state_dict(back, strict=True)
    for k, v in net.state_dict().items():
        if k.endswith('num_batches_tracked'):
            continue
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
