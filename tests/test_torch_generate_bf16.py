"""Generation at `eval_dtype: bfloat16`: the port's `generate` against the
JAX package's `build_pallas_eval` (B1 at bfloat16, interpret mode) on the
same weights and the same gaussians, and `restore_and_infer` at bfloat16
against per-batch calls of that `generate`.

`build_pallas_eval` has no noise override, so the test reproduces its
draws (mocodad_tpu/models/mocodad.py:529-553) and hands them to the port
as `noise_override`.  JAX's bfloat16 `generate()` is a different function
(it casts the encoder and keeps the update in bfloat16) and is not the
reference here.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import CFG_KW, bf16_stats, seeded_variables, torch_net
from mocodad_tpu.config import Config as JaxConfig
from mocodad_tpu.models import MoCoDADModel as JaxModel
from mocodad_tpu_torch.config import Config as TorchConfig
from mocodad_tpu_torch.data import (affine_transform_matrices,
                                    apply_affine_batch, build_dataset,
                                    make_loader, synthetic)
from mocodad_tpu_torch.models.mocodad import MoCoDADModel as TorchModel
from mocodad_tpu_torch.training.inference import restore_and_infer

B, S = 4, 3
# bfloat16 chains on both sides with the same rounding points; sums in
# another order flip a bfloat16 rounding now and then, and the 9 steps
# carry it.  Measured on three seeds: losses within 0.02-0.09 % of the
# largest loss, selected poses within 0.5-1.4 % (max) and 0.06-0.13 %
# (mean); the float32 chain on the same noise is 0.22-0.26 % (losses) and
# 0.52-0.55 % (pose mean) away, so these bounds tell the two apart.
LOSS_REL = 1.5e-3
POSE_MAX_REL, POSE_MEAN_REL = 2.5e-2, 2.5e-3


def _cfg(cls, **kw):
    cfg = cls(**{**CFG_KW, 'n_generated_samples': S, **kw})
    cfg.extras['eval_dtype'] = 'bfloat16'
    return cfg


@pytest.fixture(scope='module')
def models():
    jm = JaxModel(_cfg(JaxConfig))
    variables = seeded_variables(jm, seed=12)
    gen = jm.build_pallas_eval(variables, nb=8, interpret=True)
    tm = TorchModel(_cfg(TorchConfig))
    assert tm.eval_dtype == torch.bfloat16
    return gen, tm, torch_net(tm, variables)


def pallas_eval_noise(key, b, s):
    """build_pallas_eval's gaussians for `gen(data, key)`, in the port's
    (B*S, C, Tc, V) fold: x0 drawn in bfloat16 as (C, Tc*V, B*S), and per
    step z drawn in float32, zero at t == 1."""
    r_init, r_steps, _ = jax.random.split(key, 3)
    n = b * s
    x = jax.random.normal(r_init, (2, 3 * 17, n), dtype=jnp.bfloat16)
    keys = jax.random.split(r_steps, 9)
    zs = [jax.random.normal(k, x.shape, dtype=jnp.float32) * (t > 1)
          for k, t in zip(keys, range(9, 0, -1))]

    def fold(a):
        a = np.asarray(jnp.asarray(a, jnp.float32))
        return np.ascontiguousarray(
            a.reshape(2, 3, 17, n).transpose(3, 0, 1, 2))

    return (torch.from_numpy(fold(x)),
            torch.from_numpy(np.stack([fold(z) for z in zs])))


@pytest.mark.parametrize('seed', [1, 2])
def test_bf16_generate_matches_pallas_eval(models, seed):
    gen, tm, net = models
    data = np.random.default_rng(seed).standard_normal(
        (B, 2, 6, 17)).astype(np.float32)
    key = jax.random.key(seed)
    sel_j, loss_j = gen(jnp.asarray(data), key)
    sel_t, loss_t = tm.generate(net, torch.from_numpy(data),
                                noise_override=pallas_eval_noise(key, B, S))
    assert sel_t.dtype == loss_t.dtype == torch.float32
    assert sel_t.shape == (B, 2, 3, 17) and loss_t.shape == (B,)
    loss_j = np.asarray(loss_j)
    assert np.abs(loss_t.numpy() - loss_j).max() <= \
        LOSS_REL * np.abs(loss_j).max()
    max_rel, mean_rel = bf16_stats(sel_t.numpy(), np.asarray(sel_j))
    assert max_rel <= POSE_MAX_REL and mean_rel <= POSE_MEAN_REL, \
        (max_rel, mean_rel)


def _noise(batch_idx, n_rows):
    rng = np.random.default_rng(200 + batch_idx)
    return (torch.from_numpy(
                rng.standard_normal((n_rows, 2, 3, 17)).astype(np.float32)),
            torch.from_numpy(
                rng.standard_normal((9, n_rows, 2, 3, 17)).astype(
                    np.float32)))


def test_restore_and_infer_bf16(models, tmp_path):
    """The bfloat16 chain flows through `restore_and_infer` as it is: each
    batch's losses are those of `generate` on the same views and noise,
    finite, and not the float32 chain's."""
    _, tm, net = models
    synthetic.generate(str(tmp_path / 'data'), seed=0, n_clips_per_split=2,
                       n_actors=2, n_frames=40)
    kw = dict(batch_size=64, num_transform=2, data_dir=str(tmp_path / 'data'),
              ckpt_dir=str(tmp_path), split='test', load_ckpt='net.ckpt',
              use_hr=False,
              gt_path=str(tmp_path / 'data' / 'testing' / 'test_frame_mask'))
    cfg = _cfg(TorchConfig, **kw)
    build_dataset(cfg, split='train')          # fits the robust scaler
    torch.save({'state_dict': net.state_dict()},
               os.path.join(cfg.ckpt_dir, cfg.load_ckpt))
    model, ds, res = restore_and_infer(cfg, device='cpu', noise_fn=_noise)
    assert model.eval_dtype == torch.bfloat16
    assert res['loss'].shape == (len(ds),)
    assert np.isfinite(res['loss']).all()

    mats = torch.from_numpy(affine_transform_matrices(ds.num_transform))
    want = []
    for i, b in enumerate(make_loader(ds, cfg.batch_size)):
        data = apply_affine_batch(torch.from_numpy(b['data']), mats,
                                  torch.from_numpy(b['trans']).long())
        _, loss = tm.generate(net, data,
                              noise_override=_noise(i, data.shape[0] * S))
        want.append(loss.numpy()[b['mask'] > 0])
    np.testing.assert_array_equal(res['loss'], np.concatenate(want))

    cfg32 = TorchConfig(**{**CFG_KW, 'n_generated_samples': S, **kw})
    _, _, res32 = restore_and_infer(cfg32, device='cpu', noise_fn=_noise)
    assert not np.array_equal(res32['loss'], res['loss'])
    np.testing.assert_allclose(res32['loss'], res['loss'], rtol=5e-2)
