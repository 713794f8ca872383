"""The eval slice as a whole, checkpoint to AUC: the port against the JAX
package on the same synthetic data, weights and gaussians."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import CFG_KW, jax_model, trained_variables
from mocodad_tpu import data as jdata
from mocodad_tpu.config import Config as JaxConfig
from mocodad_tpu.data import synthetic
from mocodad_tpu.eval.harness import post_processing_from_config as jax_post
from mocodad_tpu.utils.torch_compat import export_torch_state_dict
from mocodad_tpu_torch import data as tdata
from mocodad_tpu_torch.config import Config as TorchConfig
from mocodad_tpu_torch.eval.harness import post_processing_from_config as \
    torch_post
from mocodad_tpu_torch.training.inference import restore_and_infer

S, BATCH, VIEWS = 2, 96, 2


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp('e2e')
    synthetic.generate(str(root / 'data'), seed=0, n_clips_per_split=2,
                       n_actors=2, n_frames=40)
    kw = dict(CFG_KW, n_generated_samples=S, batch_size=BATCH,
              num_transform=VIEWS, data_dir=str(root / 'data'),
              gt_path=str(root / 'data' / 'testing' / 'test_frame_mask'),
              use_hr=False, load_ckpt='ref.ckpt')
    cfgs = {}
    for name, cls in (('jax', JaxConfig), ('torch', TorchConfig)):
        ckpt_dir = root / name
        ckpt_dir.mkdir()
        cfgs[name] = cls(**kw, ckpt_dir=str(ckpt_dir), split='test')
    # the train split fits and saves the robust scaler the test split loads
    jdata.build_dataset(cfgs['jax'], split='train')
    tdata.build_dataset(cfgs['torch'], split='train')
    return cfgs


def test_dataset_and_views_match(setup):
    dj = jdata.build_dataset(setup['jax'], split='test')
    dt = tdata.build_dataset(setup['torch'], split='test')
    for name in ('data', 'meta', 'frames'):
        np.testing.assert_array_equal(getattr(dt, name), getattr(dj, name))
    assert len(dt) == len(dj) and dt.num_transform == VIEWS
    bj = next(jdata.make_loader(dj, BATCH))
    bt = next(tdata.make_loader(dt, BATCH))
    for k in bj:
        np.testing.assert_array_equal(bt[k], bj[k])
    mats = jdata.affine_transform_matrices(5)
    trans = np.arange(BATCH) % 5
    want = jdata.apply_affine_batch(jnp.asarray(bj['data']), mats,
                                    jnp.asarray(trans))
    got = tdata.apply_affine_batch(torch.from_numpy(bt['data']),
                                   torch.from_numpy(mats),
                                   torch.from_numpy(trans))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_post_processing_matches(setup):
    ds = tdata.build_dataset(setup['torch'], split='test')
    n = len(ds)
    loss = np.random.default_rng(2).random(n).astype(np.float32)
    trans = np.repeat(np.arange(VIEWS), ds.num_samples).astype(np.int32)
    meta = np.tile(ds.meta, (VIEWS, 1))
    frames = np.tile(ds.frames, (VIEWS, 1))
    a = torch_post(loss, trans, meta, frames, setup['torch'])
    b = jax_post(loss, trans, meta, frames, setup['jax'])
    assert a == b


def _noise(batch_idx, n_rows):
    rng = np.random.default_rng(100 + batch_idx)
    return (rng.standard_normal((n_rows, 2, 3, 17)).astype(np.float32),
            rng.standard_normal((9, n_rows, 2, 3, 17)).astype(np.float32))


def test_restore_and_infer_matches_jax(setup):
    jm = jax_model(n_generated_samples=S)
    variables = trained_variables(jm, seed=21)
    # a reference-named Lightning checkpoint of the JAX weights, written
    # with the JAX package's own exporter
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in export_torch_state_dict(variables).items()}
    cfg_t, cfg_j = setup['torch'], setup['jax']
    torch.save({'state_dict': sd}, f'{cfg_t.ckpt_dir}/{cfg_t.load_ckpt}')

    model, ds, res = restore_and_infer(
        cfg_t, device='cpu',
        noise_fn=lambda i, n: tuple(map(torch.from_numpy, _noise(i, n))))

    # the JAX side: the same batches, views and gaussians through generate
    dj = jdata.build_dataset(cfg_j, split='test')
    mats = jdata.affine_transform_matrices(VIEWS)
    gen = jax.jit(lambda v, d, nz: jm.generate(v, d, jax.random.key(0),
                                               noise_override=nz))
    out = {k: [] for k in ('loss', 'trans', 'meta', 'frames')}
    for i, b in enumerate(jdata.make_loader(dj, BATCH)):
        data = jdata.apply_affine_batch(jnp.asarray(b['data']), mats,
                                        jnp.asarray(b['trans']))
        noise = tuple(map(jnp.asarray, _noise(i, BATCH * S)))
        _, loss = gen(variables, data, noise)
        valid = b['mask'] > 0
        out['loss'].append(np.asarray(loss)[valid])
        for k in ('trans', 'meta', 'frames'):
            out[k].append(b[k][valid])
    want = {k: np.concatenate(v) for k, v in out.items()}

    assert res['loss'].shape == want['loss'].shape == (len(ds),)
    for k in ('trans', 'meta', 'frames'):
        np.testing.assert_array_equal(res[k], want[k])
    np.testing.assert_allclose(res['loss'], want['loss'], rtol=1e-4,
                               atol=1e-6)
    auc_t = torch_post(res['loss'], res['trans'], res['meta'],
                       res['frames'], cfg_t)
    auc_j = jax_post(want['loss'], want['trans'], want['meta'],
                     want['frames'], cfg_j)
    assert abs(auc_t - auc_j) <= 1e-6
    assert 0.0 <= auc_t <= 1.0
