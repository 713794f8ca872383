"""Evaluation on two ranks (two CPU processes over gloo): each rank scores
its block of every batch's rows and the pass gathers them into global
order, so W = 2 returns what W = 1 returns, and what JAX `generate`
returns on the global batch under the same gaussians.

Covered: the loss route and the pose route, a padded last batch, DDIM,
antithetic draws, `random_imp` frame orders and the 'random' aggregation
(these three draw from the generator: W = 2 against W = 1 at the same
seed), and `restore_and_infer(n_devices=2)` to the same AUC.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import eval_case, run_ranks
from _torch_port import CFG_KW, jax_model, trained_variables
from mocodad_tpu import data as jdata
from mocodad_tpu.utils.torch_compat import export_torch_state_dict
from mocodad_tpu_torch import data as tdata
from mocodad_tpu_torch.config import Config
from mocodad_tpu_torch.eval.harness import post_processing_from_config
from mocodad_tpu_torch.models.mocodad import build_model
from mocodad_tpu_torch.training.inference import restore_and_infer

S, BATCH, VIEWS, SEED = 2, 96, 2, 3
# W = 2 against W = 1: each fold row is computed on its own, so the two
# agree to float32 summation order at most (per window, over the largest)
REL = 1e-6
# against JAX under the same gaussians (tests/test_torch_generate.py)
RTOL, ATOL = 1e-4, 1e-5
INJECTED = ('loss', 'pose', 'ddim')
SEEDED = ('loss_seeded', 'antithetic', 'random_imp', 'random_aggregation')
DDIM = {'sampler': 'ddim', 'ddim_steps': 3}

_BODY = '''
from _torch_dist import eval_case
from mocodad_tpu_torch.config import Config
from mocodad_tpu_torch.eval.harness import post_processing_from_config
from mocodad_tpu_torch.training.inference import restore_and_infer
for name, case in INPUTS['cases'].items():
    OUT[name] = eval_case(case, INPUTS['windows'], mesh)
cfg = Config(**INPUTS['restore_kw'])
_, _, res = restore_and_infer(cfg, device='cpu', n_devices=WORLD)
OUT['restored'] = res
OUT['auc'] = post_processing_from_config(res['loss'], res['trans'],
                                         res['meta'], res['frames'], cfg)
'''


def _noise(n_batches, tc_steps, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((BATCH * S, 2, 3, 17)).astype(np.float32),
             rng.standard_normal((tc_steps, BATCH * S, 2, 3, 17))
             .astype(np.float32)) for _ in range(n_batches)]


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp('dist_eval')
    from mocodad_tpu_torch.data import synthetic
    synthetic.generate(str(root / 'data'), seed=0, n_clips_per_split=2,
                       n_actors=2, n_frames=40)
    base = dict(CFG_KW, n_generated_samples=S, batch_size=BATCH,
                num_transform=VIEWS, data_dir=str(root / 'data'),
                gt_path=str(root / 'data' / 'testing' / 'test_frame_mask'),
                use_hr=False, load_ckpt='ref.ckpt', ckpt_dir=str(root),
                split='test', seed=SEED)
    tdata.build_dataset(Config(**base), split='train')   # the scaler
    ds = tdata.build_dataset(Config(**base), split='test')
    windows = {'data': ds.data, 'meta': ds.meta, 'frames': ds.frames}
    n_batches = -(-len(ds) // BATCH)
    variables = trained_variables(jax_model(n_generated_samples=S), seed=21)
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in export_torch_state_dict(variables).items()}
    torch.save({'state_dict': sd}, root / 'ref.ckpt')
    torch.manual_seed(5)
    imp_kw = dict(base, conditioning_strategy='random_imp',
                  conditioning_indices=3)
    imp_sd = build_model(Config(**imp_kw)).build_net().state_dict()
    cases = {
        'loss': dict(kw=base, sd=sd, seed=SEED, with_pose=False,
                     noise=_noise(n_batches, 9, 1)),
        'pose': dict(kw=base, sd=sd, seed=SEED, with_pose=True,
                     noise=_noise(n_batches, 9, 2)),
        'ddim': dict(kw=dict(base, extras=DDIM), sd=sd, seed=SEED,
                     with_pose=True, noise=_noise(n_batches, 3, 3)),
        'loss_seeded': dict(kw=base, sd=sd, seed=SEED, with_pose=True),
        'antithetic': dict(kw=dict(base, n_generated_samples=3,
                                   extras={'antithetic': True}),
                           sd=sd, seed=SEED, with_pose=True),
        'random_imp': dict(kw=imp_kw, sd=imp_sd, seed=SEED, with_pose=True),
        'random_aggregation': dict(
            kw=dict(base, aggregation_strategy='random'), sd=sd, seed=SEED,
            with_pose=True)}
    ranks = run_ranks(root / 'work', _BODY, {
        'cases': cases, 'windows': windows, 'restore_kw': base})
    one = {name: eval_case(case, windows) for name, case in cases.items()}
    cfg = Config(**base)
    _, _, res = restore_and_infer(cfg, device='cpu')
    one['restored'] = res
    one['auc'] = post_processing_from_config(res['loss'], res['trans'],
                                             res['meta'], res['frames'], cfg)
    return root, base, variables, cases, ranks, one, len(ds)


@pytest.mark.parametrize('name', INJECTED + SEEDED + ('restored',))
def test_two_ranks_return_what_one_returns(runs, name):
    _, _, _, cases, ranks, one, n = runs
    want = one[name]
    assert want['loss'].shape[0] == n and n % BATCH, 'no padded batch'
    for got in (r[name] for r in ranks):
        for k in ('trans', 'meta', 'frames'):
            np.testing.assert_array_equal(got[k], want[k])
        for k in ('loss', 'pose'):
            if want[k] is None:
                assert got[k] is None, k
                continue
            assert got[k].shape == want[k].shape, k
            err = np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
            assert err <= REL, (k, err)
    for k in ('loss', 'pose'):
        if ranks[0][name][k] is not None:
            np.testing.assert_array_equal(ranks[0][name][k],
                                          ranks[1][name][k])


def test_seeded_draws_are_used(runs):
    """The seeded cases draw their own gaussians: they differ from the
    injected ones, and the antithetic draws from the plain ones."""
    _, _, _, _, ranks, one, _ = runs
    for a, b in (('loss', 'loss_seeded'), ('loss_seeded', 'antithetic'),
                 ('loss_seeded', 'random_aggregation')):
        assert not np.allclose(ranks[0][a]['loss'], ranks[0][b]['loss'])


@pytest.mark.parametrize('name', INJECTED)
def test_two_ranks_match_jax_generate(runs, name):
    root, base, variables, cases, ranks, _, _ = runs
    case = cases[name]
    jm = jax_model(n_generated_samples=S, **({'extras': DDIM}
                                             if name == 'ddim' else {}))
    dj = jdata.build_dataset(_jax_config(base, root), split='test')
    mats = jdata.affine_transform_matrices(VIEWS)
    gen = jax.jit(lambda v, d, nz: jm.generate(v, d, jax.random.key(0),
                                               noise_override=nz))
    loss, pose = [], []
    for i, b in enumerate(jdata.make_loader(dj, BATCH)):
        data = jdata.apply_affine_batch(jnp.asarray(b['data']), mats,
                                        jnp.asarray(b['trans']))
        sel, l = gen(variables, data, tuple(map(jnp.asarray,
                                                case['noise'][i])))
        valid = b['mask'] > 0
        loss.append(np.asarray(l)[valid])
        pose.append(np.asarray(sel)[valid])
    got = ranks[1][name]
    np.testing.assert_allclose(got['loss'], np.concatenate(loss), RTOL, ATOL)
    if case['with_pose']:
        np.testing.assert_allclose(got['pose'], np.concatenate(pose), RTOL,
                                   ATOL)


def _jax_config(base, root):
    from mocodad_tpu.config import Config as JaxConfig
    jroot = root / 'jax'
    jroot.mkdir(exist_ok=True)
    cfg = JaxConfig(**dict(base, ckpt_dir=str(jroot)))
    jdata.build_dataset(cfg, split='train')
    return cfg


def test_restore_and_infer_on_two_ranks_gives_the_same_auc(runs):
    *_, ranks, one, _ = runs
    assert 0.0 <= one['auc'] <= 1.0
    assert ranks[0]['auc'] == ranks[1]['auc'] == one['auc']
