"""The latent slice as a whole, on the CPU.

* A JAX `save_checkpoint` of seeded weights goes into the port's
  `restore_and_infer`: at stage 'diffusion' with the same per-batch
  gaussians as JAX `generate` takes through `noise_override`, at stage
  'pretrain' against the JAX trainer's own `run_inference`; per-window
  losses and the AUC after `post_processing_from_config`.
* Two stages through the port's CLIs on a tiny synthetic split:
  train_MoCoDAD_torch.py at pretrain, then at diffusion from the first
  run's best_weights.ckpt, then eval_MoCoDAD_torch.py and
  predict_MoCoDAD_torch.py, all with --device cpu.
* The streaming scorer at stage 'diffusion' against the JAX StreamScorer
  on the same weights and per-flush noise.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from _torch_port import CFG_KW, seeded_variables
from mocodad_tpu import data as jdata
from mocodad_tpu.config import Config as JaxConfig
from mocodad_tpu.eval.harness import post_processing_from_config as jax_post
from mocodad_tpu.models import MoCoDADLatentModel as JaxLatent
from mocodad_tpu.serve import StreamScorer as JaxStreamScorer
from mocodad_tpu.training.checkpoint import save_checkpoint as jax_save
from mocodad_tpu.training.loop import Trainer as JaxTrainer
from mocodad_tpu_torch import data as tdata
from mocodad_tpu_torch.config import Config as TorchConfig
from mocodad_tpu_torch.data import synthetic
from mocodad_tpu_torch.data import trajectories as T
from mocodad_tpu_torch.eval.harness import post_processing_from_config as \
    torch_post
from mocodad_tpu_torch.models.mocodad import build_model
from mocodad_tpu_torch.serve import StreamScorer
from mocodad_tpu_torch.training.inference import restore_and_infer
from mocodad_tpu_torch.utils.weights import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, BATCH, VIEWS, D = 2, 96, 2, 16
LOSS_REL = 1e-5         # per-window losses: max |diff| over the largest
AUC_TOL = 1e-6
LATENT_KW = dict(diffusion_on_latent=True, latent_embedding_dim=D,
                 hidden_sizes=[16, 32, 16])


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp('latent_e2e')
    synthetic.generate(str(root / 'data'), seed=0, n_clips_per_split=2,
                       n_actors=2, n_frames=40)
    kw = dict(CFG_KW, **LATENT_KW, n_generated_samples=S, batch_size=BATCH,
              num_transform=VIEWS, data_dir=str(root / 'data'),
              gt_path=str(root / 'data' / 'testing' / 'test_frame_mask'),
              use_hr=False, load_ckpt='seeded.msgpack', split='test')
    (root / 'ckpt').mkdir()
    cfg = TorchConfig(**kw, ckpt_dir=str(root / 'ckpt'))
    # the train split fits and saves the robust scaler the test split loads
    tdata.build_dataset(cfg, split='train')
    return root, kw


def _noise(batch_idx, n_rows):
    rng = np.random.default_rng(100 + batch_idx)
    return (rng.standard_normal((n_rows, D)).astype(np.float32),
            rng.standard_normal((9, n_rows, D)).astype(np.float32))


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= LOSS_REL * np.abs(want).max()


@pytest.mark.parametrize('stage', ['diffusion', 'pretrain'])
def test_restore_and_infer_matches_jax(setup, stage):
    root, kw = setup
    kw = dict(kw, stage=stage)
    cfg_t = TorchConfig(**kw, ckpt_dir=str(root / 'ckpt'))
    cfg_j = JaxConfig(**kw, ckpt_dir=str(root / 'ckpt'))
    jm = JaxLatent(cfg_j)
    variables = seeded_variables(jm, seed=11)
    jax_save(os.path.join(cfg_t.ckpt_dir, cfg_t.load_ckpt),
             {'params': variables['params'],
              'batch_stats': variables['batch_stats'], 'step': np.int32(0)})

    noise_fn = (lambda i, n: tuple(map(torch.from_numpy, _noise(i, n)))) \
        if stage == 'diffusion' else None
    model, ds, res = restore_and_infer(cfg_t, device='cpu',
                                       with_pose=stage == 'pretrain',
                                       noise_fn=noise_fn)
    assert res['loss'].shape == (len(ds),)
    dj = jdata.build_dataset(cfg_j, split='test')
    if stage == 'pretrain':
        # the JAX trainer's own eval route (loop.py:295-305)
        jt = JaxTrainer(cfg_j, n_devices=1)
        want = jt.run_inference(dj, variables, jax.random.key(0),
                                with_pose=True)
        assert model.model_return_value == 'pose'
        _close(res['pose'], want['pose'])
    else:
        mats = jdata.affine_transform_matrices(VIEWS)
        gen = jax.jit(lambda v, d, nz: jm.generate(v, d, jax.random.key(0),
                                                   noise_override=nz))
        out = {k: [] for k in ('loss', 'trans', 'meta', 'frames')}
        for i, b in enumerate(jdata.make_loader(dj, BATCH)):
            data = jdata.apply_affine_batch(jnp.asarray(b['data']), mats,
                                            jnp.asarray(b['trans']))
            _, loss = gen(variables, data,
                          tuple(map(jnp.asarray, _noise(i, BATCH * S))))
            valid = b['mask'] > 0
            out['loss'].append(np.asarray(loss)[valid])
            for k in ('trans', 'meta', 'frames'):
                out[k].append(b[k][valid])
        want = {k: np.concatenate(v) for k, v in out.items()}
    for k in ('trans', 'meta', 'frames'):
        np.testing.assert_array_equal(res[k], want[k])
    _close(res['loss'], want['loss'])
    auc_t = torch_post(res['loss'], res['trans'], res['meta'],
                       res['frames'], cfg_t)
    auc_j = jax_post(want['loss'], want['trans'], want['meta'],
                     want['frames'], cfg_j)
    assert abs(auc_t - auc_j) <= AUC_TOL and 0.0 <= auc_t <= 1.0


# ---------------------------------------------------------------------------
# Two stages through the CLIs
# ---------------------------------------------------------------------------

def _run(script, yaml_path, *args):
    env = dict(os.environ, OMP_NUM_THREADS='1')
    env.pop('PYTHONPATH', None)
    proc = subprocess.run(
        [sys.executable, script, '-c', str(yaml_path), '--device', 'cpu',
         *args], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc


def _yaml(root, name, shipped, **kw):
    with open(os.path.join(REPO, 'config', 'UBnormal', shipped)) as f:
        raw = yaml.safe_load(f)
    raw.update(data_dir=str(root / 'data'), exp_dir=str(root / 'exp'),
               use_hr=False, n_generated_samples=2, batch_size=64,
               num_transform=2, n_epochs=1, **kw)
    path = root / name
    with open(path, 'w') as f:
        yaml.safe_dump(raw, f)
    return path


def test_two_stage_clis(setup):
    """The shipped latent configs at their widths (latent 64, MLP
    [64, 128, 128, 64]), cut to one epoch of batch 64 on the synthetic
    split: the diffusion run starts from the pretrain run's
    best_weights.ckpt and leaves its encoders as they were."""
    root, _ = setup
    val = str(root / 'data' / 'validating' / 'test_frame_mask')
    exp = root / 'exp' / 'UBnormal'
    pre = _yaml(root, 'pretrain.yaml', 'mocodad-latent_train.yaml',
                dir_name='latent/pretrain', test_path=val)
    os.makedirs(exp / 'latent' / 'pretrain')
    proc = _run('train_MoCoDAD_torch.py', pre)
    assert 'checkpointing on pretrain_rec_loss (min)' in proc.stdout
    assert re.search(r'\[epoch 0\] .*pretrain_rec_loss=', proc.stdout)
    first = exp / 'latent' / 'pretrain' / 'best_weights.ckpt'
    assert first.exists()

    diff = _yaml(root, 'diffusion.yaml', 'mocodad-latent_train.yaml',
                 dir_name='latent/diffusion', test_path=val,
                 stage='diffusion', pretrained_model_ckpt_path=str(first))
    os.makedirs(exp / 'latent' / 'diffusion')
    proc = _run('train_MoCoDAD_torch.py', diff)
    assert 'checkpointing on AUC (max)' in proc.stdout
    assert re.search(r'\[epoch 0\] .*loss_noise=.*AUC=', proc.stdout)
    second = exp / 'latent' / 'diffusion' / 'best_weights.ckpt'
    a = torch.load(first, weights_only=False)['state_dict']
    b = torch.load(second, weights_only=False)['state_dict']
    shared = [k for k in b if k in a and not k.startswith('denoiser.')
              and a[k].shape == b[k].shape and 'running' not in k
              and not k.endswith('num_batches_tracked')]
    assert len(shared) > 100
    for k in shared:
        assert torch.equal(a[k], b[k]), k

    test = _yaml(root, 'test.yaml', 'mocodad-latent_test.yaml',
                 dir_name='latent/diffusion',
                 test_path=str(root / 'data' / 'testing' /
                               'test_frame_mask'))
    proc = _run('eval_MoCoDAD_torch.py', test)
    auc = float(re.findall(r'AUC score: ([0-9.]+)', proc.stdout)[-1])
    assert 0.0 <= auc <= 1.0
    proc = _run('predict_MoCoDAD_torch.py', test)
    path = proc.stdout.strip().splitlines()[-1].split('saved tensors to ')[-1]
    pred = np.load(os.path.join(path, 'prediction.npy'))
    assert pred.ndim == 1 and np.isfinite(pred).all()


# ---------------------------------------------------------------------------
# Serving the diffusion stage
# ---------------------------------------------------------------------------

def _serve_kw(synth, ckpt_dir):
    """tests/test_torch_serve.py's configuration at the latent stage."""
    return dict(
        split='train', data_dir=synth, exp_dir=str(ckpt_dir),
        ckpt_dir=str(ckpt_dir), dataset_choice='UBnormal', seg_len=6,
        conditioning_strategy='inject', conditioning_indices=[0, 1, 2],
        conditioning_architecture='AE', channels=[8, 4, 8],
        embedding_dim=8, h_dim=8, latent_dim=8, dropout=0.0,
        noise_steps=5, opt_lr=1e-3, batch_size=64, num_coords=2,
        num_transform=2, seg_stride=1, n_generated_samples=2,
        aggregation_strategy='best', model_return_value='loss',
        vid_res=[640, 360], normalization_strategy='robust',
        use_hr=False, validation=False, seed=7,
        filter_kernel_size=4, frames_shift=3, pad_size=-1,
        test_path=os.path.join(synth, 'testing', 'test_frame_mask'),
        gt_path=os.path.join(synth, 'testing', 'test_frame_mask'),
        diffusion_on_latent=True, stage='diffusion',
        latent_embedding_dim=D, hidden_sizes=[16, 32, 16])


def test_serve_diffusion_stage_matches_jax(setup):
    root, _ = setup
    synth = str(root / 'data')
    kw = _serve_kw(synth, root / 'serve')
    (root / 'serve').mkdir()
    cfg = TorchConfig(**kw)
    tdata.build_dataset(cfg, 'train')         # the scaler the scorers load
    variables = seeded_variables(JaxLatent(JaxConfig(**kw)), seed=3)
    net = build_model(cfg).build_net()
    net.load_state_dict(state_dict_from_jax(variables), strict=True)

    batch, rows = 16, 16 * 2

    def noise(i):
        rng = np.random.default_rng(200 + i)
        return (rng.standard_normal((rows, D)).astype(np.float32),
                rng.standard_normal((4, rows, D)).astype(np.float32))

    port = StreamScorer(cfg, net, batch_size=batch, flush_every=batch,
                        device='cpu')
    assert port._folded is None
    step = port._step
    port._step = lambda d, t, i: step(d, t, i, noise_override=tuple(
        map(torch.from_numpy, noise(i))))
    jx = JaxStreamScorer(JaxConfig(**kw), variables=variables,
                         batch_size=batch, flush_every=batch)
    model = jx.model
    mats = jnp.asarray(jdata.affine_transform_matrices(2))

    @jax.jit
    def gen(v, data, trans, z0, zs):
        data = jdata.apply_affine_batch(data, mats, trans)
        return model.generate(v, data, jax.random.key(0),
                              noise_override=(z0, zs))[1]

    jx._step = lambda v, data, trans, rng, i: gen(v, data, trans, *noise(i))

    trajs = T.load_trajectories(os.path.join(synth, 'testing',
                                             'trajectories'), split='test')
    for scorer in (port, jx):
        for t in trajs.values():
            scene, clip = map(int, t.trajectory_id.split('_')[0].split('-'))
            for i in range(len(t)):
                scorer.push(scene, clip, int(t.person_id), int(t.frames[i]),
                            t.coordinates[i].reshape(-1, 2))
    assert port._batch_idx == jx._batch_idx > 2
    clips = sorted(f for f in os.listdir(cfg.gt_path) if f.endswith('.npy'))
    for f in clips:
        scene, clip = int(f.split('_')[0]), int(f.split('_')[1][:-4])
        nf = np.load(os.path.join(cfg.gt_path, f)).shape[0]
        got = port.finalize_clip(scene, clip, nf)
        want = jx.finalize_clip(scene, clip, nf)
        assert got.shape == (nf,) and np.isfinite(got).all()
        assert got.max() > 0
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    with pytest.raises(NotImplementedError, match='pretrain'):
        StreamScorer(TorchConfig(**dict(kw, stage='pretrain')), None,
                     device='cpu')
