"""How far two ranks land from one process, in the port and in the JAX
package, on the same CPU and the same batches (ROADMAP §C: bfloat16 at
W > 1, and W = 2 against W = 1).

1. A `train_dtype: bfloat16` step at W = 2 (two gloo ranks) against W = 1
   and against the JAX package's bfloat16 step on `make_mesh(2)` and
   `make_mesh(1)` of the virtual CPU mesh, at the bfloat16 bounds of
   tests/test_torch_train_step.py (the loss within 3e-3 of JAX's, the
   gradients' cosine above 0.999).
2. A float32 step at batch 128: every gradient at W = 2 against W = 1, in
   both packages, at the port-against-JAX gradient bounds of
   tests/test_torch_train_step.py.  JAX's meshes give the same gradients.
   The port's BatchNorm took another route at W = 1 (torch's
   `batch_norm`, Welford's variance) than at W = 2, and its gradients
   landed 74 times those bounds apart (fault C3); one BatchNorm at every
   W (`nn/stsgcn._GlobalBatchNorm`) puts them within 0.08 of them.
   Adam's sign-like first steps then carry such differences into later
   losses by chance: `python tests/test_torch_dist_drift.py` prints three
   steps' loss drift in both packages over four batch seeds.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_dist import adam_steps, one_step, run_ranks
from _torch_port import CFG_KW, jax_model, seeded_variables
from mocodad_tpu.config import Config as JaxConfig
from mocodad_tpu.data import affine_transform_matrices as jax_mats
from mocodad_tpu.data import apply_affine_batch as jax_affine
from mocodad_tpu.models import MoCoDADModel as JaxModel
from mocodad_tpu.parallel import make_mesh, replicated_sharding, shard_batch
from mocodad_tpu_torch.nn import stsgcn
from mocodad_tpu_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(1)
B16, B128, LR = 16, 128, 1e-3
# tests/test_torch_train_step.py's bfloat16 step against JAX's
BF16_LOSS_REL, BF16_COS = 3e-3, 0.999
# W = 2 against W = 1: the same arithmetic with the sums split in two,
# held as tests/test_torch_train_step.py holds the port's gradients to
# JAX's: each tensor within GRAD_REL of its largest gradient, or within
# GRAD_FLOOR of the step's largest if that is more (a PReLU slope's
# gradient is a sum that cancels); the BatchNorm-fed biases, whose true
# gradient is 0, are left out as there
GRAD_REL, GRAD_FLOOR = 1e-4, 1e-6
BN_FED_BIASES = ('tcn.0.bias', 'residual.0.bias', 'block.0.bias')

_BODY = '''
from _torch_dist import one_step
OUT['bf16'] = one_step(INPUTS['bf16_kw'], INPUTS['sd'], *INPUTS['b16'],
                       mesh)
OUT['f32'] = one_step(INPUTS['kw'], INPUTS['sd'], *INPUTS['b128'], mesh)
'''


def _batch(rows, seed):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((rows, 2, 6, 17)).astype(np.float32)
    t = rng.integers(1, 10, rows).astype(np.int64)
    eps = rng.standard_normal((rows, 2, 3, 17)).astype(np.float32)
    mask = np.ones(rows, np.float32)
    mask[[9, 12, 15]] = 0.0
    return data, mask, (t, eps)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    jm = jax_model()
    variables = seeded_variables(jm, seed=3)
    inputs = {'bf16_kw': dict(CFG_KW, extras={'train_dtype': 'bfloat16'}),
              'kw': dict(CFG_KW), 'sd': state_dict_from_jax(variables),
              'b16': _batch(B16, 5), 'b128': _batch(B128, 5)}
    ranks = run_ranks(tmp_path_factory.mktemp('drift'), _BODY, inputs)
    one = {'bf16': one_step(inputs['bf16_kw'], inputs['sd'],
                            *inputs['b16']),
           'f32': one_step(inputs['kw'], inputs['sd'], *inputs['b128'])}
    return jm, variables, inputs, ranks, one


def _flat(grads, names):
    return torch.cat([torch.as_tensor(np.asarray(grads[k])).reshape(-1)
                      .double() for k in names])


def _cos(a, b):
    return float(a @ b / (a.norm() * b.norm()))


def _jax_step(variables, batch, n_devices, **extras):
    cfg = JaxConfig(**CFG_KW)
    cfg.extras.update(extras)
    model = JaxModel(cfg)
    mesh = make_mesh(n_devices)
    data, mask, (t, eps) = batch
    sb = shard_batch({'data': data, 't': t.astype(np.int32), 'eps': eps,
                      'mask': mask}, mesh)
    v = jax.device_put(variables, replicated_sharding(mesh))

    def f(p):
        loss, metrics, _ = model.loss(
            {'params': p, 'batch_stats': v['batch_stats']}, sb['data'],
            jax.random.key(0), train=True, sample_mask=sb['mask'],
            noise_override=(sb['t'], sb['eps']))
        return loss, metrics
    grads, metrics = jax.jit(jax.grad(f, has_aux=True))(v['params'])
    return float(metrics['loss']), state_dict_from_jax(
        {'params': jax.device_get(grads)})


def _grad_excess(got, want):
    """The largest ratio of a tensor's max |got - want| to its bound,
    max(GRAD_REL x its largest |want|, GRAD_FLOOR x the step's largest)."""
    g_max = max(float(torch.as_tensor(np.asarray(v)).abs().max())
                for v in want.values())
    worst = 0.0
    for k, w in want.items():
        if k.endswith(BN_FED_BIASES):
            continue
        w = torch.as_tensor(np.asarray(w)).double()
        g = torch.as_tensor(np.asarray(got[k])).double().reshape(w.shape)
        worst = max(worst, float((g - w).abs().max()) / max(
            GRAD_REL * float(w.abs().max()), GRAD_FLOOR * g_max))
    return worst


def test_bf16_step_on_two_ranks(runs):
    jm, variables, inputs, ranks, one = runs
    names = sorted(one['bf16']['grads'])
    loss1 = one['bf16']['loss']
    loss2 = sum(r['bf16']['loss'] for r in ranks)
    g1 = _flat(one['bf16']['grads'], names)
    g2 = _flat(ranks[0]['bf16']['grads'], names)
    jl1, jg1 = _jax_step(variables, inputs['b16'], 1,
                         train_dtype='bfloat16')
    jl2, jg2 = _jax_step(variables, inputs['b16'], 2,
                         train_dtype='bfloat16')
    j1, j2 = _flat(jg1, names), _flat(jg2, names)
    # JAX's global batch is one array on either mesh
    assert abs(jl2 - jl1) <= 1e-6 * jl1 and _cos(j1, j2) > 0.99999
    for loss, g, jl, jg in ((loss2, g2, jl2, j2), (loss1, g1, jl1, j1)):
        assert abs(loss - jl) / jl < BF16_LOSS_REL
        assert _cos(g, jg) > BF16_COS
    assert abs(loss2 - loss1) / loss1 < BF16_LOSS_REL
    assert _cos(g1, g2) > BF16_COS


def _native_batch_norm(self, x):
    """The port's train-mode BatchNorm at W = 1 before the fix of C3: the
    statistics by `torch.var_mean`, the normalization one `batch_norm`."""
    if not self.training:
        return torch.nn.BatchNorm2d.forward(self, x)
    with torch.no_grad():
        var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
        m = self.momentum
        self.running_mean.mul_(1 - m).add_(mean, alpha=m)
        self.running_var.mul_(1 - m).add_(var, alpha=m)
        self.num_batches_tracked.add_(1)
    return torch.nn.functional.batch_norm(x, None, None, self.weight,
                                          self.bias, True, 0.0, self.eps)


def test_float32_step_on_two_ranks(runs, monkeypatch):
    jm, variables, inputs, ranks, one = runs
    two = ranks[0]['f32']
    _, jg1 = _jax_step(variables, inputs['b128'], 1)
    _, jg2 = _jax_step(variables, inputs['b128'], 2)
    assert _grad_excess(jg2, jg1) <= 1.0
    assert _grad_excess(two['grads'], one['f32']['grads']) <= 1.0
    # the same step with the W = 1 route C3 had: far outside
    monkeypatch.setattr(stsgcn.FlaxBatchNorm2d, 'forward',
                        _native_batch_norm)
    native = one_step(inputs['kw'], inputs['sd'], *inputs['b128'])
    assert _grad_excess(two['grads'], native['grads']) > 10.0


# ---- `python tests/test_torch_dist_drift.py`: three Adam steps' drift ----

def _adam_batches(seed, rows=B128, steps=3):
    out = []
    for k in range(steps):
        r = np.random.default_rng(seed + k)
        out.append((r.standard_normal((rows, 2, 6, 17)).astype(np.float32),
                    r.integers(0, 5, rows).astype(np.int32),
                    (np.arange(rows) != 13 - k).astype(np.float32),
                    (r.integers(1, 10, rows).astype(np.int64),
                     r.standard_normal((rows, 2, 3, 17)).astype(
                         np.float32))))
    return out


def _jax_adam_losses(jm, variables, batches, n_devices):
    mesh = make_mesh(n_devices)
    opt = optax.adam(optax.exponential_decay(LR, 2, 0.99, staircase=True))
    mats = jnp.asarray(jax_mats(5))
    rep = replicated_sharding(mesh)
    params, stats = jax.device_put((variables['params'],
                                    variables['batch_stats']), rep)
    opt_state = jax.device_put(opt.init(params), rep)

    @jax.jit
    def step(params, stats, opt_state, b):
        data = jax_affine(b['data'], mats, b['trans'])

        def f(p):
            loss, metrics, mutated = jm.loss(
                {'params': p, 'batch_stats': stats}, data, jax.random.key(0),
                train=True, sample_mask=b['mask'],
                noise_override=(b['t'], b['eps']))
            return loss, (metrics, mutated['batch_stats'])
        grads, (metrics, stats) = jax.grad(f, has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), stats, opt_state,
                metrics['loss'])
    losses = []
    for data, trans, mask, (t, eps) in batches:
        b = shard_batch({'data': data, 'trans': trans, 'mask': mask,
                         't': t.astype(np.int32), 'eps': eps}, mesh)
        params, stats, opt_state, loss = step(params, stats, opt_state, b)
        losses.append(float(loss))
    return np.array(losses)


def _drift_table(seeds=(20, 40, 60, 80)):
    """Each step's loss at W = 2 against W = 1, relative, for three Adam
    steps at batch 128 from `seeded_variables` seed 3, in the port (two
    gloo ranks) and in JAX (`make_mesh(2)` against `make_mesh(1)`)."""
    jm = jax_model()
    variables = seeded_variables(jm, seed=3)
    sd = state_dict_from_jax(variables)
    kw = dict(CFG_KW, opt_lr=LR, use_ema=True, num_transform=5)
    for seed in seeds:
        batches = _adam_batches(seed)
        one = adam_steps(kw, sd, batches)
        two = run_ranks(tempfile.mkdtemp(), '''
from _torch_dist import adam_steps
OUT['a'] = adam_steps(INPUTS['kw'], INPUTS['sd'], INPUTS['batches'], mesh)
''', {'kw': kw, 'sd': sd, 'batches': batches})[0]['a']
        p1, p2 = (np.array([m['loss'] for m in r['metrics']])
                  for r in (one, two))
        j1, j2 = (_jax_adam_losses(jm, variables, batches, n)
                  for n in (1, 2))
        print(f'seed {seed}: port {np.abs(p2 - p1) / p1}, '
              f'jax {np.abs(j2 - j1) / j1}', flush=True)


if __name__ == '__main__':
    # XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
    #     PYTHONPATH=. python tests/test_torch_dist_drift.py
    _drift_table()
