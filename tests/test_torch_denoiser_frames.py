"""B1's two tensor-core kernels at the U-Net frame counts that the
strategies give beyond the flagship's T = 3: T = 4 and 5 (inject with 2 or
1 conditioning frames of 6) and T = 6 (concat, the imputation strategies
and no_condition at seg_len 6).  The NumPy emulators of the kernels'
arithmetic, driven only by the packed plans (the bfloat16 kernel at 2 rows
per tile, the 3xTF32 kernel at 2 or 1 with records split over runs of
output positions), against the plain version and the JAX Pallas kernel in
interpret mode at an aligned and a ragged N; the plans' fit; and the
planner's choice of rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (bf16_stats, emulate_tc_all, jax_model,
                         seeded_variables, torch_model, torch_net)
from mocodad_tpu.ops.pallas_unet import build_pallas_denoiser
from mocodad_tpu_torch.ops import pallas_unet as P
from test_torch_denoiser_tc import (JAX_MAX_REL, JAX_MEAN_REL, PLAIN_MAX_REL,
                                    PLAIN_MEAN_REL, assert_tc_plan_fits)
from test_torch_denoiser_tc_f32 import (ATOL, RTOL, assert_tc32_plan_fits,
                                        emulate_all)

# the configuration whose U-Net runs at each frame count
FRAMES = {4: dict(conditioning_indices=[0, 1]),
          5: dict(conditioning_indices=[0]),
          6: dict(conditioning_strategy='concat')}
# rows per tile the planners pick at 17 joints (pack_for_tc_kernel and
# pack_for_tc_f32_kernel), and the float32 records over position runs
ROWS = {4: (2, 2), 5: (2, 1), 6: (2, 1)}
_CACHE = {}


def _setup(t):
    """(folded, the JAX kernel at float32 and at bfloat16, the bf16 and
    f32 plans) for the U-Net at t frames, built once."""
    if t not in _CACHE:
        jm, tm = jax_model(**FRAMES[t]), torch_model(**FRAMES[t])
        assert tm.input_n_frames == t
        variables = seeded_variables(jm, seed=t)
        folded = tm.fold(torch_net(tm, variables))

        def jax_kernel(dtype):
            return build_pallas_denoiser(
                variables['params']['model'],
                variables['batch_stats']['model'], c_in=2, n_frames=t,
                n_joints=17, embedding_dim=16, nb=8, compute_dtype=dtype,
                interpret=True)
        _CACHE[t] = (folded, jax_kernel(jnp.float32),
                     jax_kernel(jnp.bfloat16), P.pack_for_tc_kernel(folded),
                     P.pack_for_tc_f32_kernel(folded))
    return _CACHE[t]


def _inputs(t, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 17 * t, n)).astype(np.float32)
    s = rng.standard_normal((16, n)).astype(np.float32)
    return x, (s / (1 + np.exp(-s))).astype(np.float32)     # silu


@pytest.mark.parametrize('n', [8, 7], ids=['aligned', 'ragged'])
@pytest.mark.parametrize('t', [4, 5, 6])
def test_f32_kernel_at_more_frames(t, n):
    folded, jax_f32, _, _, plan = _setup(t)
    x, semb = _inputs(t, n, seed=10 * t + n)
    got = emulate_all(plan, x, semb)
    assert got.shape == (2, 17 * t, n) and np.isfinite(got).all()
    plain = P.denoise_reference(torch.from_numpy(x), torch.from_numpy(semb),
                                folded)
    np.testing.assert_allclose(got, plain.numpy(), RTOL, ATOL)
    want = np.asarray(jax_f32(jnp.asarray(x), jnp.asarray(semb)))
    np.testing.assert_allclose(got, want, RTOL, ATOL)


@pytest.mark.parametrize('n', [8, 7], ids=['aligned', 'ragged'])
@pytest.mark.parametrize('t', [4, 5, 6])
def test_bf16_kernel_at_more_frames(t, n):
    folded, _, jax_bf16, plan, _ = _setup(t)
    x, semb = _inputs(t, n, seed=10 * t + n + 1)
    xb = torch.from_numpy(x).bfloat16()
    got = emulate_tc_all(plan, xb.float().numpy(), semb)
    assert got.shape == (2, 17 * t, n) and np.isfinite(got).all()
    plain = P.denoise_reference(xb, torch.from_numpy(semb), folded,
                                compute_dtype=torch.bfloat16)
    max_rel, mean_rel = bf16_stats(got, plain.float().numpy())
    assert max_rel <= PLAIN_MAX_REL and mean_rel <= PLAIN_MEAN_REL, \
        (max_rel, mean_rel)
    want = jax_bf16(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(semb))
    max_rel, mean_rel = bf16_stats(got, np.asarray(want.astype(jnp.float32)))
    assert max_rel <= JAX_MAX_REL and mean_rel <= JAX_MEAN_REL, \
        (max_rel, mean_rel)


@pytest.mark.parametrize('t', [4, 5, 6])
def test_plans_fit_with_the_most_rows(t):
    """Each plan fits a block, with the most rows of its builds that fit
    (one more row does not); float32 layers whose graph operator outgrows
    a weight buffer are split over runs of 16-position tiles that cover
    each output position once per part of C_out."""
    folded, _, _, tc, tc32 = _setup(t)
    assert (tc.rows, tc32.rows) == ROWS[t]
    assert_tc_plan_fits(tc)
    assert_tc32_plan_fits(tc32)
    for pack, plan, counts in ((P.pack_for_tc_kernel, tc, P.TC_ROW_COUNTS),
                               (lambda f, r: P.pack_for_tc_f32_kernel(
                                   f, rows=r), tc32, P.TC32_ROW_COUNTS)):
        more = [r for r in counts if r > plan.rows]
        if more:
            with pytest.raises(P.SharedMemoryError):
                pack(folded, min(more))
    nh, no = len(P.TC32_HEADER), len(P.TC32_OP)
    table = tc32.table.numpy()
    recs = [dict(zip(P.TC32_OP, table[nh + i * no:nh + (i + 1) * no]))
            for i in range(table[0])]
    layers = {}
    for o in recs:
        if o['p0'] == 0 and o['c0'] == 0:      # a layer's first record
            layers[len(layers)] = []
        layers[len(layers) - 1].append(o)
    assert len(layers) == 15
    assert any(o['p0'] > 0 for o in recs)
    for parts in layers.values():
        mt = -(-parts[0]['tvo'] // 16)
        by_c = {}
        for o in parts:
            by_c.setdefault(o['c0'], []).extend(
                range(o['p0'] // 16, o['p0'] // 16 + o['mt']))
        assert all(sorted(v) == list(range(mt)) for v in by_c.values())


@pytest.mark.parametrize('t', [4, 6])
def test_fma_yardsticks_and_b3_stay_at_three_frames(t):
    """The FMA designs (B1's, B2's and B3's yardsticks) and B3 on the
    tensor cores (B1's bfloat16 plan at its 4 rows) raise their own
    shared-memory message above T = 3.  (B2 on the tensor cores picks its
    rows per group and still plans.)"""
    from mocodad_tpu_torch.ops import dma_unet as D, grouped_unet as G
    folded = _setup(t)[0]
    for pack in (P.pack_for_kernel, G.pack_groups, D.pack_dma_tc,
                 lambda f: D.pack_dma(f, torch.float32)):
        with pytest.raises(P.SharedMemoryError, match='shared memory'):
            pack(folded)
