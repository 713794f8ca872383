"""The fused denoiser (B1): the port's folding + plain version against the
JAX Pallas kernel in interpret mode, against the port's own module
forward, on a ragged N, and the CUDA kernel's packed plan, read back by an
emulator of the kernel's arithmetic."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_model, torch_model, torch_net, trained_variables
from mocodad_tpu.nn.components import sinusoidal_pos_encoding as jax_pos
from mocodad_tpu.ops.pallas_unet import build_pallas_denoiser
from mocodad_tpu_torch.nn import sinusoidal_pos_encoding
from mocodad_tpu_torch.ops import pallas_unet as P

# float32 on both sides, sums in another order (rtol 1e-4, atol 1e-5)
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope='module')
def weights():
    jm = jax_model()
    variables = trained_variables(jm)
    tm = torch_model()
    net = torch_net(tm, variables)
    return variables, net, tm.fold(net)


def _inputs(n, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 51, n)).astype(np.float32)
    t = rng.integers(1, 10, n).astype(np.int32)
    cond = rng.standard_normal((n, 16)).astype(np.float32)
    return x, t, cond


def _semb(t, cond):
    e = sinusoidal_pos_encoding(torch.from_numpy(t), 16) + \
        torch.from_numpy(cond)
    return torch.nn.functional.silu(e).T.contiguous()


@pytest.mark.parametrize('n', [8, 12], ids=['aligned', 'ragged'])
def test_plain_version_matches_pallas_interpret(weights, n):
    variables, _, folded = weights
    x, t, cond = _inputs(n)
    denoise = build_pallas_denoiser(
        variables['params']['model'], variables['batch_stats']['model'],
        c_in=2, n_frames=3, n_joints=17, embedding_dim=16, nb=8,
        compute_dtype=jnp.float32, interpret=True)
    semb_j = jax.nn.silu(jax_pos(jnp.asarray(t), 16) + jnp.asarray(cond)).T
    want = np.asarray(denoise(jnp.asarray(x), semb_j))
    got = P.denoise_reference(torch.from_numpy(x), _semb(t, cond), folded)
    np.testing.assert_allclose(got.numpy(), want, RTOL, ATOL)


def test_plain_version_matches_module_forward(weights):
    _, net, folded = weights
    n = 16
    x, t, cond = _inputs(n, seed=4)
    x_nctv = torch.from_numpy(x).permute(2, 0, 1).reshape(n, 2, 3, 17)
    with torch.no_grad():
        want = net.denoise(x_nctv, torch.from_numpy(t),
                           torch.from_numpy(cond))
    got = P.denoise(torch.from_numpy(x), _semb(t, cond), folded)
    got = got.permute(2, 0, 1).reshape(n, 2, 3, 17)
    np.testing.assert_allclose(got.numpy(), want.numpy(), RTOL, ATOL)


def test_ragged_columns_are_independent(weights):
    _, _, folded = weights
    x, t, cond = _inputs(13, seed=5)
    semb = _semb(t, cond)
    full = P.denoise(torch.from_numpy(x), semb, folded)
    part = P.denoise(torch.from_numpy(x[:, :, :5]).contiguous(),
                     semb[:, :5].contiguous(), folded)
    np.testing.assert_allclose(full[:, :, :5].numpy(), part.numpy(),
                               rtol=1e-6, atol=1e-7)


def _emulate_kernel(plan, x, semb, rows=P.KERNEL_ROWS):
    """csrc/denoiser.cu's arithmetic in NumPy, driven only by the packed
    table and constants: one tile of `rows` fold rows in a shared-memory
    arena of float4 slots.  Asserts that the live buffers of every op are
    disjoint (the kernel reads its inputs while it writes its outputs)."""
    table = plan.table.numpy()
    consts = plan.consts.numpy().astype(np.float64)
    h = dict(zip(['nops', 'cin', 't', 'tva', 'tvap', 'e', 'x', 'semb', 'emb',
                  'final'], table[:P._H_LEN]))
    ops = [dict(zip(P._O_FIELDS, table[P._H_LEN + i * len(P._O_FIELDS):
                                       P._H_LEN + (i + 1) * len(P._O_FIELDS)]))
           for i in range(h['nops'])]
    n_slots = plan.smem_bytes // 16
    sm = np.full((n_slots, rows), np.nan)
    cin, tva, tvap, e = h['cin'], h['tva'], h['tvap'], h['e']
    for c in range(cin):
        sm[h['x'] + c * tvap:h['x'] + c * tvap + tva] = x[c]
    sm[h['semb']:h['semb'] + e] = semb

    def left(off, k, m):                       # (K, Mp) -> (M, K)
        mp = -(-m // 4) * 4
        return consts[off:off + k * mp].reshape(k, mp)[:, :m].T

    def diagonal_walk(a, blocks):
        """A block-diagonal (M, K) operator as the kernel walks it: each
        tile of 4 outputs reads only the input blocks of its own outputs."""
        m, k = a.shape
        mb, kb = m // blocks, k // blocks
        walked = np.zeros_like(a)
        for m0 in range(0, m, 4):
            k0 = m0 // mb * kb
            k1 = (min(m0 + 3, m - 1) // mb + 1) * kb
            walked[m0:m0 + 4, k0:k1] = a[m0:m0 + 4, k0:k1]
        return walked

    def view(off, c, tv, tvp):
        return sm[off:off + c * tvp].reshape(c, tvp, rows)[:, :tv]

    def span(off, c, tvp):
        return set(range(off, off + c * tvp))

    fixed = {'x': span(h['x'], cin, tvap), 'semb': span(h['semb'], e, 1)}
    for o in ops:
        ci, co, tvi, tvo = o['ci'], o['co'], o['tvi'], o['tvo']
        s_in = span(o['in'], ci, o['tvip'])
        s_out = span(o['out'], co, o['tvop'])
        live = [s_in, s_out] + list(fixed.values())
        f = view(o['in'], ci, tvi, o['tvip'])
        if o['kind'] == 0:
            s_g = span(o['g'], ci, o['tvop'])
            live.append(s_g)
            emb = left(o['we'], e, co) @ sm[h['semb']:h['semb'] + e] + \
                consts[o['eb']:o['eb'] + co, None]
            g = np.einsum('kx,cxr->ckr', left(o['k'], tvi, tvo), f)
            view(o['g'], ci, tvo, o['tvop'])[:] = g
            y = np.einsum('oc,ckr->okr', left(o['w'], ci, co), g)
            if o['wr'] >= 0:
                y = y + np.einsum('oc,ckr->okr', left(o['wr'], ci, co), f)
            else:
                y = y + f
            y = y + consts[o['bias']:o['bias'] + co, None, None]
            slope = consts[o['slope']]
            y = np.where(y >= 0, y, slope * y) + emb[:, None, :]
        else:
            d = diagonal_walk(left(o['k'], tvi, tvo), h['t'])
            y = np.einsum('kx,cxr->ckr', d, f)
            y = y * consts[o['rs']:o['rs'] + tvo, None] + \
                consts[o['rt']:o['rt'] + tvo, None]
            if o['skip'] >= 0:
                s_skip = span(o['skip'], co, o['tvop'])
                live.append(s_skip)
                y = y + view(o['skip'], co, tvo, o['tvop'])
        for i, a in enumerate(live):
            for b in live[i + 1:]:
                assert a == b or not (a & b), 'overlapping live buffers'
        view(o['out'], co, tvo, o['tvop'])[:] = y
        if o is ops[2]:
            fixed['d1'] = s_out
        if o is ops[5]:
            fixed['d2'] = s_out
        if o is ops[9]:
            fixed.pop('d2')
        if o is ops[12]:
            fixed.pop('d1')
    fin = view(h['final'], cin, tva, tvap)
    return fin + view(h['x'], cin, tva, tvap)


def test_kernel_plan_emulation(weights):
    """The packed constants, op table and shared-memory plan that the CUDA
    kernel reads reproduce the plain version."""
    _, _, folded = weights
    rows = P.KERNEL_ROWS
    x, t, cond = _inputs(rows, seed=6)
    semb = _semb(t, cond)
    plan = P.pack_for_kernel(folded)
    assert plan.smem_bytes <= P.MAX_SMEM_BYTES
    got = _emulate_kernel(plan, x, semb.numpy())
    want = P.denoise_reference(torch.from_numpy(x), semb, folded)
    np.testing.assert_allclose(got, want.numpy(), RTOL, ATOL)


def test_flagship_plan_fits_and_counts(weights):
    _, _, folded = weights
    plan = P.pack_for_kernel(folded)
    # the flagship fold: 88,094 constants, 5.28 MFLOP per row (the joint
    # re-scalings without their zero blocks, + elementwise epilogues),
    # 226,656 bytes of the 232,448 a Hopper block may use
    assert folded.n_constants == 88094
    assert P.denoiser_flops_per_row(folded) == 5282484
    # a joint re-scaling's nonzeros are its T diagonal blocks, which is
    # all the count takes of it
    for j, (tvo, tvi) in zip(folded.joint, [(36, 51), (30, 36), (36, 30),
                                            (51, 36)]):
        assert j.d2.shape == (tvo, tvi)
        assert int(torch.count_nonzero(j.d2)) == 3 * (tvo // 3) * (tvi // 3)
    assert plan.smem_bytes == 226656


def test_wrapper_routes_by_device(weights):
    _, _, folded = weights
    x, t, cond = _inputs(4)
    before = P.DENOISER.launches
    out = P.denoise(torch.from_numpy(x), _semb(t, cond), folded)
    assert out.shape == (2, 51, 4)
    assert P.DENOISER.launches == before       # the CPU never launches
    with pytest.raises(ValueError, match='CUDA tensor'):
        P.DENOISER(torch.from_numpy(x), _semb(t, cond), folded)
