"""The fused denoiser (B1): the port's folding + plain version against the
JAX Pallas kernel in interpret mode, against the port's own module
forward, on a ragged N, and the CUDA kernels' packed plans (B1 in float32
and bfloat16, B2's five groups, B3's prefetch slot), read back by an
emulator of the kernels' arithmetic."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (bf16_stats, jax_model, torch_model, torch_net,
                         trained_variables)
from mocodad_tpu.nn.components import sinusoidal_pos_encoding as jax_pos
from mocodad_tpu.ops.pallas_unet import build_pallas_denoiser
from mocodad_tpu_torch.nn import sinusoidal_pos_encoding
from mocodad_tpu_torch.ops import dma_unet as D, grouped_unet as G
from mocodad_tpu_torch.ops import pallas_unet as P

# float32 on both sides, sums in another order (rtol 1e-4, atol 1e-5)
RTOL, ATOL = 1e-4, 1e-5
# bfloat16 on both sides (see _bf16_close): max |diff| within 2 % of the
# largest output, mean |diff| within 0.2 % of the mean output
BF16_MAX_REL, BF16_MEAN_REL = 2e-2, 2e-3


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


def bf16_round(a):
    """Round to the nearest bfloat16, ties to even, kept as float64."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def _ident(a):
    return a


def _emulate_table(table, mats, vecs, ins, semb, rnd=_ident, round_g=False,
                   rows=P.KERNEL_ROWS):
    """csrc/denoiser_body.cuh's arithmetic in NumPy for one sub-tile,
    driven only by a packed table and constants: the table's inputs
    (C, TV, rows) and silu(emb) (E, rows) are loaded into an arena of
    float4 slots, every op runs, and the table's outputs are returned.
    `rnd` rounds at the compute dtype's points (B1's; with `round_g` also
    the graph mix, B2's).  Asserts that every buffer an op reads was
    written, and that no two buffers live at one op overlap (the kernel
    reads its inputs while it writes its outputs)."""
    table = np.asarray(table)
    mats = np.asarray(mats, np.float64)
    vecs = np.asarray(vecs, np.float64)
    h = table[:P._H_LEN]
    ops = [dict(zip(P._O_FIELDS, table[P._H_LEN + i * len(P._O_FIELDS):
                                       P._H_LEN + (i + 1) * len(P._O_FIELDS)]))
           for i in range(h[P._H_NOPS])]
    arena, e = h[P._H_ARENA], h[P._H_E]

    def io(slot):
        base = P._H_IO + slot * P._IO_LEN
        return tuple(int(v) for v in h[base:base + P._IO_LEN])

    sm = np.full((arena, rows), np.nan)
    buffers = []                     # [offset, size, written, last read]

    def write(off, size, at):
        assert 0 <= off and off + size <= arena, 'buffer outside the arena'
        buffers.append([off, size, at, at])

    def read(off, size, at):
        for b in reversed(buffers):
            if b[0] == off and b[1] == size and b[2] <= at:
                b[3] = max(b[3], at)
                return
        raise AssertionError(f'op {at} reads an unwritten buffer at {off}')

    def view(off, c, tv, tvp):
        return sm[off:off + c * tvp].reshape(c, tvp, rows)[:, :tv]

    for i in range(h[P._H_NIN]):
        c, tv, tvp, off = io(i)
        view(off, c, tv, tvp)[:] = rnd(ins[i])
        write(off, c * tvp, -1)
    sm[h[P._H_SEMB]:h[P._H_SEMB] + e] = rnd(semb)
    write(h[P._H_SEMB], e, -1)

    def left(off, k, m):                       # (K, Mp) -> (M, K)
        mp = -(-m // 4) * 4
        return mats[off:off + k * mp].reshape(k, mp)[:, :m].T

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

    for i, o in enumerate(ops):
        ci, co, tvi, tvo = o['ci'], o['co'], o['tvi'], o['tvo']
        read(o['in'], ci * o['tvip'], i)
        f = view(o['in'], ci, tvi, o['tvip'])
        if o['kind'] == 0:
            read(h[P._H_SEMB], e, i)
            write(h[P._H_EMB], co, i)
            emb = left(o['we'], e, co) @ sm[h[P._H_SEMB]:h[P._H_SEMB] + e] + \
                vecs[o['eb']:o['eb'] + co, None]
            g = np.einsum('kx,cxr->ckr', left(o['k'], tvi, tvo), f)
            if round_g:
                g = rnd(g)
            write(o['g'], ci * o['tvop'], i)
            view(o['g'], ci, tvo, o['tvop'])[:] = g
            y = np.einsum('oc,ckr->okr', left(o['w'], ci, co), g)
            if o['wr'] >= 0:
                y = y + np.einsum('oc,ckr->okr', left(o['wr'], ci, co), f)
            else:
                y = y + f
            y = y + vecs[o['bias']:o['bias'] + co, None, None]
            slope = vecs[o['slope']]
            y = rnd(np.where(y >= 0, y, slope * y) + emb[:, None, :])
        else:
            d = diagonal_walk(left(o['k'], tvi, tvo), h[P._H_T])
            y = rnd(np.einsum('kx,cxr->ckr', d, f)
                    * vecs[o['rs']:o['rs'] + tvo, None]
                    + vecs[o['rt']:o['rt'] + tvo, None])
            if o['skip'] >= 0:
                read(o['skip'], co * o['tvop'], i)
                y = rnd(y + view(o['skip'], co, tvo, o['tvop']))
        write(o['out'], co * o['tvop'], i)
        view(o['out'], co, tvo, o['tvop'])[:] = y
    end = len(ops)
    outs = []
    for i in range(h[P._H_NOUT]):
        c, tv, tvp, off = io(P.MAX_IN + i)
        read(off, c * tvp, end)
        y = view(off, c, tv, tvp).copy()
        if i == 0 and h[P._H_FINAL_X] >= 0:
            read(h[P._H_FINAL_X], c * tvp, end)
            y = y + view(h[P._H_FINAL_X], c, tv, tvp)
        outs.append(y)
    for at in range(-1, end + 1):
        live = [b for b in buffers if b[2] <= at <= b[3]]
        for j, a in enumerate(live):
            for b in live[j + 1:]:
                assert (a[0], a[1]) == (b[0], b[1]) or \
                    a[0] + a[1] <= b[0] or b[0] + b[1] <= a[0], \
                    f'overlapping live buffers at op {at}'
    return outs


def _emulate_kernel(plan, x, semb, rnd=_ident):
    """B1's table on one tile of KERNEL_ROWS rows -> eps."""
    return _emulate_table(plan.table.numpy(), plan.mats.float().numpy(),
                          plan.vecs.numpy(), [x], semb, rnd)[0]


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


def _bf16_close(got, want, what):
    """bfloat16 at the same rounding points, sums in another order: a sum
    that lands near a rounding boundary can round the other way (2^-8
    relative), and later layers carry such flips forward."""
    assert np.isfinite(got).all(), what
    max_rel, mean_rel = bf16_stats(got, want)
    assert max_rel <= BF16_MAX_REL and mean_rel <= BF16_MEAN_REL, \
        (what, max_rel, mean_rel)


def test_kernel_plan_emulation_bf16(weights):
    """B1's bfloat16 table: the matrices stored as bfloat16, rounding at
    B1's points, reproduce the plain version at bfloat16."""
    _, _, folded = weights
    x, t, cond = _inputs(P.KERNEL_ROWS, seed=7)
    x = bf16_round(x)
    semb = _semb(t, cond)
    plan = P.pack_for_kernel(folded, torch.bfloat16)
    assert plan.mats.dtype == torch.bfloat16
    assert plan.vecs.dtype == torch.float32
    # the same table as float32; only the matrices' storage differs
    assert torch.equal(plan.table, P.pack_for_kernel(folded).table)
    got = bf16_round(_emulate_kernel(plan, x, semb.numpy(), bf16_round))
    want = P.denoise_reference(torch.from_numpy(x).bfloat16(), semb, folded,
                               compute_dtype=torch.bfloat16)
    _bf16_close(got, want.float().numpy(), 'B1 bf16')


def test_grouped_plan_emulation(weights):
    """B2's five group tables, chained through bfloat16 tensors as the
    kernels chain them through device memory, reproduce grouped_reference;
    each group's arena fits a block nsub times."""
    _, _, folded = weights
    x, t, cond = _inputs(P.KERNEL_ROWS, seed=8)
    x = bf16_round(x)
    semb = bf16_round(_semb(t, cond).numpy())
    plan = G.pack_groups(folded)
    assert [g.nsub for g in plan.groups] == [2, 2, 1, 1, 2]
    bufs = {'x': x}
    for g in plan.groups:
        assert g.smem_bytes == g.nsub * g.arena * 16 <= P.MAX_SMEM_BYTES
        outs = _emulate_table(g.table.numpy(), plan.mats.float().numpy(),
                              plan.vecs.numpy(),
                              [bufs[nm] for nm in g.spec.ins], semb,
                              bf16_round, round_g=True)
        for nm, y, shape in zip(g.spec.outs, outs, g.out_shapes):
            assert y.shape[:2] == shape
            bufs[nm] = bf16_round(y)
    want = G.grouped_reference(torch.from_numpy(x).bfloat16(),
                               torch.from_numpy(semb).bfloat16(), folded)
    _bf16_close(bufs['eps'], want.float().numpy(), 'B2')


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_dma_plan_slot(weights, dtype):
    """B3's plan: B1's arena and table, then one prefetch slot for the next
    tile's x and silu(emb) that no arena buffer touches, all within one
    block's shared memory."""
    _, _, folded = weights
    plan = D.pack_dma(folded, dtype)
    b1 = P.pack_for_kernel(folded, dtype)
    assert torch.equal(plan.kernel.table, b1.table)
    slot = 2 * 51 + 16
    assert plan.stage_off == b1.arena
    assert plan.smem_bytes == (b1.arena + slot) * 16 <= P.MAX_SMEM_BYTES
    # the flagship: 226,656 + 1,888 of the 232,448 bytes
    assert plan.smem_bytes == 228544


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
