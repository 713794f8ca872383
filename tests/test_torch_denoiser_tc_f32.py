"""B1 at float32 on the tensor cores as 3xTF32 (`csrc/denoiser_tc_f32.cu`):
a NumPy emulation of the kernel's arithmetic, driven only by what
`pack_for_tc_f32_kernel` packs, against the plain version and the JAX
Pallas kernel in interpret mode; the 3xTF32 split per layer; the table
format and the shared-memory plan; the bfloat16 plan left as it was; and
the routing of a CPU tensor."""

import hashlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (jax_model, seeded_variables, torch_model, torch_net,
                         k_unfragment as unfragment,
                         tf32_kernel_split as split,
                         tf32_operand as mma_operand)
from mocodad_tpu.ops.pallas_unet import build_pallas_denoiser
from mocodad_tpu_torch.ops import pallas_unet as P

# float32 on both sides, sums in another order and every product as
# 3xTF32 (about 2^-21 relative per product): the f32 check of
# chip_smoke.py and tests/test_torch_kernel_gpu.py
RTOL, ATOL = 1e-4, 1e-5
# one product K f or W g as 3xTF32: within 2^-19 of the sum of the
# magnitudes of its terms (the dropped lo * lo terms and the truncated lo
# parts give at most about 3 x 2^-21 of it, the float32 sums a little
# more); a single TF32 pass (hi * hi) misses that by orders of magnitude
SPLIT_REL = 2.0 ** -19
CSRC = os.path.join(os.path.dirname(__file__), '..', 'mocodad_tpu_torch',
                    'csrc', 'denoiser_tc_f32.cu')
# sha256 of pack_for_tc_kernel's blob and table for the fixture's weights:
# the bfloat16 plan this change must leave as it was
TC_BF16_PLAN_SHA256 = (
    '8482a731799b0cef1a5ff9627e875e46f64178023800bf9efd6abb889135bd9f')


@pytest.fixture(scope='module')
def weights():
    jm = jax_model()
    variables = seeded_variables(jm, seed=5)
    tm = torch_model()
    net = torch_net(tm, variables)
    denoise = build_pallas_denoiser(
        variables['params']['model'], variables['batch_stats']['model'],
        c_in=2, n_frames=3, n_joints=17, embedding_dim=16, nb=8,
        compute_dtype=jnp.float32, interpret=True)
    folded = tm.fold(net)
    return denoise, folded, P.pack_for_tc_f32_kernel(folded)


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 51, n)).astype(np.float32)
    s = rng.standard_normal((16, n)).astype(np.float32)
    return x, (s / (1 + np.exp(-s))).astype(np.float32)     # silu


def mma3(ah, al, bh, bl):
    """A B as three TF32 products summed into float32."""
    return (al @ bh + ah @ bl + ah @ bh).astype(np.float32)


def _records(plan):
    table = plan.table.numpy()
    nh, no = len(P.TC32_HEADER), len(P.TC32_OP)
    h = dict(zip(P.TC32_HEADER, table[:nh]))
    ops = [dict(zip(P.TC32_OP, table[nh + i * no:nh + (i + 1) * no]))
           for i in range(h['nops'])]
    return h, ops


def emulate(plan, x, semb, n0=0):
    """csrc/denoiser_tc_f32.cu on one tile of plan.rows fold rows from
    row n0 of x (C_in, T*V, N) and silu(emb) (E, N): shared memory as
    bytes that start as NaN (0xff), each op record's constants copied from
    the blob into its weight buffer, every layer's embedding from the
    blob's W_e^T and b_e, activations as float32 (T*V, C) tiles read back
    through the table's offsets and strides (only the rows and columns the
    kernel reads), every product as 3xTF32 (K's and the dense joint
    operators' hi and lo as the host split them, f, g, W and Wr split as
    the kernel splits them, g's channel pairs as the permuted A fragments
    give them; a record covers its 16 mt output positions from p0, with
    those rows of K).  Returns eps (C_in, T*V, rows) for the rows below
    N."""
    h, ops = _records(plan)
    blob = plan.blob.numpy()
    sm = np.full(plan.smem_bytes, 0xff, np.uint8)
    rows, n = plan.rows, x.shape[2]
    nv = max(0, min(rows, n - n0))

    def f32(off, size):
        return sm[off:off + 4 * size].view(np.float32)

    def tile(off, nrows, stride):
        return f32(off, nrows * stride).reshape(nrows, stride)

    def row(r):
        return h['row0'] + r * h['row_bytes']

    cin, tva, e, es = h['cin'], h['tva'], h['e'], h['emb_stride']
    for r in range(rows):
        xt = tile(row(r) + h['x_off'], h['tvap'], h['x_stride'])
        xt[:, :h['x_stride'] - 8] = 0
        if r < nv:
            xt[:tva, :cin] = x[:, :, n0 + r].T
        f32(row(r) + h['semb_off'], e)[:] = semb[:, n0 + r] if r < nv else 0
    emb_blob = blob[h['embw_blob']:].view(np.float32)
    we, eb = emb_blob[:e * es].reshape(e, es), emb_blob[e * es:e * es + es]
    for r in range(rows):
        f32(h['emb_off'] + r * es * 4, es)[:] = \
            we.T.astype(np.float64) @ f32(row(r) + h['semb_off'], e) + eb
    for k, o in enumerate(ops):
        wb = h['wbuf0'] if k % 2 == 0 else h['wbuf1']
        sm[wb:wb + o['blob_bytes']] = \
            blob[o['blob']:o['blob'] + o['blob_bytes']]
        tvop, p0 = 16 * o['mt'], o['p0']
        pos = slice(p0, p0 + tvop)          # the record's output positions
        khi, klo = unfragment(f32(wb + o['k'], o['mt'] * o['ks'] * 256)
                              .reshape(o['mt'], o['ks'], 2, 32, 4))
        khi, klo = khi.astype(np.float64), mma_operand(klo)
        if o['kind'] == 1:
            c = o['ci']
            rs = f32(wb + o['rs'], p0 + tvop)[pos, None]
            rt = f32(wb + o['rt'], p0 + tvop)[pos, None]
            for r in range(rows):
                f = tile(row(r) + o['in'], 8 * o['ks'], o['in_stride'])
                fh, fl = split(f[:, :c])
                y = mma3(khi, klo, fh, fl) * rs + rt
                if o['skip'] >= 0:
                    y = y + tile(row(r) + o['skip'], p0 + tvop,
                                 o['skip_stride'])[pos, :c]
                y[max(0, o['tvo'] - p0):] = 0
                tile(row(r) + o['out'], p0 + tvop,
                     o['out_stride'])[pos, :c] = y
            continue
        ci, cop, oc = o['ci'], 8 * o['nt'], o['c0']
        wh, wl = split(tile(wb + o['w'], cop, o['w_stride'])[:, :ci].T)
        if o['res']:
            wrh, wrl = split(tile(wb + o['wr'], cop, o['w_stride'])[:, :ci].T)
        bias = f32(wb + o['bias'], cop)
        slope = f32(wb + o['slope'], 1)[0]
        for r in range(rows):
            f = tile(row(r) + o['in'], max(8 * o['ks'], p0 + tvop),
                     o['in_stride'])
            fh, fl = split(f[:8 * o['ks'], :ci])
            g = mma3(khi, klo, fh, fl)                   # (16 mt, ci)
            gh, gl = split(g)
            y = mma3(gh, gl, wh, wl).astype(np.float64)
            if o['res']:
                ah, al = split(f[pos, :ci])
                y = y + mma3(ah, al, wrh, wrl)
            else:
                y = y + f[pos, oc:oc + cop]
            y = (y + bias).astype(np.float32)
            y = np.where(y >= 0, y, slope * y) + \
                f32(h['emb_off'] + (r * es + o['emb']) * 4, cop)
            y[max(0, o['tvo'] - p0):] = 0
            tile(row(r) + o['out'], p0 + tvop,
                 o['out_stride'])[pos, oc:oc + cop] = y
    eps = np.zeros((cin, tva, nv), np.float32)
    for r in range(nv):
        out = tile(row(r) + h['out_off'], h['tvap'], h['out_stride'])
        x0 = tile(row(r) + h['x_off'], h['tvap'], h['x_stride'])
        eps[:, :, r] = (out[:tva, :cin] + x0[:tva, :cin]).T
    return eps


def emulate_all(plan, x, semb):
    n = x.shape[2]
    return np.concatenate([emulate(plan, x, semb, n0)
                           for n0 in range(0, n, plan.rows)], axis=2)


@pytest.mark.parametrize('n', [8, 7], ids=['aligned', 'ragged'])
def test_tc32_emulation_matches_plain_version_and_pallas(weights, n):
    denoise, folded, plan = weights
    x, semb = _inputs(n, seed=n + 30)
    got = emulate_all(plan, x, semb)
    assert got.shape == (2, 51, n) and np.isfinite(got).all()
    plain = P.denoise_reference(torch.from_numpy(x), torch.from_numpy(semb),
                                folded)
    np.testing.assert_allclose(got, plain.numpy(), RTOL, ATOL)
    want = np.asarray(denoise(jnp.asarray(x), jnp.asarray(semb)))
    np.testing.assert_allclose(got, want, RTOL, ATOL)


def test_one_tf32_pass_misses_the_f32_check(weights, monkeypatch):
    """The same emulation with each product as hi * hi alone (TF32 in the
    sense of allow_tf32) lands several times outside the f32 check that
    3xTF32 holds with room to spare."""
    _, folded, plan = weights
    x, semb = _inputs(8, seed=38)
    want = P.denoise_reference(torch.from_numpy(x), torch.from_numpy(semb),
                               folded).numpy()

    def excess(got):
        return np.max(np.abs(got - want) / (ATOL + RTOL * np.abs(want)))

    assert excess(emulate_all(plan, x, semb)) < 0.2
    monkeypatch.setitem(globals(), 'mma3', lambda ah, al, bh, bl:
                        (ah @ bh).astype(np.float32))
    assert excess(emulate_all(plan, x, semb)) > 5


def _magnitude_bound(a, b):
    return SPLIT_REL * (np.abs(a) @ np.abs(b))


@pytest.mark.parametrize('layer', range(len(P.GCN_LAYERS)),
                         ids=list(P.GCN_LAYERS))
def test_3xtf32_reproduces_each_f32_product(weights, layer):
    """On each flagship layer's shapes: the graph mix K f and the channel
    mix W g as the kernel splits them land within 2^-19 of the sum of
    their terms' magnitudes of the exact products; hi * hi alone does
    not."""
    _, folded, _ = weights
    w = folded.gcn[layer]
    tv, ci = w.k2.shape[0], w.w2.shape[1]
    rng = np.random.default_rng(layer)
    f = rng.standard_normal((tv, ci)).astype(np.float32)
    k = w.k2.numpy()
    kh, kl = P.tf32_split(k)
    kh, kl = kh.astype(np.float64), P.tf32_round(kl).astype(np.float64)
    fh, fl = split(f)
    g = mma3(kh, kl, fh, fl)
    want_g = k.astype(np.float64) @ f
    assert (np.abs(g - want_g) <= _magnitude_bound(k, f)).all()
    assert (np.abs((kh @ fh) - want_g) > _magnitude_bound(k, f)).any()
    wt = w.w2.numpy().T
    gh, gl = split(g)
    wh, wl = split(wt)
    y = mma3(gh, gl, wh, wl)
    want_y = g.astype(np.float64) @ wt
    assert (np.abs(y - want_y) <= _magnitude_bound(g, wt)).all()
    assert (np.abs((gh @ wh) - want_y) > _magnitude_bound(g, wt)).any()


def test_tf32_round_is_round_to_nearest_ties_away():
    """hi keeps 10 mantissa bits: 1 + 2^-11 (a tie) rounds away to 1 +
    2^-10, just below it to 1; a - hi is exact; signs are symmetric."""
    one = np.float32(1)
    a = np.array([one + np.float32(2.0 ** -11),
                  np.nextafter(one + np.float32(2.0 ** -11), one),
                  -(one + np.float32(2.0 ** -11)), 3.14159265], np.float32)
    hi, lo = P.tf32_split(a)
    np.testing.assert_array_equal(hi[:3], [1 + 2.0 ** -10, 1,
                                           -(1 + 2.0 ** -10)])
    assert not (hi.view(np.uint32) & 0x1fff).any()
    np.testing.assert_array_equal(hi.astype(np.float64) + lo, a)
    assert np.abs(lo[3]) <= 2.0 ** -11 * np.abs(a[3])


def test_tc32_blob_holds_the_f32_constants(weights):
    """Each record's K fragments give its graph operator, or a joint's
    dense operator (hi + lo within 2^-21 relative, both TF32, zero outside
    it), its W tile the rows of W it covers, exactly."""
    _, folded, plan = weights
    _, ops = _records(plan)
    blob = plan.blob.numpy()
    layer = iter(P.layer_sequence(folded))
    for o in ops:
        if o['kind'] == 1 or o['c0'] == 0:
            cur = next(layer)
        kind, i, tvi, tvo = cur
        base = o['blob']
        frags = blob[base + o['k']:base + o['k'] + o['mt'] * o['ks'] * 1024]
        khi, klo = unfragment(frags.view(np.float32).reshape(
            o['mt'], o['ks'], 2, 32, 4))
        k = khi.astype(np.float64) + klo
        want_k = (folded.gcn[i].k2 if kind == 0 else folded.joint[i].d2)
        np.testing.assert_allclose(k[:tvo, :tvi], want_k.numpy(),
                                   rtol=2.0 ** -21, atol=0)
        assert not k[tvo:].any() and not k[:, tvi:].any()
        if kind == 1:
            continue
        w = folded.gcn[i]
        assert not (np.concatenate([khi, klo]).view(np.uint32)
                    & 0x1fff).any()
        cop = 8 * o['nt']
        tile = blob[base + o['w']:base + o['w'] + cop * o['w_stride'] * 4]
        tile = tile.view(np.float32).reshape(cop, o['w_stride'])
        co, ci = w.w2.shape
        want = np.zeros((cop, o['ci']), np.float32)
        sub = w.w2.numpy()[o['c0']:o['c0'] + cop]
        want[:sub.shape[0], :ci] = sub
        np.testing.assert_array_equal(tile[:, :o['ci']], want)
        assert bool(o['res']) == (w.wr2 is not None)


def assert_tc32_plan_fits(plan):
    """The plan inside a block's shared memory, its regions apart and
    aligned; per record, its input, output and skip inside the row and
    apart, strides 8 or 24 mod 32 words (conflict-free fragment loads);
    a record's constants inside a weight buffer."""
    h, ops = _records(plan)
    rows = plan.rows
    assert plan.smem_bytes + P.TC32_STATIC_SMEM <= P.MAX_SMEM_BYTES
    assert len(plan.table) <= P.TC32_MAX_TABLE
    wsize = h['wbuf1'] - h['wbuf0']
    assert max(o['blob_bytes'] for o in ops) <= wsize
    spans = [(h['wbuf0'], h['wbuf0'] + wsize),
             (h['wbuf1'], h['wbuf1'] + wsize),
             (h['emb_off'], h['emb_off'] + rows * h['emb_stride'] * 4),
             (h['pbuf_off'], h['pbuf_off'] + -(-rows * (
                 h['cin'] * h['tva'] + h['e']) * 4 // 16) * 16)]
    spans += [(h['row0'] + r * h['row_bytes'],
               h['row0'] + (r + 1) * h['row_bytes'])
              for r in range(rows)]
    spans.sort()
    assert spans[0][0] == 0 and spans[-1][1] == plan.smem_bytes
    for a, b in zip(spans, spans[1:]):
        assert a[1] <= b[0], 'overlapping regions'
    assert all(s % 16 == 0 for span in spans for s in span)
    for o in ops:
        rows_in = max(16 * -(-o['tvi'] // 16), 8 * o['ks'])
        rows_out = 16 * -(-o['tvo'] // 16)
        assert o['p0'] % 16 == 0 and o['p0'] + 16 * o['mt'] <= rows_out
        bufs = [(o['in'], rows_in * o['in_stride'] * 4),
                (o['out'], rows_out * o['out_stride'] * 4)]
        if o['skip'] >= 0:
            bufs.append((o['skip'], rows_out * o['skip_stride'] * 4))
        for off, size in bufs:
            assert 0 <= off and off + size <= h['row_bytes']
            assert off % 16 == 0
        bufs.sort()
        for a, b in zip(bufs, bufs[1:]):
            assert a[0] + a[1] <= b[0], 'overlapping activations'
        assert o['in_stride'] % 32 in (8, 24)
        assert o['out_stride'] % 32 in (8, 24)
        assert o['kind'] == 1 or o['w_stride'] % 32 in (8, 24)


def test_tc32_plan_fits_and_buffers_are_disjoint(weights):
    _, _, plan = weights
    _, ops = _records(plan)
    # the flagship: 211,728 bytes, plus 4,112 of static shared memory for
    # the table and two mbarriers, of the 232,448 a Hopper block may use;
    # 2 rows per tile; d3_0 and d3_1 each staged as two halves of C_out,
    # no record split over positions
    assert plan.smem_bytes == 211728 and plan.rows == 2
    assert len(ops) == 17 and [o['c0'] for o in ops[7:11]] == [0, 64, 0, 32]
    assert all(o['p0'] == 0 for o in ops)
    assert_tc32_plan_fits(plan)


def test_tc32_nsplit_keeps_every_warp_busy_where_it_pays():
    """The cost model's split at the flagship's level c (2 rows x 2
    position tiles = 4 units; d3_0's half: 4 chunks, 4 steps, 8 tiles,
    residual): 8 warps take 2 parts of 4 tiles, 16 warps 4 of 2; never
    more than 4 tiles per unit."""
    assert P.tc32_nsplit(4, 4, 4, 8, True, warps=8) == 2
    assert P.tc32_nsplit(4, 4, 4, 8, True, warps=16) == 4
    assert P.tc32_nsplit(1, 4, 4, 8, True, warps=1) == 2
    assert P.tc32_nsplit(8, 2, 7, 1, True) == 1
    with pytest.raises(ValueError, match='cannot split'):
        P.tc32_nsplit(4, 1, 1, 3, False)


def test_tc32_table_format_matches_the_source():
    """The header and op record fields the host packs are the enums the
    CUDA source reads, in order (the library also reports their lengths
    when it loads)."""
    with open(CSRC) as f:
        src = f.read()

    def enum(first):
        body = re.search(r'enum \{\s*(' + first + r'\b.*?)\};', src,
                         re.S).group(1)
        body = re.sub(r'//[^\n]*', '', body)
        return [t.strip() for t in body.split(',') if t.strip()]

    assert enum('H_NOPS') == ['H_' + k.upper() for k in P.TC32_HEADER] + \
        ['H_LEN']
    assert enum('O_KIND') == ['O_' + k.upper() for k in P.TC32_OP] + \
        ['O_LEN']
    # one launch case per build of rows per tile, and the mask it reports
    cases = re.findall(r'case (\d+):\s*return launch_rows<\1>', src)
    assert sorted(map(int, cases)) == sorted(P.TC32_ROW_COUNTS)
    assert re.search(r'row_counts\(\) \{\s*return ([^;]+);', src).group(1) \
        == ' | '.join(f'(1 << {r})' for r in P.TC32_ROW_COUNTS)
    assert re.search(r'#define TC32_WARPS (\d+)', src).group(1) == \
        str(P.TC32_WARPS)
    assert re.search(r'kMaxTable = (\d+);', src).group(1) == \
        str(P.TC32_MAX_TABLE)
    assert re.search(r'kMaxE = (\d+);', src).group(1) == str(P.TC32_MAX_E)
    # 3xTF32, not one TF32 pass: three MMAs per product
    assert 'm16n8k8.row.col.f32.tf32.tf32.f32' in src
    assert len(re.findall(r'mma\(ds?\[q\], a[hl], b[hl]\[q\]', src)) == 3


def test_bf16_plan_is_unchanged(weights):
    """pack_for_tc_kernel's output, byte for byte, as before this kernel
    was added."""
    _, folded, _ = weights
    plan = P.pack_for_tc_kernel(folded)
    h = hashlib.sha256(plan.blob.numpy().tobytes())
    h.update(plan.table.numpy().astype('<i4').tobytes())
    h.update(str(plan.smem_bytes).encode())
    assert h.hexdigest() == TC_BF16_PLAN_SHA256


def test_f32_cpu_tensor_goes_to_the_plain_version(weights):
    _, folded, _ = weights
    x, semb = _inputs(8, seed=3)
    xt, s = torch.from_numpy(x), torch.from_numpy(semb)
    kernels = (P.DENOISER, P.DENOISER_F32_MMA, P.DENOISER_F32_FMA,
               P.DENOISER_BF16, P.DENOISER_BF16_FMA)
    before = [k.launches for k in kernels]
    got = P.denoise(xt, s, folded)
    assert [k.launches for k in kernels] == before
    assert torch.equal(got, P.denoise_reference(xt, s, folded))
    # the mma.sync kernel is kept as the warpgroup kernel's yardstick
    assert type(P.DENOISER_F32_MMA) is P.TensorCoreF32DenoiserKernel
    assert P.DENOISER_F32_MMA.source == 'denoiser_tc_f32.cu'
    for k in (P.DENOISER_F32_MMA, P.DENOISER_F32_FMA):
        with pytest.raises(ValueError, match='CUDA tensor'):
            k(xt, s, folded)


def test_phase_probe_instruments_the_f32_source():
    """tools/perf/probe_tc_phases.py finds every anchor it patches in
    csrc/denoiser_tc_f32.cu, once each, and the chunk dispatch its variants
    replace."""
    from mocodad_tpu_torch.tools.perf import probe_tc_phases as Q
    src = Q.instrumented_source('f32')
    assert src.count('atomicAdd(&g_prof[') == 7
    assert 'mocodad_probe_read' in src
    with open(CSRC) as f:
        base = f.read()
    assert Q.variant_source(32) == base
    for chunk in (16, 64):
        assert Q.CHUNK_DISPATCH not in Q.variant_source(chunk)
    fma = Q.variant_source(32, 'fma')
    assert Q.JOINT_MMA[0] not in fma and 'on the FMA units' in fma


def test_fma_joint_plan_holds_the_diagonal_blocks(weights):
    """The probe's plan for the FMA joint variant: each joint record points
    at its T diagonal (V_out, V_in) blocks, which rebuild its operator, and
    carries V_in in ks and V_out in nt; the other records are untouched."""
    from mocodad_tpu_torch.tools.perf import probe_tc_phases as Q
    _, folded, plan = weights
    h, ops = _records(plan)
    fma = Q.joint_fma_plan(plan, folded)
    _, fops = _records(fma)
    blob = fma.blob.numpy()
    joints, t_dim = iter(folded.joint), folded.n_frames
    for o, d in zip(ops, fops):
        if o['kind'] == 0:
            assert o == d
            continue
        assert d['blob_bytes'] <= h['wbuf1'] - h['wbuf0']
        vi, vo = d['ks'], d['nt']
        blk = blob[d['blob'] + d['k']:d['blob'] + d['k'] +
                   t_dim * vo * vi * 4].view(np.float32)
        dense = np.kron(np.eye(t_dim), np.ones((vo, vi))) * np.tile(
            blk.reshape(t_dim, vo, vi).reshape(t_dim * vo, vi), (1, t_dim))
        np.testing.assert_array_equal(dense, next(joints).d2.numpy())
