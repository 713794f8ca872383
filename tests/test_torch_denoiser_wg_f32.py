"""B1 at float32 on wgmma (`csrc/denoiser_wg_f32.cu`): a NumPy emulation of
the kernel's arithmetic (`_torch_port.emulate_wg32`), driven only by what
`pack_for_wg32_kernel` packs, with W and Wr hi and lo read back through a
model of wgmma's TF32 shared-memory descriptor, the graph mixes over the
8-position blocks of K in the plan's masks and a layer's accumulators
carried over its records, against the plain version and the JAX Pallas
kernel in interpret mode at T = 3 and T = 6; a control with one small
term of 3xTF32 dropped; the packed constants and their split; the plans
at T = 1-6; the table format; and the routing of a CPU tensor."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (WG32_TERMS, emulate_wg32_all, jax_model,
                         k_unfragment, seeded_variables,
                         table_records, torch_model, torch_net,
                         wg32_weight)
from mocodad_tpu.ops.pallas_unet import build_pallas_denoiser
from mocodad_tpu_torch.ops import pallas_unet as P
from test_torch_denoiser_tc_f32 import ATOL, RTOL
from test_torch_denoiser_wg import FRAMES

CSRC = os.path.join(os.path.dirname(__file__), '..', 'mocodad_tpu_torch',
                    'csrc', 'denoiser_wg_f32.cu')
_CACHE = {}


def _setup(t):
    """(the JAX kernel at float32, folded, the plan) at t frames, JAX
    weights from seed t + 4, built once."""
    if t not in _CACHE:
        jm, tm = jax_model(**FRAMES[t]), torch_model(**FRAMES[t])
        variables = seeded_variables(jm, seed=t + 4)
        folded = tm.fold(torch_net(tm, variables))
        assert folded.n_frames == t
        denoise = build_pallas_denoiser(
            variables['params']['model'], variables['batch_stats']['model'],
            c_in=2, n_frames=t, n_joints=17, embedding_dim=16, nb=8,
            compute_dtype=jnp.float32, interpret=True)
        _CACHE[t] = denoise, folded, P.pack_for_wg32_kernel(folded)
    return _CACHE[t]


def _inputs(t, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 17 * t, n)).astype(np.float32)
    s = rng.standard_normal((16, n)).astype(np.float32)
    return x, (s / (1 + np.exp(-s))).astype(np.float32)     # silu


def _records(plan):
    return table_records(plan.table, P.WG32_HEADER, P.WG32_OP)


def _excess(got, want):
    return np.max(np.abs(got - want) / (ATOL + RTOL * np.abs(want)))


@pytest.mark.parametrize('t,n', [(3, 8), (3, 7), (6, 3), (6, 2)],
                         ids=['t3-aligned', 't3-ragged', 't6-three',
                              't6-two'])
def test_wg32_emulation_matches_plain_version_and_pallas(t, n):
    denoise, folded, plan = _setup(t)
    assert plan.rows == (2 if t == 3 else 1)
    x, semb = _inputs(t, n, seed=10 * t + n)
    got = emulate_wg32_all(plan, x, semb)
    assert got.shape == (2, 17 * t, n) and np.isfinite(got).all()
    plain = P.denoise_reference(torch.from_numpy(x), torch.from_numpy(semb),
                                folded)
    np.testing.assert_allclose(got, plain.numpy(), RTOL, ATOL)
    want = np.asarray(denoise(jnp.asarray(x), jnp.asarray(semb)))
    np.testing.assert_allclose(got, want, RTOL, ATOL)


@pytest.mark.parametrize('dropped', WG32_TERMS[:2])
def test_one_small_term_dropped_misses_the_f32_check(dropped):
    """The emulation with one small term of the channel and residual
    mixes' 3xTF32 left out (g_lo W_hi or g_hi W_lo) lands outside the f32
    check that all three terms hold with room to spare."""
    _, folded, plan = _setup(3)
    x, semb = _inputs(3, 4, seed=38)
    want = P.denoise_reference(torch.from_numpy(x), torch.from_numpy(semb),
                               folded).numpy()
    assert _excess(emulate_wg32_all(plan, x, semb), want) < 0.2
    terms = tuple(term for term in WG32_TERMS if term != dropped)
    assert _excess(emulate_wg32_all(plan, x, semb, terms=terms), want) > 1


@pytest.mark.parametrize('t', [3, 6])
def test_wg32_blob_holds_the_f32_constants_and_their_split(t):
    """Each record's K fragments give its run's rows of the graph operator
    (hi + lo within 2^-21 relative, both TF32, zero outside it), its masks
    mark exactly the 8-position blocks with a nonzero entry (the joint
    re-scalings' zero blocks are skipped), and W and Wr read through their
    descriptors are the layer's rows C0 .. C1, hi and lo each TF32 and hi
    + lo within 2^-21 relative of them, zero outside; bias and slope
    exact."""
    _, folded, plan = _setup(t)
    _, ops = _records(plan)
    blob = plan.blob.numpy()
    layers = iter(P.layer_sequence(folded))
    skipped = 0
    for o in ops:
        if o['c0'] == 0 and o['p0'] == 0:           # a layer's first
            kind, i, tvi, tvo = next(layers)
        base, mt, ks, p0 = o['blob'], o['mt'], o['ks'], o['p0']
        khi, klo = k_unfragment(blob[base + o['k']:base + o['k'] +
                                     mt * ks * 1024].view(np.float32)
                                .reshape(mt, ks, 2, 32, 4))
        assert not (np.concatenate([khi, klo]).view(np.uint32)
                    & 0x1fff).any()
        kmat = (folded.gcn[i].k2 if kind == 0 else folded.joint[i].d2)
        want = np.zeros((p0 + 16 * mt, 8 * ks))
        want[:tvo, :tvi] = kmat.numpy()[:p0 + 16 * mt]
        want = want[p0:]
        np.testing.assert_allclose(khi.astype(np.float64) + klo, want,
                                   rtol=2.0 ** -21, atol=0)
        masks = blob[base + o['kmask']:base + o['kmask'] + 4 * mt].view(
            np.int32)
        nonzero = (want != 0).reshape(mt, 16, ks, 8).any(axis=(1, 3))
        assert [[bool(m >> s & 1) for s in range(ks)] for m in masks] == \
            nonzero.tolist()
        skipped += int((~nonzero).sum()) * (kind == 1)
        if kind == 1:
            continue
        w = folded.gcn[i]
        co = w.w2.shape[0]
        c0, c1 = o['c0'], o['c1']
        assert bool(o['res']) == (w.wr2 is not None)
        mats = [('w', w.w2)] + ([('wr', w.wr2)] if o['res'] else [])
        for key, m in mats:
            hi, lo = (wg32_weight(blob[base:], 0, o, k)
                      for k in (key, key + '_lo'))
            for half in (hi, lo):
                assert not (half.astype(np.float32).view(np.uint32)
                            & 0x1fff).any()
            want = np.zeros((c1 - c0, 8 * o['nt']))
            sub = m.numpy().T[c0:c1]
            want[:sub.shape[0], :co] = sub
            np.testing.assert_allclose(hi + lo, want, rtol=2.0 ** -21, atol=0)
        bias = blob[base + o['bias']:base + o['bias'] + 4 * co].view(
            np.float32)
        np.testing.assert_array_equal(bias, w.bias.numpy())
        assert blob[base + o['slope']:base + o['slope'] + 4].view(
            np.float32)[0] == np.float32(w.slope)
    assert skipped > 0


@pytest.mark.parametrize('t', sorted(FRAMES))
def test_wg32_plan_fits_and_buffers_are_disjoint(t):
    """At T = 1-6 the plan fits a block's shared memory beside the static
    table, with the most rows that fit (2 up to T = 4, 1 above; one more
    row does not fit), its regions apart and aligned, each record's
    constants inside a weight buffer and its input, output and skip inside
    the row and apart; an ST-GCNN layer's records cover its output tiles
    in runs and each run's input channels in order, a run of several
    records has at most one warpgroup unit per warpgroup, and each wgmma
    is 16 to 128 channels wide."""
    tm = torch_model(**FRAMES[t])
    folded = tm.fold(torch_net(tm, seeded_variables(jax_model(**FRAMES[t]),
                                                    seed=t)))
    plan = P.pack_for_wg32_kernel(folded)
    assert plan.rows == (2 if t <= 4 else 1)
    assert plan.smem_bytes + P.WG32_STATIC_SMEM <= P.MAX_SMEM_BYTES
    assert plan.table.numel() <= P.WG32_MAX_TABLE
    more = [r for r in P.WG32_ROW_COUNTS if r > plan.rows]
    if more:
        with pytest.raises(P.SharedMemoryError):
            P.pack_for_wg32_kernel(folded, min(more))
    h, ops = _records(plan)
    wsize = h['wbuf1'] - h['wbuf0']
    spans = [(h['wbuf0'], h['wbuf0'] + wsize),
             (h['wbuf1'], h['wbuf1'] + wsize),
             (h['emb_off'], h['emb_off'] + plan.rows * h['emb_stride'] * 4),
             (h['pbuf_off'], h['pbuf_off'] + -(-plan.rows * (
                 h['cin'] * h['tva'] + h['e']) * 4 // 16) * 16)]
    spans += [(h['row0'] + r * h['row_bytes'],
               h['row0'] + (r + 1) * h['row_bytes'])
              for r in range(plan.rows)]
    spans.sort()
    assert spans[0][0] == 0 and spans[-1][1] == plan.smem_bytes
    for a, b in zip(spans, spans[1:]):
        assert a[1] <= b[0], 'overlapping regions'
    assert all(s % 16 == 0 for span in spans for s in span)
    layers = iter(P.layer_sequence(folded))
    k = 0
    while k < len(ops):
        kind, _, tvi, tvo = next(layers)
        tiles = 0
        while tiles < -(-tvo // 16):
            o = ops[k]
            assert o['p0'] == 16 * tiles and o['ks'] == -(-tvi // 8)
            run = ops[k:k + o['nrec']]
            assert [(r['c0'], r['c1']) for r in run] == \
                [(c, c + o['c1'] - o['c0'])
                 for c in range(0, o['ci'], o['c1'] - o['c0'])]
            if kind == 1:
                assert o['nrec'] == 1 and o['nsplit'] == 1
            else:
                assert o['nt'] // o['nsplit'] in P.WG32_UNIT_TILES
                assert o['c1'] - o['c0'] >= P.wg32_min_width(
                    o['nt'] // o['nsplit'])
                if o['nrec'] > 1:
                    assert -(-plan.rows * o['mt'] // 4) * o['nsplit'] <= \
                        P.WG32_GROUPS
            for r in run:
                assert r['blob_bytes'] <= wsize
                assert all(r[f] == o[f] for f in ('p0', 'mt', 'nrec', 'in',
                                                   'out', 'nt', 'nsplit'))
                for key in ('k', 'kmask', 'w', 'w_lo', 'wr', 'wr_lo',
                            'bias'):
                    if r[key] >= 0:
                        assert r[key] % 16 == 0 and r[key] < r['blob_bytes']
                bufs = [(r['in'], 16 * -(-tvi // 16) * r['in_stride'] * 4),
                        (r['out'], 16 * -(-tvo // 16) * r['out_stride'] * 4)]
                if r['skip'] >= 0:
                    bufs.append((r['skip'],
                                 16 * -(-tvo // 16) * r['skip_stride'] * 4))
                for off, size in bufs:
                    assert 0 <= off and off + size <= h['row_bytes']
                    assert off % 16 == 0
                bufs.sort()
                for a, b in zip(bufs, bufs[1:]):
                    assert a[0] + a[1] <= b[0], 'overlapping activations'
            tiles += o['mt']
            k += o['nrec']
    assert next(layers, None) is None


def test_wg32_planner_streams_the_widest_layers():
    """At the flagship's T = 3 (2 rows a tile) every layer is one record,
    one wgmma unit each, except the two 128-channel ones, which stream
    over their input channels in 4 records each: d3_0 in 16s (W and Wr
    hi and lo for 128 outputs), d3_1 in 32s."""
    _, folded, plan = _setup(3)
    _, ops = _records(plan)
    names = [P.GCN_LAYERS[i] if kind == 0 else P.JOINT_LAYERS[i]
             for kind, i, _, _ in P.layer_sequence(folded)]
    nrec = []
    for o in ops:
        if o['c0'] == 0:
            nrec.append(o['nrec'])
    assert dict(zip(names, nrec)) == {n: 1 for n in names} | \
        {'d3_0': 4, 'd3_1': 4}
    assert [o['c1'] - o['c0'] for o in ops[7:15]] == [16] * 4 + [32] * 4
    assert all(o['nsplit'] == 1 and o['p0'] == 0 for o in ops)


def test_wg32_table_format_matches_the_source():
    """The header and op record fields the host packs are the enums the
    CUDA source reads, in order; the rows, warps, table length and
    descriptor offsets the host plans for are the source's; the channel
    mixes are TF32 wgmmas of every width the host packs, three per k-step
    (six with a residual mix), the graph mixes TF32 mma.sync."""
    with open(CSRC) as f:
        src = f.read()

    def enum(first):
        body = re.search(r'enum \{\s*(' + first + r'\b.*?)\};', src,
                         re.S).group(1)
        body = re.sub(r'//[^\n]*', '', body)
        return [t.strip() for t in body.split(',') if t.strip()]

    def const(name):
        return int(re.search(r'constexpr \w+ ' + name + r' = (\d+);',
                             src).group(1))

    assert enum('H_NOPS') == ['H_' + k.upper() for k in P.WG32_HEADER] + \
        ['H_LEN']
    assert enum('O_KIND') == ['O_' + k.upper() for k in P.WG32_OP] + \
        ['O_LEN']
    cases = re.findall(r'case (\d+):\s*return launch_rows<\1>', src)
    assert sorted(map(int, cases)) == sorted(P.WG32_ROW_COUNTS)
    assert re.search(r'row_counts\(\) \{\s*return ([^;]+);', src).group(1) \
        == ' | '.join(f'(1 << {r})' for r in P.WG32_ROW_COUNTS)
    assert const('kWarps') == P.WG32_WARPS == 4 * P.WG32_GROUPS
    assert (const('kMaxTable'), const('kMaxE')) == \
        (P.WG32_MAX_TABLE, P.TC32_MAX_E)
    assert (const('kLbo'), const('kSbo')) == (P.WG_LBO, P.WG_SBO)
    widths = sorted(int(n) for n in re.findall(
        r'wgmma\.mma_async\.sync\.aligned\.m64n(\d+)k8\.f32\.tf32\.tf32',
        src))
    assert widths == [8 * t for t in P.WG32_UNIT_TILES]
    assert sorted({int(k) for k in re.findall(
        r'case (\d+):\s*return [^;]*RUN\(\1,', src)}) == \
        list(P.WG32_UNIT_TILES)
    assert 'm16n8k8.row.col.f32.tf32.tf32.f32' in src
    assert len(re.findall(r'wgmma<NT>\(acc, [gf]l\[j\], b_desc\(d[wr]h \+ '
                          r'q\)\);', src)) == 2
    assert len(re.findall(r'wgmma<NT>\(acc, [gf]h\[j\], b_desc\(d[wr][hl] \+ '
                          r'q\)\);', src)) == 4


def test_wg32_f32_cpu_tensor_goes_to_the_plain_version():
    _, folded, _ = _setup(3)
    x, semb = _inputs(3, 8, seed=3)
    xt, s = torch.from_numpy(x), torch.from_numpy(semb)
    kernels = (P.DENOISER, P.DENOISER_F32_MMA, P.DENOISER_F32_FMA,
               P.DENOISER_BF16, P.DENOISER_BF16_MMA, P.DENOISER_BF16_FMA)
    before = [k.launches for k in kernels]
    got = P.denoise(xt, s, folded)
    assert [k.launches for k in kernels] == before
    assert torch.equal(got, P.denoise_reference(xt, s, folded))
    assert isinstance(P.DENOISER, P.WarpgroupF32DenoiserKernel)
    assert P.DENOISER.source == 'denoiser_wg_f32.cu'
    assert P.DENOISER_F32_MMA.source == 'denoiser_tc_f32.cu'
    for k in (P.DENOISER, P.DENOISER_F32_MMA):
        with pytest.raises(ValueError, match='CUDA tensor'):
            k(xt, s, folded)


def test_phase_probe_instruments_the_wg32_source():
    """tools/perf/probe_tc_phases.py finds every anchor it patches in
    csrc/denoiser_wg_f32.cu, once each (the loads, embeddings, each run of
    records with its waits apart, warp 0's graph mixes, rounds and
    epilogues, the store), and builds each variant it times by rewriting
    the source's constants: the shipped build is the source as it stands,
    and every other variant finds each line it rewrites."""
    from mocodad_tpu_torch.tools.perf import probe_tc_phases as Q
    src = Q.instrumented_source('wg32')
    assert src.count('atomicAdd(&g_prof[') == 8
    assert src.count('g_wait += ') == 1 and 'mocodad_probe_read' in src
    with open(CSRC) as f:
        base = f.read()
    # the shipped build is the first variant the probe times
    assert Q.WG32_VARIANTS[0] == (P.WG32_WARPS, P.WG32_UNIT_TILES[-1], 4)
    assert Q.wg32_variant_source(Q.WG32_VARIANTS[0]) == base
    for w, nt, jt in Q.WG32_VARIANTS[1:]:
        src = Q.wg32_variant_source((w, nt, jt))
        assert f'constexpr int kWarps = {w};' in src
        assert ('RUN(16, 1)' in src) == (nt >= 16)
        assert (f'gcn_run<NT, (JT < {jt} ? JT : {jt}), kRows>(' in src) == \
            (jt < 4)
    # a variant's plan packs only the wgmma widths its build has, and the
    # package's planner settings stand as they were
    _, folded, shipped = _setup(3)
    widths = {o['nt'] // o['nsplit'] for o in _records(shipped)[1]
              if o['kind'] == 0}
    assert max(widths) == 16
    for w, nt, jt in Q.WG32_VARIANTS[1:]:
        plan = Q.wg32_variant_plan(folded, (w, nt, jt), 'cpu')
        assert max(o['nt'] // o['nsplit'] for o in _records(plan)[1]
                   if o['kind'] == 0) == nt
    assert (P.WG32_GROUPS, P.WG32_UNIT_TILES) == (2, (2, 4, 8, 16))
