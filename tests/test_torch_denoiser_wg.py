"""B1 at bfloat16 on wgmma (`csrc/denoiser_wg.cu`): a NumPy emulation of
the kernel's arithmetic (`_torch_port.emulate_wg`), driven only by what
`pack_for_wg_kernel` packs, with W and Wr read back through a model of the
wgmma shared-memory descriptor and the graph mixes over the blocks of K in
the plan's masks, against the plain version and the JAX Pallas kernel in
interpret mode at T = 3 and T = 6; the packed constants; the plans at T =
1-6; the table format; and the routing of a CPU tensor."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (bf16_stats, emulate_wg_all, from_bits, jax_model,
                         seeded_variables, table_records, torch_model,
                         torch_net, wg_b_operand, wg_descriptor)
from mocodad_tpu.ops.pallas_unet import build_pallas_denoiser
from mocodad_tpu_torch.ops import pallas_unet as P
from test_torch_denoiser_tc import (JAX_MAX_REL, JAX_MEAN_REL, PLAIN_MAX_REL,
                                    PLAIN_MEAN_REL)

CSRC = os.path.join(os.path.dirname(__file__), '..', 'mocodad_tpu_torch',
                    'csrc', 'denoiser_wg.cu')
# the configuration whose U-Net runs at each frame count at 17 joints
FRAMES = {1: dict(conditioning_indices=[0, 1, 2, 3, 4]),
          2: dict(conditioning_indices=[0, 1, 2, 3]), 3: {},
          4: dict(conditioning_indices=[0, 1]),
          5: dict(conditioning_indices=[0]),
          6: dict(conditioning_strategy='concat')}
_CACHE = {}


def _setup(t):
    """(the JAX kernel at bfloat16, folded, the warpgroup plan) at t frames,
    JAX weights from seed t + 2, built once."""
    if t not in _CACHE:
        jm, tm = jax_model(**FRAMES[t]), torch_model(**FRAMES[t])
        variables = seeded_variables(jm, seed=t + 2)
        folded = tm.fold(torch_net(tm, variables))
        assert folded.n_frames == t
        denoise = build_pallas_denoiser(
            variables['params']['model'], variables['batch_stats']['model'],
            c_in=2, n_frames=t, n_joints=17, embedding_dim=16, nb=8,
            compute_dtype=jnp.bfloat16, interpret=True)
        _CACHE[t] = denoise, folded, P.pack_for_wg_kernel(folded)
    return _CACHE[t]


def _inputs(t, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 17 * t, n)).astype(np.float32)
    s = rng.standard_normal((16, n)).astype(np.float32)
    return x, (s / (1 + np.exp(-s))).astype(np.float32)     # silu


def _records(plan):
    return table_records(plan.table, P.TC_HEADER, P.WG_OP)


@pytest.mark.parametrize('t,n', [(3, 16), (3, 13), (6, 8), (6, 7)],
                         ids=['t3-aligned', 't3-ragged', 't6-aligned',
                              't6-ragged'])
def test_wg_emulation_matches_plain_version_and_pallas(t, n):
    denoise, folded, plan = _setup(t)
    assert plan.rows == (4 if t == 3 else 2)
    x, semb = _inputs(t, n, seed=10 * t + n)
    xb = torch.from_numpy(x).bfloat16()
    got = emulate_wg_all(plan, xb.float().numpy(), semb)
    assert got.shape == (2, 17 * t, n) and np.isfinite(got).all()
    plain = P.denoise_reference(xb, torch.from_numpy(semb), folded,
                                compute_dtype=torch.bfloat16)
    max_rel, mean_rel = bf16_stats(got, plain.float().numpy())
    assert max_rel <= PLAIN_MAX_REL and mean_rel <= PLAIN_MEAN_REL, \
        (max_rel, mean_rel)
    want = denoise(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(semb))
    max_rel, mean_rel = bf16_stats(got, np.asarray(want.astype(jnp.float32)))
    assert max_rel <= JAX_MAX_REL and mean_rel <= JAX_MEAN_REL, \
        (max_rel, mean_rel)


@pytest.mark.parametrize('t', [3, 6])
def test_wg_blob_holds_the_rounded_constants(t):
    """Each op's K tile is B1's bf16 operator, its masks mark exactly the
    16x16 blocks with a nonzero entry (the joint re-scalings' zero blocks
    are skipped), and W and Wr read through their descriptors are B1's
    bf16 matrices, zero outside them."""
    _, folded, plan = _setup(t)
    _, ops = _records(plan)
    blob = plan.blob.numpy()
    fw = P.compute_weights(folded, torch.bfloat16)
    skipped = 0
    for o, (kind, i, tvi, tvo) in zip(ops, P.layer_sequence(folded)):
        base = o['blob']
        tvop, tvip = 16 * o['mt'], 16 * o['ks']
        k = from_bits(blob[base + o['k']:base + o['k'] + tvop * o['k_stride']
                           * 2].view(np.uint16).reshape(tvop, o['k_stride']))
        want_k = (fw.gcn[i].k2 if kind == 0 else fw.joint[i].d2).numpy()
        np.testing.assert_array_equal(k[:tvo, :tvi], want_k)
        assert not k[tvo:].any() and not k[:, tvi:].any()
        masks = blob[base + o['kmask']:base + o['kmask'] + 4 * o['mt']].view(
            np.int32)
        nonzero = np.abs(k[:, :tvip]).reshape(
            o['mt'], 16, o['ks'], 16).any(axis=(1, 3))
        assert [[bool(m >> s & 1) for s in range(o['ks'])] for m in masks] \
            == nonzero.tolist()
        skipped += int((~nonzero).sum()) * (kind == 1)
        if kind == 0:
            co, ci = fw.gcn[i].w2.shape
            mats = [('w', fw.gcn[i].w2)] + \
                ([('wr', fw.gcn[i].wr2)] if o['res'] else [])
            for key, m in mats:
                wt = np.block([[wg_b_operand(blob[base:], wg_descriptor(
                    o[key] + c0 // 16 * o['w_stride'] + o0 // 8 * P.WG_SBO),
                    8) for o0 in range(0, 8 * o['nt'], 8)]
                    for c0 in range(0, o['ci'], 16)])
                np.testing.assert_array_equal(wt[:ci, :co], m.numpy().T)
                assert not wt[ci:].any() and not wt[:, co:].any()
            assert bool(o['res']) == (fw.gcn[i].wr2 is not None)
            assert o['w_stride'] == 32 * 8 * o['nt']
    assert skipped > 0


def _fit_records(plan):
    """(header, op records, every buffer an op touches in a row)."""
    h, ops = _records(plan)
    bufs = []
    for o in ops:
        b = [(o['in'], 16 * o['ks'] * o['in_stride'] * 2),
             (o['out'], 16 * o['mt'] * o['out_stride'] * 2)]
        if o['skip'] >= 0:
            b.append((o['skip'], 16 * o['mt'] * o['skip_stride'] * 2))
        bufs.append(b)
    return h, ops, bufs


@pytest.mark.parametrize('t', sorted(FRAMES))
def test_wg_plan_fits_and_buffers_are_disjoint(t):
    """At T = 1-6 the plan fits a block's shared memory beside the static
    table, with the most rows that fit (4 up to T = 3, 2 above; one more
    row does not fit), its regions apart and aligned, each op's constants
    inside a weight buffer and its input, output and skip inside the row
    and apart, every op's K steps within the kernel's registers, and each
    wgmma 16, 32 or 64 channels wide."""
    tm = torch_model(**FRAMES[t])
    folded = tm.fold(torch_net(tm, seeded_variables(jax_model(**FRAMES[t]),
                                                    seed=t)))
    plan = P.pack_for_wg_kernel(folded)
    assert plan.rows == (4 if t <= 3 else 2)
    assert plan.smem_bytes + P.WG_STATIC_SMEM <= P.MAX_SMEM_BYTES
    assert plan.table.numel() <= P.WG_MAX_TABLE
    more = [r for r in P.WG_ROW_COUNTS if r > plan.rows]
    if more:
        with pytest.raises(P.SharedMemoryError):
            P.pack_for_wg_kernel(folded, min(more))
    h, ops, bufs = _fit_records(plan)
    wsize = h['wbuf1'] - h['wbuf0']
    spans = [(h['wbuf0'], h['wbuf0'] + wsize),
             (h['wbuf1'], h['wbuf1'] + wsize),
             (h['embw_off'], h['embw_off'] + h['embw_bytes']),
             (h['emb_off'], h['emb_off'] + plan.rows * h['emb_stride'] * 4)]
    spans += [(h['row0'] + r * h['row_bytes'],
               h['row0'] + (r + 1) * h['row_bytes'])
              for r in range(plan.rows)]
    spans.sort()
    assert spans[0][0] == 0 and spans[-1][1] == plan.smem_bytes
    for a, b in zip(spans, spans[1:]):
        assert a[1] <= b[0], 'overlapping regions'
    assert all(s % 16 == 0 for span in spans for s in span)
    for o, b in zip(ops, bufs):
        assert o['blob_bytes'] <= wsize
        assert 1 <= o['ks'] <= (P.WG_SHORT_KS if plan.rows == 4
                                else P.WG_MAX_KS)
        for key in ('k', 'kmask', 'w', 'wr'):
            if o[key] >= 0:
                assert o[key] % 16 == 0 and o[key] < o['blob_bytes']
        assert o['nt'] // o['nsplit'] in P.wg_unit_tiles(o['ks']) \
            if o['kind'] == 0 else o['nsplit'] == 1
        for off, size in b:
            assert 0 <= off and off + size <= h['row_bytes']
            assert off % 16 == 0
        b.sort()
        for x, y in zip(b, b[1:]):
            assert x[0] + x[1] <= y[0], 'overlapping activations'


def test_wg_table_format_matches_the_source():
    """The header and op record fields the host packs are the enums the
    CUDA source reads, in order; the rows, warps, K steps and descriptor
    offsets the host plans for are the source's."""
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

    assert enum('H_NOPS') == ['H_' + k.upper() for k in P.TC_HEADER] + \
        ['H_LEN']
    assert enum('O_KIND') == ['O_' + k.upper() for k in P.WG_OP] + ['O_LEN']
    cases = re.findall(r'case (\d+):\s*return launch<\1>', src)
    assert sorted(map(int, cases)) == sorted(P.WG_ROW_COUNTS)
    assert re.search(r'row_counts\(\) \{\s*return ([^;]+);', src).group(1) \
        == ' | '.join(f'(1 << {r})' for r in P.WG_ROW_COUNTS)
    assert (const('kWarps'), const('kMaxTable'), const('kMaxKs')) == \
        (P.WG_WARPS, P.WG_MAX_TABLE, P.WG_MAX_KS)
    assert (const('kLbo'), const('kSbo')) == (P.WG_LBO, P.WG_SBO)
    assert const('kShortKs') == P.WG_SHORT_KS
    assert 'constexpr int kMaxNt8Ks = kShortKs;' in src and \
        P.WG_MAX_NT8_KS == P.WG_SHORT_KS
    # the short code for up to kShortKs K steps, the long code in the 2-row
    # build only; one dispatch per wgmma width
    assert re.search(r'if \(utab\(d, O_KS\) <= kShortKs\)\s*'
                     r'wg_run_ks<kShortKs>.*?else if constexpr \(kRows < 4\)'
                     r'\s*wg_run_ks<kMaxKs>', src, re.S)
    assert sorted(int(k) for k in re.findall(
        r'case (\d+):\s*(?:if constexpr \(KS <= kMaxNt8Ks\)\s*)?'
        r'wg_gcn<\1, KS>', src)) == list(P.WG_UNIT_TILES)


def test_wg_planner_takes_the_widest_wgmma():
    """C_out goes in as few parts as the wgmma widths allow (a part
    recomputes its graph mixes): at T = 3 only d3_0 (128 channels) splits,
    in two wgmmas of 64; at T = 6 also the second level's 64-channel
    layers (5 K steps), in two of 32; no joint re-scaling splits."""
    for t, split in ((3, {'d3_0': 2}),
                     (6, {'d2_0': 2, 'd2_1': 2, 'd3_0': 2, 'u4_0': 2})):
        _, folded, plan = _setup(t)
        _, ops = _records(plan)
        names = [P.GCN_LAYERS[i] if kind == 0 else P.JOINT_LAYERS[i]
                 for kind, i, _, _ in P.layer_sequence(folded)]
        assert {n: int(o['nsplit']) for n, o in zip(names, ops)
                if o['nsplit'] > 1} == split
        for o in ops:
            if o['kind'] == 0:
                assert o['nt'] // o['nsplit'] in P.wg_unit_tiles(o['ks'])
    assert P.wg_nsplit(2, 16) == 2 and P.wg_nsplit(5, 8) == 2
    assert P.wg_nsplit(4, 8) == 1 and P.wg_nsplit(7, 2) == 1


def test_wg_bf16_cpu_tensor_goes_to_the_plain_version():
    _, folded, _ = _setup(3)
    x, semb = _inputs(3, 8, seed=3)
    xb, s = torch.from_numpy(x).bfloat16(), torch.from_numpy(semb)
    kernels = (P.DENOISER, P.DENOISER_F32_FMA, P.DENOISER_BF16,
               P.DENOISER_BF16_MMA, P.DENOISER_BF16_FMA)
    before = [k.launches for k in kernels]
    got = P.denoise(xb, s, folded)
    assert [k.launches for k in kernels] == before
    assert torch.equal(got, P.denoise_reference(
        xb, s, folded, compute_dtype=torch.bfloat16))
    assert P.DENOISER_BF16.source == 'denoiser_wg.cu'
    assert P.DENOISER_BF16_MMA.source == 'denoiser_tc.cu'
    for k in (P.DENOISER_BF16, P.DENOISER_BF16_MMA):
        with pytest.raises(ValueError, match='CUDA tensor'):
            k(xb, s, folded)
