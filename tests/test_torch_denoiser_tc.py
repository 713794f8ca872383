"""B1 at bfloat16 on the tensor cores (`csrc/denoiser_tc.cu`): a NumPy
emulation of the kernel's arithmetic (`_torch_port.emulate_tc`), driven
only by what `pack_for_tc_kernel` packs, against the plain version and the
JAX Pallas kernel in interpret mode; the hi/lo split of g; the shared-memory plan;
and the routing of a CPU tensor."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (bf16, bf16_stats, emulate_tc_all, from_bits,
                         jax_model, seeded_variables, table_records,
                         torch_model, torch_net)
from mocodad_tpu.ops.pallas_unet import build_pallas_denoiser
from mocodad_tpu_torch.ops import pallas_unet as P

# bfloat16 on both sides at the same rounding points, sums in another
# order: a sum near a rounding boundary can round the other way (2^-8
# relative) and later layers carry the flip.  Against the plain version,
# chip_smoke.py's bounds (max |diff| within 3 % of the largest output,
# mean |diff| within 0.1 % of the mean output); against the JAX kernel,
# tests/test_torch_denoiser_bf16.py's (1.5 %, 0.1 %).
PLAIN_MAX_REL, PLAIN_MEAN_REL = 3e-2, 1e-3
JAX_MAX_REL, JAX_MEAN_REL = 1.5e-2, 1e-3
# W g with g = g_hi + g_lo: within 2^-15 of the product's largest entry
HILO_REL = 2.0 ** -15
CSRC = os.path.join(os.path.dirname(__file__), '..', 'mocodad_tpu_torch',
                    'csrc', 'denoiser_tc.cu')


@pytest.fixture(scope='module')
def weights():
    jm = jax_model()
    variables = seeded_variables(jm, seed=5)
    tm = torch_model()
    net = torch_net(tm, variables)
    denoise = build_pallas_denoiser(
        variables['params']['model'], variables['batch_stats']['model'],
        c_in=2, n_frames=3, n_joints=17, embedding_dim=16, nb=8,
        compute_dtype=jnp.bfloat16, interpret=True)
    folded = tm.fold(net)
    return denoise, folded, P.pack_for_tc_kernel(folded)


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 51, n)).astype(np.float32)
    s = rng.standard_normal((16, n)).astype(np.float32)
    return x, (s / (1 + np.exp(-s))).astype(np.float32)     # silu


def _records(plan):
    return table_records(plan.table, P.TC_HEADER)


@pytest.mark.parametrize('n', [16, 13], ids=['aligned', 'ragged'])
def test_tc_emulation_matches_plain_version_and_pallas(weights, n):
    denoise, folded, plan = weights
    x, semb = _inputs(n, seed=n + 20)
    xb = torch.from_numpy(x).bfloat16()
    got = emulate_tc_all(plan, xb.float().numpy(), semb)
    assert got.shape == (2, 51, n) and np.isfinite(got).all()
    plain = P.denoise_reference(xb, torch.from_numpy(semb), folded,
                                compute_dtype=torch.bfloat16)
    max_rel, mean_rel = bf16_stats(got, plain.float().numpy())
    assert max_rel <= PLAIN_MAX_REL and mean_rel <= PLAIN_MEAN_REL, \
        (max_rel, mean_rel)
    want = denoise(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(semb))
    max_rel, mean_rel = bf16_stats(got, np.asarray(want.astype(jnp.float32)))
    assert max_rel <= JAX_MAX_REL and mean_rel <= JAX_MEAN_REL, \
        (max_rel, mean_rel)


def test_tc_blob_holds_the_rounded_constants(weights):
    """Each op's tiles are B1's bf16 matrices, zero outside them."""
    _, folded, plan = weights
    _, ops = _records(plan)
    blob = plan.blob.numpy()
    fw = P.compute_weights(folded, torch.bfloat16)
    for o, (kind, i, tvi, tvo) in zip(ops, P.layer_sequence(folded)):
        base = o['blob']

        def tile(off, rows, stride):
            a = blob[base + off:base + off + rows * stride * 2]
            return from_bits(a.view(np.uint16).reshape(rows, stride))

        k = tile(o['k'], 16 * o['mt'], o['k_stride'])
        want_k = (fw.gcn[i].k2 if kind == 0 else fw.joint[i].d2).numpy()
        np.testing.assert_array_equal(k[:tvo, :tvi], want_k)
        assert not k[tvo:].any() and not k[:, tvi:].any()
        if kind == 0:
            w = tile(o['w'], 8 * o['nt'], o['w_stride'])
            co, ci = fw.gcn[i].w2.shape
            np.testing.assert_array_equal(w[:co, :ci], fw.gcn[i].w2.numpy())
            assert not w[co:].any() and not w[:, ci:].any()
            assert bool(o['res']) == (fw.gcn[i].wr2 is not None)


@pytest.mark.parametrize('layer', range(len(P.GCN_LAYERS)),
                         ids=list(P.GCN_LAYERS))
def test_hi_lo_split_reproduces_the_f32_channel_mix(weights, layer):
    """W g with g float32 (B1): g_hi + g_lo in bf16 gives it to within
    2^-15 of its largest entry on each flagship layer's shapes; g rounded
    once to bf16 (B2's function) does not."""
    _, folded, _ = weights
    w = P.compute_weights(folded, torch.bfloat16).gcn[layer]
    tv, ci = w.k2.shape[0], w.w2.shape[1]
    rng = np.random.default_rng(layer)
    f = bf16(rng.standard_normal((tv, ci)))
    g = (w.k2.double().numpy() @ f).astype(np.float32).astype(np.float64)
    wt = w.w2.double().numpy().T
    want = g @ wt
    hi = bf16(g)
    lo = bf16(g - hi)
    scale = np.abs(want).max()
    assert np.abs(hi @ wt + lo @ wt - want).max() <= HILO_REL * scale
    assert np.abs(hi @ wt - want).max() > HILO_REL * scale


def assert_tc_plan_fits(plan):
    """The plan inside a block's shared memory beside the table, its
    regions apart and aligned; per op, its input, output and skip inside
    the row and apart."""
    h, ops = _records(plan)
    assert plan.smem_bytes + 4 * P.TC_MAX_TABLE <= P.MAX_SMEM_BYTES
    wsize = h['wbuf1'] - h['wbuf0']
    assert max(o['blob_bytes'] for o in ops) <= wsize
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
    for o in ops:
        bufs = [(o['in'], 16 * o['ks'] * o['in_stride'] * 2),
                (o['out'], 16 * o['mt'] * o['out_stride'] * 2)]
        if o['skip'] >= 0:
            bufs.append((o['skip'], 16 * o['mt'] * o['skip_stride'] * 2))
        for off, size in bufs:
            assert 0 <= off and off + size <= h['row_bytes']
            assert off % 16 == 0
        bufs.sort()
        for a, b in zip(bufs, bufs[1:]):
            assert a[0] + a[1] <= b[0], 'overlapping activations'


def test_tc_plan_fits_and_buffers_are_disjoint(weights):
    _, _, plan = weights
    # the flagship: 224,160 of the 232,448 bytes a Hopper block may use,
    # 4 rows per tile
    assert plan.smem_bytes == 224160 and plan.rows == 4
    assert_tc_plan_fits(plan)


def test_tc_table_format_matches_the_source():
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

    assert enum('H_NOPS') == ['H_' + k.upper() for k in P.TC_HEADER] + \
        ['H_LEN']
    assert enum('O_KIND') == ['O_' + k.upper() for k in P.TC_OP] + ['O_LEN']
    # one launch case per build of rows per tile, and the mask it reports
    cases = re.findall(r'case (\d+):\s*return launch<\1>', src)
    assert sorted(map(int, cases)) == sorted(P.TC_ROW_COUNTS)
    assert re.search(r'row_counts\(\) \{\s*return ([^;]+);', src).group(1) \
        == ' | '.join(f'(1 << {r})' for r in P.TC_ROW_COUNTS)


def test_bf16_cpu_tensor_goes_to_the_plain_version(weights):
    _, folded, _ = weights
    x, semb = _inputs(8, seed=3)
    xb, s = torch.from_numpy(x).bfloat16(), torch.from_numpy(semb)
    kernels = (P.DENOISER, P.DENOISER_F32_FMA, P.DENOISER_BF16,
               P.DENOISER_BF16_FMA)
    before = [k.launches for k in kernels]
    got = P.denoise(xb, s, folded)
    assert [k.launches for k in kernels] == before
    assert torch.equal(got, P.denoise_reference(
        xb, s, folded, compute_dtype=torch.bfloat16))
    for k in (P.DENOISER_BF16, P.DENOISER_BF16_FMA):
        with pytest.raises(ValueError, match='CUDA tensor'):
            k(xb, s, folded)


def test_phase_probe_instruments_the_source():
    """tools/perf/probe_tc_phases.py finds every anchor it patches in
    csrc/denoiser_tc.cu and csrc/denoiser_wg.cu, once each (the graph mix
    counter included)."""
    from mocodad_tpu_torch.tools.perf import probe_tc_phases
    for which in ('mma', 'wg'):
        src = probe_tc_phases.instrumented_source(which)
        assert src.count('atomicAdd(&g_prof[') == 8
        assert 'mocodad_probe_read' in src
