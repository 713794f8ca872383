"""B2 on the tensor cores (`csrc/denoiser_tc_grouped.cu`): a NumPy
emulation of the five group kernels' arithmetic, driven only by what
`pack_groups_tc` packs (each group's table, the shared blob, shared memory
that starts as NaN, the intermediates through the kernel's own (N, T*V, C)
layout), against the plain version `grouped_reference` and the JAX
repository's probe `grouped` in interpret mode; the rounding of g that
makes it B2's function; the x and silu_emb slots' word windows; the
plans; and the routing of a CPU tensor."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (bf16, bf16_stats, from_bits, grouped_probe,
                         smem_f32, smem_tile, table_records, tc_embed, tc_ops,
                         to_bits, torch_model, torch_net)
from mocodad_tpu_torch.ops import build
from mocodad_tpu_torch.ops import grouped_unet as G
from mocodad_tpu_torch.ops import pallas_unet as P

torch.set_num_threads(1)

# bfloat16 on both sides at B2's rounding points, sums in another order:
# against the JAX probe tests/test_torch_grouped.py's bounds; against the
# plain version chip_smoke.py's
JAX_MAX_REL, JAX_MEAN_REL = 1.5e-2, 1e-3
PLAIN_MAX_REL, PLAIN_MEAN_REL = 3e-2, 1e-3
CSRC = f'{build.CSRC_DIR}/denoiser_tc_grouped.cu'


@pytest.fixture(scope='module')
def probe():
    yield from grouped_probe()


@pytest.fixture(scope='module')
def folded(probe):
    """The probe's own variables in the port."""
    variables = jax.device_get(probe['variables'])
    tm = torch_model()
    return tm.fold(torch_net(tm, variables))


@pytest.fixture(scope='module')
def plan(folded):
    return G.pack_groups_tc(folded)


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 51, n)).astype(np.float32)
    s = rng.standard_normal((16, n)).astype(np.float32)
    semb = (s / (1 + np.exp(-s))).astype(np.float32)          # silu
    return (torch.from_numpy(x).bfloat16(),
            torch.from_numpy(semb).bfloat16())


def _group_records(g):
    """(header, the four I/O records, the op records) of a group's table."""
    nio = G.TCG_NIO * len(G.TCG_IO)
    h, ops = table_records(g.table, G.TCG_HEADER, skip=nio)
    flat = g.table.numpy()[len(G.TCG_HEADER):len(G.TCG_HEADER) + nio]
    io = [dict(zip(G.TCG_IO, flat[k * len(G.TCG_IO):
                                  (k + 1) * len(G.TCG_IO)]))
          for k in range(G.TCG_NIO)]
    return h, io, ops


def emulate_group(plan, g, tensors, semb, round_g=True):
    """One group kernel over every tile of its rows: `tensors` maps the
    names of its inputs to their device-memory arrays (x (C, T*V, N), an
    intermediate (N, T*V, C), bf16 values as float), semb (E, N).  Each
    tile starts from shared memory full of NaN with its row areas zeroed;
    an intermediate fills its (T*V, C) tiles row by row, x goes through
    the x slot (K1: into its tile; K5: to the final add).  Returns the
    group's outputs in their device layouts."""
    h, io, ops = _group_records(g)
    blob = plan.blob.numpy()
    rows, n = h['rows'], semb.shape[1]
    outs = {}
    for nm, rec in zip(g.spec.outs, io[2:]):
        c, tv = int(rec['c']), int(rec['tv'])
        outs[nm] = np.zeros((c, tv, n) if rec['cn'] else (n, tv, c))
    for n0 in range(0, n, rows):
        nv = min(rows, n - n0)
        sm = np.full(g.smem_bytes, 0xff, np.uint8)
        sm[h['row0']:h['row0'] + rows * h['row_bytes']] = 0
        rows_at = [h['row0'] + r * h['row_bytes'] for r in range(rows)]
        sm[h['embw_off']:h['embw_off'] + h['embw_bytes']] = \
            blob[h['embw_blob']:h['embw_blob'] + h['embw_bytes']]
        x_slot = None
        for nm, rec in zip(g.spec.ins, io):
            a, c, tv = tensors[nm], int(rec['c']), int(rec['tv'])
            if rec['cn']:
                x_slot = a[:, :, n0:n0 + nv]
                if rec['off'] < 0:
                    continue
            for r in range(nv):
                t = smem_tile(sm, rows_at[r] + rec['off'], -(-tv // 16) * 16,
                              rec['stride'])
                t[:tv, :c] = to_bits(a[:, :, n0 + r].T if rec['cn']
                                     else a[n0 + r])
        for r, at in enumerate(rows_at):
            smem_f32(sm, at + h['semb_off'], h['e'])[:] = \
                semb[:, n0 + r] if r < nv else 0
        tc_embed(sm, h, rows_at)
        tc_ops(sm, h, ops, blob, rows_at, round_g)
        for nm, rec in zip(g.spec.outs, io[2:]):
            c, tv = int(rec['c']), int(rec['tv'])
            for r in range(nv):
                f = from_bits(smem_tile(sm, rows_at[r] + rec['off'],
                                        -(-tv // 16) * 16,
                                        rec['stride'])[:tv, :c])
                if rec['cn']:
                    outs[nm][:, :, n0 + r] = bf16(f + x_slot[:, :, r].T).T
                else:
                    outs[nm][n0 + r] = f
    return outs


def emulate_grouped(plan, x, semb, round_g=True):
    """B2's eps through the five groups, x and semb bf16 tensors."""
    tensors = {'x': x.float().numpy().astype(np.float64)}
    s = semb.float().numpy().astype(np.float64)
    for g in plan.groups:
        tensors.update(emulate_group(plan, g, tensors, s, round_g))
    return tensors['eps']


@pytest.mark.parametrize('n', [16, 13], ids=['aligned', 'ragged'])
def test_tc_emulation_matches_plain_version_and_probe(probe, folded, plan,
                                                      n):
    x, semb = _inputs(n, seed=n + 30)
    got = emulate_grouped(plan, x, semb)
    assert got.shape == (2, 51, n) and np.isfinite(got).all()
    want = G.grouped_reference(x, semb, folded).float().numpy()
    max_rel, mean_rel = bf16_stats(got, want)
    assert max_rel <= PLAIN_MAX_REL and mean_rel <= PLAIN_MEAN_REL, \
        (max_rel, mean_rel)
    if n % 8:                        # the probe's tiles are 8 rows
        return
    jx = probe['grouped'](jnp.asarray(x.float().numpy(), jnp.bfloat16),
                          jnp.asarray(semb.float().numpy(), jnp.bfloat16))
    max_rel, mean_rel = bf16_stats(got, np.asarray(jx.astype(jnp.float32)))
    assert max_rel <= JAX_MAX_REL and mean_rel <= JAX_MEAN_REL, \
        (max_rel, mean_rel)


def test_rounding_g_is_b2s_function(folded, plan):
    """The same plan with g split into bf16 hi + lo (B1's channel mix) lands
    measurably farther from grouped_reference than with g rounded once: the
    kernel's one MMA per W fragment computes B2's function."""
    x, semb = _inputs(16, seed=40)
    want = G.grouped_reference(x, semb, folded).float().numpy()
    _, rounded = bf16_stats(emulate_grouped(plan, x, semb), want)
    _, split = bf16_stats(emulate_grouped(plan, x, semb, round_g=False),
                          want)
    assert split > 10 * rounded and split > 1e-4, (split, rounded)


def _slot_words(a, n0, rows):
    """prefetch_cols: each column's 4-byte words from the one that holds
    element n0, rows / 2 + 1 of them, 0 past the tensor's end."""
    flat = to_bits(a).reshape(-1)
    nw = rows // 2 + 1
    padded = np.concatenate([flat, np.zeros(2 * nw + 2, np.uint16)])
    words = np.zeros((a.shape[0], 2 * nw), np.uint16)
    for j in range(a.shape[0]):
        e = (j * a.shape[1] + n0) // 2 * 2
        words[j] = padded[e:e + 2 * nw]
    return words.reshape(-1)


@pytest.mark.parametrize('n', [13, 16])
@pytest.mark.parametrize('rows', [4, 5, 12])
def test_slot_words_hold_every_column(n, rows):
    """slot_col reads element (j, n0 + r) back from the words, at any
    2-byte boundary of a column and across the tensor's end."""
    a = bf16(np.random.default_rng(n * rows).standard_normal((7, n)))
    nw = rows // 2 + 1
    for n0 in range(0, n, rows):
        slot = _slot_words(a, n0, rows)
        for j in range(a.shape[0]):
            for r in range(min(rows, n - n0)):
                k = (j * n + n0) % 2 + r
                got = from_bits(slot[(j * nw + k // 2) * 2 + k % 2])
                assert got == a[j, n0 + r]


def test_plans_fit_and_buffers_are_disjoint(folded, plan):
    e = folded.embedding_dim
    for g in plan.groups:
        h, io, ops = _group_records(g)
        rows = h['rows']
        assert g.rows == rows >= 4
        assert g.smem_bytes + 4 * G.TCG_MAX_TABLE <= P.MAX_SMEM_BYTES
        wsize = h['wbuf1'] - h['wbuf0']
        assert max(o['blob_bytes'] for o in ops) <= wsize
        x_cols = folded.c_in * 51 if 'x' in g.spec.ins else 0
        spans = [(h['wbuf0'], h['wbuf0'] + wsize),
                 (h['wbuf1'], h['wbuf1'] + wsize),
                 (h['embw_off'], h['embw_off'] + h['embw_bytes']),
                 (h['emb_off'], h['emb_off'] + rows * h['emb_stride'] * 4),
                 (h['sslot_off'], h['sslot_off'] + G.slot_bytes(e, rows))]
        if x_cols:
            spans.append((h['xslot_off'],
                          h['xslot_off'] + G.slot_bytes(x_cols, rows)))
        else:
            assert h['xslot_off'] == -1
        spans += [(h['row0'] + r * h['row_bytes'],
                   h['row0'] + (r + 1) * h['row_bytes'])
                  for r in range(rows)]
        spans.sort()
        assert spans[0][0] == 0 and spans[-1][1] == g.smem_bytes
        for a, b in zip(spans, spans[1:]):
            assert a[1] <= b[0], (g.spec.name, 'overlapping regions')
        assert all(s % 16 == 0 for span in spans for s in span)
        # the inputs' tiles are the first op's input and the last op's
        # skip; the outputs are where their ops leave them
        assert io[0]['off'] == ops[0]['in']
        if g.spec.skip:
            assert io[1]['off'] == ops[-1]['skip'] >= 0
        a0 = g.spec.ops[0]
        for rec, i in zip(io[2:], g.spec.out_ops):
            assert rec['off'] == ops[i - a0]['out']
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
            assert o['blob'] + o['blob_bytes'] <= plan.blob.numel()
    # the flagship's rows per tile: every group's arena but K3's holds more
    # than B1's 4
    assert [g.rows for g in plan.groups] == [12, 10, 4, 5, 12]


def test_groups_stage_only_their_layers_embeddings(folded, plan):
    """Each group's W_e block holds its own layers' (C_out padded to 16)
    columns, and its ops' embedding columns count from 0."""
    seq = P.layer_sequence(folded)
    for g in plan.groups:
        h, _, ops = _group_records(g)
        a, b = g.spec.ops
        layers = [i for kind, i, _, _ in seq[a:b] if kind == 0]
        assert h['emb_stride'] == sum(
            P.pad16(folded.gcn[i].w2.shape[0]) for i in layers)
        embs = [o['emb'] for o in ops if o['kind'] == 0]
        assert embs[0] == 0 and embs == sorted(embs)


def test_intermediates_move_what_intermediate_bytes_counts(folded, plan):
    """The (N, T*V, C) layout pads nothing: each intermediate is written
    once and read once by each group that takes it."""
    written = {nm: c * tv for g in plan.groups
               for nm, (c, tv) in zip(g.spec.outs, g.out_shapes)
               if nm != 'eps'}
    reads = sum(written[nm] for g in plan.groups for nm in g.spec.ins
                if nm != 'x')
    assert G.intermediate_bytes(folded, 100) == \
        2 * 100 * (sum(written.values()) + reads)


def test_table_format_matches_the_source():
    """The header, I/O record and op record fields the host packs are the
    enums the CUDA source reads, in order."""
    with open(CSRC) as f:
        src = f.read()

    def enum(first):
        body = re.search(r'enum \{\s*(' + first + r'\b.*?)\};', src,
                         re.S).group(1)
        body = re.sub(r'//[^\n]*', '', body)
        return [t.strip() for t in body.split(',') if t.strip()]

    assert enum('H_NOPS') == ['H_' + k.upper() for k in G.TCG_HEADER] + \
        ['H_IO']
    assert enum('IO_C') == ['IO_' + k.upper() for k in G.TCG_IO] + ['IO_LEN']
    assert enum('O_KIND') == ['O_' + k.upper() for k in P.TC_OP] + ['O_LEN']
    for name, want in (('kNio', G.TCG_NIO), ('kWarps', G.TCG_WARPS),
                       ('kMaxTable', G.TCG_MAX_TABLE)):
        assert re.search(name + r' = (\d+);', src).group(1) == str(want)


def test_cpu_tensor_goes_to_the_plain_version(folded):
    x, semb = _inputs(5, seed=41)
    kernels = (G.GROUPED, G.GROUPED_FMA)
    before = [k.launches for k in kernels]
    got = G.denoise_grouped(x, semb, folded)
    assert [k.launches for k in kernels] == before
    assert torch.equal(got, G.grouped_reference(x, semb, folded))
    assert isinstance(G.GROUPED, G.TensorCoreGroupedKernel)
    assert G.GROUPED.source == 'denoiser_tc_grouped.cu'
    assert G.GROUPED_FMA.source == 'denoiser_grouped.cu'
    for k in kernels:
        with pytest.raises(ValueError, match='CUDA tensor'):
            k(x, semb, folded)
