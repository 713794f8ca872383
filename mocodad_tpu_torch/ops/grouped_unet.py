"""The layer-grouped denoiser (B2): five group kernels with the activations
between groups in device memory, in bfloat16.

Counterpart of `tools/perf/probe_grouped_pallas.py` (`gcn_body`,
`joint_body`, `make_kernel`, `k1_body` ... `k5_body`, `grouped`, :57-218),
a TPU probe of the JAX repository.  The same function as B1 at bfloat16,
but for one rounding point: every ST-GCNN layer rounds its graph-mixed g
to bfloat16 before the channel mix (:65).  The five groups:

    K1  p1a, d1_0, d1_1, down1       x       -> d1, f1
    K2  d2_0, d2_1, down2            f1      -> d2, f2
    K3  d3_0, d3_1, up3 (+ d2)       f2, d2  -> f3
    K4  u4_0, u4_1, up2 (+ d1)       f3, d1  -> f4
    K5  u3_0, u3_1, + x              f4, x   -> eps

x, silu(emb) and eps are bfloat16 (C, T*V, N) and (E, N) tensors; the
layout of the intermediates between groups is the kernels' own business
(the probe keeps them (T*V, C, N), where its dots want them).
`grouped_reference` is the plain PyTorch version, one function per group.
`GROUPED` wraps `csrc/denoiser_tc_grouped.cu`, the tensor-core kernel, one
launch per group, with its intermediates (N, T*V, C) (a fold row's values
contiguous); `GROUPED_FMA` wraps `csrc/denoiser_grouped.cu`, the FMA
design kept as its yardstick, with its intermediates (C, T*V, N).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from mocodad_tpu_torch.ops import pallas_unet as P

BF16 = torch.bfloat16


# ---------------------------------------------------------------------------
# The plain PyTorch version, group by group
# ---------------------------------------------------------------------------

def _rnd(t: torch.Tensor) -> torch.Tensor:
    return t.to(BF16).float()


def _gcn(f, w, semb):
    return P.gcn_reference(f, w, semb, _rnd, round_g=True)


def _joint(f, w):
    return P.joint_reference(f, w, _rnd)


def group_k1(x, semb, fw):
    """K1 (:152-158): x -> (d1, f1)."""
    f = _gcn(x, fw.gcn[0], semb)
    f = _gcn(f, fw.gcn[1], semb)
    d1 = _gcn(f, fw.gcn[2], semb)
    return d1, _joint(d1, fw.joint[0])


def group_k2(f1, semb, fw):
    """K2 (:165-170): f1 -> (d2, f2)."""
    f = _gcn(f1, fw.gcn[3], semb)
    d2 = _gcn(f, fw.gcn[4], semb)
    return d2, _joint(d2, fw.joint[1])


def group_k3(f2, d2, semb, fw):
    """K3 (:177-182): (f2, d2) -> f3."""
    f = _gcn(f2, fw.gcn[5], semb)
    f = _gcn(f, fw.gcn[6], semb)
    return _rnd(_joint(f, fw.joint[2]) + d2)


def group_k4(f3, d1, semb, fw):
    """K4 (:189-194): (f3, d1) -> f4."""
    f = _gcn(f3, fw.gcn[7], semb)
    f = _gcn(f, fw.gcn[8], semb)
    return _rnd(_joint(f, fw.joint[3]) + d1)


def group_k5(f4, x, semb, fw):
    """K5 (:201-206): (f4, x) -> eps, f + x rounded to bfloat16."""
    f = _gcn(f4, fw.gcn[9], semb)
    f = _gcn(f, fw.gcn[10], semb)
    return _rnd(f + x)


@torch.no_grad()
def grouped_reference(x_ctn: torch.Tensor, silu_emb_en: torch.Tensor,
                      folded: P.FoldedDenoiser) -> torch.Tensor:
    """B2's function: bfloat16 x (C_in, T*V, N) and silu(emb) (E, N) ->
    bfloat16 eps, through the five groups with bfloat16 between them."""
    fw = P.compute_weights(folded, BF16)
    x = _rnd(x_ctn.float())
    semb = _rnd(silu_emb_en.float())
    d1, f1 = group_k1(x, semb, fw)
    d2, f2 = group_k2(f1, semb, fw)
    f3 = group_k3(f2, d2, semb, fw)
    f4 = group_k4(f3, d1, semb, fw)
    return group_k5(f4, x, semb, fw).to(BF16)


# ---------------------------------------------------------------------------
# The FMA design: one table per group, the wrapper
# ---------------------------------------------------------------------------

MAX_SUB = 2                          # sub-tiles per block (kMaxSub)


@dataclass
class _Spec:
    name: str
    ops: Tuple[int, int]             # B1's op records [a, b)
    ins: Tuple[str, ...]             # the first is the first op's input
    outs: Tuple[str, ...]
    out_ops: Tuple[int, ...]         # B1's op index that writes each out
    skip: Tuple[Tuple[int, str], ...] = ()
    final_x: bool = False


SPECS = (
    _Spec('K1', (0, 4), ('x',), ('d1', 'f1'), (2, 3)),
    _Spec('K2', (4, 7), ('f1',), ('d2', 'f2'), (5, 6)),
    _Spec('K3', (7, 10), ('f2', 'd2'), ('f3',), (9,), skip=((9, 'd2'),)),
    _Spec('K4', (10, 13), ('f3', 'd1'), ('f4',), (12,), skip=((12, 'd1'),)),
    _Spec('K5', (13, 15), ('f4', 'x'), ('eps',), (14,), final_x=True),
)
# B1's op that writes each tensor between groups (x is the input)
_PRODUCER = {'d1': 2, 'f1': 3, 'd2': 5, 'f2': 6, 'f3': 9, 'f4': 12,
             'eps': 14}


@dataclass
class GroupPlan:
    spec: _Spec
    table: torch.Tensor
    arena: int                       # float4s per sub-tile
    nsub: int                        # sub-tiles of 4 rows per block
    smem_bytes: int
    out_shapes: List[Tuple[int, int]]

    def to(self, device) -> 'GroupPlan':
        return GroupPlan(self.spec, self.table.to(device), self.arena,
                         self.nsub, self.smem_bytes, self.out_shapes)


@dataclass
class GroupedPlan:
    mats: torch.Tensor               # bfloat16
    vecs: torch.Tensor               # float32
    groups: List[GroupPlan]

    def to(self, device) -> 'GroupedPlan':
        return GroupedPlan(self.mats.to(device), self.vecs.to(device),
                           [g.to(device) for g in self.groups])


def pack_groups(folded: P.FoldedDenoiser) -> GroupedPlan:
    """B1's packed constants at bfloat16 and one table per group: the
    group's ops, its inputs (the first in the work area, the rest in fixed
    regions that stay for the group: a skip, or x for the final add), its
    outputs where its ops leave them, and the sub-tiles per block that its
    arena allows."""
    mats, vecs, ops = P.pack_layers(folded)
    c_in, e_dim = folded.c_in, folded.embedding_dim
    tva = ops[0]['tvi']

    def shape(name):
        if name == 'x':
            return c_in, tva
        o = ops[_PRODUCER[name]]
        return o['co'], o['tvo']

    groups = []
    for spec in SPECS:
        a, b = spec.ops
        g_ops = [dict(o) for o in ops[a:b]]
        kept = [(nm, shape(nm)[0] * P.odd(shape(nm)[1]))
                for nm in spec.ins[1:]]
        cmax = max(o['co'] for o in g_ops if o['kind'] == 0)
        off, arena = P.plan_arena(
            g_ops, kept + [('semb', e_dim), ('emb', cmax)],
            skip={i - a: nm for i, nm in spec.skip})
        ins = [shape(spec.ins[0]) + (g_ops[0]['in'],)] + \
            [shape(nm) + (off[nm],) for nm in spec.ins[1:]]
        outs = [shape(nm) + (g_ops[i - a]['out'],)
                for nm, i in zip(spec.outs, spec.out_ops)]
        table = P.kernel_table(g_ops, folded, off, arena, ins, outs,
                               final_x=off['x'] if spec.final_x else -1)
        nsub = max(1, min(MAX_SUB, P.MAX_SMEM_BYTES // (arena * 16)))
        smem_bytes = nsub * arena * 16
        P.check_smem(f'grouped {spec.name}', smem_bytes)
        groups.append(GroupPlan(spec, torch.tensor(table, dtype=torch.int32),
                                arena, nsub, smem_bytes,
                                [shape(nm) for nm in spec.outs]))
    return GroupedPlan(P.constants_as(mats, BF16), torch.from_numpy(vecs),
                       groups)


def grouped_plan(folded: P.FoldedDenoiser, device) -> GroupedPlan:
    return P.cached_plan(folded, ('grouped',), device,
                         lambda: pack_groups(folded))


def intermediate_bytes(folded: P.FoldedDenoiser, n: int) -> int:
    """Bytes B2 moves through device memory for its intermediates at N
    rows: each written once by its group and read once by every later
    group that takes it (d1, f1, d2, f2, f3, f4; x and eps excluded)."""
    plan = pack_groups(folded)
    written = {nm: c * tv for g in plan.groups
               for nm, (c, tv) in zip(g.spec.outs, g.out_shapes)
               if nm != 'eps'}
    reads = sum(written[nm] for s in SPECS for nm in s.ins if nm != 'x')
    return 2 * n * (sum(written.values()) + reads)


class GroupedKernel:
    """Wrapper of `csrc/denoiser_grouped.cu`, the FMA design: bfloat16 x
    and silu(emb) -> bfloat16 eps in five launches.  `launches` counts the
    kernel launches this process made through it (5 per forward), and
    nothing else."""

    source = 'denoiser_grouped.cu'

    def __init__(self):
        self.launches = 0
        self._fn = None

    def load(self):
        if self._fn is None:
            lib = P.load_library(self.source, 'mocodad_grouped', {
                'max_sub': MAX_SUB, 'header_len': P._H_LEN,
                'op_len': len(P._O_FIELDS)})
            self._fn = P.bind(lib, 'mocodad_grouped_launch', 8, 3)
        return self._fn

    def __call__(self, x_ctn: torch.Tensor, silu_emb_en: torch.Tensor,
                 folded: P.FoldedDenoiser) -> torch.Tensor:
        n = P.check_fold_inputs(x_ctn, silu_emb_en, folded, BF16, BF16)
        dev = x_ctn.device
        if n == 0:
            return torch.empty_like(x_ctn)
        plan = grouped_plan(folded, dev)
        fn = self.load()
        bufs = {'x': x_ctn}
        with torch.cuda.device(dev):
            stream = P.current_stream(dev)
            for g in plan.groups:
                ins = [bufs[nm].data_ptr() for nm in g.spec.ins]
                outs = [torch.empty((c, tv, n), dtype=BF16, device=dev)
                        for c, tv in g.out_shapes]
                ptrs = [o.data_ptr() for o in outs]
                err = fn(ins[0], ins[1] if len(ins) > 1 else None,
                         silu_emb_en.data_ptr(), ptrs[0],
                         ptrs[1] if len(ptrs) > 1 else None,
                         plan.mats.data_ptr(), plan.vecs.data_ptr(),
                         g.table.data_ptr(), n, g.nsub, g.smem_bytes,
                         stream)
                if err != 0:
                    raise RuntimeError(f'grouped kernel {g.spec.name} launch '
                                       f'failed: CUDA error {err}')
                self.launches += 1
                bufs.update(zip(g.spec.outs, outs))
        return bufs['eps']


GROUPED_FMA = GroupedKernel()


# ---------------------------------------------------------------------------
# The tensor-core kernel: one table per group over one blob, the wrapper
# ---------------------------------------------------------------------------

# must match the enums in csrc/denoiser_tc_grouped.cu (checked when it
# loads); the op records are csrc/denoiser_tc.cu's (P.TC_OP)
TCG_HEADER = ('nops', 'rows', 'e', 'row0', 'row_bytes', 'semb_off',
              'emb_off', 'emb_stride', 'embw_off', 'embw_blob', 'embw_bytes',
              'wbuf0', 'wbuf1', 'sslot_off', 'xslot_off')
TCG_IO = ('c', 'tv', 'off', 'stride', 'cn')   # one I/O record
TCG_NIO = 4                          # in0, in1, out0, out1
TCG_WARPS = P.TC_WARPS               # warps per block (kWarps), the op
                                     # code's and its C_out splits'
TCG_MAX_TABLE = 512                  # ints of table it copies (kMaxTable)
TCG_MAX_ROWS = 16                    # most fold rows per tile the plan takes


@dataclass
class TcGroupPlan:
    spec: _Spec
    table: torch.Tensor              # int32: header, I/O records, op records
    rows: int                        # fold rows per tile
    smem_bytes: int                  # dynamic shared memory per block
    out_shapes: List[Tuple[int, int]]   # (C, T*V) of each output

    def to(self, device) -> 'TcGroupPlan':
        return TcGroupPlan(self.spec, self.table.to(device), self.rows,
                           self.smem_bytes, self.out_shapes)


@dataclass
class TcGroupedPlan:
    blob: torch.Tensor               # uint8: every group's constants
    groups: List[TcGroupPlan]

    def to(self, device) -> 'TcGroupedPlan':
        return TcGroupedPlan(self.blob.to(device),
                             [g.to(device) for g in self.groups])


def slot_bytes(cols: int, rows: int) -> int:
    """Bytes of a slot that holds `cols` columns of a (cols, N) bf16 tensor
    for a tile of `rows` rows: the rows / 2 + 1 four-byte words that hold
    a column's rows at any 2-byte boundary, 16-byte aligned."""
    return -(-cols * (rows // 2 + 1) * 4 // 16) * 16


def mmas_per_row(ops: List[dict], rows: int, busiest: bool = True,
                 round_g: bool = True) -> float:
    """MMAs per fold row of tensor-core op records at `rows` rows per tile,
    the ST-GCNN layers' C_out split for that tile: the busiest warp's
    (rounds of units over the block's warps, the plan's cost model), or
    with `busiest` False the block's.  The channel mix takes one MMA per
    output tile with g rounded (B2), two with g split (B1), one more with
    a residual mix."""
    total = 0
    for o in ops:
        units, chunks = rows * o['mt'], o['ci'] // 16
        if o['kind'] == 0:
            ns = P.tc_nsplit(units, chunks, o['ks'], o['nt'], bool(o['res']),
                             round_g)
            mix = (1 if round_g else 2) + o['res']
            per_unit = P.tc_unit_mmas(chunks, o['ks'], mix * o['nt'] // ns)
        else:
            ns, per_unit = 1, P.tc_unit_mmas(chunks, o['ks'], 0)
        total += (-(-units * ns // TCG_WARPS) if busiest
                  else units * ns) * per_unit
    return total / rows


def pack_groups_tc(folded: P.FoldedDenoiser) -> TcGroupedPlan:
    """One table per group for `csrc/denoiser_tc_grouped.cu` and one blob
    of every group's constants (offsets in bytes, strides in bf16
    elements).

    A group's ops are B1's records for its range (`P.tc_ops`, g rounded),
    with only its layers' W_e and b_e.  One fold row's area: the first
    input's tile, a skip's (K3's d2, K4's d1), silu_emb (float32), then a
    work area whose two ends alternate as layer input and output
    (`P.tc_row_plan`); K1's x and K5's x come through the x slot (x's
    words for a tile) and have no tile but K1's.  Shared memory: two
    weight buffers of the group's largest op, its W_e and b_e, its
    embeddings (rows x their C_out, float32), the silu_emb slot, the x
    slot, then the row areas.  The rows per tile are the count up to
    TCG_MAX_ROWS that fits and gives the fewest MMAs per row
    (`mmas_per_row`), the larger on a tie."""
    c_in, e_dim = folded.c_in, folded.embedding_dim
    seq = P.layer_sequence(folded)
    chans = P.tc_channels(folded)
    tva = seq[0][2]

    def shape(name):
        if name in ('x', 'eps'):
            return c_in, tva
        k = _PRODUCER[name]
        return chans[k + 1], seq[k][3]

    parts, groups, base = [], [], 0
    for spec in SPECS:
        a, b = spec.ops
        # every input but K5's x has a tile in the row area
        tiles = [(f'in{k}', nm) for k, nm in enumerate(spec.ins)
                 if k == 0 or nm != 'x']
        for nm in spec.ins + spec.outs:
            if nm not in ('x', 'eps') and shape(nm)[0] % 8:
                raise ValueError(f'the grouped tensor-core kernel moves '
                                 f'{nm} 8 channels at a time, not '
                                 f'{shape(nm)[0]}')

        def group_ops(rows):
            ops, blocks, emb_w, emb_b = P.tc_ops(folded, a, b, rows,
                                                  round_g=True)
            off, row_bytes = P.tc_row_plan(
                ops, [(r, P.tc_act_bytes(shape(nm)[1], shape(nm)[0]))
                      for r, nm in tiles]
                + [('semb', P.tc_semb_bytes(e_dim))],
                'in0', skip={i - a: 'in1' for i, _ in spec.skip})
            return ops, blocks, emb_w, emb_b, off, row_bytes

        ops, blocks, emb_w, emb_b, off, row_bytes = group_ops(P.TC_ROWS)
        if len(ops) < 2:
            raise ValueError('the grouped tensor-core kernel prefetches '
                             'during a group\'s second op; '
                             f'{spec.name} has {len(ops)}')
        embw, emb_stride = P.tc_embw(emb_w, emb_b)
        wbuf = max(blk.size for blk in blocks)
        x_cols = c_in * tva if 'x' in spec.ins else 0

        def smem(rows):
            return (2 * wbuf + embw.size + rows * emb_stride * 4
                    + slot_bytes(e_dim, rows)
                    + (slot_bytes(x_cols, rows) if x_cols else 0)
                    + rows * row_bytes)

        fits = [r for r in range(1, TCG_MAX_ROWS + 1)
                if smem(r) + 4 * TCG_MAX_TABLE <= P.MAX_SMEM_BYTES]
        if not fits:
            raise ValueError(f'grouped {spec.name} does not fit one fold '
                             f'row in {P.MAX_SMEM_BYTES} bytes')
        rows = min(fits, key=lambda r: (mmas_per_row(ops, r), -r))
        ops, blocks, emb_w, emb_b, off, row_bytes = group_ops(rows)

        embw_off = 2 * wbuf
        emb_off = embw_off + embw.size
        sslot_off = emb_off + rows * emb_stride * 4
        xslot_off = sslot_off + slot_bytes(e_dim, rows)
        row0 = xslot_off + (slot_bytes(x_cols, rows) if x_cols else 0)
        header = dict(nops=len(ops), rows=rows, e=e_dim, row0=row0,
                      row_bytes=row_bytes, semb_off=off['semb'],
                      emb_off=emb_off, emb_stride=emb_stride,
                      embw_off=embw_off,
                      embw_blob=base + sum(blk.size for blk in blocks),
                      embw_bytes=embw.size, wbuf0=0, wbuf1=wbuf,
                      sslot_off=sslot_off,
                      xslot_off=xslot_off if x_cols else -1)
        io = []
        for k, nm in enumerate(spec.ins):
            c, tv = shape(nm)
            io.append((c, tv, off.get(f'in{k}', -1), P.tc_stride(c),
                       int(nm == 'x')))
        io += [(0,) * len(TCG_IO)] * (2 - len(spec.ins))
        for nm, i in zip(spec.outs, spec.out_ops):
            o = ops[i - a]
            io.append(shape(nm) + (o['out'], o['out_stride'],
                                   int(nm == 'eps')))
        io += [(0,) * len(TCG_IO)] * (2 - len(spec.outs))
        for o in ops:
            o['blob'] += base
        table = [header[k] for k in TCG_HEADER] + \
            [int(v) for rec in io for v in rec] + \
            [int(o[k]) for o in ops for k in P.TC_OP]
        if len(table) > TCG_MAX_TABLE:
            raise ValueError(f'the grouped tensor-core kernel reads at most '
                             f'{TCG_MAX_TABLE} table entries, got '
                             f'{len(table)}')
        smem_bytes = smem(rows)
        P.check_smem(f'grouped tensor-core {spec.name}',
                     smem_bytes + 4 * TCG_MAX_TABLE)
        group_parts = [p for blk in blocks + [embw] for p in blk.parts]
        parts += group_parts
        base += sum(p.size for p in group_parts)
        groups.append(TcGroupPlan(spec, torch.tensor(table,
                                                     dtype=torch.int32),
                                  rows, smem_bytes,
                                  [shape(nm) for nm in spec.outs]))
    return TcGroupedPlan(torch.from_numpy(np.concatenate(parts)), groups)


def grouped_tc_plan(folded: P.FoldedDenoiser, device) -> TcGroupedPlan:
    return P.cached_plan(folded, ('grouped_tc',), device,
                         lambda: pack_groups_tc(folded))


class TensorCoreGroupedKernel:
    """Wrapper of `csrc/denoiser_tc_grouped.cu`, B2 on the tensor cores:
    bfloat16 x and silu(emb) -> bfloat16 eps in five launches, the
    intermediates (N, T*V, C) bfloat16.  `launches` counts the kernel
    launches this process made through it (5 per forward), and nothing
    else."""

    source = 'denoiser_tc_grouped.cu'

    def __init__(self):
        self.launches = 0
        self._fn = None

    def load(self):
        if self._fn is None:
            lib = P.load_library(self.source, 'mocodad_grouped_tc', {
                'warps_per_block': TCG_WARPS, 'max_table': TCG_MAX_TABLE,
                'header_len': len(TCG_HEADER) + TCG_NIO * len(TCG_IO),
                'io_len': len(TCG_IO), 'op_len': len(P.TC_OP)})
            self._fn = P.bind(lib, 'mocodad_grouped_tc_launch', 7, 3)
        return self._fn

    def __call__(self, x_ctn: torch.Tensor, silu_emb_en: torch.Tensor,
                 folded: P.FoldedDenoiser,
                 events: Optional[List[torch.cuda.Event]] = None
                 ) -> torch.Tensor:
        """eps; with `events` (six timing CUDA events), one is recorded on
        the stream before each group's launch and one after the last, so
        that a probe can time the groups apart."""
        n = P.check_fold_inputs(x_ctn, silu_emb_en, folded, BF16, BF16)
        dev = x_ctn.device
        if n == 0:
            return torch.empty_like(x_ctn)
        plan = grouped_tc_plan(folded, dev)
        fn = self.load()
        bufs = {'x': x_ctn}
        with torch.cuda.device(dev):
            stream = P.current_stream(dev)
            for k, g in enumerate(plan.groups):
                ins = [bufs[nm].data_ptr() for nm in g.spec.ins]
                outs = [torch.empty((c, tv, n) if nm == 'eps' else
                                    (n, tv, c), dtype=BF16, device=dev)
                        for nm, (c, tv) in zip(g.spec.outs, g.out_shapes)]
                if events:
                    events[k].record()
                err = fn(ins[0], ins[1] if len(ins) > 1 else None,
                         silu_emb_en.data_ptr(), outs[0].data_ptr(),
                         outs[1].data_ptr() if len(outs) > 1 else None,
                         plan.blob.data_ptr(), g.table.data_ptr(), n,
                         g.rows, g.smem_bytes, stream)
                if err != 0:
                    raise RuntimeError(f'grouped tensor-core kernel '
                                       f'{g.spec.name} launch failed: CUDA '
                                       f'error {err}')
                self.launches += 1
                bufs.update(zip(g.spec.outs, outs))
            if events:
                events[len(plan.groups)].record()
        return bufs['eps']


GROUPED = TensorCoreGroupedKernel()


def denoise_grouped(x_ctn: torch.Tensor, silu_emb_en: torch.Tensor,
                    folded: P.FoldedDenoiser) -> torch.Tensor:
    """B2's eps: the plain version for a CPU tensor, the five tensor-core
    kernels for a CUDA tensor."""
    if x_ctn.device.type == 'cpu':
        return grouped_reference(x_ctn, silu_emb_en, folded)
    if x_ctn.device.type == 'cuda':
        return GROUPED(x_ctn, silu_emb_en, folded)
    raise ValueError(f'no grouped denoiser for device {x_ctn.device}')
