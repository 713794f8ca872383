"""The fused eval-mode U-Net denoiser: folded constants, the plain PyTorch
version, the kernels' shared packing and shared-memory planning, and the
wrapper of the hand-written CUDA kernel B1.

Counterpart of `mocodad_tpu/ops/pallas_unet.py` (`build_pallas_denoiser`,
the JAX package's Pallas TPU kernel).  The same function, in the same
batch-in-last-dim layout:

    eps = denoise(x_ctn, silu_emb_en, folded)
    x_ctn (C_in, T*V, N), silu_emb_en (E, N) = silu(t_emb + cond_emb)^T,
    eps   (C_in, T*V, N), in x_ctn's dtype

`fold_denoiser` folds an `STSAEUnet`'s eval-mode BatchNorms, biases and
graph operators into per-layer constants exactly as the JAX host folding
does (pallas_unet.py:68-102).  `denoise_reference` applies them layer by
layer with einsums, in B1's order and association (graph operator first,
then channel mix), at a compute dtype: float32, or bfloat16 with float32
accumulation and B1's rounding points (pallas_unet.py:157-204; the
matrices rounded to bfloat16 as `_fold_gcn` / `_fold_joint` store them,
biases and affines float32).  `denoise` routes by device: a CPU tensor
goes to `denoise_reference` at x's dtype; a CUDA tensor launches the
kernel in `csrc/denoiser.cu` (`DENOISER` for float32 x, `DENOISER_BF16`
for bfloat16 x), or raises.

The grouped (B2, `ops/grouped_unet.py`) and DMA-pipelined (B3,
`ops/dma_unet.py`) kernels compute the same function from the same packed
constants; their tables come from `pack_layers` and `plan_arena` here.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mocodad_tpu_torch.nn.stsgcn import (JointMixLayer, STGCNNLayer,
                                         compose_graph_operator)
from mocodad_tpu_torch.nn.unet import STSAEUnet, joint_pyramid

GCN_LAYERS = ('p1a', 'd1_0', 'd1_1', 'd2_0', 'd2_1', 'd3_0', 'd3_1',
              'u4_0', 'u4_1', 'u3_0', 'u3_1')
JOINT_LAYERS = ('down1', 'down2', 'up3', 'up2')
_STACKS = {'p1a': 'st_gcnnsp1a', 'd1': 'st_gcnnsd1', 'd2': 'st_gcnnsd2',
           'd3': 'st_gcnnsd3', 'u4': 'st_gcnnsu4', 'u3': 'st_gcnnsu3'}


@dataclass
class GcnW:
    k2: torch.Tensor                 # (TV, TV)  graph operator, left form
    w2: torch.Tensor                 # (Co, Ci)  channel mix, BN scale folded
    bias: torch.Tensor               # (Co,)     conv bias + BN shifts
    slope: float                     # PReLU negative slope
    we2: torch.Tensor                # (Co, E)   embedding projection
    eb: torch.Tensor                 # (Co,)     embedding bias
    wr2: Optional[torch.Tensor]      # (Co, Ci)  residual mix or None


@dataclass
class JointW:
    d2: torch.Tensor                 # (TVo, TVi) joint mix, T diagonal blocks
    rs: torch.Tensor                 # (TVo,) per-row scale (folded BN)
    rt: torch.Tensor                 # (TVo,) per-row shift (bias + BN)


@dataclass
class FoldedDenoiser:
    """All folded constants of one STSAEUnet, in B1's order, plus (once
    built) their packed forms for the CUDA kernels and their copies
    rounded to a compute dtype."""
    c_in: int
    n_frames: int
    n_joints: int
    embedding_dim: int
    gcn: List[GcnW]
    joint: List[JointW]
    _packed: Dict[tuple, object] = field(default_factory=dict, repr=False)
    _rounded: Dict[torch.dtype, 'FoldedDenoiser'] = field(
        default_factory=dict, repr=False)

    @property
    def n_constants(self) -> int:
        n = 0
        for w in self.gcn:
            n += (w.k2.numel() + w.w2.numel() + w.bias.numel() + 1
                  + w.we2.numel() + w.eb.numel()
                  + (0 if w.wr2 is None else w.wr2.numel()))
        for j in self.joint:
            n += j.d2.numel() + j.rs.numel() + j.rt.numel()
        return n


def fold_bn(bn: torch.nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Running-stat BatchNorm -> (scale, shift) (ops/fast_unet.py:44-50)."""
    scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    shift = bn.bias - bn.running_mean * scale
    return scale, shift


def block_diag_joint_mix(kernel: torch.Tensor, t_dim: int) -> torch.Tensor:
    """(V_in, V_out) joint-mix kernel -> (T*V_in, T*V_out) block-diagonal
    operator D[(t,v),(s,w)] = eye[t,s] * kernel[v,w]
    (ops/fast_unet.py:53-60)."""
    v_in, v_out = kernel.shape
    eye = torch.eye(t_dim, dtype=kernel.dtype, device=kernel.device)
    d = torch.einsum('ts,vw->tvsw', eye, kernel)
    return d.reshape(t_dim * v_in, t_dim * v_out)


def fold_gcn(layer: STGCNNLayer) -> GcnW:
    """One ST-GCNN layer's folded constants (pallas_unet.py:68-89)."""
    conv, bn = layer.tcn[0], layer.tcn[1]
    k2 = compose_graph_operator(layer.gcn.T, layer.gcn.A).T
    sc, sh = fold_bn(bn)
    w2 = conv.weight[:, :, 0, 0] * sc[:, None]
    b = conv.bias if conv.bias is not None else 0.0
    bias = b * sc + sh
    wr2 = None
    if layer.residual is not None:
        rconv, rbn = layer.residual[0], layer.residual[1]
        rsc, rsh = fold_bn(rbn)
        wr2 = rconv.weight[:, :, 0, 0] * rsc[:, None]
        rb = rconv.bias if rconv.bias is not None else 0.0
        bias = bias + (rb * rsc + rsh)
    emb = layer.emb_layer[1]
    return GcnW(k2=k2.contiguous(), w2=w2.contiguous(), bias=bias,
                slope=float(layer.prelu.weight.reshape(-1)[0]),
                we2=emb.weight.contiguous(), eb=emb.bias,
                wr2=None if wr2 is None else wr2.contiguous())


def fold_joint(layer: JointMixLayer, t_dim: int) -> JointW:
    """One joint re-scaling's folded constants (pallas_unet.py:92-102):
    bias and BN act per output joint, tiled over t."""
    conv, bn = layer.block[0], layer.block[1]
    kernel = conv.weight[:, :, 0, 0].T                   # (V_in, V_out)
    d2 = block_diag_joint_mix(kernel, t_dim).T
    sc, sh = fold_bn(bn)
    b = (conv.bias if conv.bias is not None
         else torch.zeros_like(sc))
    return JointW(d2=d2.contiguous(), rs=sc.repeat(t_dim),
                  rt=(b * sc + sh).repeat(t_dim))


@torch.no_grad()
def fold_denoiser(unet: STSAEUnet) -> FoldedDenoiser:
    """Fold an eval-mode STSAEUnet (inject conditioning, no bottleneck)."""
    if unet.use_bottleneck:
        raise ValueError('the fused denoiser has no bottleneck path')

    def gcn_layer(name: str) -> STGCNNLayer:
        if name == 'p1a':
            return unet.st_gcnnsp1a[0]
        stack, idx = name.split('_')
        return getattr(unet, _STACKS[stack])[int(idx)]

    t = unet.n_frames
    return FoldedDenoiser(
        c_in=unet.c_in, n_frames=t, n_joints=unet.n_joints,
        embedding_dim=unet.embedding_dim,
        gcn=[fold_gcn(gcn_layer(n)) for n in GCN_LAYERS],
        joint=[fold_joint(getattr(unet, n), t) for n in JOINT_LAYERS])


# ---------------------------------------------------------------------------
# The plain PyTorch version
# ---------------------------------------------------------------------------

def rounder(dtype: torch.dtype) -> Callable[[torch.Tensor], torch.Tensor]:
    """float32 -> float32 rounding at a compute dtype: the identity for
    float32, round to nearest even bfloat16 (kept as float32) for
    bfloat16."""
    if dtype == torch.float32:
        return lambda t: t
    if dtype == torch.bfloat16:
        return lambda t: t.to(torch.bfloat16).float()
    raise ValueError(f'no compute dtype {dtype}; float32 or bfloat16')


def compute_weights(folded: FoldedDenoiser,
                    dtype: torch.dtype) -> FoldedDenoiser:
    """The folded constants as a kernel at `dtype` stores them: the
    matrices (k2, w2, wr2, we2, d2) rounded to `dtype`, held as float32;
    bias, slope, eb, rs and rt float32 (pallas_unet.py:84-89, :100-102).
    Built once per dtype."""
    if dtype == torch.float32:
        return folded
    if dtype not in folded._rounded:
        r = rounder(dtype)
        folded._rounded[dtype] = FoldedDenoiser(
            c_in=folded.c_in, n_frames=folded.n_frames,
            n_joints=folded.n_joints, embedding_dim=folded.embedding_dim,
            gcn=[GcnW(k2=r(w.k2), w2=r(w.w2), bias=w.bias, slope=w.slope,
                      we2=r(w.we2), eb=w.eb,
                      wr2=None if w.wr2 is None else r(w.wr2))
                 for w in folded.gcn],
            joint=[JointW(d2=r(j.d2), rs=j.rs, rt=j.rt)
                   for j in folded.joint])
    return folded._rounded[dtype]


def gcn_reference(f: torch.Tensor, w: GcnW, semb: torch.Tensor,
                  rnd: Callable, round_g: bool = False) -> torch.Tensor:
    """One ST-GCNN layer on (Ci, TV, N) -> (Co, TV, N) (pallas_unet.py
    :160-179): f and semb hold values of the compute dtype, sums are
    float32, the output is rounded.  The graph-mixed g stays float32 (B1)
    or is rounded before the channel mix (`round_g`, B2)."""
    g = torch.einsum('kx,cxn->ckn', w.k2, f)             # graph operator
    if round_g:
        g = rnd(g)
    y = torch.einsum('oc,ckn->okn', w.w2, g)             # channel mix
    if w.wr2 is not None:
        y = y + torch.einsum('oc,ckn->okn', w.wr2, f)
    else:
        y = y + f
    y = y + w.bias[:, None, None]
    y = torch.where(y >= 0, y, w.slope * y)
    e = w.we2 @ semb + w.eb[:, None]                     # (Co, N)
    return rnd(y + e[:, None, :])


def joint_reference(f: torch.Tensor, w: JointW, rnd: Callable
                    ) -> torch.Tensor:
    """Joint re-scaling on (C, TVi, N) -> (C, TVo, N), rounded
    (pallas_unet.py:181-184)."""
    h = torch.einsum('kx,cxn->ckn', w.d2, f)
    return rnd(h * w.rs[None, :, None] + w.rt[None, :, None])


@torch.no_grad()
def forward_reference(x_ctn: torch.Tensor, silu_emb_en: torch.Tensor,
                      folded: FoldedDenoiser,
                      compute_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """B1's body (pallas_unet.py:157-204) at `compute_dtype`, returning
    the float32 sum f + x0 before its cast to the output dtype."""
    rnd = rounder(compute_dtype)
    fw = compute_weights(folded, compute_dtype)
    gw, jw = fw.gcn, fw.joint
    x0 = rnd(x_ctn.float())
    semb = rnd(silu_emb_en.float())
    f = gcn_reference(x0, gw[0], semb, rnd)
    f = gcn_reference(f, gw[1], semb, rnd)
    d1 = f = gcn_reference(f, gw[2], semb, rnd)
    f = joint_reference(f, jw[0], rnd)
    f = gcn_reference(f, gw[3], semb, rnd)
    d2 = f = gcn_reference(f, gw[4], semb, rnd)
    f = joint_reference(f, jw[1], rnd)
    f = gcn_reference(f, gw[5], semb, rnd)
    f = gcn_reference(f, gw[6], semb, rnd)
    f = rnd(joint_reference(f, jw[2], rnd) + d2)
    f = gcn_reference(f, gw[7], semb, rnd)
    f = gcn_reference(f, gw[8], semb, rnd)
    f = rnd(joint_reference(f, jw[3], rnd) + d1)
    f = gcn_reference(f, gw[9], semb, rnd)
    f = gcn_reference(f, gw[10], semb, rnd)
    return f + x0


def denoise_reference(x_ctn: torch.Tensor, silu_emb_en: torch.Tensor,
                      folded: FoldedDenoiser,
                      compute_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """The plain PyTorch version of the kernel, layer by layer as B1's
    body, eps in x_ctn's dtype (pallas_unet.py:203-204)."""
    return forward_reference(x_ctn, silu_emb_en, folded,
                             compute_dtype).to(x_ctn.dtype)


# ---------------------------------------------------------------------------
# The CUDA kernels' constants, op tables and shared-memory plans
# ---------------------------------------------------------------------------

# must match the enums in csrc/denoiser_body.cuh (checked when a kernel
# library loads)
_H_NOPS, _H_T, _H_E, _H_SEMB, _H_EMB, _H_FINAL_X, _H_ARENA, _H_NIN, \
    _H_NOUT, _H_IO = range(10)
MAX_IN, MAX_OUT = 2, 2               # activation tensors in / out per table
_IO_LEN = 4                          # (C, TV, TVp, arena offset)
_H_LEN = _H_IO + (MAX_IN + MAX_OUT) * _IO_LEN
_O_FIELDS = ('kind', 'ci', 'co', 'tvi', 'tvip', 'tvo', 'tvop', 'in', 'g',
             'out', 'skip', 'k', 'w', 'wr', 'we', 'bias', 'slope', 'eb',
             'rs', 'rt')
KERNEL_ROWS = 4                     # fold rows per sub-tile (kRows)
MAX_SMEM_BYTES = 232448             # dynamic shared memory a Hopper block may use


@dataclass
class KernelPlan:
    mats: torch.Tensor               # (m,) folded matrices, compute dtype
    vecs: torch.Tensor               # (v,) float32 biases, slopes, affines
    table: torch.Tensor              # (t,) int32, ops + offsets + smem plan
    arena: int                       # float4s of one sub-tile's arena
    smem_bytes: int                  # dynamic shared memory per block

    def to(self, device: torch.device) -> 'KernelPlan':
        return KernelPlan(mats=self.mats.to(device),
                          vecs=self.vecs.to(device),
                          table=self.table.to(device), arena=self.arena,
                          smem_bytes=self.smem_bytes)


def odd(n: int) -> int:
    """T*V padded to an odd float4 stride (bank-conflict-free walks)."""
    return n | 1


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


class _Packer:
    """Appends constants to one float32 buffer at 4-element aligned
    offsets (16 bytes in float32, 8 in bfloat16)."""

    def __init__(self):
        self.parts: List[np.ndarray] = []
        self.size = 0

    def add(self, a: np.ndarray) -> int:
        a = np.asarray(a, np.float32).reshape(-1)
        off = self.size
        padded = np.zeros(_pad4(a.size), np.float32)
        padded[:a.size] = a
        self.parts.append(padded)
        self.size += padded.size
        return off

    def add_left(self, m: torch.Tensor) -> int:
        """A left operator (M, K) stored as its (K, Mp) transpose, M
        zero-padded to a multiple of 4."""
        mat = m.detach().cpu().float().numpy()
        rows, cols = mat.shape
        t = np.zeros((cols, _pad4(rows)), np.float32)
        t[:, :rows] = mat.T
        return self.add(t)

    def vec(self, v: torch.Tensor) -> int:
        return self.add(v.detach().cpu().float().numpy())

    def array(self) -> np.ndarray:
        return np.concatenate(self.parts) if self.parts else \
            np.zeros(0, np.float32)


def pack_layers(folded: FoldedDenoiser
                 ) -> Tuple[np.ndarray, np.ndarray, List[dict]]:
    """The folded matrices and vectors as two float32 buffers, and B1's 15
    op records (shapes and constant offsets; arena offsets unset) in B1's
    order: p1a d1_0 d1_1 | down1 | d2_0 d2_1 | down2 | d3_0 d3_1 |
    up3 (+d2) | u4_0 u4_1 | up2 (+d1) | u3_0 u3_1."""
    mats, vecs = _Packer(), _Packer()
    t = folded.n_frames
    jp = joint_pyramid(folded.n_joints)
    tva, tvb, tvc = t * jp['a'], t * jp['b'], t * jp['c']
    tv_of_gcn = [tva, tva, tva, tvb, tvb, tvc, tvc, tvb, tvb, tva, tva]
    joint_tv = [(tva, tvb), (tvb, tvc), (tvc, tvb), (tvb, tva)]
    ops = []
    for w, tv in zip(folded.gcn, tv_of_gcn):
        co, ci = w.w2.shape
        ops.append(dict(
            kind=0, ci=ci, co=co, tvi=tv, tvip=odd(tv), tvo=tv,
            tvop=odd(tv), k=mats.add_left(w.k2), w=mats.add_left(w.w2),
            wr=-1 if w.wr2 is None else mats.add_left(w.wr2),
            we=mats.add_left(w.we2), bias=vecs.vec(w.bias),
            slope=vecs.add(np.float32([w.slope])), eb=vecs.vec(w.eb),
            rs=-1, rt=-1, skip=-1))
    joints = []
    for w, (tvi, tvo) in zip(folded.joint, joint_tv):
        joints.append(dict(
            kind=1, tvi=tvi, tvip=odd(tvi), tvo=tvo, tvop=odd(tvo),
            k=mats.add_left(w.d2), rs=vecs.vec(w.rs), rt=vecs.vec(w.rt),
            w=-1, wr=-1, we=-1, bias=-1, slope=-1, eb=-1, skip=-1))
    seq = (ops[0:3] + [joints[0]] + ops[3:5] + [joints[1]] + ops[5:7]
           + [joints[2]] + ops[7:9] + [joints[3]] + ops[9:11])
    for i, o in enumerate(seq):      # a joint keeps its channel count
        if o['kind'] == 1:
            o['ci'] = o['co'] = seq[i - 1]['co']
    return mats.array(), vecs.array(), seq


def plan_arena(ops: List[dict], regions: Sequence[Tuple[str, int]],
                first_in: Optional[str] = None,
                dst: Optional[Dict[int, str]] = None,
                skip: Optional[Dict[int, str]] = None
                ) -> Tuple[Dict[str, int], int]:
    """Lay out one sub-tile's arena (offsets in float4s) for `ops`.

    `regions` are (name, size) regions that stay put for the whole run,
    laid out first in that order; they include 'semb' and 'emb'.  After
    them comes a work area whose two ends alternate as layer input and
    output: a layer's graph-mixed intermediate sits next to its input (at
    the left end when the input is a fixed region) and its output goes to
    the other end.  `first_in` names the fixed region that holds the first
    op's input, or None for the work area's left end; `dst` maps op index
    -> the fixed region that op writes (a skip saved for later), `skip`
    op index -> the fixed region a joint op adds.  Sets every op's 'in',
    'g', 'out' and 'skip'; returns the regions' offsets and the arena's
    size."""
    dst, skip = dst or {}, skip or {}
    off: Dict[str, int] = {}
    total = 0
    for name, size in regions:
        off[name] = total
        total += size
    off_work = total

    def sizes(o):
        return o['ci'] * o['tvip'], o['ci'] * o['tvop'], o['co'] * o['tvop']

    # pass 1: which end each buffer sits at, and the work area's size
    where = first_in or 'L'          # a fixed region, or L / R (work)
    layout = []
    work = 0
    for i, o in enumerate(ops):
        s_in, s_g, s_out = sizes(o)
        in_work = where in ('L', 'R')
        to_fixed = dst.get(i)
        if o['kind'] == 0:
            g_side = 'R' if where == 'R' else 'L'
            out_side = to_fixed or ('L' if g_side == 'R' else 'R')
            used = (s_in if in_work else 0) + s_g + \
                (0 if to_fixed else s_out)
        else:
            g_side = None
            out_side = to_fixed or ('R' if where == 'L' else 'L')
            used = (s_in if in_work else 0) + (0 if to_fixed else s_out)
        work = max(work, used)
        layout.append((where, g_side, out_side))
        where = out_side

    def at(side, size, inner=0):
        """Offset of a buffer of `size` at one end of the work area,
        `inner` float4s away from that end."""
        if side == 'L':
            return off_work + inner
        return off_work + work - inner - size

    for i, (o, (src, g_side, out_side)) in enumerate(zip(ops, layout)):
        s_in, s_g, s_out = sizes(o)
        o['in'] = off[src] if src in off else at(src, s_in)
        o['out'] = off[out_side] if out_side in off else at(out_side, s_out)
        o['g'] = (-1 if g_side is None else
                  at(g_side, s_g, 0 if src in off else s_in))
        o['skip'] = off[skip[i]] if i in skip else -1
    return off, off_work + work


def kernel_table(ops: List[dict], folded: FoldedDenoiser,
                 off: Dict[str, int], arena: int,
                 ins: Sequence[Tuple[int, int, int]],
                 outs: Sequence[Tuple[int, int, int]],
                 final_x: int) -> List[int]:
    """The int32 table a kernel reads: header, I/O records ((C, TV, arena
    offset) of each input and output tensor) and op records."""
    header = [0] * _H_LEN
    header[_H_NOPS] = len(ops)
    header[_H_T] = folded.n_frames
    header[_H_E] = folded.embedding_dim
    header[_H_SEMB] = off['semb']
    header[_H_EMB] = off['emb']
    header[_H_FINAL_X] = final_x
    header[_H_ARENA] = arena
    header[_H_NIN] = len(ins)
    header[_H_NOUT] = len(outs)
    for slot, (c, tv, o) in list(enumerate(ins)) + \
            [(MAX_IN + i, io) for i, io in enumerate(outs)]:
        base = _H_IO + slot * _IO_LEN
        header[base:base + _IO_LEN] = [c, tv, odd(tv), o]
    return header + [int(o[k]) for o in ops for k in _O_FIELDS]


def constants_as(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A packed float32 buffer at a kernel's storage dtype (bfloat16
    rounds to nearest even)."""
    return torch.from_numpy(a).to(dtype)


def check_smem(what: str, smem_bytes: int) -> None:
    if smem_bytes > MAX_SMEM_BYTES:
        raise ValueError(
            f'the {what} kernel needs {smem_bytes} bytes of shared memory '
            f'for these shapes; a Hopper block has {MAX_SMEM_BYTES}')


def pack_for_kernel(folded: FoldedDenoiser,
                    dtype: torch.dtype = torch.float32) -> KernelPlan:
    """Lay the folded constants out for `csrc/denoiser.cu` at `dtype`
    (the matrices at `dtype`, the vectors float32) and plan its shared
    memory (offsets in float4 units; one float4 holds one element for the
    kRows rows of a block): x, silu_emb, the layer embedding, the skips d1
    and d2 (d1_1 and d2_1 write straight into them), then the work area."""
    rounder(dtype)                   # float32 or bfloat16 only
    mats, vecs, ops = pack_layers(folded)
    c_in, e_dim = folded.c_in, folded.embedding_dim
    tva = ops[0]['tvi']
    cmax = max(o['co'] for o in ops if o['kind'] == 0)
    regions = [('x', c_in * odd(tva)), ('semb', e_dim), ('emb', cmax),
               ('d1', ops[2]['co'] * ops[2]['tvop']),
               ('d2', ops[5]['co'] * ops[5]['tvop'])]
    off, arena = plan_arena(ops, regions, first_in='x',
                             dst={2: 'd1', 5: 'd2'}, skip={9: 'd2', 12: 'd1'})
    smem_bytes = arena * 16
    check_smem('denoiser', smem_bytes)
    table = kernel_table(ops, folded, off, arena,
                         ins=[(c_in, tva, off['x'])],
                         outs=[(c_in, tva, ops[-1]['out'])],
                         final_x=off['x'])
    return KernelPlan(mats=constants_as(mats, dtype),
                      vecs=torch.from_numpy(vecs),
                      table=torch.tensor(table, dtype=torch.int32),
                      arena=arena, smem_bytes=smem_bytes)


def cached_plan(folded: FoldedDenoiser, key: tuple, device: torch.device,
                build: Callable[[], object]):
    """`build()` moved to `device`, built once per (key, device)."""
    device = torch.device(device)
    if (key, device) not in folded._packed:
        folded._packed[(key, device)] = build().to(device)
    return folded._packed[(key, device)]


def kernel_plan(folded: FoldedDenoiser, device: torch.device,
                dtype: torch.dtype = torch.float32) -> KernelPlan:
    """B1's packed constants and table on `device`, built once."""
    return cached_plan(folded, ('denoiser', dtype), device,
                       lambda: pack_for_kernel(folded, dtype))


def denoiser_flops_per_row(folded: FoldedDenoiser) -> int:
    """Floating-point operations the function needs per fold row: 2 per
    multiply-add of its products, plus the elementwise epilogues.  The
    graph operators are dense; a joint re-scaling counts only its T
    diagonal (V_out x V_in) blocks, not the zeros between them."""
    ops = 0
    for w in folded.gcn:
        co, ci = w.w2.shape
        tv = w.k2.shape[0]
        mac = ci * tv * tv + co * ci * tv + co * w.we2.shape[1]
        if w.wr2 is not None:
            mac += co * ci * tv
        ops += 2 * mac + 4 * co * tv + co   # res, bias, prelu, emb adds
    chans = [folded.gcn[2].w2.shape[0], folded.gcn[4].w2.shape[0],
             folded.gcn[6].w2.shape[0], folded.gcn[8].w2.shape[0]]
    skips = [False, False, True, True]
    t = folded.n_frames
    for j, c, skip in zip(folded.joint, chans, skips):
        tvo, tvi = j.d2.shape
        ops += 2 * c * t * (tvo // t) * (tvi // t) + \
            (3 if skip else 2) * c * tvo
    ops += folded.c_in * folded.gcn[0].k2.shape[0]  # + x
    return ops


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------

def check_fold_inputs(x_ctn: torch.Tensor, silu_emb_en: torch.Tensor,
                      folded: FoldedDenoiser, x_dtype: torch.dtype,
                      semb_dtype: torch.dtype) -> int:
    """Raise unless x_ctn (C_in, T*V, N) and silu_emb_en (E, N) are
    contiguous CUDA tensors of the given dtypes on one device; returns
    N."""
    c_in = folded.c_in
    tva = folded.gcn[0].k2.shape[0]
    e_dim = folded.embedding_dim
    for name, a, dt in (('x_ctn', x_ctn, x_dtype),
                        ('silu_emb_en', silu_emb_en, semb_dtype)):
        if a.device.type != 'cuda':
            raise ValueError(f'{name} must be a CUDA tensor')
        if a.dtype != dt:
            raise ValueError(f'{name} must be {str(dt)[6:]}, got {a.dtype}')
        if not a.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    if x_ctn.dim() != 3 or tuple(x_ctn.shape[:2]) != (c_in, tva):
        raise ValueError(f'x_ctn must be ({c_in}, {tva}, N), got '
                         f'{tuple(x_ctn.shape)}')
    n = x_ctn.shape[2]
    if tuple(silu_emb_en.shape) != (e_dim, n):
        raise ValueError(f'silu_emb_en must be ({e_dim}, {n}), got '
                         f'{tuple(silu_emb_en.shape)}')
    if silu_emb_en.device != x_ctn.device:
        raise ValueError('x_ctn and silu_emb_en are on different devices')
    cmax = max(w.w2.shape[0] * w.k2.shape[0] for w in folded.gcn)
    if n >= 2 ** 31 // max(cmax, e_dim):
        raise ValueError(f'N = {n} overflows the kernel\'s int indexing')
    return n


def load_library(source: str, prefix: str, checks: Dict[str, int]):
    """Build (at first use) and load `csrc/<source>`, and raise unless each
    `<prefix>_<name>()` of the library returns the value the host packs
    for (the table format, the rows per sub-tile)."""
    from mocodad_tpu_torch.ops.build import load
    lib = load(source)
    for name, want in checks.items():
        get = getattr(lib, f'{prefix}_{name}')
        get.argtypes, get.restype = [], ctypes.c_int
        if get() != want:
            raise RuntimeError(f'{source} reads {get()} for {name}; the '
                               f'host packs for {want}')
    return lib


def bind(lib, symbol: str, n_ptrs: int, n_ints: int):
    """The C entry point `symbol`: `n_ptrs` pointers, `n_ints` ints, then
    the stream; returns the CUDA error code."""
    fn = getattr(lib, symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def current_stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


class DenoiserKernel:
    """Wrapper of `csrc/denoiser.cu` at one compute dtype: float32 x and
    eps, or bfloat16 x and eps (silu_emb float32 either way).  `launches`
    counts the kernel launches this process made through it, and nothing
    else."""

    source = 'denoiser.cu'

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype
        self.launches = 0
        self._fn = None

    @property
    def symbol(self) -> str:
        suffix = {torch.float32: 'f32', torch.bfloat16: 'bf16'}[self.dtype]
        return f'mocodad_denoiser_launch_{suffix}'

    def load(self):
        """Build (at first use) and bind the C entry point."""
        if self._fn is None:
            lib = load_library(self.source, 'mocodad_denoiser', {
                'rows_per_block': KERNEL_ROWS, 'header_len': _H_LEN,
                'op_len': len(_O_FIELDS)})
            self._fn = bind(lib, self.symbol, 6, 2)
        return self._fn

    def __call__(self, x_ctn: torch.Tensor, silu_emb_en: torch.Tensor,
                 folded: FoldedDenoiser) -> torch.Tensor:
        n = check_fold_inputs(x_ctn, silu_emb_en, folded, self.dtype,
                              torch.float32)
        out = torch.empty_like(x_ctn)
        if n == 0:
            return out
        plan = kernel_plan(folded, x_ctn.device, self.dtype)
        fn = self.load()
        with torch.cuda.device(x_ctn.device):
            err = fn(x_ctn.data_ptr(), silu_emb_en.data_ptr(),
                     plan.mats.data_ptr(), plan.vecs.data_ptr(),
                     plan.table.data_ptr(), out.data_ptr(), n,
                     plan.smem_bytes, current_stream(x_ctn.device))
        if err != 0:
            raise RuntimeError(f'denoiser kernel launch failed: CUDA error '
                               f'{err}')
        self.launches += 1
        return out


DENOISER = DenoiserKernel(torch.float32)
DENOISER_BF16 = DenoiserKernel(torch.bfloat16)


def denoise(x_ctn: torch.Tensor, silu_emb_en: torch.Tensor,
            folded: FoldedDenoiser) -> torch.Tensor:
    """eps for a (C_in, T*V, N) fold, computed at x_ctn's dtype (float32,
    or bfloat16 with float32 accumulation): the plain version for a CPU
    tensor, the CUDA kernel for a CUDA tensor."""
    if x_ctn.device.type == 'cpu':
        return denoise_reference(x_ctn, silu_emb_en, folded,
                                 compute_dtype=x_ctn.dtype)
    if x_ctn.device.type == 'cuda':
        if x_ctn.dtype == torch.bfloat16:
            return DENOISER_BF16(x_ctn, silu_emb_en, folded)
        return DENOISER(x_ctn, silu_emb_en, folded)
    raise ValueError(f'no denoiser for device {x_ctn.device}')
