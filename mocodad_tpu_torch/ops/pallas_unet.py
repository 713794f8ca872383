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
goes to `denoise_reference` at x's dtype; a CUDA tensor launches a
tensor-core kernel (`DENOISER`, `csrc/denoiser_tc_f32.cu`, 3xTF32, for
float32 x; `DENOISER_BF16`, `csrc/denoiser_tc.cu`, for bfloat16 x), or
raises.  `DENOISER_F32_FMA` and `DENOISER_BF16_FMA` (`csrc/denoiser.cu`'s
two entries) are the FMA design of B1, kept as the tensor-core kernels'
yardsticks; `pack_for_tc_f32_kernel` and `pack_for_tc_kernel` lay out the
tensor-core kernels' constants.

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


def layer_sequence(folded: FoldedDenoiser) -> List[Tuple[int, int, int, int]]:
    """B1's 15 ops in order as (kind, index, T*V in, T*V out): kind 0 is
    `folded.gcn[index]`, kind 1 `folded.joint[index]`: p1a d1_0 d1_1 |
    down1 | d2_0 d2_1 | down2 | d3_0 d3_1 | up3 (+d2) | u4_0 u4_1 |
    up2 (+d1) | u3_0 u3_1."""
    t = folded.n_frames
    jp = joint_pyramid(folded.n_joints)
    tva, tvb, tvc = t * jp['a'], t * jp['b'], t * jp['c']
    tv_of_gcn = [tva, tva, tva, tvb, tvb, tvc, tvc, tvb, tvb, tva, tva]
    joint_tv = [(tva, tvb), (tvb, tvc), (tvc, tvb), (tvb, tva)]
    gcn = [(0, i, tv, tv) for i, tv in enumerate(tv_of_gcn)]
    joint = [(1, i, tvi, tvo) for i, (tvi, tvo) in enumerate(joint_tv)]
    return (gcn[0:3] + [joint[0]] + gcn[3:5] + [joint[1]] + gcn[5:7]
            + [joint[2]] + gcn[7:9] + [joint[3]] + gcn[9:11])


def pack_layers(folded: FoldedDenoiser
                 ) -> Tuple[np.ndarray, np.ndarray, List[dict]]:
    """The folded matrices and vectors as two float32 buffers, and B1's 15
    op records (shapes and constant offsets; arena offsets unset) in
    `layer_sequence` order."""
    mats, vecs = _Packer(), _Packer()
    order = layer_sequence(folded)
    recs = {}                        # all ST-GCNN layers' constants first
    for kind, i, tvi, tvo in sorted(order):
        if kind == 0:
            w = folded.gcn[i]
            co, ci = w.w2.shape
            recs[kind, i] = dict(
                kind=0, ci=ci, co=co, tvi=tvi, tvip=odd(tvi), tvo=tvo,
                tvop=odd(tvo), k=mats.add_left(w.k2), w=mats.add_left(w.w2),
                wr=-1 if w.wr2 is None else mats.add_left(w.wr2),
                we=mats.add_left(w.we2), bias=vecs.vec(w.bias),
                slope=vecs.add(np.float32([w.slope])), eb=vecs.vec(w.eb),
                rs=-1, rt=-1, skip=-1)
        else:
            w = folded.joint[i]
            recs[kind, i] = dict(
                kind=1, tvi=tvi, tvip=odd(tvi), tvo=tvo, tvop=odd(tvo),
                k=mats.add_left(w.d2), rs=vecs.vec(w.rs), rt=vecs.vec(w.rt),
                w=-1, wr=-1, we=-1, bias=-1, slope=-1, eb=-1, skip=-1)
    seq = [recs[kind, i] for kind, i, _, _ in order]
    for j, o in enumerate(seq):      # a joint keeps its channel count
        if o['kind'] == 1:
            o['ci'] = o['co'] = seq[j - 1]['co']
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


# ---------------------------------------------------------------------------
# The tensor-core kernel's constants and shared-memory plan
# (csrc/denoiser_tc.cu, B1 at bfloat16)
# ---------------------------------------------------------------------------

# must match the enums in csrc/denoiser_tc.cu (checked when it loads)
TC_HEADER = ('nops', 'e', 'cin', 'tva', 'tvap', 'row0', 'row_bytes',
             'x_off', 'x_stride', 'semb_off', 'emb_off', 'emb_stride',
             'embw_off', 'embw_blob', 'embw_bytes', 'wbuf0', 'wbuf1',
             'out_off', 'out_stride')
TC_OP = ('kind', 'ci', 'nt', 'nsplit', 'tvi', 'tvo', 'mt', 'ks', 'in',
         'in_stride', 'out', 'out_stride', 'skip', 'skip_stride', 'res',
         'blob', 'blob_bytes', 'k', 'k_stride', 'w', 'w_stride', 'wr',
         'bias', 'slope', 'rs', 'rt', 'emb')
TC_ROWS = 4                          # fold rows per tile (kRows)
TC_WARPS = 16                        # warps per block (kWarps)
TC_MAX_TABLE = 512                   # ints of table it copies (kMaxTable)
TC_UNIT_TILES = (2, 4, 8)            # 8-channel output tiles per unit it
                                     # instantiates


def tc_nsplit(units: int, chunks: int, ks: int, nt: int, res: bool) -> int:
    """Parts of C_out for one ST-GCNN layer's units: the split that makes
    the busiest warp's MMA count least (rounds of units over TC_WARPS
    warps, each unit recomputing its graph mix), fewest parts on a tie."""
    def cost(ns):
        per_unit = chunks * (2 * ks + (3 if res else 2) * nt // ns)
        return -(-units * ns // TC_WARPS) * per_unit
    fits = [ns for ns in (1, 2, 4) if nt % ns == 0
            and nt // ns in TC_UNIT_TILES]
    if not fits:
        raise ValueError(f'the tensor-core denoiser cannot split '
                         f'{8 * nt} output channels into units of '
                         f'{[8 * t for t in TC_UNIT_TILES]}')
    return min(fits, key=lambda ns: (cost(ns), ns))


def pad16(n: int) -> int:
    return -(-n // 16) * 16


def tc_stride(c: int) -> int:
    """Row stride (bf16 elements) of a (T*V, C) tile: C padded to the MMA's
    16, plus 8 so that ldmatrix's 8 row addresses hit distinct banks."""
    return pad16(c) + 8


def tc_act_bytes(tv: int, c: int) -> int:
    """Bytes of one row's (T*V, C) activation tile, T*V padded to 16."""
    return pad16(tv) * tc_stride(c) * 2


def bf16_bits(m: torch.Tensor) -> np.ndarray:
    """A tensor rounded to bfloat16 (nearest even), as uint16 bit
    patterns."""
    return m.detach().cpu().float().to(torch.bfloat16).view(
        torch.int16).numpy().view(np.uint16)


class _Blob:
    """One op's constants: sections at 16-byte aligned offsets."""

    def __init__(self):
        self.parts: List[np.ndarray] = []
        self.size = 0

    def add(self, a: np.ndarray) -> int:
        b = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        off, pad = self.size, -b.size % 16
        self.parts += [b, np.zeros(pad, np.uint8)]
        self.size += b.size + pad
        return off

    def tile(self, m: torch.Tensor, rows: int, stride: int) -> int:
        """A matrix as a zero-padded (rows, stride) bf16 tile."""
        t = np.zeros((rows, stride), np.uint16)
        bits = bf16_bits(m)
        t[:bits.shape[0], :bits.shape[1]] = bits
        return self.add(t)

    def vec(self, v: torch.Tensor, size: int) -> int:
        a = np.zeros(size, np.float32)
        vals = v.detach().cpu().float().numpy().reshape(-1)
        a[:vals.size] = vals
        return self.add(a)


@dataclass
class TcPlan:
    blob: torch.Tensor               # (b,) uint8, every op's constants
    table: torch.Tensor              # int32: header, then op records
    smem_bytes: int                  # dynamic shared memory per block

    def to(self, device: torch.device) -> 'TcPlan':
        return TcPlan(blob=self.blob.to(device), table=self.table.to(device),
                      smem_bytes=self.smem_bytes)


def pack_for_tc_kernel(folded: FoldedDenoiser) -> TcPlan:
    """Lay the folded constants out for `csrc/denoiser_tc.cu` and plan its
    shared memory (offsets in bytes, strides in bf16 elements).

    Each op's constants are one 16-byte aligned block of the blob, copied
    whole into a weight buffer: an ST-GCNN layer's K (T*V_out, T*V_in), W
    and Wr (C_out, C_in) as zero-padded bf16 tiles of `tc_stride` columns,
    bias and slope float32; a joint re-scaling's dense (T*V_out, T*V_in)
    operator and its per-row affine.  Every layer's W_e (C_out, E) bf16,
    stacked and transposed to (E, sum of C_out), then its b_e float32, form
    the blob's last block, staged once per block.  Shared memory: two
    weight buffers of the largest op's size, the stacked W_e and b_e,
    every layer's embedding (TC_ROWS x the stacked C_out, float32), then
    TC_ROWS row areas of x, the skips d1 and d2, silu_emb (float32) and a
    work area whose two ends alternate as layer input and output."""
    seq = layer_sequence(folded)
    e_dim, cin = folded.embedding_dim, folded.c_in
    ops, blocks = [], []
    chans = [cin]                    # channels of each op's input, then out
    emb_w, emb_b = [], []            # every layer's W_e and b_e, stacked
    for kind, i, tvi, tvo in seq:
        b = _Blob()
        ci = chans[-1]
        o = dict(kind=kind, tvi=tvi, tvo=tvo, mt=pad16(tvo) // 16,
                 ks=pad16(tvi) // 16, ci=pad16(ci), res=0,
                 k_stride=tc_stride(tvi), w=-1, w_stride=0, wr=-1, bias=-1,
                 slope=-1, rs=-1, rt=-1, emb=-1)
        if kind == 0:
            w = folded.gcn[i]
            co = w.w2.shape[0]
            cop = pad16(co)
            o.update(nt=cop // 8, res=int(w.wr2 is not None),
                     nsplit=tc_nsplit(TC_ROWS * o['mt'], pad16(ci) // 16,
                                      o['ks'], cop // 8, w.wr2 is not None),
                     k=b.tile(w.k2, pad16(tvo), tc_stride(tvi)),
                     w=b.tile(w.w2, cop, tc_stride(ci)),
                     w_stride=tc_stride(ci))
            if w.wr2 is not None:
                o['wr'] = b.tile(w.wr2, cop, tc_stride(ci))
            o.update(bias=b.vec(w.bias, cop),
                     slope=b.add(np.float32([w.slope])),
                     emb=sum(a.shape[0] for a in emb_w))
            we = np.zeros((cop, e_dim), np.uint16)
            we[:co] = bf16_bits(w.we2)
            eb = np.zeros(cop, np.float32)
            eb[:co] = w.eb.detach().cpu().float().numpy()
            emb_w.append(we)
            emb_b.append(eb)
        else:
            j = folded.joint[i]
            co = ci
            o.update(nt=pad16(ci) // 8, nsplit=1,
                     k=b.tile(j.d2, pad16(tvo), tc_stride(tvi)),
                     rs=b.vec(j.rs, pad16(tvo)), rt=b.vec(j.rt, pad16(tvo)))
        chans.append(co)
        o.update(blob=sum(x.size for x in blocks), blob_bytes=b.size,
                 c_in=ci, c_out=co)
        blocks.append(b)
        ops.append(o)

    # one row's area: fixed regions, then the work area
    regions = [('x', tc_act_bytes(seq[0][2], cin)),
               ('d1', tc_act_bytes(seq[2][3], chans[3])),
               ('d2', tc_act_bytes(seq[5][3], chans[6])),
               ('semb', -(-e_dim * 4 // 16) * 16)]
    off, total = {}, 0
    for name, size in regions:
        off[name] = total
        total += size
    dst, skip = {2: 'd1', 5: 'd2'}, {9: 'd2', 12: 'd1'}
    where, sides, work = 'x', [], 0
    for k, o in enumerate(ops):
        s_in = tc_act_bytes(o['tvi'], o['c_in'])
        s_out = tc_act_bytes(o['tvo'], o['c_out'])
        out = dst.get(k) or ('R' if where == 'L' else 'L')
        work = max(work, (s_in if where in 'LR' else 0)
                   + (s_out if out in 'LR' else 0))
        sides.append((where, out, s_in, s_out))
        where = out

    def at(side, size):
        if side in off:
            return off[side]
        return total if side == 'L' else total + work - size

    for k, (o, (src, out, s_in, s_out)) in enumerate(zip(ops, sides)):
        o.update(
            {'in': at(src, s_in), 'in_stride': tc_stride(o['c_in']),
             'out': at(out, s_out), 'out_stride': tc_stride(o['c_out']),
             'skip': off[skip[k]] if k in skip else -1,
             'skip_stride': tc_stride(o['c_out']) if k in skip else 0})
    row_bytes = total + work
    wbuf = max(b.size for b in blocks)
    embw = _Blob()
    embw.add(np.ascontiguousarray(np.concatenate(emb_w).T))
    embw.add(np.concatenate(emb_b))
    emb_stride = sum(a.shape[0] for a in emb_w)
    embw_off = 2 * wbuf
    emb_off = embw_off + embw.size
    row0 = emb_off + TC_ROWS * emb_stride * 4
    smem_bytes = row0 + TC_ROWS * row_bytes
    # the kernel also holds the table in static shared memory
    check_smem('tensor-core denoiser', smem_bytes + 4 * TC_MAX_TABLE)
    header = dict(nops=len(ops), e=e_dim, cin=cin, tva=seq[0][2],
                  tvap=pad16(seq[0][2]), row0=row0, row_bytes=row_bytes,
                  x_off=off['x'], x_stride=tc_stride(cin),
                  semb_off=off['semb'], emb_off=emb_off,
                  emb_stride=emb_stride, embw_off=embw_off,
                  embw_blob=sum(b.size for b in blocks),
                  embw_bytes=embw.size, wbuf0=0, wbuf1=wbuf,
                  out_off=ops[-1]['out'], out_stride=ops[-1]['out_stride'])
    table = [header[k] for k in TC_HEADER] + \
        [int(o[k]) for o in ops for k in TC_OP]
    if len(table) > TC_MAX_TABLE:
        raise ValueError(f'the tensor-core denoiser reads at most '
                         f'{TC_MAX_TABLE} table entries, got {len(table)}')
    blob = np.concatenate([p for b in blocks + [embw] for p in b.parts])
    return TcPlan(blob=torch.from_numpy(blob),
                  table=torch.tensor(table, dtype=torch.int32),
                  smem_bytes=smem_bytes)


def tc_plan(folded: FoldedDenoiser, device: torch.device) -> TcPlan:
    """The tensor-core kernel's packed constants and table on `device`,
    built once."""
    return cached_plan(folded, ('denoiser_tc',), device,
                       lambda: pack_for_tc_kernel(folded))


# ---------------------------------------------------------------------------
# The float32 tensor-core kernel's constants and shared-memory plan
# (csrc/denoiser_tc_f32.cu, B1 at float32 as 3xTF32)
# ---------------------------------------------------------------------------

# must match the enums in csrc/denoiser_tc_f32.cu (checked when it loads)
TC32_HEADER = ('nops', 'e', 'cin', 'tva', 'tvap', 'row0', 'row_bytes',
               'x_off', 'x_stride', 'semb_off', 'emb_off', 'emb_stride',
               'embw_blob', 'wbuf0', 'wbuf1', 'out_off', 'out_stride',
               'pbuf_off')
TC32_OP = ('kind', 'ci', 'nt', 'nsplit', 'tvi', 'tvo', 'mt', 'ks', 'in',
           'in_stride', 'out', 'out_stride', 'skip', 'skip_stride', 'res',
           'c0', 'blob', 'blob_bytes', 'k', 'w', 'w_stride', 'wr', 'bias',
           'slope', 'rs', 'rt', 'emb')
TC32_ROWS = 2                        # fold rows per tile (kRows)
TC32_WARPS = 12                      # warps per block (kWarps)
TC32_MAX_TABLE = 768                 # ints of table it copies (kMaxTable)
TC32_STATIC_SMEM = 4 * TC32_MAX_TABLE + 16   # the table and two mbarriers
TC32_MAX_E = 16                      # embedding width it unrolls for (kMaxE)
TC32_UNIT_TILES = (1, 2, 4)          # 8-channel output tiles per unit it
                                     # instantiates


def pad8(n: int) -> int:
    return -(-n // 8) * 8


def tc32_nsplit(units: int, chunks: int, ks: int, nt: int, res: bool,
                warps: int = TC32_WARPS) -> int:
    """Parts of one op record's output tiles over its `units` (row, 16
    positions): the split that makes the busiest warp's MMA count least
    (rounds of units over `warps` warps; per 16-channel chunk a unit
    issues 2 x ks graph-mix products and 2 channel-mix products per output
    tile, 4 with a residual mix, and recomputes its graph mix in every
    part), fewest parts on a tie."""
    def cost(ns):
        per_unit = chunks * (2 * ks + (4 if res else 2) * nt // ns)
        return -(-units * ns // warps) * per_unit
    fits = [ns for ns in (1, 2, 4, 8) if nt % ns == 0
            and nt // ns in TC32_UNIT_TILES]
    if not fits:
        raise ValueError(f'the float32 tensor-core denoiser cannot split '
                         f'{8 * nt} output channels into units of '
                         f'{[8 * t for t in TC32_UNIT_TILES]}')
    return min(fits, key=lambda ns: (cost(ns), ns))


def tc32_stride(c: int) -> int:
    """Row stride (floats) of a float32 (T*V, C) tile: C padded to 16, plus
    8, so that the stride is 8 or 24 mod 32 words (conflict-free fragment
    loads, see the source note)."""
    return pad16(c) + 8


def tc32_act_bytes(tv: int, c: int) -> int:
    """Bytes of one row's float32 (T*V, C) activation tile, T*V padded to
    16."""
    return pad16(tv) * tc32_stride(c) * 4


def tf32_round(a: np.ndarray) -> np.ndarray:
    """float32 -> float32 rounded to TF32 as the kernel does it: the low 13
    bits of the magnitude rounded off, to nearest, ties away from zero
    ((bits + 0x1000) & ~0x1fff, what cvt.rna.tf32.f32 gives)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)


def tf32_split(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """a = hi + lo: hi = tf32_round(a), lo = a - hi (exact in float32)."""
    a = np.asarray(a, np.float32)
    hi = tf32_round(a)
    return hi, (a - hi).astype(np.float32)


def k_fragments(m: torch.Tensor, mt: int, ks: int) -> np.ndarray:
    """A graph operator (TVo, TVi) as the kernel's A fragments of
    mma.m16n8k8 TF32: zero-padded to (16 mt, 8 ks), split into hi and lo
    (both rounded to TF32), and laid out (mt, ks, hi / lo, lane, 4) with a
    lane's four registers (a0..a3) = rows g, g + 8, g, g + 8 and columns
    t, t, t + 4, t + 4 of the 16 x 8 block (g = lane / 4, t = lane % 4)."""
    mat = m.detach().cpu().float().numpy()
    k = np.zeros((16 * mt, 8 * ks), np.float32)
    k[:mat.shape[0], :mat.shape[1]] = mat
    hi, lo = tf32_split(k)
    lo = tf32_round(lo)
    lane = np.arange(32)
    gid, tig = lane >> 2, lane & 3
    rows = np.stack([gid, gid + 8, gid, gid + 8], axis=1)    # (32, 4)
    cols = np.stack([tig, tig, tig + 4, tig + 4], axis=1)
    out = np.empty((mt, ks, 2, 32, 4), np.float32)
    for i in range(mt):
        for s in range(ks):
            for part, src in enumerate((hi, lo)):
                out[i, s, part] = src[16 * i + rows, 8 * s + cols]
    return out


def tc32_parts_bytes(mt: int, ks: int, ci: int, nt: int, res: bool) -> int:
    """Bytes of one op record's constants: K hi and lo in fragment order,
    W (and Wr) as (8 nt, tc32_stride(ci)) float32 tiles, bias, slope."""
    return (mt * ks * 2 * 512 + (2 if res else 1) * 8 * nt *
            tc32_stride(ci) * 4 + -(-8 * nt * 4 // 16) * 16 + 16)


def pack_for_tc_f32_kernel(folded: FoldedDenoiser,
                           warps: int = TC32_WARPS) -> TcPlan:
    """Lay the folded constants out for `csrc/denoiser_tc_f32.cu` and plan
    its shared memory (offsets in bytes, strides in floats), for a build
    with `warps` warps per block: two weight buffers, every layer's
    embedding, a prefetch buffer for the next tile's x and silu_emb, then
    TC32_ROWS row areas.

    One row's area: x, the skips d1 and d2, silu_emb, then a work area
    whose two ends alternate as layer input and output, every activation a
    float32 (T*V, C) tile of `tc32_stride` columns.  Each op record's
    constants are one 16-byte aligned block of the blob, copied whole into
    a weight buffer: an ST-GCNN layer's K (`k_fragments`), W and Wr (C_out,
    C_in) as float32 tiles, bias and slope; a joint re-scaling's dense
    (T*V_out, T*V_in) operator as K, and its per-row affine.  A layer whose constants would not fit
    a buffer (two buffers beside TC32_ROWS row areas and the embeddings)
    becomes 2 or 4 records over parts of its C_out, each with its own copy
    of K.  Every layer's W_e (C_out, E), stacked and transposed to (E, sum
    of C_out), then its b_e, form the blob's last block, which the kernel
    reads through __ldg."""
    seq = layer_sequence(folded)
    e_dim, cin = folded.embedding_dim, folded.c_in
    if e_dim > TC32_MAX_E:
        raise ValueError(f'the float32 tensor-core denoiser takes embeddings '
                         f'of at most {TC32_MAX_E}, got {e_dim}')
    chans = [cin]
    for kind, i, _, _ in seq:
        chans.append(folded.gcn[i].w2.shape[0] if kind == 0 else chans[-1])

    # one row's area: fixed regions, then the work area
    regions = [('x', tc32_act_bytes(seq[0][2], cin)),
               ('d1', tc32_act_bytes(seq[2][3], chans[3])),
               ('d2', tc32_act_bytes(seq[5][3], chans[6])),
               ('semb', -(-e_dim * 4 // 16) * 16)]
    off, total = {}, 0
    for name, size in regions:
        off[name] = total
        total += size
    dst, skip = {2: 'd1', 5: 'd2'}, {9: 'd2', 12: 'd1'}
    where, sides, work = 'x', [], 0
    for k, (_, _, tvi, tvo) in enumerate(seq):
        s_in = tc32_act_bytes(tvi, chans[k])
        s_out = tc32_act_bytes(tvo, chans[k + 1])
        out = dst.get(k) or ('R' if where == 'L' else 'L')
        work = max(work, (s_in if where in 'LR' else 0)
                   + (s_out if out in 'LR' else 0))
        sides.append((where, out, s_in, s_out))
        where = out

    def at(side, size):
        if side in off:
            return off[side]
        return total if side == 'L' else total + work - size

    row_bytes = total + work
    emb_stride = sum(pad8(w.w2.shape[0]) for w in folded.gcn)
    emb_bytes = TC32_ROWS * emb_stride * 4
    # the next tile's x and silu_emb, as cp.async brings them
    pbuf_bytes = -(-TC32_ROWS * (cin * seq[0][2] + e_dim) * 4 // 16) * 16
    # the kernel also holds the table and its mbarriers in static shared
    # memory
    wcap = (MAX_SMEM_BYTES - TC32_STATIC_SMEM - TC32_ROWS * row_bytes
            - emb_bytes - pbuf_bytes) // 2 // 16 * 16

    ops, blocks = [], []
    emb_w, emb_b = [], []            # every layer's W_e and b_e, stacked
    for k, ((kind, i, tvi, tvo), (src, out, s_in, s_out)) in enumerate(
            zip(seq, sides)):
        ci, co = chans[k], chans[k + 1]
        rec = dict(kind=kind, tvi=tvi, tvo=tvo, mt=pad16(tvo) // 16,
                   ks=pad8(tvi) // 8, ci=pad16(ci), res=0, c0=0,
                   w=-1, w_stride=0, wr=-1, bias=-1, slope=-1, rs=-1, rt=-1,
                   emb=-1, skip=off[skip[k]] if k in skip else -1,
                   skip_stride=tc32_stride(co) if k in skip else 0,
                   **{'in': at(src, s_in), 'in_stride': tc32_stride(ci),
                      'out': at(out, s_out), 'out_stride': tc32_stride(co)})
        if kind == 1:
            j = folded.joint[i]
            b = _Blob()
            rec.update(nt=pad16(ci) // 8, nsplit=1,
                       k=b.add(k_fragments(j.d2, rec['mt'], rec['ks'])),
                       rs=b.vec(j.rs, pad16(tvo)), rt=b.vec(j.rt, pad16(tvo)))
            ops.append(rec)
            blocks.append(b)
            continue
        w = folded.gcn[i]
        res = w.wr2 is not None
        nt = pad8(co) // 8
        parts = 1
        while tc32_parts_bytes(rec['mt'], rec['ks'], ci, nt // parts,
                               res) > wcap:
            parts *= 2
            if nt % parts:
                raise ValueError(f'the float32 tensor-core denoiser cannot '
                                 f'fit layer {GCN_LAYERS[i]}\'s constants '
                                 f'in {wcap} bytes')
        ntp = nt // parts
        kfrag = k_fragments(w.k2, rec['mt'], rec['ks'])
        col = sum(a.shape[0] for a in emb_w)
        for p in range(parts):
            b = _Blob()
            rows = slice(8 * ntp * p, 8 * ntp * (p + 1))

            def tile(m):
                t = np.zeros((8 * nt, tc32_stride(ci)), np.float32)
                mat = m.detach().cpu().float().numpy()
                t[:mat.shape[0], :mat.shape[1]] = mat
                return b.add(t[rows])

            bias = np.zeros(8 * nt, np.float32)
            bias[:co] = w.bias.detach().cpu().float().numpy()
            r = dict(rec, nt=ntp, res=int(res), c0=8 * ntp * p,
                     emb=col + 8 * ntp * p, k=b.add(kfrag), w=tile(w.w2),
                     w_stride=tc32_stride(ci))
            if res:
                r['wr'] = tile(w.wr2)
            r.update(bias=b.add(bias[rows]),
                     slope=b.add(np.float32([w.slope])),
                     nsplit=tc32_nsplit(TC32_ROWS * rec['mt'],
                                        pad16(ci) // 16, rec['ks'], ntp,
                                        res, warps))
            ops.append(r)
            blocks.append(b)
        we = np.zeros((8 * nt, e_dim), np.float32)
        we[:co] = w.we2.detach().cpu().float().numpy()
        eb = np.zeros(8 * nt, np.float32)
        eb[:co] = w.eb.detach().cpu().float().numpy()
        emb_w.append(we)
        emb_b.append(eb)

    offset = 0
    for o, b in zip(ops, blocks):
        o.update(blob=offset, blob_bytes=b.size)
        offset += b.size
    embw = _Blob()
    embw.add(np.ascontiguousarray(np.concatenate(emb_w).T))
    embw.add(np.concatenate(emb_b))
    wbuf = max(b.size for b in blocks)
    emb_off = 2 * wbuf
    pbuf_off = emb_off + emb_bytes
    row0 = pbuf_off + pbuf_bytes
    smem_bytes = row0 + TC32_ROWS * row_bytes
    check_smem('float32 tensor-core denoiser',
               smem_bytes + TC32_STATIC_SMEM)
    header = dict(nops=len(ops), e=e_dim, cin=cin, tva=seq[0][2],
                  tvap=pad16(seq[0][2]), row0=row0, row_bytes=row_bytes,
                  x_off=off['x'], x_stride=tc32_stride(cin),
                  semb_off=off['semb'], emb_off=emb_off,
                  emb_stride=emb_stride, embw_blob=offset, wbuf0=0,
                  wbuf1=wbuf, out_off=ops[-1]['out'],
                  out_stride=ops[-1]['out_stride'], pbuf_off=pbuf_off)
    table = [header[k] for k in TC32_HEADER] + \
        [int(o[k]) for o in ops for k in TC32_OP]
    if len(table) > TC32_MAX_TABLE:
        raise ValueError(f'the float32 tensor-core denoiser reads at most '
                         f'{TC32_MAX_TABLE} table entries, got {len(table)}')
    blob = np.concatenate([p for b in blocks + [embw] for p in b.parts])
    return TcPlan(blob=torch.from_numpy(blob),
                  table=torch.tensor(table, dtype=torch.int32),
                  smem_bytes=smem_bytes)


def tc32_plan(folded: FoldedDenoiser, device: torch.device,
              warps: int = TC32_WARPS) -> TcPlan:
    """The float32 tensor-core kernel's packed constants and table on
    `device`, built once per warp count."""
    return cached_plan(folded, ('denoiser_tc32', warps), device,
                       lambda: pack_for_tc_f32_kernel(folded, warps))


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


class TensorCoreDenoiserKernel:
    """Wrapper of `csrc/denoiser_tc.cu`, B1 at bfloat16 on the tensor
    cores: bfloat16 x and eps, float32 silu_emb.  `launches` counts the
    kernel launches this process made through it, and nothing else."""

    source = 'denoiser_tc.cu'
    symbol = 'mocodad_denoiser_tc_launch'
    prefix = 'mocodad_denoiser_tc'
    dtype = torch.bfloat16

    def __init__(self):
        self.launches = 0
        self._fn = None

    def constants(self) -> Dict[str, int]:
        """What the library must report: the plan the host packs for."""
        return {'rows_per_block': TC_ROWS, 'warps_per_block': TC_WARPS,
                'max_table': TC_MAX_TABLE, 'header_len': len(TC_HEADER),
                'op_len': len(TC_OP)}

    def plan(self, folded: FoldedDenoiser, device: torch.device) -> TcPlan:
        return tc_plan(folded, device)

    def load(self):
        """Build (at first use) and bind the C entry point."""
        if self._fn is None:
            lib = load_library(self.source, self.prefix, self.constants())
            self._fn = bind(lib, self.symbol, 5, 2)
        return self._fn

    def __call__(self, x_ctn: torch.Tensor, silu_emb_en: torch.Tensor,
                 folded: FoldedDenoiser) -> torch.Tensor:
        n = check_fold_inputs(x_ctn, silu_emb_en, folded, self.dtype,
                              torch.float32)
        out = torch.empty_like(x_ctn)
        if n == 0:
            return out
        plan = self.plan(folded, x_ctn.device)
        fn = self.load()
        with torch.cuda.device(x_ctn.device):
            err = fn(x_ctn.data_ptr(), silu_emb_en.data_ptr(),
                     plan.blob.data_ptr(), plan.table.data_ptr(),
                     out.data_ptr(), n, plan.smem_bytes,
                     current_stream(x_ctn.device))
        if err != 0:
            raise RuntimeError(f'{self.source} kernel launch failed: CUDA '
                               f'error {err}')
        self.launches += 1
        return out


class TensorCoreF32DenoiserKernel(TensorCoreDenoiserKernel):
    """Wrapper of `csrc/denoiser_tc_f32.cu`, B1 at float32 on the tensor
    cores as 3xTF32: float32 x, silu_emb and eps.  `launches` counts the
    kernel launches this process made through it, and nothing else."""

    source = 'denoiser_tc_f32.cu'
    symbol = 'mocodad_denoiser_tc32_launch'
    prefix = 'mocodad_denoiser_tc32'
    dtype = torch.float32

    def constants(self) -> Dict[str, int]:
        return {'rows_per_block': TC32_ROWS, 'warps_per_block': TC32_WARPS,
                'max_table': TC32_MAX_TABLE, 'header_len': len(TC32_HEADER),
                'op_len': len(TC32_OP)}

    def plan(self, folded: FoldedDenoiser, device: torch.device) -> TcPlan:
        return tc32_plan(folded, device)


# B1 at each dtype: the tensor-core kernel on the main path, and the FMA
# design of csrc/denoiser.cu kept as its yardstick (timed beside it, never
# on a main path)
DENOISER = TensorCoreF32DenoiserKernel()
DENOISER_F32_FMA = DenoiserKernel(torch.float32)
DENOISER_BF16 = TensorCoreDenoiserKernel()
DENOISER_BF16_FMA = DenoiserKernel(torch.bfloat16)


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
