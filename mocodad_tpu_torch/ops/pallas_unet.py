"""The fused eval-mode U-Net denoiser: folded constants, the plain PyTorch
version, and the wrapper of the hand-written CUDA kernel.

Counterpart of `mocodad_tpu/ops/pallas_unet.py` (`build_pallas_denoiser`,
the JAX package's Pallas TPU kernel).  The same function, in the same
batch-in-last-dim layout:

    eps = denoise(x_ctn, silu_emb_en, folded)
    x_ctn (C_in, T*V, N), silu_emb_en (E, N) = silu(t_emb + cond_emb)^T,
    eps   (C_in, T*V, N)

`fold_denoiser` folds an `STSAEUnet`'s eval-mode BatchNorms, biases and
graph operators into per-layer constants exactly as the JAX host folding
does (pallas_unet.py:68-102).  `denoise_reference` applies them layer by
layer with einsums, in B1's order and association (graph operator first,
then channel mix).  `denoise` routes by device: a CPU tensor goes to
`denoise_reference`; a CUDA tensor launches the kernel in
`csrc/denoiser.cu` (`DENOISER`), or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

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
    built) their packed form for the CUDA kernel."""
    c_in: int
    n_frames: int
    n_joints: int
    embedding_dim: int
    gcn: List[GcnW]
    joint: List[JointW]
    _packed: Dict[torch.device, 'KernelPlan'] = field(default_factory=dict,
                                                      repr=False)

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

def _gcn_reference(f: torch.Tensor, w: GcnW, semb: torch.Tensor
                   ) -> torch.Tensor:
    """One ST-GCNN layer on (Ci, TV, N) -> (Co, TV, N) (pallas_unet.py:160-179)."""
    g = torch.einsum('kx,cxn->ckn', w.k2, f)             # graph operator
    y = torch.einsum('oc,ckn->okn', w.w2, g)             # channel mix
    if w.wr2 is not None:
        y = y + torch.einsum('oc,ckn->okn', w.wr2, f)
    else:
        y = y + f
    y = y + w.bias[:, None, None]
    y = torch.where(y >= 0, y, w.slope * y)
    e = w.we2 @ semb + w.eb[:, None]                     # (Co, N)
    return y + e[:, None, :]


def _joint_reference(f: torch.Tensor, w: JointW) -> torch.Tensor:
    """Joint re-scaling on (C, TVi, N) -> (C, TVo, N) (pallas_unet.py:181-184)."""
    h = torch.einsum('kx,cxn->ckn', w.d2, f)
    return h * w.rs[None, :, None] + w.rt[None, :, None]


@torch.no_grad()
def denoise_reference(x_ctn: torch.Tensor, silu_emb_en: torch.Tensor,
                      folded: FoldedDenoiser) -> torch.Tensor:
    """The plain PyTorch version of the kernel, layer by layer as B1's
    body (pallas_unet.py:186-204)."""
    gw, jw = folded.gcn, folded.joint
    f = _gcn_reference(x_ctn, gw[0], silu_emb_en)
    f = _gcn_reference(f, gw[1], silu_emb_en)
    d1 = f = _gcn_reference(f, gw[2], silu_emb_en)
    f = _joint_reference(f, jw[0])
    f = _gcn_reference(f, gw[3], silu_emb_en)
    d2 = f = _gcn_reference(f, gw[4], silu_emb_en)
    f = _joint_reference(f, jw[1])
    f = _gcn_reference(f, gw[5], silu_emb_en)
    f = _gcn_reference(f, gw[6], silu_emb_en)
    f = _joint_reference(f, jw[2]) + d2
    f = _gcn_reference(f, gw[7], silu_emb_en)
    f = _gcn_reference(f, gw[8], silu_emb_en)
    f = _joint_reference(f, jw[3]) + d1
    f = _gcn_reference(f, gw[9], silu_emb_en)
    f = _gcn_reference(f, gw[10], silu_emb_en)
    return f + x_ctn


# ---------------------------------------------------------------------------
# The CUDA kernel: packing, plan, wrapper
# ---------------------------------------------------------------------------

# must match the enums in csrc/denoiser.cu (checked when the kernel loads)
_H_NOPS, _H_CIN, _H_T, _H_TVA, _H_TVAP, _H_E, _H_X, _H_SEMB, _H_EMB, \
    _H_FINAL, _H_LEN = range(11)
_O_FIELDS = ('kind', 'ci', 'co', 'tvi', 'tvip', 'tvo', 'tvop', 'in', 'g',
             'out', 'skip', 'k', 'w', 'wr', 'bias', 'slope', 'we', 'eb',
             'rs', 'rt')
KERNEL_ROWS = 4                     # fold rows per block (kRows)
MAX_SMEM_BYTES = 232448             # dynamic shared memory a Hopper block may use


@dataclass
class KernelPlan:
    consts: torch.Tensor             # (n,) float32, every folded constant
    table: torch.Tensor              # (m,) int32, ops + offsets + smem plan
    smem_bytes: int


def _odd(n: int) -> int:
    return n | 1


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


class _Packer:
    """Appends constants to one float32 buffer at 16-byte aligned offsets,
    transposed to (K, M) with M zero-padded to a multiple of 4."""

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
        """A left operator (M, K) stored as its (K, Mp) transpose."""
        mat = m.detach().cpu().numpy()
        rows, cols = mat.shape
        t = np.zeros((cols, _pad4(rows)), np.float32)
        t[:, :rows] = mat.T
        return self.add(t)

    def vec(self, v: torch.Tensor) -> int:
        return self.add(v.detach().cpu().numpy())


def pack_for_kernel(folded: FoldedDenoiser) -> KernelPlan:
    """Lay the folded constants out for `csrc/denoiser.cu` and plan its
    shared memory (offsets in float4 units; one float4 holds one element
    for the kRows rows of a block)."""
    p = _Packer()
    t, c_in, e_dim = folded.n_frames, folded.c_in, folded.embedding_dim
    jp = joint_pyramid(folded.n_joints)
    tva, tvb, tvc = t * jp['a'], t * jp['b'], t * jp['c']
    gw, jw = folded.gcn, folded.joint
    tv_of_gcn = [tva, tva, tva, tvb, tvb, tvc, tvc, tvb, tvb, tva, tva]
    joint_tv = [(tva, tvb), (tvb, tvc), (tvc, tvb), (tvb, tva)]

    ops = []
    for w, tv in zip(gw, tv_of_gcn):
        co, ci = w.w2.shape
        ops.append(dict(
            kind=0, ci=ci, co=co, tvi=tv, tvip=_odd(tv), tvo=tv,
            tvop=_odd(tv), k=p.add_left(w.k2), w=p.add_left(w.w2),
            wr=-1 if w.wr2 is None else p.add_left(w.wr2),
            bias=p.vec(w.bias), slope=p.add(np.float32([w.slope])),
            we=p.add_left(w.we2), eb=p.vec(w.eb), rs=-1, rt=-1, skip=-1))
    joints = []
    for w, (tvi, tvo) in zip(jw, joint_tv):
        joints.append(dict(
            kind=1, tvi=tvi, tvip=_odd(tvi), tvo=tvo, tvop=_odd(tvo),
            k=p.add_left(w.d2), rs=p.vec(w.rs), rt=p.vec(w.rt), w=-1, wr=-1,
            bias=-1, slope=-1, we=-1, eb=-1, skip=-1))
    # B1's order: p1a d1_0 d1_1 | down1 | d2_0 d2_1 | down2 | d3_0 d3_1 |
    # up3 (+d2) | u4_0 u4_1 | up2 (+d1) | u3_0 u3_1
    seq = (ops[0:3] + [joints[0]] + ops[3:5] + [joints[1]] + ops[5:7]
           + [joints[2]] + ops[7:9] + [joints[3]] + ops[9:11])
    for i, o in enumerate(seq):      # a joint keeps its channel count
        if o['kind'] == 1:
            o['ci'] = o['co'] = seq[i - 1]['co']
    d1_op, d2_op = seq[2], seq[5]

    # fixed regions, then a work area whose ends alternate as the layer
    # input / output; d1_1 and d2_1 write into the skip buffers directly
    size_x = c_in * _odd(tva)
    cmax = max(o['co'] for o in seq if o['kind'] == 0)
    size_d1 = d1_op['co'] * d1_op['tvop']
    size_d2 = d2_op['co'] * d2_op['tvop']
    off_x = 0
    off_semb = off_x + size_x
    off_emb = off_semb + e_dim
    off_d1 = off_emb + cmax
    off_d2 = off_d1 + size_d1
    off_work = off_d2 + size_d2

    def sizes(o):
        return o['ci'] * o['tvip'], o['ci'] * o['tvop'], o['co'] * o['tvop']

    # pass 1: which end each buffer sits at, and the work area's size.  A
    # layer's graph-mixed intermediate sits next to its input (at L when
    # the input is a fixed region); its output goes to the other end.
    where = 'x'                      # x / d1 / d2 (fixed) or L / R (work)
    layout = []
    work = 0
    for o in seq:
        s_in, s_g, s_out = sizes(o)
        in_work = where in ('L', 'R')
        to_skip = 'd1' if o is d1_op else 'd2' if o is d2_op else None
        if o['kind'] == 0:
            g_side = 'R' if where == 'R' else 'L'
            out_side = to_skip or ('L' if g_side == 'R' else 'R')
            used = (s_in if in_work else 0) + s_g + \
                (0 if to_skip else s_out)
        else:
            g_side = None
            out_side = 'R' if where == 'L' else 'L'
            used = (s_in if in_work else 0) + s_out
        work = max(work, used)
        layout.append((where, g_side, out_side))
        where = out_side

    def at(side, size, inner=0):
        """Offset of a buffer of `size` at one end of the work area,
        `inner` floats away from that end."""
        if side == 'L':
            return off_work + inner
        return off_work + work - inner - size

    fixed = {'x': off_x, 'd1': off_d1, 'd2': off_d2}
    for o, (src, g_side, dst) in zip(seq, layout):
        s_in, s_g, s_out = sizes(o)
        o['in'] = fixed[src] if src in fixed else at(src, s_in)
        o['out'] = fixed[dst] if dst in fixed else at(dst, s_out)
        o['g'] = (-1 if g_side is None else
                  at(g_side, s_g, 0 if src in fixed else s_in))
    seq[9]['skip'] = off_d2          # up3 (+ d2)
    seq[12]['skip'] = off_d1         # up2 (+ d1)

    total = off_work + work
    smem_bytes = total * 16
    if smem_bytes > MAX_SMEM_BYTES:
        raise ValueError(
            f'the denoiser kernel needs {smem_bytes} bytes of shared memory '
            f'for these shapes; a Hopper block has {MAX_SMEM_BYTES}')
    header = [0] * _H_LEN
    header[_H_NOPS] = len(seq)
    header[_H_CIN] = c_in
    header[_H_T] = t
    header[_H_TVA] = tva
    header[_H_TVAP] = _odd(tva)
    header[_H_E] = e_dim
    header[_H_X] = off_x
    header[_H_SEMB] = off_semb
    header[_H_EMB] = off_emb
    header[_H_FINAL] = seq[-1]['out']
    table = header + [int(o[k]) for o in seq for k in _O_FIELDS]
    return KernelPlan(consts=torch.from_numpy(np.concatenate(p.parts)),
                      table=torch.tensor(table, dtype=torch.int32),
                      smem_bytes=smem_bytes)


def kernel_plan(folded: FoldedDenoiser, device: torch.device) -> KernelPlan:
    """The packed constants on `device`, built once per device."""
    device = torch.device(device)
    if device not in folded._packed:
        plan = pack_for_kernel(folded)
        folded._packed[device] = KernelPlan(
            consts=plan.consts.to(device), table=plan.table.to(device),
            smem_bytes=plan.smem_bytes)
    return folded._packed[device]


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
        ops +=2 * c * t * (tvo // t) * (tvi // t) + \
            (3 if skip else 2) * c * tvo
    ops += folded.c_in * folded.gcn[0].k2.shape[0]  # + x
    return ops


class DenoiserKernel:
    """Wrapper of `csrc/denoiser.cu`.  `launches` counts the kernel
    launches this process made through it, and nothing else."""

    source = 'denoiser.cu'

    def __init__(self):
        self.launches = 0
        self._fn = None

    def load(self):
        """Build (at first use) and bind the C entry point."""
        if self._fn is None:
            from mocodad_tpu_torch.ops.build import load
            lib = load(self.source)
            for what, sym, want in (
                    ('rows per block', 'mocodad_denoiser_rows_per_block',
                     KERNEL_ROWS),
                    ('table header fields', 'mocodad_denoiser_header_len',
                     _H_LEN),
                    ('fields per op record', 'mocodad_denoiser_op_len',
                     len(_O_FIELDS))):
                get = getattr(lib, sym)
                get.argtypes, get.restype = [], ctypes.c_int
                if get() != want:
                    raise RuntimeError(f'{self.source} reads {get()} {what}; '
                                       f'pack_for_kernel writes {want}')
            fn = lib.mocodad_denoiser_launch
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, x_ctn: torch.Tensor, silu_emb_en: torch.Tensor,
                 folded: FoldedDenoiser) -> torch.Tensor:
        c_in = folded.c_in
        tva = folded.gcn[0].k2.shape[0]
        e_dim = folded.embedding_dim
        for name, a in (('x_ctn', x_ctn), ('silu_emb_en', silu_emb_en)):
            if a.device.type != 'cuda':
                raise ValueError(f'{name} must be a CUDA tensor')
            if a.dtype != torch.float32:
                raise ValueError(f'{name} must be float32, got {a.dtype}')
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
        if n >= 2 ** 31 // max(c_in * tva, e_dim):
            raise ValueError(f'N = {n} overflows the kernel\'s int indexing')
        out = torch.empty_like(x_ctn)
        if n == 0:
            return out
        plan = kernel_plan(folded, x_ctn.device)
        fn = self.load()
        with torch.cuda.device(x_ctn.device):
            stream = torch.cuda.current_stream(x_ctn.device).cuda_stream
            err = fn(x_ctn.data_ptr(), silu_emb_en.data_ptr(),
                     plan.consts.data_ptr(), plan.table.data_ptr(),
                     out.data_ptr(), n, plan.smem_bytes, stream)
        if err != 0:
            raise RuntimeError(f'denoiser kernel launch failed: CUDA error '
                               f'{err}')
        self.launches += 1
        return out


DENOISER = DenoiserKernel()


def denoise(x_ctn: torch.Tensor, silu_emb_en: torch.Tensor,
            folded: FoldedDenoiser) -> torch.Tensor:
    """eps for a (C_in, T*V, N) fold: the plain version for a CPU tensor,
    the CUDA kernel for a CUDA tensor."""
    if x_ctn.device.type == 'cpu':
        return denoise_reference(x_ctn, silu_emb_en, folded)
    if x_ctn.device.type == 'cuda':
        return DENOISER(x_ctn, silu_emb_en, folded)
    raise ValueError(f'no denoiser for device {x_ctn.device}')
