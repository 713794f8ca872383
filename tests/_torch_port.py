"""Shared set-up of the parity tests between the JAX package and its PyTorch
port (tests/test_torch_*.py): one configuration, weights made in the JAX
package's variables layout, and the same weights as a port network.

Inputs and noise are made from a seed with NumPy and handed to both
packages.  JAX stays on the CPU (tests/conftest.py); the port runs on the
CPU with its kernels' plain versions.
"""

from __future__ import annotations

import functools
import importlib.util
import os
import sys

import jax
import numpy as np
import torch

from mocodad_tpu.config import Config as JaxConfig
from mocodad_tpu.models import MoCoDADModel as JaxModel
from mocodad_tpu_torch.config import Config as TorchConfig
from mocodad_tpu_torch.models.mocodad import MoCoDADModel as TorchModel
from mocodad_tpu_torch.ops import pallas_unet as P
from mocodad_tpu_torch.utils.weights import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# several test workers share a small host
torch.set_num_threads(1)

CFG_KW = dict(conditioning_strategy='inject', conditioning_indices=[0, 1, 2],
              seg_len=6, num_coords=2, embedding_dim=16, h_dim=32,
              latent_dim=16, channels=[32, 16, 32], dropout=0.0,
              noise_steps=10, n_generated_samples=2,
              aggregation_strategy='best', conditioning_architecture='AE')


def jax_model(**kw) -> JaxModel:
    return JaxModel(JaxConfig(**{**CFG_KW, **kw}))


def torch_model(**kw) -> TorchModel:
    return TorchModel(TorchConfig(**{**CFG_KW, **kw}))


def _to_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jax.device_get(tree))


def trained_variables(model: JaxModel, seed: int = 0):
    """The JAX package's own init plus one train-mode loss step, so the
    BatchNorm running statistics are non-trivial
    (the pattern of tests/test_pallas_unet.py:26-32)."""
    variables = model.init_variables(jax.random.key(seed))
    data = jax.random.normal(jax.random.key(9),
                             (16, model.num_coords, model.n_frames,
                              model.n_joints))
    loss = jax.jit(lambda v, d, k: model.loss(v, d, k, train=True)[2])
    mut = loss(variables, data, jax.random.key(10))
    return _to_np({'params': variables['params'],
                   'batch_stats': mut['batch_stats']})


def seeded_tree(shapes, seed: int = 0):
    """Fill a traced variables tree (jax.eval_shape of a flax init) with
    values drawn from a NumPy seed: weights uniform as at init, BatchNorm
    scale/shift and running statistics away from their identity values."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [str(getattr(p, 'key', '')) for p in path]
        shape = leaf.shape
        if names[0] == 'batch_stats':
            if names[-1] == 'mean':
                return (0.1 * rng.standard_normal(shape)).astype(np.float32)
            return (0.5 + rng.random(shape)).astype(np.float32)
        if names[-1] == 'negative_slope':
            return np.float32(0.25 + 0.1 * rng.random(shape))
        if 'BatchNorm' in names[-2] or names[-2].endswith('_bn'):
            if names[-1] == 'scale':
                return (1 + 0.1 * rng.standard_normal(shape)).astype(
                    np.float32)
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        fan = shape[-2] if len(shape) >= 2 else shape[0]
        bound = 1.0 / np.sqrt(fan)
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def seeded_variables(model: JaxModel, seed: int = 0):
    """A JAX model's variables tree filled by `seeded_tree`: BatchNorm
    statistics away from identity without a training step."""
    shapes = jax.eval_shape(model.init_variables, jax.random.key(0))
    return seeded_tree(shapes, seed=seed)


def bf16_stats(got, want):
    """(max |got - want| / max |want|, mean |got - want| / mean |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    return err.max() / np.abs(want).max(), err.mean() / np.abs(want).mean()


def sub_state_dict(variables, root: str, prefix: str, name=None):
    """The port's state dict of one submodule, from the `variables` of a
    flax module placed at params[root] (or params[root][name]); keys are
    returned without `prefix`."""
    params = variables['params']
    stats = variables.get('batch_stats', {})
    if name is not None:
        params, stats = {name: params}, {name: stats}
    sd = state_dict_from_jax({'params': {root: params},
                              'batch_stats': {root: stats}})
    assert all(k.startswith(prefix) for k in sd), list(sd)[:3]
    return {k[len(prefix):]: v for k, v in sd.items()}


def torch_net(model: TorchModel, variables):
    """The port's network holding the same weights, in eval mode."""
    net = model.build_net()
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    return net.eval()


# ---------------------------------------------------------------------------
# The JAX repository's TPU probes of B2 and B3 (tools/perf/), on the CPU
# ---------------------------------------------------------------------------

GROUPED_PROBE = os.path.join(REPO, 'tools', 'perf', 'probe_grouped_pallas.py')
GROUPED_MARKER = '# ---- parity + timing'
DMA_PROBE = os.path.join(REPO, 'tools', 'perf', 'probe_dma_pipeline.py')


def grouped_probe():
    """Generator for a module fixture: the B2 probe's namespace (its Config,
    variables, folded layers, K1 .. K5 and `grouped`), built with NB = 8 and
    every pallas_call interpreted.  The probe runs TPU code at module level
    from its `# ---- parity + timing` marker on, so only its source up to
    the marker is executed; sys.path, the environment, pallas_call and the
    JAX cache settings that its top lines change are restored after."""
    from jax.experimental import pallas as pl
    with open(GROUPED_PROBE) as f:
        src = f.read()
    src = src[:src.index(GROUPED_MARKER)]
    saved_path, saved_env = list(sys.path), dict(os.environ)
    saved_cache = (jax.config.jax_compilation_cache_dir,
                   jax.config.jax_persistent_cache_min_compile_time_secs)
    saved_call = pl.pallas_call
    os.environ['NB'] = '8'
    if saved_cache[0]:               # keep the tests' compilation cache
        os.environ['JAX_COMPILATION_CACHE_DIR'] = saved_cache[0]
    pl.pallas_call = functools.partial(saved_call, interpret=True)
    try:
        ns = {'__file__': GROUPED_PROBE, '__name__': 'probe_grouped_pallas'}
        exec(compile(src, GROUPED_PROBE, 'exec'), ns)
        yield ns
    finally:
        pl.pallas_call = saved_call
        sys.path[:] = saved_path
        os.environ.clear()
        os.environ.update(saved_env)
        jax.config.update('jax_compilation_cache_dir', saved_cache[0])
        jax.config.update('jax_persistent_cache_min_compile_time_secs',
                          saved_cache[1])


def dma_probe():
    """The B3 probe imported from its file; its import-time edits of
    sys.path and the environment are undone."""
    saved_path, saved_env = list(sys.path), dict(os.environ)
    try:
        spec = importlib.util.spec_from_file_location('probe_dma_pipeline',
                                                      DMA_PROBE)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = saved_path
        os.environ.clear()
        os.environ.update(saved_env)
    return module


# ---------------------------------------------------------------------------
# A NumPy emulation of the bfloat16 tensor-core kernels' arithmetic
# (csrc/denoiser_tc_body.cuh), driven by their packed tables
# ---------------------------------------------------------------------------

def to_bits(a):
    """float -> bfloat16 bit patterns, to nearest even."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def from_bits(u):
    return (np.asarray(u, np.uint16).astype(np.uint32) << 16).view(
        np.float32).astype(np.float64)


def bf16(a):
    return from_bits(to_bits(a))


def smem_tile(sm, off, nrows, stride):
    """A view of shared memory bytes as a (nrows, stride) bf16 tile."""
    return sm[off:off + nrows * stride * 2].view(np.uint16).reshape(
        nrows, stride)


def smem_f32(sm, off, size):
    return sm[off:off + 4 * size].view(np.float32)


def table_records(table, header, op=P.TC_OP, skip=0):
    """(header dict, op record dicts) of an int32 table: `header` fields,
    then `skip` ints, then the op records."""
    t = np.asarray(table)
    h = dict(zip(header, t[:len(header)]))
    base, no = len(header) + skip, len(op)
    return h, [dict(zip(op, t[base + i * no:base + (i + 1) * no]))
               for i in range(h['nops'])]


def tc_embed(sm, h, rows_at):
    """Every layer's embedding for the tile's rows, from the staged W_e
    and b_e and each row's silu_emb (embed_all)."""
    e, es = h['e'], h['emb_stride']
    we = from_bits(smem_tile(sm, h['embw_off'], e, es)).T
    eb = smem_f32(sm, h['embw_off'] + es * e * 2, es)
    for r, at in enumerate(rows_at):
        smem_f32(sm, h['emb_off'] + r * es * 4, es)[:] = \
            we @ smem_f32(sm, at + h['semb_off'], e) + eb


def tc_op(sm, h, o, rows_at, wb, round_g):
    """One op record (gcn_op or joint_op) over the tile's rows, from the
    constants in the weight buffer at `wb`: the products as the MMAs take
    them (f32 sums of exact bf16 products), g rounded to bf16 before the
    channel mix (`round_g`, B2) or split into bf16 hi + lo (B1), rounding
    at the kernels' points, 0 past T*V."""
    es = h['emb_stride']
    tvop, tvip = 16 * o['mt'], 16 * o['ks']
    ci, cop = o['ci'], 8 * o['nt']
    kop = from_bits(smem_tile(sm, wb + o['k'], tvop, o['k_stride'])[:, :tvip])
    for r, at in enumerate(rows_at):
        f = from_bits(smem_tile(sm, at + o['in'], tvip,
                                o['in_stride'])[:, :ci])
        g = (kop @ f).astype(np.float32)                 # (TVo_p, Ci_p)
        if o['kind'] == 0:
            w = from_bits(smem_tile(sm, wb + o['w'], cop,
                                    o['w_stride'])[:, :ci])
            if round_g:
                y = bf16(g) @ w.T
            else:
                hi = bf16(g)
                y = hi @ w.T + bf16(g - hi) @ w.T
            y = y.astype(np.float32).astype(np.float64)
            if o['res']:
                wr = from_bits(smem_tile(sm, wb + o['wr'], cop,
                                         o['w_stride'])[:, :ci])
                y = y + f[:tvop] @ wr.T
            else:
                y = y + f[:tvop, :cop]
            emb = smem_f32(sm, h['emb_off'] + (r * es + o['emb']) * 4, cop)
            y = y + smem_f32(sm, wb + o['bias'], cop)
            slope = smem_f32(sm, wb + o['slope'], 1)[0]
            y = bf16(np.where(y >= 0, y, slope * y) + emb)
        else:
            y = bf16(g * smem_f32(sm, wb + o['rs'], tvop)[:, None]
                     + smem_f32(sm, wb + o['rt'], tvop)[:, None])
            if o['skip'] >= 0:
                y = bf16(y + from_bits(smem_tile(
                    sm, at + o['skip'], tvop, o['skip_stride'])[:, :ci]))
        y[o['tvo']:] = 0
        smem_tile(sm, at + o['out'], tvop, o['out_stride'])[:, :y.shape[1]] \
            = to_bits(y)


def tc_ops(sm, h, ops, blob, rows_at, round_g, op_fn=None):
    """Every op in turn, its constants copied from the blob into the two
    weight buffers alternately; `op_fn(sm, h, o, rows_at, wb)` in place of
    `tc_op`."""
    for k, o in enumerate(ops):
        wb = h['wbuf0'] if k % 2 == 0 else h['wbuf1']
        sm[wb:wb + o['blob_bytes']] = blob[o['blob']:o['blob'] +
                                           o['blob_bytes']]
        if op_fn is None:
            tc_op(sm, h, o, rows_at, wb, round_g)
        else:
            op_fn(sm, h, o, rows_at, wb)


def emulate_tc(plan, x, semb, n0=0, round_eps=True, smem_bytes=None,
               ops=None, op_fn=None):
    """csrc/denoiser_tc.cu (B1 bfloat16) on one tile of plan.rows fold rows
    from row n0 of x (C_in, T*V, N) and silu(emb) (E, N): shared memory as
    bytes that start as NaN (0xff), the constants copied from the blob,
    x and silu_emb rounded to bf16, the ops as `tc_op`.  Returns eps
    (C_in, T*V, rows) for the rows below N: bf16(f + x), or with
    `round_eps` False f + x in float32 (csrc/denoiser_tc_dma.cu, B3).
    Another kernel on the same header gives its op records `ops` and its
    `op_fn` (`emulate_wg`)."""
    h, recs = table_records(plan.table, P.TC_HEADER)
    ops = recs if ops is None else ops
    blob = plan.blob.numpy()
    sm = np.full(smem_bytes or plan.smem_bytes, 0xff, np.uint8)
    rows, n = plan.rows, x.shape[2]
    nv = max(0, min(rows, n - n0))
    rows_at = [h['row0'] + r * h['row_bytes'] for r in range(rows)]
    cin, tva, e = h['cin'], h['tva'], h['e']
    for r, at in enumerate(rows_at):
        xt = smem_tile(sm, at + h['x_off'], h['tvap'], h['x_stride'])
        xt[:, :h['x_stride'] - 8] = 0
        if r < nv:
            xt[:tva, :cin] = to_bits(x[:, :, n0 + r].T)
        smem_f32(sm, at + h['semb_off'], e)[:] = \
            bf16(semb[:, n0 + r]) if r < nv else 0
    sm[h['embw_off']:h['embw_off'] + h['embw_bytes']] = \
        blob[h['embw_blob']:h['embw_blob'] + h['embw_bytes']]
    tc_embed(sm, h, rows_at)
    tc_ops(sm, h, ops, blob, rows_at, round_g=False, op_fn=op_fn)
    eps = np.zeros((cin, tva, nv))
    for r in range(nv):
        out = from_bits(smem_tile(sm, rows_at[r] + h['out_off'], h['tvap'],
                                  h['out_stride'])[:tva, :cin])
        x0 = from_bits(smem_tile(sm, rows_at[r] + h['x_off'], h['tvap'],
                                 h['x_stride'])[:tva, :cin])
        eps[:, :, r] = (bf16(out + x0) if round_eps else
                        (out + x0).astype(np.float32)).T
    return eps


def emulate_tc_all(plan, x, semb, **kw):
    n = x.shape[2]
    return np.concatenate([emulate_tc(plan, x, semb, n0, **kw)
                           for n0 in range(0, n, plan.rows)], axis=2)


# ---------------------------------------------------------------------------
# The warpgroup kernel (csrc/denoiser_wg.cu): W and Wr read back through
# a model of wgmma's shared-memory matrix descriptor
# ---------------------------------------------------------------------------

def wg_descriptor(addr, lbo=P.WG_LBO, sbo=P.WG_SBO):
    """wgmma's 64-bit shared-memory matrix descriptor as the kernel builds
    it (b_desc): the start address >> 4 in bits 0-13, the leading byte
    offset >> 4 in bits 16-29, the stride byte offset >> 4 in bits 32-45,
    base offset 0 and layout type 0 (no swizzle, bits 62-63)."""
    addr = int(addr)
    return ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) | ((sbo >> 4) << 32)


def wg_b_operand(sm, desc, n):
    """The (16, n) B operand (K = 16 input channels, n output channels)
    that a K-major descriptor without swizzle addresses in shared memory:
    8x8 core matrices of 16-byte rows, element (k, j) at start + (j // 8)
    stride offset + (k // 8) leading offset + (j % 8) 16 + (k % 8) 2."""
    assert desc >> 46 == 0, 'base offset and swizzle must be 0'
    start = (desc & 0x3FFF) << 4
    lbo, sbo = ((desc >> 16) & 0x3FFF) << 4, ((desc >> 32) & 0x3FFF) << 4
    k, j = np.arange(16)[:, None], np.arange(n)[None, :]
    off = start + j // 8 * sbo + k // 8 * lbo + j % 8 * 16 + k % 8 * 2
    return from_bits(sm[off].astype(np.uint16) |
                     (sm[off + 1].astype(np.uint16) << 8))


def wg_weight(sm, wb, o, off):
    """W^T or Wr^T (C_in padded, C_out padded) of an op record, chunk by
    chunk and part by part as the kernel's descriptors read it."""
    ntu = o['nt'] // o['nsplit']
    return np.block([[wg_b_operand(sm, wg_descriptor(
        wb + off + c0 // 16 * o['w_stride'] + o0 // 8 * P.WG_SBO), 8 * ntu)
        for o0 in range(0, 8 * o['nt'], 8 * ntu)]
        for c0 in range(0, o['ci'], 16)])


def wg_op(sm, h, o, rows_at, wb):
    """One op record of the warpgroup kernel over the tile's rows: the
    graph mix over the blocks of K in the op's masks only, W and Wr read
    through their descriptors, otherwise `tc_op`'s arithmetic (g split
    into bf16 hi + lo)."""
    es = h['emb_stride']
    mt, ks = o['mt'], o['ks']
    tvop, tvip = 16 * mt, 16 * ks
    ci, cop = o['ci'], 8 * o['nt']
    kop = from_bits(smem_tile(sm, wb + o['k'], tvop, o['k_stride'])[:, :tvip])
    masks = sm[wb + o['kmask']:wb + o['kmask'] + 4 * mt].view(np.int32)
    keep = (masks[:, None] >> np.arange(ks)[None, :]) & 1
    kop = kop * np.repeat(np.repeat(keep, 16, axis=0), 16, axis=1)
    for r, at in enumerate(rows_at):
        f = from_bits(smem_tile(sm, at + o['in'], tvip,
                                o['in_stride'])[:, :ci])
        g = (kop @ f).astype(np.float32)                 # (TVo_p, Ci_p)
        if o['kind'] == 0:
            wt = wg_weight(sm, wb, o, o['w'])
            hi = bf16(g)
            y = (hi @ wt + bf16(g - hi) @ wt).astype(np.float32).astype(
                np.float64)
            if o['res']:
                y = y + f[:tvop] @ wg_weight(sm, wb, o, o['wr'])
            else:
                y = y + f[:tvop, :cop]
            emb = smem_f32(sm, h['emb_off'] + (r * es + o['emb']) * 4, cop)
            y = y + smem_f32(sm, wb + o['bias'], cop)
            slope = smem_f32(sm, wb + o['slope'], 1)[0]
            y = bf16(np.where(y >= 0, y, slope * y) + emb)
        else:
            y = bf16(g * smem_f32(sm, wb + o['rs'], tvop)[:, None]
                     + smem_f32(sm, wb + o['rt'], tvop)[:, None])
            if o['skip'] >= 0:
                y = bf16(y + from_bits(smem_tile(
                    sm, at + o['skip'], tvop, o['skip_stride'])[:, :ci]))
        y[o['tvo']:] = 0
        smem_tile(sm, at + o['out'], tvop, o['out_stride'])[:, :y.shape[1]] \
            = to_bits(y)


def emulate_wg(plan, x, semb, n0=0):
    """csrc/denoiser_wg.cu on one tile of plan.rows fold rows from row n0,
    as `emulate_tc` with the ops as `wg_op`; eps (C_in, T*V, rows) for the
    rows below N."""
    ops = table_records(plan.table, P.TC_HEADER, P.WG_OP)[1]
    return emulate_tc(plan, x, semb, n0, ops=ops, op_fn=wg_op)


def emulate_wg_all(plan, x, semb):
    n = x.shape[2]
    return np.concatenate([emulate_wg(plan, x, semb, n0)
                           for n0 in range(0, n, plan.rows)], axis=2)


# ---------------------------------------------------------------------------
# The float32 warpgroup kernel (csrc/denoiser_wg_f32.cu): 3xTF32, W and Wr
# hi and lo read back through a model of wgmma's TF32 descriptor
# ---------------------------------------------------------------------------

def tf32_operand(a):
    """What a TF32 MMA reads of a float32 register: its top 19 bits (the
    low 13 bits of the mantissa ignored)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return (u & np.uint32(0xffffe000)).view(np.float32).astype(np.float64)


def tf32_kernel_split(a):
    """a -> (hi, lo) as the kernel splits an operand in registers and the
    MMA reads them: hi = a with the low 13 mantissa bits cleared, lo = a -
    hi exact in float32, truncated by the MMA."""
    a = np.asarray(a, np.float32)
    hi = tf32_operand(a)
    return hi, tf32_operand((a - hi).astype(np.float32))


def k_unfragment(frags):
    """(mt, ks, 2, 32, 4) mma.m16n8k8 TF32 A fragments -> K hi and lo
    (16 mt, 8 ks): a lane's four registers are rows g, g + 8, g, g + 8 and
    columns t, t, t + 4, t + 4 (g = lane / 4, t = lane % 4)."""
    mt, ks = frags.shape[:2]
    lane = np.arange(32)
    gid, tig = lane >> 2, lane & 3
    rows = np.stack([gid, gid + 8, gid, gid + 8], axis=1)
    cols = np.stack([tig, tig, tig + 4, tig + 4], axis=1)
    out = np.full((2, 16 * mt, 8 * ks), np.nan, np.float32)
    for i in range(mt):
        for s in range(ks):
            for part in range(2):
                out[part, 16 * i + rows, 8 * s + cols] = frags[i, s, part]
    return out[0], out[1]


def wg32_b_operand(sm, desc, n):
    """The (8, n) TF32 B operand (K = a k-step's 8 logical input columns,
    n output channels) that a K-major descriptor without swizzle addresses
    in shared memory: 8x4 core matrices of 16-byte rows, element (k, j) at
    start + (j // 8) stride offset + (k // 4) leading offset + (j % 8) 16
    + (k % 4) 4."""
    assert desc >> 46 == 0, 'base offset and swizzle must be 0'
    start = (desc & 0x3FFF) << 4
    lbo, sbo = ((desc >> 16) & 0x3FFF) << 4, ((desc >> 32) & 0x3FFF) << 4
    k, j = np.arange(8)[:, None], np.arange(n)[None, :]
    off = start + j // 8 * sbo + k // 4 * lbo + j % 8 * 16 + k % 4 * 4
    u = sum(sm[off + b].astype(np.uint32) << (8 * b) for b in range(4))
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def wg32_weight(sm, wb, o, key):
    """W^T or Wr^T (input channels C0 .. C1, C_out padded) of an op record
    as the kernel's descriptors read its hi or lo half (`key`), k-step by
    k-step and part by part, each k-step's logical columns put back at
    their input channels (P.WG32_PERM)."""
    ntu = o['nt'] // o['nsplit']
    width, cop = o['c1'] - o['c0'], 8 * o['nt']
    out = np.full((width, cop), np.nan)
    for q in range(width // 8):
        for o0 in range(0, cop, 8 * ntu):
            b = wg32_b_operand(sm, wg_descriptor(
                wb + o[key] + q * o['w_step'] + o0 // 8 * P.WG_SBO), 8 * ntu)
            out[8 * q + np.array(P.WG32_PERM), o0:o0 + 8 * ntu] = b
    return out


WG32_TERMS = ('lo_hi', 'hi_lo', 'hi_hi')


def wg32_product(ah, al, bh, bl, terms=WG32_TERMS):
    """A B as the kernel's wgmmas take it: the `terms` of a_lo b_hi + a_hi
    b_lo + a_hi b_hi (exact products of TF32 values, summed)."""
    parts = {'lo_hi': (al, bh), 'hi_lo': (ah, bl), 'hi_hi': (ah, bh)}
    return sum(a @ b for a, b in (parts[t] for t in terms))


def emulate_wg32(plan, x, semb, n0=0, terms=WG32_TERMS):
    """csrc/denoiser_wg_f32.cu on one tile of plan.rows fold rows from
    row n0 of x (C_in, T*V, N) and silu(emb) (E, N): shared memory as
    bytes that start as NaN (0xff), each record's constants copied from
    the blob into the two weight buffers in turn, every layer's embedding
    from the blob's W_e^T and b_e, activations as float32 (T*V, C) tiles
    through the table's offsets and strides; the graph mixes as 3xTF32
    over the 8-position blocks of K in the record's masks only (K's hi and
    lo as the host split them, f split as the kernel splits it); the
    channel and residual mixes with g and f split as the kernel splits
    them, W and Wr hi and lo read through their descriptors, the `terms`
    of each product (all three: `WG32_TERMS`), summed over a run's records
    in one accumulator; the epilogue after a run's last record.  Returns
    eps (C_in, T*V, rows) for the rows below N."""
    h, ops = table_records(plan.table, P.WG32_HEADER, P.WG32_OP)
    blob = plan.blob.numpy()
    sm = np.full(plan.smem_bytes, 0xff, np.uint8)
    rows, n = plan.rows, x.shape[2]
    nv = max(0, min(rows, n - n0))

    def tile(off, nrows, stride):
        return smem_f32(sm, off, nrows * stride).reshape(nrows, stride)

    def row(r):
        return h['row0'] + r * h['row_bytes']

    cin, tva, e, es = h['cin'], h['tva'], h['e'], h['emb_stride']
    for r in range(rows):
        xt = tile(row(r) + h['x_off'], h['tvap'], h['x_stride'])
        xt[:, :h['x_stride'] - 8] = 0
        if r < nv:
            xt[:tva, :cin] = x[:, :, n0 + r].T
        smem_f32(sm, row(r) + h['semb_off'], e)[:] = \
            semb[:, n0 + r] if r < nv else 0
    emb_blob = blob[h['embw_blob']:].view(np.float32)
    we, eb = emb_blob[:e * es].reshape(e, es), emb_blob[e * es:e * es + es]
    for r in range(rows):
        smem_f32(sm, h['emb_off'] + r * es * 4, es)[:] = \
            we.T.astype(np.float64) @ smem_f32(sm, row(r) + h['semb_off'],
                                               e) + eb
    acc = None
    for k, o in enumerate(ops):
        wb = h['wbuf0'] if k % 2 == 0 else h['wbuf1']
        sm[wb:wb + o['blob_bytes']] = \
            blob[o['blob']:o['blob'] + o['blob_bytes']]
        mt, ks, p0 = o['mt'], o['ks'], o['p0']
        tvop = 16 * mt
        pos = slice(p0, p0 + tvop)          # the run's output positions
        khi, klo = k_unfragment(smem_f32(sm, wb + o['k'], mt * ks * 256)
                                .reshape(mt, ks, 2, 32, 4))
        masks = smem_f32(sm, wb + o['kmask'], mt).view(np.int32)
        keep = np.repeat(np.repeat(
            (masks[:, None] >> np.arange(ks)[None, :]) & 1, 16, axis=0), 8,
            axis=1)
        khi = khi.astype(np.float64) * keep
        klo = tf32_operand(klo) * keep
        if o['kind'] == 1:
            c = o['ci']
            rs = smem_f32(sm, wb + o['rs'], p0 + tvop)[pos, None]
            rt = smem_f32(sm, wb + o['rt'], p0 + tvop)[pos, None]
            for r in range(rows):
                f = tile(row(r) + o['in'], 8 * ks, o['in_stride'])
                fh, fl = tf32_kernel_split(f[:, :c])
                g = (klo @ fh + khi @ fl + khi @ fh).astype(np.float32)
                y = g * rs + rt
                if o['skip'] >= 0:
                    y = y + tile(row(r) + o['skip'], p0 + tvop,
                                 o['skip_stride'])[pos, :c]
                y[max(0, o['tvo'] - p0):] = 0
                tile(row(r) + o['out'], p0 + tvop,
                     o['out_stride'])[pos, :c] = y
            continue
        c0, c1, cop = o['c0'], o['c1'], 8 * o['nt']
        if c0 == 0:
            acc = np.zeros((rows, tvop, cop))
        wh, wl = wg32_weight(sm, wb, o, 'w'), wg32_weight(sm, wb, o, 'w_lo')
        if o['res']:
            wrh = wg32_weight(sm, wb, o, 'wr')
            wrl = wg32_weight(sm, wb, o, 'wr_lo')
        for r in range(rows):
            f = tile(row(r) + o['in'], max(8 * ks, p0 + tvop),
                     o['in_stride'])
            fh, fl = tf32_kernel_split(f[:8 * ks, c0:c1])
            g = (klo @ fh + khi @ fl + khi @ fh).astype(np.float32)
            gh, gl = tf32_kernel_split(g)
            acc[r] += wg32_product(gh, gl, wh, wl, terms)
            if o['res']:
                ah, al = tf32_kernel_split(f[pos, c0:c1])
                acc[r] += wg32_product(ah, al, wrh, wrl, terms)
        if c1 < o['ci']:
            continue
        bias = smem_f32(sm, wb + o['bias'], cop)
        slope = smem_f32(sm, wb + o['slope'], 1)[0]
        for r in range(rows):
            f = tile(row(r) + o['in'], max(8 * ks, p0 + tvop),
                     o['in_stride'])
            y = acc[r].astype(np.float32).astype(np.float64)
            if not o['res']:
                y = y + f[pos, :cop]
            y = (y + bias).astype(np.float32)
            y = np.where(y >= 0, y, slope * y) + \
                smem_f32(sm, h['emb_off'] + (r * es + o['emb']) * 4, cop)
            y[max(0, o['tvo'] - p0):] = 0
            tile(row(r) + o['out'], p0 + tvop, o['out_stride'])[pos, :cop] \
                = y
    eps = np.zeros((cin, tva, nv), np.float32)
    for r in range(nv):
        out = tile(row(r) + h['out_off'], h['tvap'], h['out_stride'])
        x0 = tile(row(r) + h['x_off'], h['tvap'], h['x_stride'])
        eps[:, :, r] = (out[:tva, :cin] + x0[:tva, :cin]).T
    return eps


def emulate_wg32_all(plan, x, semb, **kw):
    n = x.shape[2]
    return np.concatenate([emulate_wg32(plan, x, semb, n0, **kw)
                           for n0 in range(0, n, plan.rows)], axis=2)
