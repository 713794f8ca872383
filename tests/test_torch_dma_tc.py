"""B3 on the tensor cores: at bfloat16 `csrc/denoiser_tc_dma.cu`, B1
bfloat16's tensor-core body on its plan with B3's I/O (float32 x rounded on
entry, float32 eps not rounded), as a NumPy emulation driven by what
`pack_dma_tc` packs, against the plain version `dma_reference` and the JAX
repository's probe `build_dma_pipelined_denoiser` in interpret mode; at
float32 `csrc/denoiser_tc_f32.cu`'s kernel through an entry point of B3's
own.  Also the plan, the table format and the routing of a CPU tensor."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (bf16, bf16_stats, dma_probe, emulate_tc_all,
                         jax_model, seeded_variables, torch_model, torch_net)
from mocodad_tpu_torch.ops import build
from mocodad_tpu_torch.ops import dma_unet as D
from mocodad_tpu_torch.ops import pallas_unet as P

torch.set_num_threads(1)

# bfloat16 on both sides at B1's rounding points, sums in another order;
# eps is float32, so its last rounding is not there to flip: against the
# JAX probe tests/test_torch_dma.py's bounds, against the plain version
# chip_smoke.py's
JAX_MAX_REL, JAX_MEAN_REL = 1.5e-2, 1e-3
PLAIN_MAX_REL, PLAIN_MEAN_REL = 3e-2, 1e-3


@pytest.fixture(scope='module')
def weights():
    jm = jax_model()
    variables = seeded_variables(jm, seed=7)
    tm = torch_model()
    folded = tm.fold(torch_net(tm, variables))
    return variables, folded, D.pack_dma_tc(folded)


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 51, n)).astype(np.float32)
    s = rng.standard_normal((16, n)).astype(np.float32)
    return x, (s / (1 + np.exp(-s))).astype(np.float32)     # silu


def _emulate(plan, x, semb):
    """The kernel's tiles: B1 bfloat16's emulation on the plan in B3's
    shared memory (the slot after B1's), eps = f + x unrounded."""
    return emulate_tc_all(plan.kernel, x, semb, round_eps=False,
                          smem_bytes=plan.smem_bytes)


@pytest.mark.parametrize('n', [16, 13], ids=['aligned', 'ragged'])
def test_tc_emulation_matches_plain_version_and_probe(weights, n):
    variables, folded, plan = weights
    x, semb = _inputs(n, seed=n + 50)
    got = _emulate(plan, x, semb)
    assert got.shape == (2, 51, n) and np.isfinite(got).all()
    # eps is not rounded to bfloat16
    assert not np.array_equal(got, bf16(got))
    want = D.dma_reference(torch.from_numpy(x), torch.from_numpy(semb),
                           folded, compute_dtype=torch.bfloat16)
    max_rel, mean_rel = bf16_stats(got, want.numpy())
    assert max_rel <= PLAIN_MAX_REL and mean_rel <= PLAIN_MEAN_REL, \
        (max_rel, mean_rel)
    fn = dma_probe().build_dma_pipelined_denoiser(
        variables['params']['model'], variables['batch_stats']['model'],
        c_in=2, n_frames=3, n_joints=17, embedding_dim=16, nb=8,
        compute_dtype=jnp.bfloat16, interpret=True)
    jx = fn(jnp.asarray(x), jnp.asarray(semb))
    assert jx.dtype == jnp.float32
    max_rel, mean_rel = bf16_stats(got, np.asarray(jx))
    assert max_rel <= JAX_MAX_REL and mean_rel <= JAX_MEAN_REL, \
        (max_rel, mean_rel)


def test_plan_is_b1s_plus_the_slot(weights):
    """B1 bfloat16's plan byte for byte, then a slot for the next tile's
    x and silu_emb (TC_ROWS x (C_in T*V + E) float32), inside what a block
    may use beside the kernel's table."""
    _, folded, plan = weights
    b1 = P.pack_for_tc_kernel(folded)
    assert torch.equal(plan.kernel.blob, b1.blob)
    assert torch.equal(plan.kernel.table, b1.table)
    assert plan.slot_off == b1.smem_bytes and plan.slot_off % 16 == 0
    assert plan.smem_bytes - plan.slot_off >= P.TC_ROWS * (2 * 51 + 16) * 4
    assert plan.smem_bytes + 4 * P.TC_MAX_TABLE <= P.MAX_SMEM_BYTES


def test_table_format_matches_the_source():
    """denoiser_tc_dma.cu reads B1 bfloat16's table: the same enums, rows
    and warps as denoiser_tc.cu."""
    with open(f'{build.CSRC_DIR}/denoiser_tc_dma.cu') as f:
        src = f.read()

    def enum(first):
        body = re.search(r'enum \{\s*(' + first + r'\b.*?)\};', src,
                         re.S).group(1)
        body = re.sub(r'//[^\n]*', '', body)
        return [t.strip() for t in body.split(',') if t.strip()]

    assert enum('H_NOPS') == ['H_' + k.upper() for k in P.TC_HEADER] + \
        ['H_LEN']
    assert enum('O_KIND') == ['O_' + k.upper() for k in P.TC_OP] + ['O_LEN']
    for name, want in (('kRows', P.TC_ROWS), ('kWarps', P.TC_WARPS),
                       ('kMaxTable', P.TC_MAX_TABLE)):
        assert re.search(name + r' = (\d+);', src).group(1) == str(want)


def test_f32_binds_the_3xtf32_kernel_under_its_own_name(weights):
    """DMA_PIPELINED_F32 launches denoiser_tc_f32.cu's kernel (B1
    float32 on mma.sync, the warpgroup kernel's yardstick) on its plan
    through mocodad_dma_tc32_launch, and counts apart from that kernel's
    wrapper."""
    _, folded, _ = weights
    k, b1 = D.DMA_PIPELINED_F32, P.DENOISER_F32_MMA
    assert k.source == b1.source == 'denoiser_tc_f32.cu'
    assert k.symbol == 'mocodad_dma_tc32_launch' != b1.symbol
    assert k is not b1 and k.constants() == b1.constants()
    assert k.plan(folded, 'cpu') is P.tc32_plan(folded, 'cpu')
    with open(f'{build.CSRC_DIR}/denoiser_tc_f32.cu') as f:
        assert f'extern "C" int {k.symbol}(' in f.read()


def test_cpu_tensor_goes_to_the_plain_version(weights):
    _, folded, _ = weights
    x, semb = _inputs(5, seed=51)
    xt, st = torch.from_numpy(x), torch.from_numpy(semb)
    kernels = (D.DMA_PIPELINED, D.DMA_PIPELINED_F32, D.DMA_PIPELINED_FMA,
               D.DMA_PIPELINED_F32_FMA, P.DENOISER, P.DENOISER_BF16)
    before = [k.launches for k in kernels]
    for dtype in (torch.bfloat16, torch.float32):
        got = D.denoise_dma(xt, st, folded, compute_dtype=dtype)
        assert torch.equal(got, D.dma_reference(xt, st, folded, dtype))
    assert [k.launches for k in kernels] == before
    assert D.DMA_PIPELINED.source == 'denoiser_tc_dma.cu'
    assert D.DMA_PIPELINED_FMA.source == 'denoiser_dma.cu'
    for k in kernels[:4]:
        with pytest.raises(ValueError, match='CUDA tensor'):
            k(xt, st, folded)
