"""The DMA-pipelined denoiser (B3): one persistent block per SM that walks
the tiles with the next tile's inputs prefetched.

Counterpart of `tools/perf/probe_dma_pipeline.py`
(`build_dma_pipelined_denoiser`, :39-238), a TPU probe of the JAX
repository: B1's body in one program that walks the batch chunks with
2-slot manual DMAs.  The function is B1's at the compute dtype (float32,
or bfloat16 with float32 accumulation), except that eps is float32
whatever the compute dtype (its output buffer and `out_shape` are float32,
:225, :230).  x and silu(emb) are float32, as the probe feeds them.

`dma_reference` is the plain PyTorch version.  The kernels run on the
tensor cores: `DMA_PIPELINED` (bfloat16, the probe's default) wraps
`csrc/denoiser_tc_dma.cu`, B1 bfloat16's tensor-core body on its plan with
B3's I/O and a prefetch slot; `DMA_PIPELINED_F32` is
`csrc/denoiser_tc_f32.cu`'s kernel (B1 float32, 3xTF32, which already walks
the tiles in persistent blocks with the next tile prefetched) through an
entry point of B3's own.  `DMA_PIPELINED_FMA` and `DMA_PIPELINED_F32_FMA`
wrap `csrc/denoiser_dma.cu`, the FMA design kept as their yardstick.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from mocodad_tpu_torch.ops import pallas_unet as P


@torch.no_grad()
def dma_reference(x_ctn: torch.Tensor, silu_emb_en: torch.Tensor,
                  folded: P.FoldedDenoiser,
                  compute_dtype: torch.dtype = torch.bfloat16
                  ) -> torch.Tensor:
    """B3's function: B1's body at `compute_dtype`, x rounded to it on
    entry, eps float32 (probe_dma_pipeline.py:131-149, :167)."""
    return P.forward_reference(x_ctn, silu_emb_en, folded, compute_dtype)


@dataclass
class DmaPlan:
    kernel: P.KernelPlan             # B1's constants and table
    stage_off: int                   # float4 offset of the prefetch slot
    smem_bytes: int                  # arena + slot

    def to(self, device) -> 'DmaPlan':
        return DmaPlan(self.kernel.to(device), self.stage_off,
                       self.smem_bytes)


def pack_dma(folded: P.FoldedDenoiser, dtype: torch.dtype) -> DmaPlan:
    """B1's plan plus one prefetch slot after its arena: the next tile's x
    (C_in * T*V float4s, unpadded) and silu(emb) (E float4s).  Raises if
    the two do not fit in one block's shared memory."""
    plan = P.pack_for_kernel(folded, dtype)
    tva = folded.gcn[0].k2.shape[0]
    slot = folded.c_in * tva + folded.embedding_dim
    smem_bytes = (plan.arena + slot) * 16
    P.check_smem('DMA-pipelined denoiser', smem_bytes)
    return DmaPlan(plan, plan.arena, smem_bytes)


def dma_plan(folded: P.FoldedDenoiser, device, dtype) -> DmaPlan:
    return P.cached_plan(folded, ('dma', dtype), device,
                         lambda: pack_dma(folded, dtype))


class DmaPipelinedKernel:
    """Wrapper of `csrc/denoiser_dma.cu`, the FMA design, at one compute
    dtype: float32 x
    and silu(emb) -> float32 eps, one launch of one block per SM.
    `launches` counts the kernel launches this process made through it,
    and nothing else."""

    source = 'denoiser_dma.cu'

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype
        self.launches = 0
        self._fn = None

    def load(self):
        if self._fn is None:
            lib = P.load_library(self.source, 'mocodad_dma', {
                'header_len': P._H_LEN, 'op_len': len(P._O_FIELDS)})
            suffix = {torch.float32: 'f32', torch.bfloat16: 'bf16'}[
                self.dtype]
            self._fn = P.bind(lib, f'mocodad_dma_launch_{suffix}', 6, 4)
        return self._fn

    def __call__(self, x_ctn: torch.Tensor, silu_emb_en: torch.Tensor,
                 folded: P.FoldedDenoiser) -> torch.Tensor:
        n = P.check_fold_inputs(x_ctn, silu_emb_en, folded, torch.float32,
                                torch.float32)
        dev = x_ctn.device
        out = torch.empty_like(x_ctn)
        if n == 0:
            return out
        plan = dma_plan(folded, dev, self.dtype)
        tiles = -(-n // P.KERNEL_ROWS)
        grid = min(torch.cuda.get_device_properties(dev).multi_processor_count,
                   tiles)
        fn = self.load()
        k = plan.kernel
        with torch.cuda.device(dev):
            err = fn(x_ctn.data_ptr(), silu_emb_en.data_ptr(),
                     k.mats.data_ptr(), k.vecs.data_ptr(), k.table.data_ptr(),
                     out.data_ptr(), n, grid, plan.stage_off,
                     plan.smem_bytes, P.current_stream(dev))
        if err != 0:
            raise RuntimeError(f'DMA-pipelined kernel launch failed: CUDA '
                               f'error {err}')
        self.launches += 1
        return out


DMA_PIPELINED_FMA = DmaPipelinedKernel(torch.bfloat16)
DMA_PIPELINED_F32_FMA = DmaPipelinedKernel(torch.float32)


@dataclass
class TcDmaPlan:
    kernel: P.TcPlan                 # B1 bfloat16's constants and table
    slot_off: int                    # bytes: the prefetch slot
    smem_bytes: int                  # B1's plan + the slot

    def to(self, device) -> 'TcDmaPlan':
        return TcDmaPlan(self.kernel.to(device), self.slot_off,
                         self.smem_bytes)


def pack_dma_tc(folded: P.FoldedDenoiser) -> TcDmaPlan:
    """B1 bfloat16's tensor-core plan (`P.pack_for_tc_kernel`), unchanged,
    plus one prefetch slot after its shared memory: the next tile's x and
    silu(emb), TC_ROWS x (C_in * T*V + E) float32.  Raises if they do not
    fit one block's shared memory beside the kernel's table."""
    plan = P.pack_for_tc_kernel(folded, P.TC_ROWS)
    tva = folded.gcn[0].k2.shape[0]
    slot = -(-P.TC_ROWS * (folded.c_in * tva + folded.embedding_dim) * 4
             // 16) * 16
    smem_bytes = plan.smem_bytes + slot
    P.check_smem('DMA-pipelined tensor-core denoiser',
                 smem_bytes + 4 * P.TC_MAX_TABLE)
    return TcDmaPlan(plan, plan.smem_bytes, smem_bytes)


def dma_tc_plan(folded: P.FoldedDenoiser, device) -> TcDmaPlan:
    return P.cached_plan(folded, ('dma_tc',), device,
                         lambda: pack_dma_tc(folded))


class TensorCoreDmaKernel(P.TensorCoreDenoiserKernel):
    """Wrapper of `csrc/denoiser_tc_dma.cu`, B3 at bfloat16 on the tensor
    cores: float32 x and silu(emb) -> float32 eps, one launch of one block
    per SM.  `launches` counts the kernel launches this process made
    through it, and nothing else."""

    source = 'denoiser_tc_dma.cu'
    symbol = 'mocodad_dma_tc_launch'
    prefix = 'mocodad_dma_tc'
    dtype = torch.float32            # of x and eps; the compute is bfloat16

    def constants(self):
        """B1 bfloat16's table format, built for TC_ROWS rows per tile
        only."""
        return {'rows_per_block': P.TC_ROWS, 'warps_per_block': P.TC_WARPS,
                'max_table': P.TC_MAX_TABLE, 'header_len': len(P.TC_HEADER),
                'op_len': len(P.TC_OP)}

    def plan(self, folded: P.FoldedDenoiser, device) -> TcDmaPlan:
        return dma_tc_plan(folded, device)

    def load(self):
        if self._fn is None:
            lib = P.load_library(self.source, self.prefix, self.constants())
            self._fn = P.bind(lib, self.symbol, 5, 3)
        return self._fn

    def __call__(self, x_ctn: torch.Tensor, silu_emb_en: torch.Tensor,
                 folded: P.FoldedDenoiser) -> torch.Tensor:
        n = P.check_fold_inputs(x_ctn, silu_emb_en, folded, torch.float32,
                                torch.float32)
        dev = x_ctn.device
        out = torch.empty_like(x_ctn)
        if n == 0:
            return out
        plan = self.plan(folded, dev)
        fn = self.load()
        with torch.cuda.device(dev):
            err = fn(x_ctn.data_ptr(), silu_emb_en.data_ptr(),
                     plan.kernel.blob.data_ptr(),
                     plan.kernel.table.data_ptr(), out.data_ptr(), n,
                     plan.slot_off, plan.smem_bytes, P.current_stream(dev))
        if err != 0:
            raise RuntimeError(f'{self.source} kernel launch failed: CUDA '
                               f'error {err}')
        self.launches += 1
        return out


class TensorCoreF32DmaKernel(P.TensorCoreF32DenoiserKernel):
    """B3 at float32 on the tensor cores: `csrc/denoiser_tc_f32.cu`'s
    kernel on its plan (B3's function at float32 is B1's), through the
    entry point `mocodad_dma_tc32_launch`.  `launches` counts the launches
    this process made through it, apart from B1's, and nothing else."""

    symbol = 'mocodad_dma_tc32_launch'


DMA_PIPELINED = TensorCoreDmaKernel()
DMA_PIPELINED_F32 = TensorCoreF32DmaKernel()


def denoise_dma(x_ctn: torch.Tensor, silu_emb_en: torch.Tensor,
                folded: P.FoldedDenoiser,
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """B3's eps at `compute_dtype`: the plain version for a CPU tensor, the
    tensor-core kernel for a CUDA tensor."""
    if x_ctn.device.type == 'cpu':
        return dma_reference(x_ctn, silu_emb_en, folded, compute_dtype)
    if x_ctn.device.type == 'cuda':
        kernel = {torch.bfloat16: DMA_PIPELINED,
                  torch.float32: DMA_PIPELINED_F32}[compute_dtype]
        return kernel(x_ctn, silu_emb_en, folded)
    raise ValueError(f'no DMA-pipelined denoiser for device {x_ctn.device}')
