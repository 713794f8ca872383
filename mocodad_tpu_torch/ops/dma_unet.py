"""The DMA-pipelined denoiser (B3): one persistent block per SM that walks
the tiles with the next tile's inputs prefetched.

Counterpart of `tools/perf/probe_dma_pipeline.py`
(`build_dma_pipelined_denoiser`, :39-238), a TPU probe of the JAX
repository: B1's body in one program that walks the batch chunks with
2-slot manual DMAs.  The function is B1's at the compute dtype (float32,
or bfloat16 with float32 accumulation), except that eps is float32
whatever the compute dtype (its output buffer and `out_shape` are float32,
:225, :230).  x and silu(emb) are float32, as the probe feeds them.

`dma_reference` is the plain PyTorch version; `DMA_PIPELINED` (bfloat16,
the probe's default) and `DMA_PIPELINED_F32` wrap `csrc/denoiser_dma.cu`.
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
    """Wrapper of `csrc/denoiser_dma.cu` at one compute dtype: float32 x
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


DMA_PIPELINED = DmaPipelinedKernel(torch.bfloat16)
DMA_PIPELINED_F32 = DmaPipelinedKernel(torch.float32)


def denoise_dma(x_ctn: torch.Tensor, silu_emb_en: torch.Tensor,
                folded: P.FoldedDenoiser,
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """B3's eps at `compute_dtype`: the plain version for a CPU tensor, the
    kernel for a CUDA tensor."""
    if x_ctn.device.type == 'cpu':
        return dma_reference(x_ctn, silu_emb_en, folded, compute_dtype)
    if x_ctn.device.type == 'cuda':
        kernel = {torch.bfloat16: DMA_PIPELINED,
                  torch.float32: DMA_PIPELINED_F32}[compute_dtype]
        return kernel(x_ctn, silu_emb_en, folded)
    raise ValueError(f'no DMA-pipelined denoiser for device {x_ctn.device}')
