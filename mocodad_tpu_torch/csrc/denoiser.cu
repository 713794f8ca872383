// Eval-mode STSAEUnet denoiser forward, one thread block per tile of fold
// rows, for NVIDIA Hopper (sm_90a), in float32 and in bfloat16.
//
// Replaces: mocodad_tpu/ops/pallas_unet.py:build_pallas_denoiser (the inner
// `kernel`, :141-204), kernel B1 of the JAX package.  It computes the same
// function on the same folded constants, in the same layer order and with
// the same association: in every ST-GCNN layer the graph operator K^T is
// applied first, then the channel mix W (BN scale folded in), plus the
// residual (a folded 1x1 conv + BN, or identity), the folded bias, PReLU
// with one shared slope, and W_e silu(emb) + b_e.  The four joint
// re-scalings are a block-diagonal (T*V_out x T*V_in) operator, one
// (V_out x V_in) block per frame, plus a per-row affine; then the skip adds
// of d1 and d2, and + x at the end.  Accumulation is float32.
//
// Two entry points, one template:
//   mocodad_denoiser_launch_f32   x, silu_emb, eps float32; float32
//                                 matrices; no rounding (B1 at
//                                 compute_dtype float32).
//   mocodad_denoiser_launch_bf16  x and eps bfloat16, silu_emb float32,
//                                 bfloat16 matrices; rounds to bfloat16 at
//                                 B1's cast points (pallas_unet.py:157-204):
//                                 x and silu_emb on load, every layer and
//                                 joint output, every skip add, and eps.
//                                 The graph-mixed g stays float32 (JAX's
//                                 bf16 x f32 channel mix promotes).
//
// Contract: eps = denoise(x, silu_emb, folded)
//   x        (C_in, T*V, N)  contiguous
//   silu_emb (E, N)          float32, contiguous
//   eps      (C_in, T*V, N)  contiguous, x's type
//   mats     the folded matrices (float32 or bfloat16), vecs the folded
//            biases, slopes and affines (float32); `table` (int32) holds the
//            op sequence, the shapes, the offsets into both and the
//            shared-memory plan (mocodad_tpu_torch/ops/pallas_unet.py
//            pack_for_kernel).  Any N, including a ragged last tile: rows
//            past N are read as 0 and never written.
//
// What bounds it: at the flagship shapes (C_in 2, T 3, V 17 -> 12 -> 10,
// channels up to 128, E 16) one fold row costs 5.28 MFLOP (the joint
// re-scalings counted without their zero blocks) and moves under 1 KB of
// input and output.  In float32 a call is bound by arithmetic at the H100
// SXM's 67 TFLOP/s outside the tensor cores: about 4.0 ms for N = 51,200.
// In bfloat16 the same products are what the tensor cores compute, so the
// least time is over 989 TFLOP/s: about 0.27 ms.  This kernel uses no
// tensor cores, so its bfloat16 variant runs at the float32 rate and
// saves only weight bytes.  chip_smoke.py recomputes both bounds.
//
// Design (right and simple first; no wgmma or TMA yet), in
// denoiser_body.cuh:
//   * kRows = 4 fold rows per block, 256 threads.  Every activation lives
//     in dynamic shared memory as float4 vectors over the 4 rows.  At the
//     flagship shapes the plan takes 226,656 of the 232,448 bytes a block
//     may use: one block per SM.  The bfloat16 variant keeps the arena in
//     float32, holding rounded values.
//   * The host plans the arena (x, silu_emb, the per-layer embedding, the
//     skips d1 and d2, and a work area whose layer input, graph-mixed
//     intermediate and output alternate between its two ends), so nothing
//     is copied between layers.
//   * The folded matrices (352 KB in float32, 176 KB in bfloat16) are read
//     through the read-only path and stay resident in the 50 MB L2.  They
//     are stored transposed and zero-padded to a multiple of 4 outputs, so
//     one thread loads 4 output rows of a weight column in one load.
//   * Products are plain FMA loops with float32 accumulators; each thread
//     owns 4 outputs x 4 rows.  A joint re-scaling's thread walks only the
//     input frames of its 4 outputs, so the zero blocks are skipped.
//   * The known cost: with 226 KB of shared memory per block, L1 keeps
//     little of a layer's weights, so weight loads come from L2 and one
//     block of 8 warps per SM hides their latency poorly.  Measured
//     (chip_smoke.py, H100 SXM): about 19 ms per call at N = 51,200 in
//     either type, 14 TFLOP/s, 21 % of the float32 bound and 1.4 % of the
//     bfloat16 one.

#include "denoiser_body.cuh"

namespace mocodad {
namespace {

template <typename IT, typename WT>
__global__ void __launch_bounds__(kThreads, 1)
denoiser_kernel(const IT* __restrict__ x, const float* __restrict__ semb,
                const WT* __restrict__ mats, const float* __restrict__ vecs,
                const int* __restrict__ table, IT* __restrict__ eps, int n) {
  extern __shared__ float4 sm[];
  const IT* ins[kMaxIn] = {x, nullptr};
  IT* outs[kMaxOut] = {eps, nullptr};
  tile_forward<IT, float, IT, WT, false>(threadIdx.x, sm, table, ins, semb,
                                         outs, mats, vecs, n,
                                         blockIdx.x * kRows);
}

template <typename IT, typename WT>
int launch(const IT* x, const float* semb, const WT* mats, const float* vecs,
           const int* table, IT* eps, int n, int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      denoiser_kernel<IT, WT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kRows - 1) / kRows;
  denoiser_kernel<IT, WT><<<blocks, kThreads, smem_bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      x, semb, mats, vecs, table, eps, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mocodad

// Launch on `stream`; each returns the CUDA error code (0 on success).
// Nothing is allocated and nothing is synchronised here.
extern "C" int mocodad_denoiser_launch_f32(const float* x, const float* semb,
                                           const float* mats,
                                           const float* vecs,
                                           const int* table, float* eps,
                                           int n, int smem_bytes,
                                           void* stream) {
  return mocodad::launch(x, semb, mats, vecs, table, eps, n, smem_bytes,
                         stream);
}

extern "C" int mocodad_denoiser_launch_bf16(const mocodad::bf16* x,
                                            const float* semb,
                                            const mocodad::bf16* mats,
                                            const float* vecs,
                                            const int* table,
                                            mocodad::bf16* eps, int n,
                                            int smem_bytes, void* stream) {
  return mocodad::launch(x, semb, mats, vecs, table, eps, n, smem_bytes,
                         stream);
}

extern "C" int mocodad_denoiser_rows_per_block() { return mocodad::kRows; }

// The table format this build reads: its header length and its op record
// length.  The host's packer checks both before the first launch.
extern "C" int mocodad_denoiser_header_len() { return mocodad::H_LEN; }
extern "C" int mocodad_denoiser_op_len() { return mocodad::O_LEN; }
