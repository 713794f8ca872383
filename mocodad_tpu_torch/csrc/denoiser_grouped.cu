// The eval-mode STSAEUnet denoiser as five layer-group kernels, bfloat16,
// for NVIDIA Hopper (sm_90a).
//
// Replaces: tools/perf/probe_grouped_pallas.py:make_kernel / grouped
// (:111-218, `pallas_call` :141), kernel B2 of the JAX repository.  The
// same function as B1 (denoiser.cu) in five launches, with the activations
// between groups in global memory in bfloat16:
//   K1  p1a, d1_0, d1_1, down1          x       -> d1, f1
//   K2  d2_0, d2_1, down2               f1      -> d2, f2
//   K3  d3_0, d3_1, up3 (+ d2)          f2, d2  -> f3
//   K4  u4_0, u4_1, up2 (+ d1)          f3, d1  -> f4
//   K5  u3_0, u3_1, + x                 f4, x   -> eps
// Its rounding points are B1's at bfloat16 but for one: the graph-mixed g
// of every ST-GCNN layer is rounded to bfloat16 before the channel mix
// (probe_grouped_pallas.py:65).  Every group output is bfloat16; eps is
// bfloat16 (:205-206).
//
// Contract: one call runs one group.
//   in0, in1  the group's activation inputs (C, T*V, N), bfloat16
//   semb      silu(emb) (E, N), bfloat16
//   out0, out1 the group's outputs (C, T*V, N), bfloat16
//   mats, vecs, table  as for denoiser.cu; the group's table
//             (mocodad_tpu_torch/ops/grouped_unet.py) names its inputs,
//             outputs and arena.  Any N: rows past N read as 0 and are
//             never written; no host-side padding (B2 needs N a multiple
//             of its NB, :129).
//
// What bounds it: the function is B1's, 5.28 MFLOP per fold row, so the
// least time at N = 51,200 is set by operations over the tensor cores'
// 989 TFLOP/s bfloat16 rate: about 0.27 ms.  The intermediates add their
// own bytes (each written once and read once: 2.24 GB at N = 51,200,
// 0.67 ms at 3.35 TB/s), which chip_smoke.py prints on a line of their
// own; they are B2's cost, not the function's.
//
// Design: denoiser_body.cuh's interpreter on each group's op table, with
// global-memory endpoints.  A group's arena is a fraction of B1's, so a
// block holds `nsub` sub-tiles of 4 rows (256 threads each), nsub chosen
// on the host as the most arenas that fit the 232,448 bytes a block may
// use, at most kMaxSub.  At the flagship shapes: K1 2 (8 rows, 158,208
// bytes), K2 2 (8 rows, 229,888), K3 1 (4 rows, 198,912), K4 1 (4 rows,
// 141,056), K5 2 (8 rows, 161,472).  kMaxSub = 2 keeps a block at 512
// threads within its register budget.

#include "denoiser_body.cuh"

namespace mocodad {
namespace {

constexpr int kMaxSub = 2;

struct GroupIO {
  const bf16* in[kMaxIn];
  bf16* out[kMaxOut];
};

__global__ void __launch_bounds__(kThreads * kMaxSub, 1)
grouped_kernel(GroupIO io, const bf16* __restrict__ semb,
               const bf16* __restrict__ mats,
               const float* __restrict__ vecs,
               const int* __restrict__ table, int n, int nsub) {
  extern __shared__ float4 sm[];
  const int s = threadIdx.x / kThreads;
  const int tid = threadIdx.x % kThreads;
  float4* arena = sm + s * __ldg(table + H_ARENA);
  tile_forward<bf16, bf16, bf16, bf16, true>(
      tid, arena, table, io.in, semb, io.out, mats, vecs, n,
      (blockIdx.x * nsub + s) * kRows);
}

}  // namespace
}  // namespace mocodad

// Launch one group on `stream`; returns the CUDA error code (0 on
// success).  Nothing is allocated and nothing is synchronised here.
extern "C" int mocodad_grouped_launch(
    const mocodad::bf16* in0, const mocodad::bf16* in1,
    const mocodad::bf16* semb, mocodad::bf16* out0, mocodad::bf16* out1,
    const mocodad::bf16* mats, const float* vecs, const int* table, int n,
    int nsub, int smem_bytes, void* stream) {
  using namespace mocodad;
  if (nsub < 1 || nsub > kMaxSub)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      grouped_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  GroupIO io = {{in0, in1}, {out0, out1}};
  const int rows = kRows * nsub;
  const int blocks = (n + rows - 1) / rows;
  grouped_kernel<<<blocks, kThreads * nsub, smem_bytes,
                   static_cast<cudaStream_t>(stream)>>>(io, semb, mats, vecs,
                                                        table, n, nsub);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mocodad_grouped_max_sub() { return mocodad::kMaxSub; }
extern "C" int mocodad_grouped_header_len() { return mocodad::H_LEN; }
extern "C" int mocodad_grouped_op_len() { return mocodad::O_LEN; }
