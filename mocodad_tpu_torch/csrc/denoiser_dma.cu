// The eval-mode STSAEUnet denoiser as one persistent block per SM that walks
// the tiles with its next tile's inputs prefetched, for NVIDIA Hopper
// (sm_90a), computing in float32 or bfloat16.
//
// Replaces: tools/perf/probe_dma_pipeline.py:build_dma_pipelined_denoiser
// (:39, kernel :79-193, `pallas_call` :214), kernel B3 of the JAX
// repository: B1's body in one program that walks the batch chunks, with
// the next chunk's x and silu(emb) fetched by 2-slot manual DMAs while the
// current one computes (:151-193).  The same function as B1 at the compute
// type, except that x is rounded from the input buffer (:167) and eps is
// float32 whatever the compute type (:149, :225, :230).
//
// Contract: eps = denoise(x, silu_emb, folded)
//   x        (C_in, T*V, N)  float32, contiguous
//   silu_emb (E, N)          float32, contiguous
//   eps      (C_in, T*V, N)  float32, contiguous
//   mats (float32 or bfloat16), vecs, table: B1's (denoiser.cu), and
//   stage_off, the arena offset of the prefetch slot, which the host plan
//   (mocodad_tpu_torch/ops/dma_unet.py) puts after B1's arena.  Any N:
//   rows past N are read as 0 and never written.
//
// What bounds it: the function is B1's, 5.28 MFLOP per fold row: at
// N = 51,200 about 4.0 ms by operations in float32 (67 TFLOP/s outside
// the tensor cores) and about 0.27 ms in bfloat16 (989 TFLOP/s); its bytes
// (x, silu(emb) and eps in float32, the folded constants) take about
// 0.014 ms at 3.35 TB/s.
//
// Design: grid = the number of SMs (132 on the H100 SXM), or fewer when N
// has fewer tiles; block b walks tiles b, b + grid, ...  The arena is
// B1's; after it sits one prefetch slot of (C_in * T*V + E) float4s (1,888
// bytes at the flagship) that holds the next tile's x and silu(emb) as
// they arrive from global memory.  Per tile: wait for the slot, unpack it
// into the arena's x and silu(emb) regions (rounding at the compute type),
// start the next tile's copies into the slot with cp.async (4 bytes each,
// zero-filled past N, committed as one group), run B1's ops, store eps.
// The arena's x region and the slot are B3's two slots.  Stores need no
// draining: a global store does not hold the block.  Arena plus slot:
// 228,544 of the 232,448 bytes a block may use (dma_unet.py raises when a
// plan does not fit).

#include "denoiser_body.cuh"

namespace mocodad {
namespace {

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_size = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_size)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// tile `t`'s x (nx elements) and silu(emb) (E elements) -> the slot, 4
// rows per element, rows past N zero-filled
__device__ void prefetch(float* slot, const float* __restrict__ x,
                         const float* __restrict__ semb, int nx, int E,
                         int n, int t) {
  const int n0 = t * kRows;
  const int items = (nx + E) * kRows;
  for (int i = threadIdx.x; i < items; i += kThreads) {
    const int r = i % kRows, e = i / kRows;
    const bool valid = n0 + r < n;
    const float* src = e < nx ? x + static_cast<size_t>(e) * n
                              : semb + static_cast<size_t>(e - nx) * n;
    cp_async4(slot + i, valid ? src + n0 + r : x, valid);
  }
  cp_async_commit();
}

template <typename WT>
__global__ void __launch_bounds__(kThreads, 1)
dma_kernel(const float* __restrict__ x, const float* __restrict__ semb,
           const WT* __restrict__ mats, const float* __restrict__ vecs,
           const int* __restrict__ table, float* __restrict__ eps, int n,
           int stage_off) {
  constexpr bool R = kIsBf16<WT>;
  extern __shared__ float4 sm[];
  float* slot = reinterpret_cast<float*>(sm + stage_off);
  const int* io_x = io_in(table, 0);
  const int* io_eps = io_out(table, 0);
  const int cin = __ldg(io_x + IO_C), tva = __ldg(io_x + IO_TV);
  const int tvap = __ldg(io_x + IO_TVP);
  float4* xs = sm + __ldg(io_x + IO_OFF);
  const int E = __ldg(table + H_E);
  float4* se = sm + __ldg(table + H_SEMB);
  const float4* fin = sm + __ldg(io_eps + IO_OFF);
  const float4* fx = sm + __ldg(table + H_FINAL_X);
  const int nx = cin * tva;
  const int tiles = (n + kRows - 1) / kRows;
  const int first = blockIdx.x, step = gridDim.x;
  if (first < tiles) prefetch(slot, x, semb, nx, E, n, first);
  for (int t = first; t < tiles; t += step) {
    cp_async_wait_all();
    __syncthreads();
    // the slot -> the arena's x and silu(emb) regions
    for (int i = threadIdx.x; i < (nx + E) * kRows; i += kThreads) {
      const int r = i % kRows, e = i / kRows;
      float4* dst = e < nx ? xs + (e / tva) * tvap + e % tva : se + (e - nx);
      reinterpret_cast<float*>(dst)[r] = rnd<R>(slot[i]);
    }
    __syncthreads();
    if (t + step < tiles) prefetch(slot, x, semb, nx, E, n, t + step);
    run_ops<WT, false>(threadIdx.x, sm, table, mats, vecs);
    const int n0 = t * kRows;
    store_act(threadIdx.x, fin, fx, cin, tva, tvap, eps, n, n0,
              min(kRows, n - n0));
  }
  cp_async_wait_all();
}

template <typename WT>
int launch(const float* x, const float* semb, const WT* mats,
           const float* vecs, const int* table, float* eps, int n, int grid,
           int stage_off, int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dma_kernel<WT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dma_kernel<WT><<<grid, kThreads, smem_bytes,
                   static_cast<cudaStream_t>(stream)>>>(
      x, semb, mats, vecs, table, eps, n, stage_off);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mocodad

// Launch on `stream` with `grid` persistent blocks; each returns the CUDA
// error code (0 on success).  Nothing is allocated and nothing is
// synchronised here.
extern "C" int mocodad_dma_launch_f32(const float* x, const float* semb,
                                      const float* mats, const float* vecs,
                                      const int* table, float* eps, int n,
                                      int grid, int stage_off, int smem_bytes,
                                      void* stream) {
  return mocodad::launch(x, semb, mats, vecs, table, eps, n, grid, stage_off,
                         smem_bytes, stream);
}

extern "C" int mocodad_dma_launch_bf16(const float* x, const float* semb,
                                       const mocodad::bf16* mats,
                                       const float* vecs, const int* table,
                                       float* eps, int n, int grid,
                                       int stage_off, int smem_bytes,
                                       void* stream) {
  return mocodad::launch(x, semb, mats, vecs, table, eps, n, grid, stage_off,
                         smem_bytes, stream);
}

extern "C" int mocodad_dma_header_len() { return mocodad::H_LEN; }
extern "C" int mocodad_dma_op_len() { return mocodad::O_LEN; }
