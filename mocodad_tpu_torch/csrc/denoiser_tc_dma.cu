// The DMA-pipelined denoiser (B3) at bfloat16 on Hopper's tensor cores
// (sm_90a): B1 bfloat16's tensor-core body in persistent blocks that walk
// the tiles with the next tile's inputs copied in while this one computes.
//
// Replaces: tools/perf/probe_dma_pipeline.py:39
// build_dma_pipelined_denoiser (kernel :79-193, pallas_call :214) at
// compute_dtype=bfloat16, the JAX repository's TPU probe B3.  Same function
// as its plain version ops/dma_unet.dma_reference(compute_dtype=bfloat16)
// and as the FMA design csrc/denoiser_dma.cu (kept as the yardstick): B1 at
// bfloat16 (denoiser_tc.cu's function, g = g_hi + g_lo), with B3's I/O:
// x arrives float32 and is rounded to bfloat16 (to nearest even) on entry
// (:167), silu_emb is float32 and rounded likewise, and eps = f + x0 stays
// float32, not rounded (:149, :225, :230), where B1 stores bf16(f + x0).
//
// Contract: eps = denoise(x, silu_emb, folded)
//   x        (C_in, T*V, N) float32, contiguous
//   silu_emb (E, N)         float32, contiguous
//   eps      (C_in, T*V, N) float32, contiguous
//   blob, table: B1 bfloat16's plan (ops/pallas_unet.py
//            pack_for_tc_kernel), unchanged; the prefetch slot lies after
//            that plan's shared memory, at `slot_off`.  Any N: rows past N
//            are read as 0 and never written.
//
// What bounds it: the function's 270.46 GFLOP at N = 51,200 take 0.27 ms
// on the H100 SXM's 989 TFLOP/s of dense bf16; its bytes (x and eps in
// float32, silu_emb, the constants) about 0.01 ms at 3.35 TB/s: operations
// bound it.
//
// Design: denoiser_tc.cu's (its note), on its plan, for B3's defining
// feature: B1 bfloat16 gathers a tile's x and silu_emb with plain loads at
// the head of every tile, here the next tile's x and silu_emb come by
// 4-byte cp.async (a tile's 4 rows are 16 bytes apart in device memory, at
// any 4-byte boundary) into a slot of 1,888 bytes after B1's 224,160,
// issued as soon as this tile has unpacked the slot and awaited at the
// second op, so that their latency hides behind the embeddings and the
// first op.  The tile's head then only unpacks the slot into the x tile
// and the silu_emb rows; the op loop is B1's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mocodad_tcd {
namespace {

constexpr int kRows = 4;
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTable = 512;   // ints of the table copied to shared memory

// table header and op record: denoiser_tc.cu's
enum {
  H_NOPS, H_E, H_CIN, H_TVA, H_TVAP,
  H_ROW0, H_ROW_BYTES,
  H_X_OFF, H_X_STRIDE,
  H_SEMB_OFF,
  H_EMB_OFF, H_EMB_STRIDE,
  H_EMBW_OFF, H_EMBW_BLOB, H_EMBW_BYTES,
  H_WBUF0, H_WBUF1,
  H_OUT_OFF, H_OUT_STRIDE,
  H_LEN
};
enum {
  O_KIND, O_CI, O_NT, O_NSPLIT, O_TVI, O_TVO, O_MT, O_KS,
  O_IN, O_IN_STRIDE, O_OUT, O_OUT_STRIDE, O_SKIP, O_SKIP_STRIDE,
  O_RES, O_BLOB, O_BLOB_BYTES, O_K, O_K_STRIDE, O_W, O_W_STRIDE, O_WR,
  O_BIAS, O_SLOPE, O_RS, O_RT, O_EMB,
  O_LEN
};

#include "denoiser_tc_body.cuh"

// ---- tile I/O --------------------------------------------------------------

// x and silu_emb of rows n0 .. n0 + kRows - 1 below N -> the slot, kRows x
// (C_in T*V + E) floats, one 4-byte cp.async each, as one group
__device__ void prefetch_tile(int tid, const char* slot, const int* t,
                              const float* __restrict__ x,
                              const float* __restrict__ semb, int n, int n0) {
  const int cv = tab(t, H_CIN) * tab(t, H_TVA), E = tab(t, H_E);
  for (int i = tid; i < kRows * (cv + E); i += kThreads) {
    const int r = i % kRows, j = i / kRows;
    if (n0 + r >= n) continue;
    const float* src = j < cv ? x + static_cast<size_t>(j) * n + n0 + r
                              : semb + static_cast<size_t>(j - cv) * n + n0 + r;
    cp_async4z(smem_addr(slot + (r * (cv + E) + j) * 4), src, 4);
  }
  cp_async_commit();
}

// the slot -> each row's x tile rounded to bf16 (zero padded) and silu_emb
// rounded to bf16 (as float32); rows past N read as 0
__device__ void load_tile(int tid, char* sm, const int* t, const float* pb,
                          int n, int n0) {
  const int row0 = tab(t, H_ROW0), rb = tab(t, H_ROW_BYTES);
  const int cin = tab(t, H_CIN), tva = tab(t, H_TVA), tvap = tab(t, H_TVAP);
  const int xo = tab(t, H_X_OFF), xs = tab(t, H_X_STRIDE);
  const int E = tab(t, H_E), so = tab(t, H_SEMB_OFF);
  const int cs = xs - 8, cv = cin * tva;
  for (int i = tid; i < kRows * tvap * cs; i += kThreads) {
    const int r = i % kRows, pc = i / kRows, c = pc % cs, p = pc / cs;
    *reinterpret_cast<uint16_t*>(sm + row0 + r * rb + xo +
                                 (p * xs + c) * 2) =
        p < tva && c < cin && n0 + r < n
            ? to_bf(pb[r * (cv + E) + c * tva + p])
            : 0;
  }
  for (int i = tid; i < kRows * E; i += kThreads) {
    const int r = i % kRows, k = i / kRows;
    reinterpret_cast<float*>(sm + row0 + r * rb + so)[k] =
        n0 + r < n ? rnd(pb[r * (cv + E) + cv + k]) : 0.f;
  }
}

// eps = f + x0 in float32 (both bf16 values, the sum not rounded) for the
// tile's rows below N
__device__ void store_tile(int tid, const char* sm, const int* t,
                           float* __restrict__ eps, int n, int n0) {
  const int row0 = tab(t, H_ROW0), rb = tab(t, H_ROW_BYTES);
  const int cin = tab(t, H_CIN), tva = tab(t, H_TVA);
  const int xo = tab(t, H_X_OFF), xs = tab(t, H_X_STRIDE);
  const int oo = tab(t, H_OUT_OFF), os = tab(t, H_OUT_STRIDE);
  for (int i = tid; i < kRows * cin * tva; i += kThreads) {
    const int r = i % kRows, ctv = i / kRows;
    if (n0 + r >= n) continue;
    const int c = ctv / tva, p = ctv % tva;
    const char* row = sm + row0 + r * rb;
    const float f = bf(*reinterpret_cast<const uint16_t*>(
        row + oo + (p * os + c) * 2));
    const float x0 = bf(*reinterpret_cast<const uint16_t*>(
        row + xo + (p * xs + c) * 2));
    eps[static_cast<size_t>(ctv) * n + n0 + r] = f + x0;
  }
}

// ---- the kernel ------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
denoiser_kernel_tc_dma(const float* __restrict__ x,
                       const float* __restrict__ semb,
                       const char* __restrict__ blob,
                       const int* __restrict__ table,
                       float* __restrict__ eps, int n, int slot_off) {
  extern __shared__ __align__(128) char sm[];
  __shared__ int st[kMaxTable];
  const int tid = threadIdx.x;
  for (int i = tid; i < H_LEN + __ldg(table + H_NOPS) * O_LEN; i += kThreads)
    st[i] = __ldg(table + i);
  __syncthreads();
  const int* t = st;
  const int nops = tab(t, H_NOPS);
  const int ntiles = (n + kRows - 1) / kRows;
  const int stride = static_cast<int>(gridDim.x);
  char* wbuf[2] = {sm + tab(t, H_WBUF0), sm + tab(t, H_WBUF1)};
  const int* ops = t + H_LEN;
  int buf = 0;
  stage(tid, sm + tab(t, H_EMBW_OFF), blob, tab(t, H_EMBW_BLOB),
        tab(t, H_EMBW_BYTES));
  stage(tid, wbuf[0], blob, tab(ops, O_BLOB), tab(ops, O_BLOB_BYTES));
  if (static_cast<int>(blockIdx.x) < ntiles)
    prefetch_tile(tid, sm + slot_off, t, x, semb, n, blockIdx.x * kRows);
  for (int tile = blockIdx.x; tile < ntiles; tile += stride) {
    const int n0 = tile * kRows;
    cp_async_wait_all();
    __syncthreads();     // this tile's x and silu_emb (first: W_e and b_e)
    load_tile(tid, sm, t, reinterpret_cast<const float*>(sm + slot_off), n,
              n0);
    __syncthreads();     // x and silu_emb in place, the slot free
    const bool ahead = tile + stride < ntiles;
    if (ahead)
      prefetch_tile(tid, sm + slot_off, t, x, semb, n,
                    (tile + stride) * kRows);
    embed_all<kRows>(tid, sm, t, kRows);
    for (int op = 0; op < nops; ++op) {
      // the next tile's prefetch, the last group committed before the
      // first op, may stay in flight through it
      if (op == 0 && ahead)
        cp_async_wait_1();
      else
        cp_async_wait_all();
      __syncthreads();   // this op's constants and the last op's output
      const int next = op + 1 < nops ? op + 1
                       : tile + stride < ntiles ? 0 : -1;
      if (next >= 0)
        stage(tid, wbuf[buf ^ 1], blob, tab(ops + next * O_LEN, O_BLOB),
              tab(ops + next * O_LEN, O_BLOB_BYTES));
      run_op<false>(tid, sm, t, ops + op * O_LEN, wbuf[buf], kRows);
      buf ^= 1;
    }
    __syncthreads();
    store_tile(tid, sm, t, eps, n, n0);
  }
}

}  // namespace
}  // namespace mocodad_tcd

// Launch on `stream`: one persistent block per SM (fewer for a small N).
// Returns the CUDA error code (0 on success); allocates nothing and does
// not synchronise.
extern "C" int mocodad_dma_tc_launch(const float* x, const float* semb,
                                     const char* blob, const int* table,
                                     float* eps, int n, int slot_off,
                                     int smem_bytes, void* stream) {
  using namespace mocodad_tcd;
  cudaError_t err = cudaFuncSetAttribute(
      denoiser_kernel_tc_dma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n + kRows - 1) / kRows;
  const int grid = tiles < sms ? tiles : sms;
  denoiser_kernel_tc_dma<<<grid, kThreads, smem_bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      x, semb, blob, table, eps, n, slot_off);
  return static_cast<int>(cudaGetLastError());
}

// The plan this build reads: rows per tile, warps per block, the longest
// table, header and op record lengths.  The host checks all five before
// the first launch.
extern "C" int mocodad_dma_tc_rows_per_block() { return mocodad_tcd::kRows; }
extern "C" int mocodad_dma_tc_warps_per_block() {
  return mocodad_tcd::kWarps;
}
extern "C" int mocodad_dma_tc_max_table() { return mocodad_tcd::kMaxTable; }
extern "C" int mocodad_dma_tc_header_len() { return mocodad_tcd::H_LEN; }
extern "C" int mocodad_dma_tc_op_len() { return mocodad_tcd::O_LEN; }
