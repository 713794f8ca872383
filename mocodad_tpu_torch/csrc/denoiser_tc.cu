// Eval-mode STSAEUnet denoiser forward in bfloat16 on Hopper's tensor
// cores (sm_90a): B1 at compute dtype bfloat16, every product of the U-Net
// by mma.sync.m16n8k16 (bf16 in, f32 accumulate).
//
// Replaces: mocodad_tpu/ops/pallas_unet.py:105 build_pallas_denoiser (the
// inner `kernel`, :141-204) at compute_dtype=bfloat16, kernel B1 of the JAX
// package.  Same function as the FMA design (csrc/denoiser.cu's bf16 entry,
// kept as the yardstick) and as the plain version
// ops/pallas_unet.denoise_reference(compute_dtype=torch.bfloat16): the same
// folded constants rounded to bfloat16, the same association (graph
// operator first, then channel mix), float32 accumulation, and rounding to
// bfloat16 (to nearest even) at B1's cast points (pallas_unet.py:157-204):
// x and silu_emb on load, every layer and joint output, every skip add, and
// eps = bf16(f + x).
//
// Contract: eps = denoise(x, silu_emb, folded)
//   x        (C_in, T*V, N) bfloat16, contiguous
//   silu_emb (E, N)         float32, contiguous
//   eps      (C_in, T*V, N) bfloat16, contiguous
//   blob     every op's constants, one contiguous block per op, laid out
//            as the shared-memory tiles below (ops/pallas_unet.py
//            pack_for_tc_kernel); `table` (int32) the shared-memory plan,
//            the op records and the offsets into the blob.  Any N: rows
//            past N are read as 0 and never written.
//
// What bounds it: 5.28 MFLOP per fold row at the flagship shapes (C_in 2,
// T 3, V 17 -> 12 -> 10, channels up to 128, E 16), 270.46 GFLOP per call
// at N = 51,200; over the H100 SXM's 989 TFLOP/s of dense bf16 that is
// 0.27 ms, while the bytes (x, eps, silu_emb, the constants) take under
// 0.01 ms at 3.35 TB/s: operations bound it (chip_smoke.py recomputes
// both).  The tensor cores do more than that: T*V and C_in padded to the
// MMA's 16, the joint re-scalings as dense padded products, and a second
// MMA for the low half of g (below) make about 2.5x the function's work.
//
// Design.
//   * M comes from positions, not fold rows.  Per fold row an activation
//     is a (T*V, C) bf16 matrix in shared memory, C contiguous, T*V padded
//     to a multiple of 16 with zero rows, C padded to a multiple of 16 and
//     the row stride C + 8 (16 bytes more: ldmatrix's 8 row addresses then
//     hit distinct bank groups).  One fold row needs about 28 KB of it, so
//     a 64-row tile of fold rows cannot fit in 227 KB; the MMAs take their
//     M = 16 from positions within a row:
//       graph mix    g[k, c] = sum_x K[k, x] f[x, c]   M = TVo, K = TVi,
//                    N = C_in  (A = K by ldmatrix, B = f by ldmatrix.trans)
//       channel mix  y[k, o] = sum_c g[k, c] W[c, o]   M = TV, K = C_in,
//                    N = C_out (A = g from registers, B = W by ldmatrix)
//       residual     y += sum_c f[k, c] Wr[c, o]       (A = f by ldmatrix)
//     The joint re-scalings are the graph mix with the (TVo x TVi) block-
//     diagonal operator taken dense (its zero blocks add exact zeros; 3 %
//     of the function), then the per-row affine and the skip add.
//   * g is chained in registers.  A warp's work unit is (fold row, 16
//     positions, C_out or a part of it).  It walks C_in in chunks of 16: the
//     graph mix of one chunk leaves g (16 positions x 16 channels) in two
//     accumulator tiles whose layout is the A fragment of the channel mix
//     (flash attention's S -> P repacking), so g never touches shared
//     memory.  g stays float32 in value, as in B1 (the JAX kernel's
//     dot(w2 bf16, g f32) promotes): it enters the channel mix as
//     g_hi = bf16(g) and g_lo = bf16(g - g_hi), two MMAs into one
//     accumulator, which gives W g to about 2^-16 relative.  Rounding g
//     once would compute B2's function, not B1's.  Each W fragment is
//     loaded once per chunk and serves both halves.
//   * Weights are staged in shared memory one op at a time.  Each op's
//     constants are one contiguous block of the blob (K, W, Wr as padded
//     bf16 tiles; bias, slope or the affine as float32), copied by 16-byte
//     cp.async into one of two buffers while the previous op computes from
//     the other.  Every layer's W_e and b_e (20 KB) are staged once per
//     block, and every layer's embedding W_e silu(emb) + b_e is computed
//     once per tile by FMA (0.3 % of the work).  The L2 traffic stays
//     about what the FMA design read (176 KB of constants per 4 rows
//     through __ldg there, 2.25 GB per call; 220 KB of padded tiles per 4
//     rows here, 2.8 GB), but it is now one bulk copy per op, issued an op
//     ahead, instead of loads on the products' critical path.
//   * Rows per tile are a template parameter, kRows, built for 4 and 2:
//     the host plans for the most that fit (pack_for_tc_kernel), 4 up to T
//     = 3 frames at 17 joints, 2 from T = 4 (T = 6, T*V = 102: 222,240 bytes
//     for 2 rows, 333,728 for 4), and names that count in the launch.
//   * kRows = 4 fold rows and kWarps = 16 warps per block; the blocks are
//     persistent (one per SM), walk their tiles of 4 rows, and stage the
//     next tile's first op during the last op of the current one.  Units
//     per op are 4 rows x T*V/16 (16 / 12 / 8 at T*V = 51 / 36 / 30); the
//     host splits C_out of d3_0 and d3_1 in two (tc_nsplit), which
//     recomputes their graph mix but halves the busiest warp's MMAs.  At
//     the flagship shapes the plan takes 224,160 of the 232,448 bytes a
//     block may use (plus 2 KB of static shared memory for the table): 2 x
//     39,952 of weight buffers (the largest op, d3_0), 19,584 of W_e and
//     b_e, 8,704 of embeddings, and 4 x 28,992 of activations (x, the skips
//     d1 and d2, silu_emb, and a work area whose two ends alternate as
//     layer input and output).  The FMA design's arena was float32 holding
//     bf16 values (226,656 bytes for 4 rows); bf16 storage halves it and
//     leaves room for the weights.
//   * Per op: wait for its constants, one block barrier, stage the next
//     op's, then the MMA units, each ending in its epilogue (identity
//     residual, bias, PReLU, + embedding; or the joint affine and skip add;
//     rounding, zero for padded positions), all loads before the first
//     store, written straight to the output buffer.
//   * Measured (chip_smoke.py, H100 SXM, 700 W): about 4.4-4.8 ms per
//     call at N = 51,200 against the FMA design's 18.8-18.9 in the same
//     run.  The MMA loops take about half of a tile's time, at about 12
//     cycles per m16n8k16 per SM sub-partition: every unit re-reads the
//     op's fragments from shared memory (a unit's chunk of d3_0 reads 13
//     ldmatrix.x4, 6.5 KB, for 28 MMAs; 16 units per SM), and those reads,
//     not the tensor cores, set their pace.  The four joint re-scalings
//     (3 % of the work, latency-bound) take a fifth; per-op set-up,
//     epilogues, the tile's loads and the embeddings the rest.
//
// Why mma.sync and not wgmma: wgmma's tile is 64 rows (positions) for a
// warpgroup, so T*V = 51 / 36 / 30 pads to 64 / 64 / 64 (20 / 44 / 53 %
// waste, against 20 / 25 / 6 % at mma.sync's 16) and a block of 4 rows has
// only 4 units per layer (one 64-position tile per row) for its 4
// warpgroups; the g chain would also need wgmma's register-A layout.
// wgmma pays once M can span fold rows: the channel mixes (68 % of the
// MACs) are row-independent, so with the positions of several rows
// stacked (e.g. 2 rows x 30 at level c) in a layout that the graph mix
// (block-diagonal over rows) can still serve, and more rows resident per
// SM (a smaller arena, or weights shared across a cluster by TMA
// multicast), a 64-row wgmma tile would waste little, and its B operand
// read once from shared memory by the whole warpgroup would also cut the
// fragment reads that pace the loops here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mocodad_tc {
namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTable = 512;   // ints of the table copied to shared memory

// table header (every offset in bytes, strides in bf16 elements)
enum {
  H_NOPS, H_E, H_CIN, H_TVA, H_TVAP,
  H_ROW0, H_ROW_BYTES,          // first row's activations, bytes per row
  H_X_OFF, H_X_STRIDE,          // x (TVAP, X_STRIDE) within a row
  H_SEMB_OFF,                   // silu_emb, E float32, within a row
  H_EMB_OFF, H_EMB_STRIDE,      // every layer's embedding: kRows x
                                //   EMB_STRIDE float32
  H_EMBW_OFF, H_EMBW_BLOB, H_EMBW_BYTES,  // every layer's W_e^T (E,
                                //   EMB_STRIDE) bf16, then b_e float32,
                                //   staged once
  H_WBUF0, H_WBUF1,             // the two weight buffers
  H_OUT_OFF, H_OUT_STRIDE,      // the last op's output within a row
  H_LEN
};
// one op record: kind 0 = ST-GCNN layer, 1 = joint re-scaling
enum {
  O_KIND, O_CI,                 // input channels padded to 16
  O_NT,                         // output channels padded to 16, over 8
  O_NSPLIT,                     // parts of C_out, one unit each
  O_TVI, O_TVO, O_MT, O_KS,     // T*V in / out; 16-position tiles out / in
  O_IN, O_IN_STRIDE, O_OUT, O_OUT_STRIDE, O_SKIP, O_SKIP_STRIDE,
  O_RES,                        // 1: residual mix Wr, 0: identity
  O_BLOB, O_BLOB_BYTES,         // the op's constants in the blob
  O_K, O_K_STRIDE, O_W, O_W_STRIDE, O_WR,   // bf16 tiles (bytes)
  O_BIAS, O_SLOPE, O_RS, O_RT,              // float32 vectors (bytes)
  O_EMB,                        // the layer's first embedding column
  O_LEN
};

// the op code, shared with B2 and B3 on the tensor cores
#include "denoiser_tc_body.cuh"

// ---- tile I/O --------------------------------------------------------------

// x rows n0 .. n0 + kRows - 1 -> each row's x tile (zero padded), silu_emb
// -> each row's E floats rounded to bf16; rows past N read as 0
template <int kRows>
__device__ void load_tile(int tid, char* sm, const int* t,
                          const uint16_t* __restrict__ x,
                          const float* __restrict__ semb, int n, int n0) {
  const int row0 = tab(t, H_ROW0), rb = tab(t, H_ROW_BYTES);
  const int cin = tab(t, H_CIN), tva = tab(t, H_TVA), tvap = tab(t, H_TVAP);
  const int xo = tab(t, H_X_OFF), xs = tab(t, H_X_STRIDE);
  const int E = tab(t, H_E), so = tab(t, H_SEMB_OFF);
  const int cs = xs - 8;
  for (int i = tid; i < kRows * tvap * cs; i += kThreads) {
    const int r = i % kRows, pc = i / kRows, c = pc % cs, p = pc / cs;
    uint16_t v = 0;
    if (p < tva && c < cin && n0 + r < n)
      v = x[static_cast<size_t>(c * tva + p) * n + n0 + r];
    *reinterpret_cast<uint16_t*>(sm + row0 + r * rb + xo +
                                 (p * xs + c) * 2) = v;
  }
  for (int i = tid; i < kRows * E; i += kThreads) {
    const int r = i % kRows, k = i / kRows;
    reinterpret_cast<float*>(sm + row0 + r * rb + so)[k] =
        n0 + r < n ? rnd(__ldg(semb + static_cast<size_t>(k) * n + n0 + r))
                   : 0.f;
  }
}

// eps = bf16(f + x) for the tile's rows below N
template <int kRows>
__device__ void store_tile(int tid, const char* sm, const int* t,
                           uint16_t* __restrict__ eps, int n, int n0) {
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
    eps[static_cast<size_t>(ctv) * n + n0 + r] = to_bf(f + x0);
  }
}

// ---- the kernel ------------------------------------------------------------

// kRows fold rows per tile: 4 up to T*V = 51, 2 above (the host plans
// for the most that fit, pack_for_tc_kernel)
template <int kRows>
__global__ void __launch_bounds__(kThreads, 1)
denoiser_kernel_tc(const uint16_t* __restrict__ x,
                   const float* __restrict__ semb,
                   const char* __restrict__ blob,
                   const int* __restrict__ table, uint16_t* __restrict__ eps,
                   int n) {
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
  for (int tile = blockIdx.x; tile < ntiles; tile += stride) {
    const int n0 = tile * kRows;
    load_tile<kRows>(tid, sm, t, x, semb, n, n0);
    cp_async_wait_all();
    __syncthreads();     // silu_emb (and, first, W_e and b_e) in place
    embed_all<kRows>(tid, sm, t, kRows);
    for (int op = 0; op < nops; ++op) {
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
    store_tile<kRows>(tid, sm, t, eps, n, n0);
    __syncthreads();     // before the next tile's loads overwrite x
  }
}

template <int kRows>
int launch(const uint16_t* x, const float* semb, const char* blob,
           const int* table, uint16_t* eps, int n, int smem_bytes,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      denoiser_kernel_tc<kRows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n + kRows - 1) / kRows;
  const int grid = tiles < sms ? tiles : sms;
  denoiser_kernel_tc<kRows><<<grid, kThreads, smem_bytes, stream>>>(
      x, semb, blob, table, eps, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mocodad_tc

// Launch on `stream` with `rows` fold rows per tile (4 or 2, what the
// plan was packed for): one persistent block per SM (fewer for a small
// N).  Returns the CUDA error code (0 on success); allocates nothing and
// does not synchronise.
extern "C" int mocodad_denoiser_tc_launch(const uint16_t* x,
                                          const float* semb,
                                          const char* blob, const int* table,
                                          uint16_t* eps, int n, int rows,
                                          int smem_bytes, void* stream) {
  using namespace mocodad_tc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 4:
      return launch<4>(x, semb, blob, table, eps, n, smem_bytes, s);
    case 2:
      return launch<2>(x, semb, blob, table, eps, n, smem_bytes, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The plans this build reads: the rows per tile it is built for (a bit
// mask, bit r for r rows), warps per block, the longest table, header and
// op record lengths.  The host checks all five before the first launch.
extern "C" int mocodad_denoiser_tc_row_counts() {
  return (1 << 4) | (1 << 2);
}
extern "C" int mocodad_denoiser_tc_warps_per_block() {
  return mocodad_tc::kWarps;
}
extern "C" int mocodad_denoiser_tc_max_table() {
  return mocodad_tc::kMaxTable;
}
extern "C" int mocodad_denoiser_tc_header_len() { return mocodad_tc::H_LEN; }
extern "C" int mocodad_denoiser_tc_op_len() { return mocodad_tc::O_LEN; }
