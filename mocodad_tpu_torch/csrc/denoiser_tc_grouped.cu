// The layer-grouped denoiser (B2) on Hopper's tensor cores (sm_90a): one
// kernel that runs one group of B1's ops from its table, launched once per
// group (five per forward), with the activations between groups in device
// memory, in bfloat16.
//
// Replaces: tools/perf/probe_grouped_pallas.py:111 make_kernel / grouped
// (:213; pallas_call :141), the JAX repository's TPU probe B2.  Same
// function as its plain version ops/grouped_unet.grouped_reference and as
// the FMA design csrc/denoiser_grouped.cu (kept as the yardstick): B1 at
// bfloat16 split into five groups K1 .. K5, except that every ST-GCNN layer
// rounds its graph-mixed g to bfloat16 before the channel mix (:65).
//
// Contract, per group (the host's table says which):
//   in0      the first op's input: x (C_in, T*V, N) bfloat16 for K1, else
//            an intermediate (N, T*V, C) bfloat16
//   in1      K3's d2 and K4's d1 (intermediates, the skip their last op
//            adds), K5's x (C_in, T*V, N) for eps = bf16(f + x); or none
//   silu_emb (E, N) bfloat16
//   out0/1   intermediates (N, T*V, C) bfloat16 (K1: d1, f1; K2: d2, f2;
//            K3: f3; K4: f4), or K5's eps (C_in, T*V, N) bfloat16
//   blob     every group's op constants and its layers' W_e and b_e
//            (ops/grouped_unet.py pack_groups_tc); `table` (int32) the
//            group's shared-memory plan, I/O records and op records, the
//            op records in denoiser_tc.cu's format.  Any N: rows past N
//            are read as 0 and never written.
//
// What bounds it: the function's 270.46 GFLOP at N = 51,200 take 0.27 ms
// on the H100 SXM's 989 TFLOP/s of dense bf16; its own bytes (x, silu_emb,
// eps, the constants) 0.01 ms at 3.35 TB/s.  The design adds the
// intermediates: d1, f1, d2, f2, f3 and f4 written once and read once,
// 2.24 GB at that N, at least 0.67 ms (chip_smoke.py's design_floor_ms).
//
// Design.
//   * The op code is B1 bfloat16's (denoiser_tc_body.cuh, denoiser_tc.cu's
//     note): a fold row's activations as (T*V, C) bf16 tiles in shared
//     memory, mma.sync m16n8k16 over 16 positions of one row, g chained in
//     registers.  Here g is rounded once (B2's function), so the channel
//     mix is one MMA per W fragment where B1 needs two.
//   * Intermediates in the layout (N, T*V, C): a fold row's T*V*C values
//     are contiguous, and a tile of R rows is one contiguous run, so its
//     loads and stores are whole 32-byte sectors, 16 bytes a thread,
//     straight between device memory and the padded (T*V, C + 8) tiles.
//     The layout pads nothing: the bytes moved are what
//     grouped_unet.intermediate_bytes counts.  x and eps keep the
//     contract's (C, T*V, N) and silu_emb its (E, N): a tile's R values of
//     one column are 2R bytes at any 2-byte boundary, so they come as the
//     4-byte words that hold them (R / 2 + 1 per column) into a slot.
//   * Rows per tile R per group: the host plan picks the R (up to 16) that
//     fits shared memory and makes the MMAs per row fewest over the
//     kernel's 16 warps; each group's arena (its inputs, silu_emb, a work
//     area, no skips of other groups) is smaller than B1's, so most groups
//     hold more than B1's 4 rows.
//   * Persistent blocks, one per SM, walk tiles of R rows.  Per tile: wait
//     for its in0 and silu_emb (prefetched by cp.async during the last
//     tile's second op), unpack silu_emb (and K1's x) from their slots,
//     compute the group's embeddings (its layers' W_e, b_e staged once per
//     block), then the ops with each op's constants double-buffered as in
//     B1.  in0's tile is free once the first op has run, so the next
//     tile's in0 is copied straight into it during the second op; in1 is
//     needed only by the last op (K5: the store), so it is copied during
//     the first op of its own tile.  Outputs are stored from the tiles the
//     ops left them in.  An op waits only for the copies issued before the
//     last op (cp.async.wait_group 1 when a prefetch was the last group).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mocodad_tcg {
namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTable = 512;   // ints of the table copied to shared memory

// one I/O record: C == 0 for an absent tensor
enum {
  IO_C, IO_TV,
  IO_OFF, IO_STRIDE,            // its (T*V, C) tile within a row (bytes,
                                //   bf16 elements); -1 for K5's x
  IO_CN,                        // 1: the contract's (C, T*V, N) layout
                                //   (x through the x slot, eps = f + x),
                                //   0: an intermediate (N, T*V, C)
  IO_LEN
};
// table header (offsets in bytes), then the I/O records in0, in1, out0,
// out1, then the op records
enum {
  H_NOPS, H_ROWS, H_E,
  H_ROW0, H_ROW_BYTES,          // first row's area, bytes per row
  H_SEMB_OFF,                   // silu_emb, E float32, within a row
  H_EMB_OFF, H_EMB_STRIDE,      // the group's embeddings: rows x
                                //   EMB_STRIDE float32
  H_EMBW_OFF, H_EMBW_BLOB, H_EMBW_BYTES,  // its layers' W_e^T (E,
                                //   EMB_STRIDE) bf16, then b_e float32
  H_WBUF0, H_WBUF1,             // the two weight buffers
  H_SSLOT_OFF,                  // silu_emb's words of the next tile
  H_XSLOT_OFF,                  // x's words (K1: next tile, K5: this
                                //   tile), or -1
  H_IO
};
constexpr int kNio = 4;
constexpr int H_LEN = H_IO + kNio * IO_LEN;
// one op record, as denoiser_tc.cu's
enum {
  O_KIND, O_CI, O_NT, O_NSPLIT, O_TVI, O_TVO, O_MT, O_KS,
  O_IN, O_IN_STRIDE, O_OUT, O_OUT_STRIDE, O_SKIP, O_SKIP_STRIDE,
  O_RES, O_BLOB, O_BLOB_BYTES, O_K, O_K_STRIDE, O_W, O_W_STRIDE, O_WR,
  O_BIAS, O_SLOPE, O_RS, O_RT, O_EMB,
  O_LEN
};

#include "denoiser_tc_body.cuh"

// ---- tile I/O --------------------------------------------------------------

// The 4-byte words that hold elements n0 .. n0 + rows - 1 of each of the
// `cols` columns of a (cols, N) bf16 tensor -> slot, rows / 2 + 1 words a
// column from the word that holds its element n0; 0 past the tensor's end
__device__ void prefetch_cols(int tid, uint32_t slot,
                              const uint16_t* __restrict__ src, int cols,
                              int n, int n0, int rows) {
  const int nw = rows / 2 + 1;
  const size_t total = static_cast<size_t>(cols) * n;
  for (int i = tid; i < cols * nw; i += kThreads) {
    const int j = i / nw, w = i % nw;
    const size_t e = (static_cast<size_t>(j) * n + n0) / 2 * 2 + 2 * w;
    const int bytes = e + 1 < total ? 4 : e < total ? 2 : 0;
    cp_async4z(slot + i * 4, src + (bytes ? e : 0), bytes);
  }
}

// element (j, n0 + r) of that tensor, from the slot
__device__ __forceinline__ uint16_t slot_col(const char* slot, int j, int n,
                                             int n0, int r, int rows) {
  const int k = static_cast<int>((static_cast<size_t>(j) * n + n0) & 1) + r;
  return reinterpret_cast<const uint16_t*>(slot)[(j * (rows / 2 + 1) +
                                                  (k >> 1)) * 2 + (k & 1)];
}

// rows n0 .. n0 + rows - 1 of an intermediate (N, T*V, C) -> each row's
// (T*V, C) tile, 16 bytes per cp.async, consecutive threads on consecutive
// addresses; rows past N zero filled
__device__ void prefetch_rows(int tid, char* sm, const int* t,
                              const int* io, const uint16_t* __restrict__ src,
                              int n, int n0) {
  const int rows = tab(t, H_ROWS), row0 = tab(t, H_ROW0);
  const int rb = tab(t, H_ROW_BYTES);
  const int c = io[IO_C], tv = io[IO_TV], off = io[IO_OFF];
  const int st = io[IO_STRIDE], q = c / 8;
  for (int i = tid; i < rows * tv * q; i += kThreads) {
    const int r = i / (tv * q), p = i / q % tv, k = i % q;
    const bool live = n0 + r < n;
    cp_async16z(smem_addr(sm + row0 + r * rb + off + (p * st + k * 8) * 2),
                live ? src + (static_cast<size_t>(n0 + r) * tv + p) * c +
                           k * 8
                     : src,
                live ? 16 : 0);
  }
}

// an input for the tile from row n0: into the x slot (the contract's
// layout) or into its tiles (an intermediate), as one group
__device__ void prefetch_input(int tid, char* sm, const int* t, const int* io,
                               const uint16_t* __restrict__ src, int n,
                               int n0) {
  if (io[IO_CN])
    prefetch_cols(tid, smem_addr(sm + tab(t, H_XSLOT_OFF)), src,
                  io[IO_C] * io[IO_TV], n, n0, tab(t, H_ROWS));
  else
    prefetch_rows(tid, sm, t, io, src, n, n0);
}

// silu_emb from its slot -> each row's E float32; K1's x from the x slot
// -> each row's x tile (zero padded); rows past N read as 0
__device__ void unpack_tile(int tid, char* sm, const int* t, const int* in0,
                            int n, int n0) {
  const int rows = tab(t, H_ROWS), row0 = tab(t, H_ROW0);
  const int rb = tab(t, H_ROW_BYTES);
  const int E = tab(t, H_E), so = tab(t, H_SEMB_OFF);
  const char* sslot = sm + tab(t, H_SSLOT_OFF);
  for (int i = tid; i < rows * E; i += kThreads) {
    const int r = i % rows, k = i / rows;
    reinterpret_cast<float*>(sm + row0 + r * rb + so)[k] =
        n0 + r < n ? bf(slot_col(sslot, k, n, n0, r, rows)) : 0.f;
  }
  if (!in0[IO_CN]) return;
  const char* xslot = sm + tab(t, H_XSLOT_OFF);
  const int cin = in0[IO_C], tva = in0[IO_TV], tvap = (tva + 15) & ~15;
  const int xo = in0[IO_OFF], xs = in0[IO_STRIDE], cs = xs - 8;
  for (int i = tid; i < rows * tvap * cs; i += kThreads) {
    const int r = i % rows, pc = i / rows, c = pc % cs, p = pc / cs;
    *reinterpret_cast<uint16_t*>(sm + row0 + r * rb + xo + (p * xs + c) * 2) =
        p < tva && c < cin && n0 + r < n
            ? slot_col(xslot, c * tva + p, n, n0, r, rows)
            : 0;
  }
}

// one output of the tile's rows below N: an intermediate from its tiles,
// 16 bytes a thread; or eps = bf16(f + x), x from the x slot
__device__ void store_output(int tid, const char* sm, const int* t,
                             const int* io, uint16_t* __restrict__ dst,
                             int n, int n0) {
  const int rows = tab(t, H_ROWS), row0 = tab(t, H_ROW0);
  const int rb = tab(t, H_ROW_BYTES);
  const int c = io[IO_C], tv = io[IO_TV], off = io[IO_OFF];
  const int st = io[IO_STRIDE];
  if (io[IO_CN]) {
    const char* xslot = sm + tab(t, H_XSLOT_OFF);
    for (int i = tid; i < rows * c * tv; i += kThreads) {
      const int r = i % rows, ctv = i / rows;
      if (n0 + r >= n) continue;
      const int ch = ctv / tv, p = ctv % tv;
      const float f = bf(*reinterpret_cast<const uint16_t*>(
          sm + row0 + r * rb + off + (p * st + ch) * 2));
      const float x0 = bf(slot_col(xslot, ctv, n, n0, r, rows));
      dst[static_cast<size_t>(ctv) * n + n0 + r] = to_bf(f + x0);
    }
    return;
  }
  const int q = c / 8;
  for (int i = tid; i < rows * tv * q; i += kThreads) {
    const int r = i / (tv * q), p = i / q % tv, k = i % q;
    if (n0 + r >= n) continue;
    *reinterpret_cast<uint4*>(dst + (static_cast<size_t>(n0 + r) * tv + p) *
                                        c + k * 8) =
        *reinterpret_cast<const uint4*>(sm + row0 + r * rb + off +
                                        (p * st + k * 8) * 2);
  }
}

// ---- the kernel ------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
denoiser_kernel_tc_grouped(const uint16_t* __restrict__ in0,
                           const uint16_t* __restrict__ in1,
                           const uint16_t* __restrict__ semb,
                           uint16_t* __restrict__ out0,
                           uint16_t* __restrict__ out1,
                           const char* __restrict__ blob,
                           const int* __restrict__ table, int n) {
  extern __shared__ __align__(128) char sm[];
  __shared__ int st[kMaxTable];
  const int tid = threadIdx.x;
  for (int i = tid; i < H_LEN + __ldg(table + H_NOPS) * O_LEN; i += kThreads)
    st[i] = __ldg(table + i);
  __syncthreads();
  const int* t = st;
  const int nops = tab(t, H_NOPS), rows = tab(t, H_ROWS);
  const int* io_in0 = t + H_IO;
  const int* io_in1 = io_in0 + IO_LEN;
  const int* io_out0 = io_in1 + IO_LEN;
  const int* io_out1 = io_out0 + IO_LEN;
  const int ntiles = (n + rows - 1) / rows;
  const int stride = static_cast<int>(gridDim.x);
  char* wbuf[2] = {sm + tab(t, H_WBUF0), sm + tab(t, H_WBUF1)};
  const int* ops = t + H_LEN;
  // every row area starts at 0: the tiles' padding (positions past T*V,
  // channels past C) stays 0, and the copies fill the rest
  const int row0 = tab(t, H_ROW0);
  for (int i = tid * 16; i < rows * tab(t, H_ROW_BYTES); i += kThreads * 16)
    *reinterpret_cast<uint4*>(sm + row0 + i) = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  int buf = 0;
  stage(tid, sm + tab(t, H_EMBW_OFF), blob, tab(t, H_EMBW_BLOB),
        tab(t, H_EMBW_BYTES));
  stage(tid, wbuf[0], blob, tab(ops, O_BLOB), tab(ops, O_BLOB_BYTES));
  if (static_cast<int>(blockIdx.x) < ntiles) {
    const int n0 = blockIdx.x * rows;
    prefetch_cols(tid, smem_addr(sm + tab(t, H_SSLOT_OFF)), semb, tab(t, H_E),
                  n, n0, rows);
    prefetch_input(tid, sm, t, io_in0, in0, n, n0);
    cp_async_commit();
  }
  for (int tile = blockIdx.x; tile < ntiles; tile += stride) {
    const int n0 = tile * rows;
    // whether op k issues a prefetch after the next op's constants, the
    // last group committed, which the next wait may leave in flight
    auto prefetches = [&](int k) {
      return (k == 0 && io_in1[IO_C] > 0) ||
             (k == 1 && tile + stride < ntiles);
    };
    cp_async_wait_all();
    __syncthreads();     // this tile's in0 and silu_emb (first: W_e, b_e)
    unpack_tile(tid, sm, t, io_in0, n, n0);
    __syncthreads();     // silu_emb and x in place, the slots free
    embed_all<4>(tid, sm, t, rows);
    for (int op = 0; op < nops; ++op) {
      if (op > 0 && prefetches(op - 1))
        cp_async_wait_1();
      else
        cp_async_wait_all();
      __syncthreads();   // this op's constants and the last op's output
      const int next = op + 1 < nops ? op + 1
                       : tile + stride < ntiles ? 0 : -1;
      if (next >= 0)
        stage(tid, wbuf[buf ^ 1], blob, tab(ops + next * O_LEN, O_BLOB),
              tab(ops + next * O_LEN, O_BLOB_BYTES));
      if (op == 0 && prefetches(0)) {
        // in1 of this tile: its tiles (or the x slot) are free since the
        // last tile's last op (its store)
        prefetch_input(tid, sm, t, io_in1, in1, n, n0);
        cp_async_commit();
      }
      if (op == 1 && prefetches(1)) {
        // the next tile's in0 and silu_emb: in0's tiles are free once the
        // first op has run, the slots since this tile's unpack
        const int nn = (tile + stride) * rows;
        prefetch_cols(tid, smem_addr(sm + tab(t, H_SSLOT_OFF)), semb,
                      tab(t, H_E), n, nn, rows);
        prefetch_input(tid, sm, t, io_in0, in0, n, nn);
        cp_async_commit();
      }
      run_op<true>(tid, sm, t, ops + op * O_LEN, wbuf[buf], rows);
      buf ^= 1;
    }
    if (prefetches(nops - 1))
      cp_async_wait_1();   // K5's x has landed, the next tile's may not
    else
      cp_async_wait_all();
    __syncthreads();
    store_output(tid, sm, t, io_out0, out0, n, n0);
    if (io_out1[IO_C] > 0) store_output(tid, sm, t, io_out1, out1, n, n0);
  }
}

}  // namespace
}  // namespace mocodad_tcg

// Launch one group on `stream`: one persistent block per SM (fewer for a
// small N), tiles of `rows` rows (the table's).  Returns the CUDA error
// code (0 on success); allocates nothing and does not synchronise.
extern "C" int mocodad_grouped_tc_launch(const uint16_t* in0,
                                         const uint16_t* in1,
                                         const uint16_t* semb, uint16_t* out0,
                                         uint16_t* out1, const char* blob,
                                         const int* table, int n, int rows,
                                         int smem_bytes, void* stream) {
  using namespace mocodad_tcg;
  cudaError_t err = cudaFuncSetAttribute(
      denoiser_kernel_tc_grouped, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n + rows - 1) / rows;
  const int grid = tiles < sms ? tiles : sms;
  denoiser_kernel_tc_grouped<<<grid, kThreads, smem_bytes,
                               static_cast<cudaStream_t>(stream)>>>(
      in0, in1, semb, out0, out1, blob, table, n);
  return static_cast<int>(cudaGetLastError());
}

// The plan this build reads: warps per block, the longest table, the
// header (with the I/O records), I/O record and op record lengths.  The
// host checks all five before the first launch.
extern "C" int mocodad_grouped_tc_warps_per_block() {
  return mocodad_tcg::kWarps;
}
extern "C" int mocodad_grouped_tc_max_table() {
  return mocodad_tcg::kMaxTable;
}
extern "C" int mocodad_grouped_tc_header_len() { return mocodad_tcg::H_LEN; }
extern "C" int mocodad_grouped_tc_io_len() { return mocodad_tcg::IO_LEN; }
extern "C" int mocodad_grouped_tc_op_len() { return mocodad_tcg::O_LEN; }
