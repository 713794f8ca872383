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

constexpr int kRows = 4;
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

// ---- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col); bf16 inputs, f32 accumulator
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---- bf16 helpers ----------------------------------------------------------

__device__ __forceinline__ float bf(uint16_t u) {
  return __uint_as_float(static_cast<uint32_t>(u) << 16);
}
__device__ __forceinline__ uint16_t to_bf(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float rnd(float v) { return bf(to_bf(v)); }
// two floats -> one register of bf16 (a in the low half), to nearest even
__device__ __forceinline__ uint32_t pack(float a, float b) {
  return static_cast<uint32_t>(to_bf(a)) |
         (static_cast<uint32_t>(to_bf(b)) << 16);
}
__device__ __forceinline__ float2 unpack(uint32_t u) {
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}
// (a, b) = hi + lo with hi = bf16(a, b) and lo = bf16((a, b) - hi)
__device__ __forceinline__ void split(float a, float b, uint32_t& hi,
                                      uint32_t& lo) {
  hi = pack(a, b);
  const float2 h = unpack(hi);
  lo = pack(a - h.x, b - h.y);
}

// the table, read from its copy in shared memory
__device__ __forceinline__ int tab(const int* t, int i) { return t[i]; }

// ---- the products ----------------------------------------------------------

// g (16 positions from m0, 16 channels from c0) = K[m0.., :] f[:, c0..],
// as two 16x8 accumulator tiles, over `ks` steps of 16 input positions;
// each group of up to 4 steps issues its loads before its MMAs
__device__ __forceinline__ void graph_mix(float (&g)[2][4], uint32_t k_base,
                                          int k_st, uint32_t f_base,
                                          int f_st, int m0, int c0, int ks,
                                          int lane) {
  const int ar = lane & 15, ac = (lane >> 4) << 3;
  for (int s0 = 0; s0 < ks; s0 += 4) {
    uint32_t a[4][4], b[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (s0 + s < ks) {
        ldsm_x4(k_base + ((m0 + ar) * k_st + (s0 + s) * 16 + ac) * 2, a[s]);
        ldsm_x4_t(f_base + (((s0 + s) * 16 + ar) * f_st + c0 + ac) * 2,
                  b[s]);
      }
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (s0 + s < ks) {
        mma(g[0], a[s], b[s][0], b[s][1]);
        mma(g[1], a[s], b[s][2], b[s][3]);
      }
    }
  }
}

// One ST-GCNN layer over the block's rows: a unit is (row, 16 positions,
// NT of the layer's C_out / 8 accumulator tiles: the layer's O_NSPLIT
// parts of C_out); `res`: a residual mix (else identity).
template <int NT>
__device__ void gcn_op(char* sm, const int* t, const int* d, const char* wb,
                       int warp, int lane, bool res) {
  const int row0 = tab(t, H_ROW0), rb = tab(t, H_ROW_BYTES);
  const float* emb = reinterpret_cast<const float*>(sm + tab(t, H_EMB_OFF)) +
                     tab(d, O_EMB);
  const int es = tab(t, H_EMB_STRIDE);
  const int ci = tab(d, O_CI), tvo = tab(d, O_TVO), mt = tab(d, O_MT);
  const int ks = tab(d, O_KS), ns = tab(d, O_NSPLIT);
  const int in_off = tab(d, O_IN), in_st = tab(d, O_IN_STRIDE);
  const int out_off = tab(d, O_OUT), out_st = tab(d, O_OUT_STRIDE);
  const uint32_t k_base = smem_addr(wb + tab(d, O_K));
  const int k_st = tab(d, O_K_STRIDE);
  const uint32_t w_base = smem_addr(wb + tab(d, O_W));
  const uint32_t wr_base = smem_addr(wb + (res ? tab(d, O_WR) : 0));
  const int w_st = tab(d, O_W_STRIDE);
  const float* bias = reinterpret_cast<const float*>(wb + tab(d, O_BIAS));
  const float slope = *reinterpret_cast<const float*>(wb + tab(d, O_SLOPE));
  const int ar = lane & 15, ac = (lane >> 4) << 3;
  const int br = ((lane >> 4) << 3) + (lane & 7), bc = ((lane >> 3) & 1) << 3;
  const int gid = lane >> 2, tig = lane & 3;
  for (int u = warp; u < kRows * mt * ns; u += kWarps) {
    const int r = u / (mt * ns), m0 = (u / ns % mt) * 16;
    const int o0 = u % ns * NT * 8;
    char* row = sm + row0 + r * rb;
    const uint32_t f_base = smem_addr(row + in_off);
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int c0 = 0; c0 < ci; c0 += 16) {
      float g[2][4] = {};
      graph_mix(g, k_base, k_st, f_base, in_st, m0, c0, ks, lane);
      // the accumulator tiles of g are the channel mix's A fragment
      uint32_t hi[4], lo[4];
      split(g[0][0], g[0][1], hi[0], lo[0]);
      split(g[0][2], g[0][3], hi[1], lo[1]);
      split(g[1][0], g[1][1], hi[2], lo[2]);
      split(g[1][2], g[1][3], hi[3], lo[3]);
      // Wr f, then W g_hi for each pair of output tiles and W g_lo for
      // the pair before it, from the same W fragment: each fragment is
      // loaded once (the loop is bound by shared-memory reads) and MMAs
      // into one accumulator stand apart
      if (res) {
        uint32_t fa[4];
        ldsm_x4(f_base + ((m0 + ar) * in_st + c0 + ac) * 2, fa);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t v[4];
          ldsm_x4(wr_base + ((o0 + j * 8 + br) * w_st + c0 + bc) * 2, v);
          mma(acc[j], fa, v[0], v[1]);
          mma(acc[j + 1], fa, v[2], v[3]);
        }
      }
      uint32_t wp[4];
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t w[4];
        ldsm_x4(w_base + ((o0 + j * 8 + br) * w_st + c0 + bc) * 2, w);
        mma(acc[j], hi, w[0], w[1]);
        mma(acc[j + 1], hi, w[2], w[3]);
        if (j > 0) {
          mma(acc[j - 2], lo, wp[0], wp[1]);
          mma(acc[j - 1], lo, wp[2], wp[3]);
        }
        wp[0] = w[0]; wp[1] = w[1]; wp[2] = w[2]; wp[3] = w[3];
      }
      mma(acc[NT - 2], lo, wp[0], wp[1]);
      mma(acc[NT - 1], lo, wp[2], wp[3]);
    }
    // epilogue: (+ f), + bias, PReLU, + embedding, in place; every load
    // before the first store, which the compiler could not move them past
    const float* e = emb + r * es;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int o = o0 + j * 8 + tig * 2;
      const float2 b = *reinterpret_cast<const float2*>(bias + o);
      const float2 em = *reinterpret_cast<const float2*>(e + o);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float y0 = acc[j][2 * h] + b.x, y1 = acc[j][2 * h + 1] + b.y;
        if (!res) {
          const int p = m0 + gid + h * 8;
          const float2 f = unpack(*reinterpret_cast<const uint32_t*>(
              row + in_off + (p * in_st + o) * 2));
          y0 += f.x;
          y1 += f.y;
        }
        acc[j][2 * h] = (y0 >= 0.f ? y0 : slope * y0) + em.x;
        acc[j][2 * h + 1] = (y1 >= 0.f ? y1 : slope * y1) + em.y;
      }
    }
    // round and store; 0 past T*V
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int o = o0 + j * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = m0 + gid + h * 8;
        *reinterpret_cast<uint32_t*>(row + out_off + (p * out_st + o) * 2) =
            p < tvo ? pack(acc[j][2 * h], acc[j][2 * h + 1]) : 0u;
      }
    }
  }
}

// One joint re-scaling: h = D f (D dense, zero blocks included), then
// round(h * rs + rt) and, with a skip, round(. + skip); 0 past T*V.
__device__ void joint_op(char* sm, const int* t, const int* d, const char* wb,
                         int warp, int lane) {
  const int row0 = tab(t, H_ROW0), rb = tab(t, H_ROW_BYTES);
  const int cs = tab(d, O_CI), tvo = tab(d, O_TVO), mt = tab(d, O_MT);
  const int ks = tab(d, O_KS);
  const int in_off = tab(d, O_IN), in_st = tab(d, O_IN_STRIDE);
  const int out_off = tab(d, O_OUT), out_st = tab(d, O_OUT_STRIDE);
  const int skip_off = tab(d, O_SKIP), skip_st = tab(d, O_SKIP_STRIDE);
  const uint32_t k_base = smem_addr(wb + tab(d, O_K));
  const int k_st = tab(d, O_K_STRIDE);
  const float* rs = reinterpret_cast<const float*>(wb + tab(d, O_RS));
  const float* rt = reinterpret_cast<const float*>(wb + tab(d, O_RT));
  const int gid = lane >> 2, tig = lane & 3;
  for (int u = warp; u < kRows * mt; u += kWarps) {
    const int r = u / mt, m0 = (u % mt) * 16;
    char* row = sm + row0 + r * rb;
    const uint32_t f_base = smem_addr(row + in_off);
    for (int c00 = 0; c00 < cs; c00 += 32) {
      // two chunks' graph mixes in flight before their epilogues
      float gg[2][2][4] = {};
      graph_mix(gg[0], k_base, k_st, f_base, in_st, m0, c00, ks, lane);
      if (c00 + 16 < cs)
        graph_mix(gg[1], k_base, k_st, f_base, in_st, m0, c00 + 16, ks,
                  lane);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int c0 = c00 + q * 16;
        if (c0 >= cs) break;
        float (&g)[2][4] = gg[q];
        uint32_t v[2][2];   // every load before the first store
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = m0 + gid + h * 8;
          const float s = rs[p], b = rt[p];   // 0 past T*V (zero padded)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int o = c0 + nt * 8 + tig * 2;
            float y0 = rnd(g[nt][2 * h] * s + b);
            float y1 = rnd(g[nt][2 * h + 1] * s + b);
            if (skip_off >= 0) {
              const float2 k = unpack(*reinterpret_cast<const uint32_t*>(
                  row + skip_off + (p * skip_st + o) * 2));
              y0 = rnd(y0 + k.x);
              y1 = rnd(y1 + k.y);
            }
            v[nt][h] = p < tvo ? pack(y0, y1) : 0u;
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = m0 + gid + h * 8;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            *reinterpret_cast<uint32_t*>(
                row + out_off + (p * out_st + c0 + nt * 8 + tig * 2) * 2) =
                v[nt][h];
        }
      }
    }
  }
}

// Every layer's embedding for the tile's rows:
// emb[r][q] = sum_e W_e^T[e][q] silu_emb[r][e] + b_e[q], q over all
// layers' (padded) output channels, from the block-resident W_e^T (E rows,
// so a warp's loads are consecutive) and b_e; a thread takes one q for
// every row
__device__ void embed_all(int tid, char* sm, const int* t) {
  const int row0 = tab(t, H_ROW0), rb = tab(t, H_ROW_BYTES);
  const int E = tab(t, H_E), so = tab(t, H_SEMB_OFF);
  float* emb = reinterpret_cast<float*>(sm + tab(t, H_EMB_OFF));
  const int es = tab(t, H_EMB_STRIDE);
  const uint16_t* we = reinterpret_cast<const uint16_t*>(
      sm + tab(t, H_EMBW_OFF));
  const float* eb = reinterpret_cast<const float*>(we + es * E);
  for (int q = tid; q < es; q += kThreads) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = eb[q];
    for (int k = 0; k < E; ++k) {
      const float w = bf(we[k * es + q]);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        acc[r] = fmaf(w, reinterpret_cast<const float*>(
                             sm + row0 + r * rb + so)[k], acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) emb[r * es + q] = acc[r];
  }
}

__device__ void run_op(int tid, char* sm, const int* t, const int* d,
                       const char* wb) {
  const int warp = tid >> 5, lane = tid & 31;
  if (tab(d, O_KIND) == 1) {
    joint_op(sm, t, d, wb, warp, lane);
    return;
  }
  const bool res = tab(d, O_RES) != 0;
  switch (tab(d, O_NT) / tab(d, O_NSPLIT)) {   // the host packs only these
    case 2:
      gcn_op<2>(sm, t, d, wb, warp, lane, res);
      break;
    case 4:
      gcn_op<4>(sm, t, d, wb, warp, lane, res);
      break;
    case 8:
      gcn_op<8>(sm, t, d, wb, warp, lane, res);
      break;
    default:
      break;
  }
}

// ---- tile I/O --------------------------------------------------------------

// x rows n0 .. n0 + kRows - 1 -> each row's x tile (zero padded), silu_emb
// -> each row's E floats rounded to bf16; rows past N read as 0
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

// blob[off .. off + bytes) -> dst, 16 bytes per cp.async, as one group
__device__ void stage(int tid, char* dst, const char* __restrict__ blob,
                      int off, int bytes) {
  const char* src = blob + off;
  const uint32_t to = smem_addr(dst);
  for (int i = tid * 16; i < bytes; i += kThreads * 16)
    cp_async16(to + i, src + i);
  cp_async_commit();
}

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
    load_tile(tid, sm, t, x, semb, n, n0);
    cp_async_wait_all();
    __syncthreads();     // silu_emb (and, first, W_e and b_e) in place
    embed_all(tid, sm, t);
    for (int op = 0; op < nops; ++op) {
      cp_async_wait_all();
      __syncthreads();   // this op's constants and the last op's output
      const int next = op + 1 < nops ? op + 1
                       : tile + stride < ntiles ? 0 : -1;
      if (next >= 0)
        stage(tid, wbuf[buf ^ 1], blob, tab(ops + next * O_LEN, O_BLOB),
              tab(ops + next * O_LEN, O_BLOB_BYTES));
      run_op(tid, sm, t, ops + op * O_LEN, wbuf[buf]);
      buf ^= 1;
    }
    __syncthreads();
    store_tile(tid, sm, t, eps, n, n0);
    __syncthreads();     // before the next tile's loads overwrite x
  }
}

}  // namespace
}  // namespace mocodad_tc

// Launch on `stream`: one persistent block per SM (fewer for a small N).
// Returns the CUDA error code (0 on success); allocates nothing and does
// not synchronise.
extern "C" int mocodad_denoiser_tc_launch(const uint16_t* x,
                                          const float* semb,
                                          const char* blob, const int* table,
                                          uint16_t* eps, int n,
                                          int smem_bytes, void* stream) {
  using namespace mocodad_tc;
  cudaError_t err = cudaFuncSetAttribute(
      denoiser_kernel_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n + kRows - 1) / kRows;
  const int grid = tiles < sms ? tiles : sms;
  denoiser_kernel_tc<<<grid, kThreads, smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(x, semb, blob,
                                                            table, eps, n);
  return static_cast<int>(cudaGetLastError());
}

// The plan this build reads: rows per tile, warps per block, the longest
// table, header and op record lengths.  The host checks all five before
// the first launch.
extern "C" int mocodad_denoiser_tc_rows_per_block() {
  return mocodad_tc::kRows;
}
extern "C" int mocodad_denoiser_tc_warps_per_block() {
  return mocodad_tc::kWarps;
}
extern "C" int mocodad_denoiser_tc_max_table() {
  return mocodad_tc::kMaxTable;
}
extern "C" int mocodad_denoiser_tc_header_len() { return mocodad_tc::H_LEN; }
extern "C" int mocodad_denoiser_tc_op_len() { return mocodad_tc::O_LEN; }
