// Eval-mode STSAEUnet denoiser forward in float32 on Hopper's tensor cores
// (sm_90a): B1 at compute dtype float32, every product of the U-Net by
// mma.sync.m16n8k8 in TF32, three MMAs per product (3xTF32), so that the
// result keeps float32 accuracy.
//
// Replaces: mocodad_tpu/ops/pallas_unet.py:105 build_pallas_denoiser (the
// inner `kernel`, :141-204) at compute_dtype=float32, kernel B1 of the JAX
// package.  Same function as the FMA design (csrc/denoiser.cu's f32 entry,
// kept as the yardstick) and as the plain version
// ops/pallas_unet.denoise_reference(compute_dtype=torch.float32): the same
// folded constants, the same association (graph operator first, then
// channel mix), float32 accumulation and float32 everywhere in between.
//
// This is not TF32 in the sense of torch's `allow_tf32`: each float32
// operand a is taken as a_hi + a_lo, a_hi = a cut to TF32 (its low 13
// mantissa bits cleared; the constant K rounded to nearest on the host),
// a_lo = a - a_hi (exact in float32), and a product a b as a_lo b_hi +
// a_hi b_lo + a_hi b_hi, summed in float32.  The dropped a_lo b_lo and the
// TF32 truncation of a_lo leave about 2^-20 relative per product, the
// order of the FMA design's reordering error; the port's rule that float32
// on the card is float32 (device.py) stands, and the f32 check (rtol 1e-4,
// atol 1e-5) holds it.
//
// Contract: eps = denoise(x, silu_emb, folded)
//   x        (C_in, T*V, N) float32, contiguous
//   silu_emb (E, N)         float32, contiguous
//   eps      (C_in, T*V, N) float32, contiguous
//   blob     every op's constants, one contiguous block per op, laid out
//            as the shared-memory tiles below, then every layer's W_e^T and
//            b_e (ops/pallas_unet.py pack_for_tc_f32_kernel); `table`
//            (int32) the shared-memory plan, the op records and the offsets
//            into the blob.  Any N: rows past N are read as 0 and never
//            written.
//
// What bounds it: 5.28 MFLOP per fold row at the flagship shapes (C_in 2,
// T 3, V 17 -> 12 -> 10, channels up to 128, E 16), 270.46 GFLOP per call
// at N = 51,200.  On the FMA units (67 TFLOP/s of float32 on the H100 SXM)
// that is 4.04 ms; as 3xTF32 on the tensor cores (495 TFLOP/s of TF32) three
// times the work takes 1.64 ms, the least time at float32 accuracy.  The
// bytes (x, eps, silu_emb, the constants) take about 0.01 ms at 3.35 TB/s:
// operations bound it (chip_smoke.py recomputes both).
//
// Design.
//   * M comes from positions, as in the bfloat16 kernel (denoiser_tc.cu).
//     Per fold row an activation is a (T*V, C) float32 matrix in shared
//     memory, T*V padded to 16 with zero rows, C padded to 16 and the row
//     stride C + 8 floats (== 8 or 24 mod 32 words, see the banks below).
//     A warp's unit is (fold row, 16 positions, C_out or a part of it),
//     walking C_in in chunks of 32 channels (16 where C_in is 16):
//       graph mix    g[k, c] = sum_x K[k, x] f[x, c]   M = TVo, K = TVi in
//                    steps of 8, N = the chunk as 8-column tiles
//       channel mix  y[k, o] = sum_c g[k, c] W[c, o]   A = g (registers)
//       residual     y += sum_c f[k, c] Wr[c, o]       A = f (shared)
//     Each K fragment serves the chunk's 4 tiles; 16-channel chunks are
//     slower and 64-channel ones need 8 warps for their registers
//     (tools/perf/probe_tc_phases.py --variants times them in one call).
//   * The g chain, and the trap in it.  At bf16 the m16n8k16 accumulator
//     pairs pack into the next MMA's A fragment; at TF32 they do not: the
//     m16n8k8 accumulator gives a thread columns 2t and 2t+1, the A
//     fragment wants columns t and t+4.  K is summed, so it is permuted
//     instead of shuffled: the A fragment's logical column t is channel 2t
//     and t+4 is channel 2t+1.  Then the accumulator registers (c0, c2, c1,
//     c3) are the A fragment as they stand, and B's fragment needs W[o][2t]
//     and W[o][2t+1], one adjacent pair: one 8-byte shared-memory load.  The
//     residual's A operand, f[k][2t .. 2t+1], is read the same way.  g never
//     leaves registers; it is split into hi and lo there, once per chunk,
//     and each half serves every output tile of the unit.
//   * The split.  An operand split in the kernel (f, g, W, Wr) gets a_hi =
//     bits(a) & ~0x1fff, computed explicitly and never left to the MMA's
//     truncation of a raw float32: a - a_hi must be the remainder of what
//     the MMA reads.  Truncation is one instruction where rounding
//     (cvt.rna.tf32.f32, an add and a mask in SASS) is two, and the loops
//     are bound by issue: each value costs a mask and a subtraction.  a_lo
//     goes to the MMA as it is; the MMA ignores its low 13 bits.  The
//     graph operators K are constants: the host splits them (hi and lo,
//     both rounded to TF32) and packs them in fragment order, 16 bytes per
//     lane per step and half, so one conflict-free 128-bit load gives a
//     lane its A fragment with no split in the kernel.  The small terms
//     a_lo b_hi + a_hi b_lo go to an accumulator of their own, summed with
//     a_hi b_hi at the end: twice the
//     independent MMA chains, against an MMA latency several times its
//     issue interval (tools/perf/probe_mma_rate.py).  W is split in the
//     kernel, not on the host: split tiles are twice the bytes and would
//     cut d2_0, d3_0 and d3_1 into more op records, each recomputing its
//     graph mix.
//   * Layouts and banks.  ldmatrix moves 16-bit elements and .trans cannot
//     transpose 32-bit ones, so the graph mix's B operand (f with K =
//     positions) is two plain loads, f[x0 + t][c + g] and f[x0 + t + 4][c +
//     g]: 32 distinct banks when the row stride is 8 or 24 mod 32 words.
//     The 8-byte loads of W, Wr and of f as A (word g * stride + 2t per
//     half-warp) and the epilogue's 8-byte stores are conflict-free at that
//     stride too.
//   * The joint re-scalings are the graph mix with the (TVo x TVi)
//     block-diagonal operator taken dense (its zero blocks add exact zeros;
//     3 % of the function), packed like K, then the per-row affine and the
//     skip add: the same code as the ST-GCNN layers' graph mix.  On the FMA
//     units over their T diagonal blocks (a thread per row, frame, 4 output
//     joints and 4 channels) they do only the function's multiply-adds but
//     ran slower in the same call (probe_tc_phases.py --variants).
//   * Shared memory is the hard constraint: float32 doubles every tile of
//     the bfloat16 plan.  One fold row's activations (x, the skips d1 and
//     d2, silu_emb and the work area whose two ends alternate as layer
//     input and output) take 57,920 bytes at the flagship shapes, so a
//     block holds kRows = 2 rows.  Each op's constants are one block of the
//     blob, copied into one of two buffers by one bulk copy (the TMA unit:
//     one instruction from one thread, completing on an mbarrier) while the
//     previous op computes from the other, instead of 16-byte cp.async by
//     every thread, whose copies queue with the ops' own shared-memory
//     loads.  An op whose constants exceed a buffer (d3_0 with 82 KB,
//     d3_1 with 78 KB) becomes op records over parts of its C_out, each
//     with its own copy of K (the host's pack_for_tc_f32_kernel), so every
//     piece is at most 45 KB.  W_e and b_e (37 KB) are not staged:
//     the embeddings (0.3 % of the work) read them through __ldg once per
//     tile.  A tile's x and silu_emb come a tile ahead by 4-byte cp.async
//     (a tile's 2 rows are 8 bytes apart in device memory) into a small
//     buffer, so their latency hides behind the ops.  At the flagship
//     shapes the plan takes 2 x 45,328 bytes of weight buffers, 4,288 of
//     embeddings, 944 of prefetch buffer and 2 x 57,920 of activations:
//     211,728 of the 232,448 bytes a block may use, plus 3,088 of static
//     shared memory for the table and the two mbarriers.
//   * kRows = 2 rows and kWarps = 12 warps per persistent block (one per
//     SM), `__launch_bounds__(kThreads, 1)`: 168 registers a thread.  With
//     2 rows an op has only 4-8 units of (row, 16 positions); the host
//     splits C_out further over units (tc32_nsplit: the split that makes
//     the busiest warp's MMAs fewest, each unit recomputing its graph mix).
//     12 warps against 8 (201 registers) and 16 (spills): see
//     probe_tc_phases.py --variants; a build may define TC32_WARPS.
//   * Per tile: wait for its x and silu_emb, copy them into the row tiles,
//     prefetch the next tile's, compute every layer's embedding.  Per op:
//     wait on its buffer's mbarrier, one block barrier, stage the next
//     op's constants, then the units, each ending in its epilogue
//     (identity residual, bias, PReLU, + embedding; 0 for padded
//     positions), all loads before the first store, written straight to
//     the output buffer.
//   * Measured: see PERF.md (chip_smoke.py's time phase beside the FMA
//     design, probe_tc_phases.py's cycles per op).

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef TC32_WARPS
#define TC32_WARPS 12
#endif

namespace mocodad_tc32 {
namespace {

constexpr int kRows = 2;
constexpr int kWarps = TC32_WARPS;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTable = 768;   // ints of the table copied to shared memory
constexpr int kMaxE = 16;        // embedding width it unrolls for

// table header (offsets in bytes, strides in floats)
enum {
  H_NOPS, H_E, H_CIN, H_TVA, H_TVAP,
  H_ROW0, H_ROW_BYTES,          // first row's activations, bytes per row
  H_X_OFF, H_X_STRIDE,          // x (TVAP, X_STRIDE) within a row
  H_SEMB_OFF,                   // silu_emb, E floats, within a row
  H_EMB_OFF, H_EMB_STRIDE,      // every layer's embedding: kRows x
                                //   EMB_STRIDE floats
  H_EMBW_BLOB,                  // every layer's W_e^T (E, EMB_STRIDE),
                                //   then b_e, in the blob (read by __ldg)
  H_WBUF0, H_WBUF1,             // the two weight buffers
  H_OUT_OFF, H_OUT_STRIDE,      // the last op's output within a row
  H_PBUF_OFF,                   // the next tile's x and silu_emb as they
                                //   arrive: kRows x (C_in T*V + E) floats
  H_LEN
};
// one op record: kind 0 = ST-GCNN layer (or a part of its C_out), 1 = joint
// re-scaling
enum {
  O_KIND, O_CI,                 // input channels padded to 16
  O_NT,                         // this record's output channels / 8
  O_NSPLIT,                     // parts of them, one unit each
  O_TVI, O_TVO, O_MT, O_KS,     // T*V in / out; 16-position tiles out,
                                //   8-position steps in
  O_IN, O_IN_STRIDE, O_OUT, O_OUT_STRIDE, O_SKIP, O_SKIP_STRIDE,
  O_RES,                        // 1: residual mix Wr, 0: identity
  O_C0,                         // first output channel of this record
  O_BLOB, O_BLOB_BYTES,         // the record's constants in the blob
  O_K,                          // K hi/lo in fragment order (bytes)
  O_W, O_W_STRIDE, O_WR,        // float32 (8 NT, W_STRIDE) tiles (bytes)
  O_BIAS, O_SLOPE, O_RS, O_RT,  // float32 vectors (bytes)
  O_EMB,                        // this record's first embedding column
  O_LEN
};

// ---- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a (16x8, row) * b (8x8, col); TF32 inputs, f32 accumulator
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a b[q] for G output tiles in 3xTF32: the small terms a_lo b_hi + a_hi
// b_lo into ds[q], a_hi b_hi into d[q] (summed once the products are
// done), each term over all G tiles before the next, so that 2 G
// independent accumulators stand between two MMAs into one
template <int G>
__device__ __forceinline__ void mma3(float (*d)[4], float (*ds)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[G][2],
                                     const uint32_t (&bl)[G][2]) {
#pragma unroll
  for (int q = 0; q < G; ++q) mma(ds[q], al, bh[q][0], bh[q][1]);
#pragma unroll
  for (int q = 0; q < G; ++q) mma(d[q], ah, bh[q][0], bh[q][1]);
#pragma unroll
  for (int q = 0; q < G; ++q) mma(ds[q], ah, bl[q][0], bl[q][1]);
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// blob[off .. off + bytes) -> dst by one bulk copy (the TMA unit, no
// thread per 16 bytes), completing on `bar`; one thread issues it, after
// the block barrier that frees dst (the proxy fence orders the generic
// reads of the op before it against the copy's writes)
__device__ __forceinline__ void stage(uint32_t dst, const char* src,
                                      int bytes, uint32_t bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wait until `bar` completes the phase of the given parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar), "r"(parity)
      : "memory");
}

// a = hi + lo for an operand split in the kernel: hi = a with the low 13
// bits of its mantissa cleared (TF32 by truncation: one instruction; the
// MMA would truncate a raw float32 the same way, but a - hi must be taken
// from the hi that the MMA reads, so hi is cleared explicitly), lo = a - hi
// exact in float32 (the MMA reads its top 19 bits)
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = __float_as_uint(a) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(a - __uint_as_float(h));
}

// the table, read from its copy in shared memory
__device__ __forceinline__ int tab(const int* t, int i) { return t[i]; }

// ---- the products ----------------------------------------------------------

// g (16 positions of m-tile `mi`, 8 JT channels from c0) = K f, as JT
// 16x8 accumulator tiles (hi * hi in g, the small terms in gs), over `ks`
// steps of 8 input positions; K's hi and lo fragments come whole from `kf`
// (fragment order) and serve the JT tiles, f's are split here
template <int JT>
__device__ __forceinline__ void graph_mix(float (&g)[JT][4],
                                          float (&gs)[JT][4], const uint4* kf,
                                          const float* f, int f_st, int mi,
                                          int c0, int ks, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  const uint4* k = kf + static_cast<size_t>(mi) * ks * 64 + lane;
  const float* fb = f + tig * f_st + c0 + gid;
  for (int s0 = 0; s0 < ks; s0 += 2) {
    uint4 kh[2], kl[2];
    float b[2][JT][2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (s0 + s < ks) {
        kh[s] = k[(s0 + s) * 64];
        kl[s] = k[(s0 + s) * 64 + 32];
        const float* fs = fb + (s0 + s) * 8 * f_st;
#pragma unroll
        for (int j = 0; j < JT; ++j) {
          b[s][j][0] = fs[j * 8];
          b[s][j][1] = fs[4 * f_st + j * 8];
        }
      }
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (s0 + s < ks) {
        const uint32_t ah[4] = {kh[s].x, kh[s].y, kh[s].z, kh[s].w};
        const uint32_t al[4] = {kl[s].x, kl[s].y, kl[s].z, kl[s].w};
        uint32_t bh[JT][2], bl[JT][2];
#pragma unroll
        for (int j = 0; j < JT; ++j) {
          split(b[s][j][0], bh[j][0], bl[j][0]);
          split(b[s][j][1], bh[j][1], bl[j][1]);
        }
        mma3<JT>(g, gs, ah, al, bh, bl);
      }
    }
  }
}

// acc[n] += A (16 positions x 8 channels, split) W^T[8 channels, 8 outputs
// of tile n] for the NT tiles, in groups of up to 4 tiles; this lane's
// pair of W's channels (logical k rows t and t + 4) is one 8-byte load at
// wp + n * 8 rows
template <int NT>
__device__ __forceinline__ void chan_mix(float (&acc)[NT][4],
                                         float (&accs)[NT][4],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         const float* wp, int w_st) {
  constexpr int G = NT < 4 ? NT : 4;
#pragma unroll
  for (int n0 = 0; n0 < NT; n0 += G) {
    uint32_t bh[G][2], bl[G][2];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const float2 v = *reinterpret_cast<const float2*>(
          wp + (n0 + q) * 8 * w_st);
      split(v.x, bh[q][0], bl[q][0]);
      split(v.y, bh[q][1], bl[q][1]);
    }
    mma3<G>(acc + n0, accs + n0, ah, al, bh, bl);
  }
}

// One ST-GCNN layer (or a part of its C_out) over the block's rows: a unit
// is (row, 16 positions, NT of the record's output tiles: its O_NSPLIT
// parts), walking C_in in chunks of 8 JT channels; `res`: a residual mix
// (else identity).
template <int NT, int JT>
__device__ __forceinline__ void gcn_op(char* sm, const int* t, const int* d,
                                       const char* wb, int warp, int lane,
                                       bool res) {
  const int row0 = tab(t, H_ROW0), rb = tab(t, H_ROW_BYTES);
  const float* emb = reinterpret_cast<const float*>(sm + tab(t, H_EMB_OFF)) +
                     tab(d, O_EMB);
  const int es = tab(t, H_EMB_STRIDE);
  const int ci = tab(d, O_CI), tvo = tab(d, O_TVO), mt = tab(d, O_MT);
  const int ks = tab(d, O_KS), ns = tab(d, O_NSPLIT), oc = tab(d, O_C0);
  const int in_off = tab(d, O_IN), in_st = tab(d, O_IN_STRIDE);
  const int out_off = tab(d, O_OUT), out_st = tab(d, O_OUT_STRIDE);
  const uint4* kf = reinterpret_cast<const uint4*>(wb + tab(d, O_K));
  const float* w = reinterpret_cast<const float*>(wb + tab(d, O_W));
  const float* wr = reinterpret_cast<const float*>(wb + (res ? tab(d, O_WR)
                                                              : 0));
  const int w_st = tab(d, O_W_STRIDE);
  const float* bias = reinterpret_cast<const float*>(wb + tab(d, O_BIAS));
  const float slope = *reinterpret_cast<const float*>(wb + tab(d, O_SLOPE));
  const int gid = lane >> 2, tig = lane & 3;
  for (int u = warp; u < kRows * mt * ns; u += kWarps) {
    const int r = u / (mt * ns), mi = u / ns % mt, m0 = mi * 16;
    const int o0 = u % ns * NT * 8;
    char* row = sm + row0 + r * rb;
    const float* f = reinterpret_cast<const float*>(row + in_off);
    float acc[NT][4], accs[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = accs[j][i] = 0.f;
    for (int c0 = 0; c0 < ci; c0 += 8 * JT) {
      float g[JT][4] = {}, gs[JT][4] = {};
      graph_mix<JT>(g, gs, kf, f, in_st, mi, c0, ks, lane);
      if (res) {
#pragma unroll
        for (int j = 0; j < JT; ++j) {
          const float* fa = f + (m0 + gid) * in_st + c0 + j * 8 + tig * 2;
          const float2 a0 = *reinterpret_cast<const float2*>(fa);
          const float2 a1 = *reinterpret_cast<const float2*>(fa + 8 * in_st);
          uint32_t fh[4], fl[4];
          split(a0.x, fh[0], fl[0]);
          split(a1.x, fh[1], fl[1]);
          split(a0.y, fh[2], fl[2]);
          split(a1.y, fh[3], fl[3]);
          chan_mix<NT>(acc, accs, fh, fl, wr + (o0 + gid) * w_st + c0 +
                       j * 8 + tig * 2, w_st);
        }
      }
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        // the accumulator tile of g, permuted, is the channel mix's A
        // fragment (logical column t = channel 2t, t + 4 = channel 2t + 1)
        uint32_t gh[4], gl[4];
        split(g[j][0] + gs[j][0], gh[0], gl[0]);
        split(g[j][2] + gs[j][2], gh[1], gl[1]);
        split(g[j][1] + gs[j][1], gh[2], gl[2]);
        split(g[j][3] + gs[j][3], gh[3], gl[3]);
        chan_mix<NT>(acc, accs, gh, gl, w + (o0 + gid) * w_st + c0 + j * 8 +
                     tig * 2, w_st);
      }
    }
    // epilogue: (+ f), + bias, PReLU, + embedding, in place; every load
    // before the first store
    const float* e = emb + r * es;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int o = o0 + n * 8 + tig * 2;
      const float2 b = *reinterpret_cast<const float2*>(bias + o);
      const float2 em = *reinterpret_cast<const float2*>(e + o);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float y0 = acc[n][2 * h] + accs[n][2 * h] + b.x;
        float y1 = acc[n][2 * h + 1] + accs[n][2 * h + 1] + b.y;
        if (!res) {
          const int p = m0 + gid + h * 8;
          const float2 x = *reinterpret_cast<const float2*>(
              f + p * in_st + oc + o);
          y0 += x.x;
          y1 += x.y;
        }
        acc[n][2 * h] = (y0 >= 0.f ? y0 : slope * y0) + em.x;
        acc[n][2 * h + 1] = (y1 >= 0.f ? y1 : slope * y1) + em.y;
      }
    }
    // store; 0 past T*V
    float* out = reinterpret_cast<float*>(row + out_off);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int o = oc + o0 + n * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = m0 + gid + h * 8;
        *reinterpret_cast<float2*>(out + p * out_st + o) =
            p < tvo ? make_float2(acc[n][2 * h], acc[n][2 * h + 1])
                    : make_float2(0.f, 0.f);
      }
    }
  }
}

// One joint re-scaling: h = D f as a graph mix with D dense (its zero
// blocks add exact zeros), then h * rs + rt and, with a skip, + skip; 0
// past T*V.  A unit is (row, 16 positions, 32 channels).
__device__ __forceinline__ void joint_op(int tid, char* sm, const int* t,
                                         const int* d, const char* wb) {
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = tab(t, H_ROW0), rb = tab(t, H_ROW_BYTES);
  const int cs = tab(d, O_CI), tvo = tab(d, O_TVO), mt = tab(d, O_MT);
  const int ks = tab(d, O_KS), nc = cs / 32;
  const int in_off = tab(d, O_IN), in_st = tab(d, O_IN_STRIDE);
  const int out_off = tab(d, O_OUT), out_st = tab(d, O_OUT_STRIDE);
  const int skip_off = tab(d, O_SKIP), skip_st = tab(d, O_SKIP_STRIDE);
  const uint4* kf = reinterpret_cast<const uint4*>(wb + tab(d, O_K));
  const float* rs = reinterpret_cast<const float*>(wb + tab(d, O_RS));
  const float* rt = reinterpret_cast<const float*>(wb + tab(d, O_RT));
  const int gid = lane >> 2, tig = lane & 3;
  for (int u = warp; u < kRows * mt * nc; u += kWarps) {
    const int r = u / (mt * nc), mi = u / nc % mt, c0 = u % nc * 32;
    char* row = sm + row0 + r * rb;
    const float* f = reinterpret_cast<const float*>(row + in_off);
    float g[4][4] = {}, gs[4][4] = {};
    graph_mix<4>(g, gs, kf, f, in_st, mi, c0, ks, lane);
    float2 y[4][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = mi * 16 + gid + h * 8;
      const float s = rs[p], b = rt[p];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float y0 = (g[j][2 * h] + gs[j][2 * h]) * s + b;
        float y1 = (g[j][2 * h + 1] + gs[j][2 * h + 1]) * s + b;
        if (skip_off >= 0) {
          const float2 k = *reinterpret_cast<const float2*>(
              reinterpret_cast<const float*>(row + skip_off) + p * skip_st +
              c0 + j * 8 + tig * 2);
          y0 += k.x;
          y1 += k.y;
        }
        y[j][h] = p < tvo ? make_float2(y0, y1) : make_float2(0.f, 0.f);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float2*>(
            reinterpret_cast<float*>(row + out_off) +
            (mi * 16 + gid + h * 8) * out_st + c0 + j * 8 + tig * 2) =
            y[j][h];
  }
}

// Every layer's embedding for the tile's rows:
// emb[r][q] = sum_e W_e^T[e][q] silu_emb[r][e] + b_e[q], q over all
// layers' (padded) output channels, W_e^T and b_e read through __ldg (a
// warp's loads are consecutive); a thread takes one q for every row
__device__ __forceinline__ void embed_all(int tid, char* sm, const int* t,
                                          const char* __restrict__ blob) {
  const int row0 = tab(t, H_ROW0), rb = tab(t, H_ROW_BYTES);
  const int E = tab(t, H_E), so = tab(t, H_SEMB_OFF);
  float* emb = reinterpret_cast<float*>(sm + tab(t, H_EMB_OFF));
  const int es = tab(t, H_EMB_STRIDE);
  const float* we = reinterpret_cast<const float*>(blob + tab(t, H_EMBW_BLOB));
  const float* eb = we + es * E;
  for (int q = tid; q < es; q += kThreads) {
    float acc[kRows], w[kMaxE];
    const float b = __ldg(eb + q);
#pragma unroll
    for (int k = 0; k < kMaxE; ++k)
      w[k] = k < E ? __ldg(we + k * es + q) : 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = b;
#pragma unroll
    for (int k = 0; k < kMaxE; ++k) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        acc[r] = fmaf(w[k], k < E ? reinterpret_cast<const float*>(
                                        sm + row0 + r * rb + so)[k]
                                  : 0.f,
                      acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) emb[r * es + q] = acc[r];
  }
}

template <int JT>
__device__ __forceinline__ void gcn_units(char* sm, const int* t,
                                          const int* d, const char* wb,
                                          int warp, int lane) {
  const bool res = tab(d, O_RES) != 0;
  switch (tab(d, O_NT) / tab(d, O_NSPLIT)) {   // the host packs only these
    case 1:
      gcn_op<1, JT>(sm, t, d, wb, warp, lane, res);
      break;
    case 2:
      gcn_op<2, JT>(sm, t, d, wb, warp, lane, res);
      break;
    case 4:
      gcn_op<4, JT>(sm, t, d, wb, warp, lane, res);
      break;
    default:
      break;
  }
}

__device__ __forceinline__ void run_op(int tid, char* sm, const int* t,
                                       const int* d, const char* wb) {
  const int warp = tid >> 5, lane = tid & 31;
  if (tab(d, O_KIND) == 1) {
    joint_op(tid, sm, t, d, wb);
    return;
  }
  // chunks of 32 input channels where C_in allows, else 16
  if (tab(d, O_CI) % 32 == 0)
    gcn_units<4>(sm, t, d, wb, warp, lane);
  else
    gcn_units<2>(sm, t, d, wb, warp, lane);
}

// ---- tile I/O --------------------------------------------------------------

// x and silu_emb of rows n0 .. n0 + kRows - 1 below N -> the prefetch
// buffer, one 4-byte cp.async each (the rows of a tile are 8 bytes apart
// in device memory), as one group: issued a tile ahead, so that their
// latency hides behind the current tile's ops
__device__ __forceinline__ void prefetch_tile(int tid, char* sm,
                                              const int* t,
                                              const float* __restrict__ x,
                                              const float* __restrict__ semb,
                                              int n, int n0) {
  const int cv = tab(t, H_CIN) * tab(t, H_TVA), E = tab(t, H_E);
  const uint32_t pb = smem_addr(sm + tab(t, H_PBUF_OFF));
  for (int i = tid; i < kRows * (cv + E); i += kThreads) {
    const int r = i % kRows, j = i / kRows;
    if (n0 + r >= n) continue;
    const float* src = j < cv ? x + static_cast<size_t>(j) * n + n0 + r
                              : semb + static_cast<size_t>(j - cv) * n + n0 + r;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     pb + (r * (cv + E) + j) * 4),
                 "l"(src)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// the prefetch buffer -> each row's x tile (zero padded) and silu_emb;
// rows past N read as 0
__device__ __forceinline__ void load_tile(int tid, char* sm, const int* t,
                                          int n, int n0) {
  const int row0 = tab(t, H_ROW0), rb = tab(t, H_ROW_BYTES);
  const int cin = tab(t, H_CIN), tva = tab(t, H_TVA), tvap = tab(t, H_TVAP);
  const int xo = tab(t, H_X_OFF), xs = tab(t, H_X_STRIDE);
  const int E = tab(t, H_E), so = tab(t, H_SEMB_OFF);
  const int cs = xs - 8, cv = cin * tva;
  const float* pb = reinterpret_cast<const float*>(sm + tab(t, H_PBUF_OFF));
  for (int i = tid; i < kRows * tvap * cs; i += kThreads) {
    const int r = i % kRows, pc = i / kRows, c = pc % cs, p = pc / cs;
    reinterpret_cast<float*>(sm + row0 + r * rb + xo)[p * xs + c] =
        p < tva && c < cin && n0 + r < n ? pb[r * (cv + E) + c * tva + p]
                                         : 0.f;
  }
  for (int i = tid; i < kRows * E; i += kThreads) {
    const int r = i % kRows, k = i / kRows;
    reinterpret_cast<float*>(sm + row0 + r * rb + so)[k] =
        n0 + r < n ? pb[r * (cv + E) + cv + k] : 0.f;
  }
}

// eps = f + x for the tile's rows below N
__device__ __forceinline__ void store_tile(int tid, const char* sm,
                                           const int* t,
                                           float* __restrict__ eps, int n,
                                           int n0) {
  const int row0 = tab(t, H_ROW0), rb = tab(t, H_ROW_BYTES);
  const int cin = tab(t, H_CIN), tva = tab(t, H_TVA);
  const int xo = tab(t, H_X_OFF), xs = tab(t, H_X_STRIDE);
  const int oo = tab(t, H_OUT_OFF), os = tab(t, H_OUT_STRIDE);
  for (int i = tid; i < kRows * cin * tva; i += kThreads) {
    const int r = i % kRows, ctv = i / kRows;
    if (n0 + r >= n) continue;
    const int c = ctv / tva, p = ctv % tva;
    const char* row = sm + row0 + r * rb;
    const float f = reinterpret_cast<const float*>(row + oo)[p * os + c];
    const float x0 = reinterpret_cast<const float*>(row + xo)[p * xs + c];
    eps[static_cast<size_t>(ctv) * n + n0 + r] = f + x0;
  }
}

// ---- the kernel ------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
denoiser_kernel_tc32(const float* __restrict__ x,
                     const float* __restrict__ semb,
                     const char* __restrict__ blob,
                     const int* __restrict__ table, float* __restrict__ eps,
                     int n) {
  extern __shared__ __align__(128) char sm[];
  __shared__ int st[kMaxTable];
  __shared__ __align__(8) uint64_t bars[2];   // one per weight buffer
  const int tid = threadIdx.x;
  const uint32_t bar[2] = {smem_addr(&bars[0]), smem_addr(&bars[1])};
  for (int i = tid; i < H_LEN + __ldg(table + H_NOPS) * O_LEN; i += kThreads)
    st[i] = __ldg(table + i);
  if (tid == 0) {
    mbar_init(bar[0]);
    mbar_init(bar[1]);
  }
  __syncthreads();
  const int* t = st;
  const int nops = tab(t, H_NOPS);
  const int ntiles = (n + kRows - 1) / kRows;
  const int stride = static_cast<int>(gridDim.x);
  const int wb0 = tab(t, H_WBUF0), wb1 = tab(t, H_WBUF1);
  const int* ops = t + H_LEN;
  int buf = 0;
  uint32_t parity = 0;   // bit b: the phase of buffer b's next completion
  if (tid == 0)
    stage(smem_addr(sm + wb0), blob + tab(ops, O_BLOB),
          tab(ops, O_BLOB_BYTES), bar[0]);
  if (static_cast<int>(blockIdx.x) < ntiles)
    prefetch_tile(tid, sm, t, x, semb, n, blockIdx.x * kRows);
  for (int tile = blockIdx.x; tile < ntiles; tile += stride) {
    const int n0 = tile * kRows;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();     // this tile's x and silu_emb have arrived
    load_tile(tid, sm, t, n, n0);
    __syncthreads();     // x and silu_emb in place, the prefetch buffer free
    if (tile + stride < ntiles)
      prefetch_tile(tid, sm, t, x, semb, n, (tile + stride) * kRows);
    embed_all(tid, sm, t, blob);
    for (int op = 0; op < nops; ++op) {
      mbar_wait(buf ? bar[1] : bar[0], parity >> buf & 1);
      parity ^= 1u << buf;
      __syncthreads();   // this op's constants and the last op's output
      const int next = op + 1 < nops ? op + 1
                       : tile + stride < ntiles ? 0 : -1;
      if (next >= 0 && tid == 0)
        stage(smem_addr(sm + (buf ? wb0 : wb1)),
              blob + tab(ops + next * O_LEN, O_BLOB),
              tab(ops + next * O_LEN, O_BLOB_BYTES), buf ? bar[0] : bar[1]);
      run_op(tid, sm, t, ops + op * O_LEN, sm + (buf ? wb1 : wb0));
      buf ^= 1;
    }
    __syncthreads();
    store_tile(tid, sm, t, eps, n, n0);
    __syncthreads();     // before the next tile's loads overwrite x
  }
}

}  // namespace
}  // namespace mocodad_tc32

// Launch on `stream`: one persistent block per SM (fewer for a small N).
// Returns the CUDA error code (0 on success); allocates nothing and does
// not synchronise.
extern "C" int mocodad_denoiser_tc32_launch(const float* x, const float* semb,
                                            const char* blob,
                                            const int* table, float* eps,
                                            int n, int smem_bytes,
                                            void* stream) {
  using namespace mocodad_tc32;
  cudaError_t err = cudaFuncSetAttribute(
      denoiser_kernel_tc32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n + kRows - 1) / kRows;
  const int grid = tiles < sms ? tiles : sms;
  denoiser_kernel_tc32<<<grid, kThreads, smem_bytes,
                         static_cast<cudaStream_t>(stream)>>>(x, semb, blob,
                                                              table, eps, n);
  return static_cast<int>(cudaGetLastError());
}

// The plan this build reads: rows per tile, warps per block, the longest
// table, header and op record lengths.  The host checks all five before
// the first launch.
extern "C" int mocodad_denoiser_tc32_rows_per_block() {
  return mocodad_tc32::kRows;
}
extern "C" int mocodad_denoiser_tc32_warps_per_block() {
  return mocodad_tc32::kWarps;
}
extern "C" int mocodad_denoiser_tc32_max_table() {
  return mocodad_tc32::kMaxTable;
}
extern "C" int mocodad_denoiser_tc32_header_len() {
  return mocodad_tc32::H_LEN;
}
extern "C" int mocodad_denoiser_tc32_op_len() { return mocodad_tc32::O_LEN; }
