// Eval-mode STSAEUnet denoiser forward in bfloat16 on Hopper's tensor
// cores (sm_90a): B1 at compute dtype bfloat16, its channel and residual
// mixes as warpgroup MMAs (wgmma.mma_async m64nNk16, bf16 in, f32
// accumulate), its graph mixes as mma.sync.m16n8k16 with the graph
// operator held in registers.
//
// Replaces: mocodad_tpu/ops/pallas_unet.py:105 build_pallas_denoiser (the
// inner `kernel`, :141-204) at compute_dtype=bfloat16, kernel B1 of the JAX
// package.  The same function as csrc/denoiser_tc.cu (every product on
// mma.sync, kept as the yardstick) and as the plain version
// ops/pallas_unet.denoise_reference(compute_dtype=torch.bfloat16): the same
// folded constants rounded to bfloat16, the same association (graph
// operator first, then channel mix), float32 accumulation, rounding to
// bfloat16 at B1's cast points (pallas_unet.py:157-204), and g kept
// float32 in value: it enters the channel mix as g_hi = bf16(g) and g_lo =
// bf16(g - g_hi), two products into one accumulator (rounding g once would
// compute B2's function).
//
// Contract: as csrc/denoiser_tc.cu, with the plan of
// ops/pallas_unet.pack_for_wg_kernel (the same header; op records with W
// and Wr in wgmma's B layout and a mask of each output tile's nonzero
// blocks of the graph operator).  Any N: rows past N are read as 0 and
// never written.
//
// What bounds it: operations, as for denoiser_tc.cu: 270.46 GFLOP per call
// at N = 51,200 at the flagship shapes, 0.27 ms at the H100 SXM's 989
// TFLOP/s of dense bf16, against under 0.01 ms for the bytes.  The
// mma.sync kernel ran at 6 % of that bound, its loops paced by
// shared-memory fragment reads: every (row, 16 positions) unit re-read
// each W fragment of its op (ldmatrix, one per two MMAs) and each K
// fragment of its graph mix for every 16-channel chunk.  Here the channel
// mixes read W once per warpgroup and the graph mixes read K once per
// unit.  Each op is one chain per warp (graph mix, split, wgmmas, wait,
// epilogue) between two block barriers, one unit per warp at these
// shapes, every warp in the same phase at once, and the instructions the
// four sub-partitions issue pace it more than any one unit's latency:
// fewer instructions per unit bought more than more warpgroups at work
// (PERF.md section 5, tools/perf/probe_tc_phases.py).  So C_out is split
// as little as the wgmma widths allow, bf16 pairs are rounded by one
// cvt.rn.bf16x2, the descriptors step by a chunk's offset, and the joint
// re-scalings round on pairs.
//
// Design.
//   * The channel mixes on wgmma.  W is the same for every unit of an op,
//     so any four units stack into one M = 64 warpgroup MMA: each warp of
//     a warpgroup supplies its own unit's 16 positions as the register A
//     operand (a warp's 16-row slice of wgmma's register A fragment is
//     mma.sync m16n8k16's A layout, so g_hi, g_lo and f's ldmatrix
//     fragment go in as they are), and B, the op's (16 input channels x
//     N output channels) chunk of W or Wr, is read from shared memory
//     through a descriptor once per warpgroup instead of once per warp.
//     A warp's 16 rows of the accumulator are mma.sync's accumulator
//     tiles, so the epilogue is the mma.sync kernel's.  The activations
//     keep that kernel's layout; only W and Wr are packed in wgmma's
//     K-major layout without swizzle (8x8 core matrices of 16-byte rows,
//     the two along K kLbo bytes apart, 8-row groups along N kSbo apart,
//     16 input channels 32 x C_out bytes), so each op's block is still
//     one byte-for-byte copy.  N is C_out or a part of it (16, 32 or 64
//     channels: O_NSPLIT, as few parts as those widths allow,
//     pallas_unet.wg_nsplit: a part recomputes its units' graph mixes, and
//     the sub-partitions' issue, not the idle warpgroups, paces an op).
//     Two 16-channel chunks go per round: their graph mixes, then their 4
//     (6 with a residual mix) wgmmas, one wait.
//     Holding a round's A registers through the next round's graph mixes
//     (to overlap the two) runs 128 registers short: ptxas then
//     serializes every wgmma of the build, and a build that did it with K
//     read from shared memory instead ran slower.  Splitting a wgmma in
//     two independent halves ran slower too (probe_wgmma_rate.py: more
//     chains of narrow wgmmas lose rate).
//   * The graph mixes keep K in registers: a unit loads its 16 output
//     positions' K fragments once per op and reads only f per MMA (one
//     ldmatrix.trans per two MMAs, where the mma.sync kernel read two),
//     and skips the 16x16 blocks of K that are zero (O_KMASK, a mask per
//     output tile from the host): the joint re-scalings' operators are
//     block-diagonal over frames, so 25 % of their blocks at T = 3 and 55 %
//     at T = 6 are skipped.
//   * Code size: one body per op kind and width, with K's registers for 4
//     steps (all the 4-row build needs, T*V <= 64) or, in the 2-row build
//     only, 7; the masks skip the steps an op lacks.  A body per step count
//     made the build over twice as large, slower to fetch at each op and
//     short of registers.
//   * Each op's constants arrive by one bulk copy (TMA, issued by one
//     thread one op ahead, completing on an mbarrier), which also writes
//     through the async proxy that wgmma reads.  Per-thread cp.async
//     copies cost every thread issue slots at each op's start (the build
//     with them ran slower).
//   * Kept from the mma.sync kernel: persistent blocks, one per SM, every
//     layer's embedding once per tile, kRows = 4 fold rows per tile up to
//     T = 3 and 2 above (at T >= 4 a warpgroup stacks 2 rows x 2 position
//     tiles), 16 warps.
//   * Registers: 16 warps, so at most 128 a thread (__launch_bounds__).
//     The widest unit holds 32 accumulators (N = 64), 16 K fragment
//     registers, two chunks' g, g_hi, g_lo and f fragments; a 64-channel
//     wgmma runs only in the short code (the host splits wider units past
//     4 K steps, pallas_unet.wg_unit_tiles).  ptxas's -v line in
//     chip_smoke.py's build shows the count and spills of the build.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mocodad_wg {
namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kGroups = kWarps / 4;   // warpgroups per block
constexpr int kMaxTable = 512;        // ints of the table in shared memory
// K steps of 16 input positions held in registers: an op of up to kShortKs
// steps runs the short code, longer ones (the 2-row build only) the long
// code; the mask of an output tile's steps skips the rest.  Two bodies per
// op kind instead of one per step count keep the build small: each op
// fetches its code anew, and a tile walks 15 ops.
constexpr int kShortKs = 4;           // all the 4-row build holds (T*V <= 64)
constexpr int kMaxKs = 7;             // T*V up to 112
constexpr int kMaxNt8Ks = kShortKs;   // K steps beside a 64-channel wgmma
constexpr uint32_t kLbo = 128;        // B: the two core matrices along K
constexpr uint32_t kSbo = 256;        // B: successive 8-row groups along N

// table header (every offset in bytes, strides in bf16 elements): as
// csrc/denoiser_tc.cu
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
  O_NSPLIT,                     // parts of C_out, one wgmma width each
                                //   (1 for a joint re-scaling)
  O_TVI, O_TVO, O_MT, O_KS,     // T*V in / out; 16-position tiles out / in
  O_IN, O_IN_STRIDE, O_OUT, O_OUT_STRIDE, O_SKIP, O_SKIP_STRIDE,
  O_RES,                        // 1: residual mix Wr, 0: identity
  O_BLOB, O_BLOB_BYTES,         // the op's constants in the blob
  O_K, O_K_STRIDE,              // K as a bf16 tile (bytes; elements)
  O_W, O_W_STRIDE, O_WR,        // W, Wr in wgmma's B layout (bytes; bytes
                                //   per 16 input channels)
  O_BIAS, O_SLOPE, O_RS, O_RT,  // float32 vectors (bytes)
  O_EMB,                        // the layer's first embedding column
  O_KMASK,                      // int32 per output tile: K's nonzero
                                //   16x16 blocks along the input (bytes)
  O_LEN
};

// PTX wrappers, bf16 helpers, embed_all and stage, shared with the
// mma.sync kernels (their op code is not used here)
#include "denoiser_tc_body.cuh"

// ---- wgmma -----------------------------------------------------------------

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// blob[off .. off + bytes) -> dst by one bulk copy (the TMA unit: one
// instruction from one thread, no load-store traffic of the block's
// threads), completing on `bar`; issued after the block barrier that frees
// dst (the proxy fence orders the generic reads of the op before it against
// the copy's writes).  The copy writes through the async proxy that wgmma
// reads, and `bar`'s completion makes it visible to the threads' loads.
__device__ __forceinline__ void bulk_stage(uint32_t dst, const char* src,
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
// the accumulators stay in place around the asynchronous MMAs
template <int NT>
__device__ __forceinline__ void keep(float (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[j][i])::"memory");
}

// two floats -> one register of bf16 (a in the low half), to nearest even,
// as pack() does, in one instruction
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(b), "f"(a));
  return d;
}
// (a, b) = hi + lo with hi = bf16(a, b) and lo = bf16((a, b) - hi), as
// split() does
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  hi = pack2(a, b);
  const float2 h = unpack(hi);
  lo = pack2(a - h.x, b - h.y);
}

// B's descriptor: K-major, no swizzle, start at shared address `addr`
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kLbo >> 4) << 16) |
         (static_cast<uint64_t>(kSbo >> 4) << 32);
}

#define WG_D(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
#define WG_IN "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)

// d (64 x 8 NT; this warp's 16 rows as NT accumulator tiles) += a (this
// warp's 16 x 16 A fragment) * B (16 x 8 NT at desc)
template <int NT>
__device__ __forceinline__ void wgmma(float (&d)[NT][4],
                                      const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (NT == 2) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, "
        "1, 0;\n}\n"
        : WG_D(0), WG_D(1)
        : WG_IN);
  } else if constexpr (NT == 4) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : WG_D(0), WG_D(1), WG_D(2), WG_D(3)
        : WG_IN);
  } else {
    static_assert(NT == 8, "wgmma of 16, 32 or 64 output channels");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : WG_D(0), WG_D(1), WG_D(2), WG_D(3), WG_D(4), WG_D(5), WG_D(6),
          WG_D(7)
        : WG_IN);
  }
}

#undef WG_D
#undef WG_IN

// A table entry broadcast from lane 0: ptxas then knows every branch and
// loop bound around the wgmmas is uniform (it serializes wgmma.mma_async
// on a path it takes for divergent)
__device__ __forceinline__ int utab(const int* t, int i) {
  return __shfl_sync(0xffffffffu, t[i], 0);
}

// ---- the graph mix ---------------------------------------------------------

// K's fragments for 16 output positions from m0, the steps in `mask`
template <int KS>
__device__ __forceinline__ void load_k(uint32_t (&kf)[KS][4], uint32_t k_base,
                                       int k_st, int m0, int mask, int lane) {
  const int ar = lane & 15, ac = (lane >> 4) << 3;
#pragma unroll
  for (int s = 0; s < KS; ++s)
    if (mask >> s & 1)
      ldsm_x4(k_base + ((m0 + ar) * k_st + s * 16 + ac) * 2, kf[s]);
}

// g (16 positions, 16 channels from c0) = K f over the steps in `mask`, as
// two 16x8 accumulator tiles; each group of up to 4 steps issues its loads
// of f before its MMAs
template <int KS>
__device__ __forceinline__ void graph_mix_k(float (&g)[2][4],
                                            const uint32_t (&kf)[KS][4],
                                            int mask, uint32_t f_base,
                                            int f_st, int c0, int lane) {
  const int ar = lane & 15, ac = (lane >> 4) << 3;
#pragma unroll
  for (int s0 = 0; s0 < KS; s0 += 4) {
    uint32_t b[4][4];
#pragma unroll
    for (int s = s0; s < s0 + 4 && s < KS; ++s)
      if (mask >> s & 1)
        ldsm_x4_t(f_base + ((s * 16 + ar) * f_st + c0 + ac) * 2, b[s - s0]);
#pragma unroll
    for (int s = s0; s < s0 + 4 && s < KS; ++s) {
      if (mask >> s & 1) {
        mma(g[0], kf[s], b[s - s0][0], b[s - s0][1]);
        mma(g[1], kf[s], b[s - s0][2], b[s - s0][3]);
      }
    }
  }
}

// ---- the ops ---------------------------------------------------------------

// An ST-GCNN unit's epilogue on its accumulator tiles (16 positions from
// m0 of row `row`, 8 NT channels from o0): (+ f), + bias, PReLU, +
// embedding, every load before the first store; rounded and stored, 0
// past T*V
template <int NT>
__device__ __forceinline__ void store_gcn(float (&acc)[NT][4], const char* sm,
                                          const int* t, const int* d,
                                          const char* wb, char* row, int r,
                                          int m0, int o0, int lane, bool res) {
  const float* e = reinterpret_cast<const float*>(sm + tab(t, H_EMB_OFF)) +
                   tab(d, O_EMB) + r * tab(t, H_EMB_STRIDE);
  const int tvo = tab(d, O_TVO);
  const int in_off = tab(d, O_IN), in_st = tab(d, O_IN_STRIDE);
  const int out_off = tab(d, O_OUT), out_st = tab(d, O_OUT_STRIDE);
  const float* bias = reinterpret_cast<const float*>(wb + tab(d, O_BIAS));
  const float slope = *reinterpret_cast<const float*>(wb + tab(d, O_SLOPE));
  const int gid = lane >> 2, tig = lane & 3;
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
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int o = o0 + j * 8 + tig * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = m0 + gid + h * 8;
      *reinterpret_cast<uint32_t*>(row + out_off + (p * out_st + o) * 2) =
          p < tvo ? pack2(acc[j][2 * h], acc[j][2 * h + 1]) : 0u;
    }
  }
}

// One ST-GCNN layer over the tile's `rows` rows.  A warpgroup unit is four
// (row, 16 positions) units, one per warp (the last group's missing ones
// recompute the op's last unit and store nothing), and one of the layer's
// O_NSPLIT parts of C_out (8 NT channels).
template <int NT, int KS>
__device__ __forceinline__ void wg_gcn(char* sm, const int* t, const int* d,
                                       const char* wb, int rows, int warp,
                                       int lane) {
  const int row0 = tab(t, H_ROW0), rb = tab(t, H_ROW_BYTES);
  const int ci = utab(d, O_CI), mt = utab(d, O_MT), ns = utab(d, O_NSPLIT);
  const int in_off = tab(d, O_IN), in_st = tab(d, O_IN_STRIDE);
  const uint32_t k_base = smem_addr(wb + tab(d, O_K));
  const int k_st = tab(d, O_K_STRIDE);
  const uint32_t w_base = smem_addr(wb + tab(d, O_W));
  const bool res = utab(d, O_RES) != 0;
  const uint32_t wr_base = smem_addr(wb + tab(d, res ? O_WR : O_W));
  const int dstep = tab(d, O_W_STRIDE) >> 4;
  const int* kmask = reinterpret_cast<const int*>(wb + tab(d, O_KMASK));
  const int ar = lane & 15, ac = (lane >> 4) << 3;
  const int units = rows * mt, groups = (units + 3) / 4;
  for (int v = warp >> 2; v < groups * ns; v += kGroups) {
    const int unit = v / ns * 4 + (warp & 3);
    const bool live = unit < units;
    const int uu = live ? unit : units - 1;
    const int r = uu / mt, mi = uu % mt, m0 = mi * 16;
    const int o0 = v % ns * NT * 8;
    char* row = sm + row0 + r * rb;
    const uint32_t f_base = smem_addr(row + in_off);
    const int mask = __shfl_sync(0xffffffffu, kmask[mi], 0);
    uint32_t kf[KS][4];
    load_k<KS>(kf, k_base, k_st, m0, mask, lane);
    // W's and Wr's descriptors at this part's first chunk: a chunk on is
    // O_W_STRIDE / 16 more in the address field, which never carries out
    // of its 14 bits (shared addresses stay below 256 KB)
    const uint64_t dw = b_desc(w_base + o0 / 8 * kSbo);
    const uint64_t dr = b_desc(wr_base + o0 / 8 * kSbo);
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    // two 16-channel chunks at a time: their graph mixes are independent
    // chains, and their wgmmas share one wait
    for (int c0 = 0; c0 < ci; c0 += 32) {
      const int nc = c0 + 16 < ci ? 2 : 1;
      float g[2][2][4] = {};
      graph_mix_k<KS>(g[0], kf, mask, f_base, in_st, c0, lane);
      if (nc == 2)
        graph_mix_k<KS>(g[1], kf, mask, f_base, in_st, c0 + 16, lane);
      // the accumulator tiles of g are this warp's slice of A
      uint32_t hi[2][4], lo[2][4], fa[2][4];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        split2(g[q][0][0], g[q][0][1], hi[q][0], lo[q][0]);
        split2(g[q][0][2], g[q][0][3], hi[q][1], lo[q][1]);
        split2(g[q][1][0], g[q][1][1], hi[q][2], lo[q][2]);
        split2(g[q][1][2], g[q][1][3], hi[q][3], lo[q][3]);
        if (res && q < nc)
          ldsm_x4(f_base + ((m0 + ar) * in_st + c0 + q * 16 + ac) * 2,
                  fa[q]);
      }
      keep<NT>(acc);
      wg_fence();
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q < nc) {
          const uint64_t dq = static_cast<uint64_t>(c0 / 16 + q) * dstep;
          wgmma<NT>(acc, hi[q], dw + dq);
          wgmma<NT>(acc, lo[q], dw + dq);
          if (res) wgmma<NT>(acc, fa[q], dr + dq);
        }
      }
      wg_commit();
      // done before the next graph mixes overwrite g: holding these A
      // registers across them runs 128 registers short
      wg_wait_all();
      keep<NT>(acc);
    }
    if (live) store_gcn<NT>(acc, sm, t, d, wb, row, r, m0, o0, lane, res);
  }
}

// One joint re-scaling: h = D f over D's nonzero 16x16 blocks, then
// round(h * rs + rt) and, with a skip, round(. + skip); 0 past T*V.  A
// unit is (row, 16 positions), one warp each.
template <int KS>
__device__ __forceinline__ void wg_joint(char* sm, const int* t,
                                         const int* d, const char* wb,
                                         int rows, int warp, int lane) {
  const int row0 = tab(t, H_ROW0), rb = tab(t, H_ROW_BYTES);
  const int cs = tab(d, O_CI), tvo = tab(d, O_TVO), mt = tab(d, O_MT);
  const int in_off = tab(d, O_IN), in_st = tab(d, O_IN_STRIDE);
  const int out_off = tab(d, O_OUT), out_st = tab(d, O_OUT_STRIDE);
  const int skip_off = tab(d, O_SKIP), skip_st = tab(d, O_SKIP_STRIDE);
  const uint32_t k_base = smem_addr(wb + tab(d, O_K));
  const int k_st = tab(d, O_K_STRIDE);
  const int* kmask = reinterpret_cast<const int*>(wb + tab(d, O_KMASK));
  const float* rs = reinterpret_cast<const float*>(wb + tab(d, O_RS));
  const float* rt = reinterpret_cast<const float*>(wb + tab(d, O_RT));
  const int gid = lane >> 2, tig = lane & 3;
  for (int u = warp; u < rows * mt; u += kWarps) {
    const int r = u / mt, mi = u % mt, m0 = mi * 16;
    char* row = sm + row0 + r * rb;
    const uint32_t f_base = smem_addr(row + in_off);
    const int mask = kmask[mi];
    uint32_t kf[KS][4];
    load_k<KS>(kf, k_base, k_st, m0, mask, lane);
    for (int c00 = 0; c00 < cs; c00 += 32) {
      // two chunks' graph mixes in flight before their epilogues
      float gg[2][2][4] = {};
      graph_mix_k<KS>(gg[0], kf, mask, f_base, in_st, c00, lane);
      if (c00 + 16 < cs)
        graph_mix_k<KS>(gg[1], kf, mask, f_base, in_st, c00 + 16, lane);
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
            // round(h * rs + rt) as a bf16 pair, then round(. + skip)
            uint32_t y = pack2(g[nt][2 * h] * s + b, g[nt][2 * h + 1] * s + b);
            if (skip_off >= 0) {
              const float2 k = unpack(*reinterpret_cast<const uint32_t*>(
                  row + skip_off + (p * skip_st + o) * 2));
              const float2 z = unpack(y);
              y = pack2(z.x + k.x, z.y + k.y);
            }
            v[nt][h] = p < tvo ? y : 0u;
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

// wgmmas of 16, 32 or 64 channels (64 only in the short code: the host
// packs no wider unit beside more K steps, pallas_unet.wg_unit_tiles)
template <int KS>
__device__ __forceinline__ void wg_run_ks(char* sm, const int* t,
                                          const int* d, const char* wb,
                                          int rows, int warp, int lane) {
  if (utab(d, O_KIND) == 1) {
    wg_joint<KS>(sm, t, d, wb, rows, warp, lane);
    return;
  }
  switch (utab(d, O_NT) / utab(d, O_NSPLIT)) {
    case 2:
      wg_gcn<2, KS>(sm, t, d, wb, rows, warp, lane);
      break;
    case 4:
      wg_gcn<4, KS>(sm, t, d, wb, rows, warp, lane);
      break;
    case 8:
      if constexpr (KS <= kMaxNt8Ks)
        wg_gcn<8, KS>(sm, t, d, wb, rows, warp, lane);
      break;
    default:
      break;
  }
}

template <int kRows>
__device__ __forceinline__ void wg_run_op(int tid, char* sm, const int* t,
                                          const int* d, const char* wb,
                                          int rows) {
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  if (utab(d, O_KS) <= kShortKs)
    wg_run_ks<kShortKs>(sm, t, d, wb, rows, warp, lane);
  else if constexpr (kRows < 4)
    wg_run_ks<kMaxKs>(sm, t, d, wb, rows, warp, lane);
}

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
// for the most that fit, pack_for_wg_kernel)
template <int kRows>
__global__ void __launch_bounds__(kThreads, 1)
denoiser_kernel_wg(const uint16_t* __restrict__ x,
                   const float* __restrict__ semb,
                   const char* __restrict__ blob,
                   const int* __restrict__ table, uint16_t* __restrict__ eps,
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
  char* wbuf[2] = {sm + tab(t, H_WBUF0), sm + tab(t, H_WBUF1)};
  const int* ops = t + H_LEN;
  int buf = 0;
  stage(tid, sm + tab(t, H_EMBW_OFF), blob, tab(t, H_EMBW_BLOB),
        tab(t, H_EMBW_BYTES));
  uint32_t parity = 0;   // bit b: the phase of buffer b's next completion
  if (tid == 0)
    bulk_stage(smem_addr(wbuf[0]), blob + tab(ops, O_BLOB),
               tab(ops, O_BLOB_BYTES), bar[0]);
  for (int tile = blockIdx.x; tile < ntiles; tile += stride) {
    const int n0 = tile * kRows;
    load_tile<kRows>(tid, sm, t, x, semb, n, n0);
    cp_async_wait_all();
    __syncthreads();     // silu_emb (and, first, W_e and b_e) in place
    embed_all<kRows>(tid, sm, t, kRows);
    for (int op = 0; op < nops; ++op) {
      mbar_wait(bar[buf], parity >> buf & 1);
      parity ^= 1u << buf;
      __syncthreads();   // this op's constants and the last op's output
      const int next = op + 1 < nops ? op + 1
                       : tile + stride < ntiles ? 0 : -1;
      if (next >= 0 && tid == 0)
        bulk_stage(smem_addr(wbuf[buf ^ 1]),
                   blob + tab(ops + next * O_LEN, O_BLOB),
                   tab(ops + next * O_LEN, O_BLOB_BYTES), bar[buf ^ 1]);
      wg_run_op<kRows>(tid, sm, t, ops + op * O_LEN, wbuf[buf], kRows);
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
      denoiser_kernel_wg<kRows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n + kRows - 1) / kRows;
  const int grid = tiles < sms ? tiles : sms;
  denoiser_kernel_wg<kRows><<<grid, kThreads, smem_bytes, stream>>>(
      x, semb, blob, table, eps, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mocodad_wg

// Launch on `stream` with `rows` fold rows per tile (4 or 2, what the
// plan was packed for): one persistent block per SM (fewer for a small
// N).  Returns the CUDA error code (0 on success); allocates nothing and
// does not synchronise.
extern "C" int mocodad_denoiser_wg_launch(const uint16_t* x,
                                          const float* semb,
                                          const char* blob, const int* table,
                                          uint16_t* eps, int n, int rows,
                                          int smem_bytes, void* stream) {
  using namespace mocodad_wg;
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
// op record lengths, the most K steps.  The host checks all six before the
// first launch.
extern "C" int mocodad_denoiser_wg_row_counts() {
  return (1 << 4) | (1 << 2);
}
extern "C" int mocodad_denoiser_wg_warps_per_block() {
  return mocodad_wg::kWarps;
}
extern "C" int mocodad_denoiser_wg_max_table() {
  return mocodad_wg::kMaxTable;
}
extern "C" int mocodad_denoiser_wg_header_len() { return mocodad_wg::H_LEN; }
extern "C" int mocodad_denoiser_wg_op_len() { return mocodad_wg::O_LEN; }
extern "C" int mocodad_denoiser_wg_max_ks() { return mocodad_wg::kMaxKs; }
extern "C" int mocodad_denoiser_wg_short_ks() {
  return mocodad_wg::kShortKs;
}
