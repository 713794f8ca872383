// Eval-mode STSAEUnet denoiser forward in float32 on Hopper's tensor cores
// (sm_90a): B1 at compute dtype float32, every product of the U-Net as
// three TF32 products (3xTF32), so that the result keeps float32 accuracy;
// the channel and residual mixes as warpgroup MMAs (wgmma.mma_async
// m64nNk8, TF32 in, f32 accumulate), the graph mixes as mma.sync.m16n8k8.
//
// Replaces: mocodad_tpu/ops/pallas_unet.py:105 build_pallas_denoiser (the
// inner `kernel`, :141-204) at compute_dtype=float32, kernel B1 of the JAX
// package.  The same function as csrc/denoiser_tc_f32.cu (every product on
// mma.sync, kept as the yardstick), as the FMA design (csrc/denoiser.cu's
// f32 entry) and as the plain version
// ops/pallas_unet.denoise_reference(compute_dtype=torch.float32): the same
// folded constants, the same association (graph operator first, then
// channel mix), float32 sums and float32 everywhere in between.  Each
// float32 operand a is taken as a_hi + a_lo and a product a b as a_lo b_hi
// + a_hi b_lo + a_hi b_hi (denoiser_tc_f32.cu's note says why that keeps
// float32 accuracy; the f32 check, rtol 1e-4 and atol 1e-5, holds it).
//
// Contract: as csrc/denoiser_tc_f32.cu, with the plan of
// ops/pallas_unet.pack_for_wg32_kernel (the same header; op records that
// each hold a run of 16-position output tiles and a range of input
// channels of one layer, with W and Wr split into hi and lo in wgmma's B
// layout, and a mask of each output tile's nonzero 8-position blocks of
// the graph operator).  Any N: rows past N are read as 0 and never
// written.
//
// What bounds it: operations, as for denoiser_tc_f32.cu: 270.46 GFLOP per
// call at N = 51,200 at the flagship shapes, three TF32 products each on
// the H100 SXM's 495 TFLOP/s of dense TF32, so 1.639 ms, against about
// 0.01 ms for the bytes.  The mma.sync kernel ran at 13.7 % of that bound,
// its loops paced by the instructions each unit issues: every (row, 16
// positions) unit re-read its op's W and Wr from shared memory as B
// fragments (one 8-byte load per three MMAs) and split every value into hi
// and lo (a mask and a subtraction), and it issued 5.2x the function's
// products as MMAs, partly for C_out parts that recomputed their graph
// mixes.
//
// Design.
//   * The channel and residual mixes on wgmma.  W is the same for every
//     unit of an op, so four (row, 16 positions) units stack into one M =
//     64 warpgroup MMA: each warp of a warpgroup supplies its own unit's 16
//     positions as the register A operand.  A warp's 16-row slice of
//     wgmma's TF32 A fragment is mma.sync m16n8k8's A layout, so the
//     permuted-K trick of denoiser_tc_f32.cu carries over: a k-step's 8
//     input channels are taken in the order 0 2 4 6 1 3 5 7, and the graph
//     mix's accumulator registers (c0, c2, c1, c3), split into hi and lo,
//     are A as they stand; the residual's A is f[p][c .. c + 1], one 8-byte
//     load per row.  B, the op's (8 input channels x N output channels)
//     chunk of W or Wr, is read from shared memory through a descriptor
//     once per warpgroup.  TF32 B must be K-major, so the host lays W out
//     with the input channels of each output channel contiguous, in that
//     permuted order, in 8x4 core matrices of 16-byte rows (the two along
//     K kLbo bytes apart, 8-row groups along N kSbo apart).  A warp's 16
//     rows of the accumulator are mma.sync's accumulator tiles, so the
//     epilogue is the mma.sync kernel's.
//   * 3xTF32 on wgmma: per k-step g_lo W_hi, g_hi W_lo, g_hi W_hi into one
//     accumulator (the small terms first), the same three for f and Wr.
//     W's split is the host's (pack_for_wg32_kernel: hi rounded to TF32,
//     lo the TF32 rounding of the rest, as for K), made once per weight
//     instead of once per unit and chunk, and both halves lie in shared
//     memory as B operands: twice W's bytes.  g and f are split in
//     registers once per chunk, hi = bits & ~0x1fff explicitly (never left
//     to the MMA's truncation of a raw float32: a - a_hi must be the rest
//     of what the MMA reads), lo = a - hi exact.
//   * Shared memory is the hard constraint: float32 doubles every
//     activation tile of the bfloat16 plan and W's split doubles its
//     weights.  So an op's constants are not one block: the host cuts a
//     layer into records over runs of its 16-position output tiles (each
//     with only those rows of K, as denoiser_tc_f32.cu does at T = 6) and
//     over ranges of its input channels (each with those rows of W and
//     Wr).  A warpgroup keeps its accumulators in registers from one
//     channel record to the next and runs the epilogue after the run's
//     last, so no record recomputes another's graph mix; a run cut over
//     channels has at most one warpgroup unit per warpgroup.  Records
//     stream through the two weight buffers, each by one bulk copy (the
//     TMA unit, issued by one thread one record ahead, completing on an
//     mbarrier), which also writes through the async proxy that wgmma
//     reads.  At the flagship shapes a tile holds kRows = 2 rows, d3_0
//     streams in 4 records of 16 input channels and d3_1 in 4 of 32.
//   * C_out in as few parts as the wgmma widths (16-128 channels) allow:
//     a part recomputes its units' graph mixes, and a plan that split
//     d3_0 and d3_1 further to busy the warpgroup their 4 units leave idle
//     ran slower (PERF.md).
//   * The graph mixes stay on mma.sync.m16n8k8 in 3xTF32 as in
//     denoiser_tc_f32.cu: K's hi and lo fragments, split on the host,
//     one conflict-free 16-byte load each per step, f split per step;
//     only the 8-position blocks of K that hold a nonzero entry (a mask
//     per output tile from the host): the joint re-scalings' operators are
//     block-diagonal over frames.  K stays in shared memory, not in
//     registers: at float32 a step's fragments take 8 registers (4x the
//     bfloat16 kernel's per position), up to 104 at T = 6, beside a
//     warpgroup's accumulators and A operands.
//   * Registers: kWarps = 8 warps per persistent block (one per SM,
//     __launch_bounds__(kThreads, 1)), so up to 255 registers a thread.  A
//     unit holds its accumulators (N / 2 registers), a round's A operands
//     (JT k-steps of g and of f, hi and lo: 16 JT) and the graph mix's
//     (8 JT): the widest bodies take ~248 registers.  At 12 warps (168)
//     they spilled and ran 2.5x slower; narrower bodies that fit 12 warps
//     ran slower than 8 warps with the wide ones; a tile's gcn ops keep
//     only two warpgroups busy at 2 rows anyway (PERF.md;
//     tools/perf/probe_tc_phases.py's WG32_VARIANTS time the builds).  The
//     fields that steer the wgmmas are read by a warp broadcast (utab),
//     with one body per wgmma width and round of input channels, so ptxas
//     takes every branch around a wgmma for uniform (it serializes every
//     wgmma of a build otherwise: chip_smoke.py's build prints the
//     registers and spills).
//   * What paces it (PERF.md, probe_tc_phases.py): the graph mixes, on
//     mma.sync, take over half of a round, then the unit waits for its
//     round's wgmmas: a TF32 wgmma from registers costs one warpgroup about
//     as many cycles as a bf16 one with twice its K (probe_wgmma_rate.py),
//     and a gcn op has at most two warpgroups' units at 2 rows.  A round's
//     A registers held across the next round's graph mix, a second
//     accumulator, a wait every 6 wgmmas, and a layer's input channels
//     split over two warpgroups of a 16-warp block (partial sums added
//     through the output tile) each ran no faster.
//   * Kept from denoiser_tc_f32.cu: persistent blocks, every layer's
//     embedding once per tile (W_e and b_e read through __ldg), the next
//     tile's x and silu_emb prefetched by cp.async, the row layout, the
//     joint re-scalings as a graph mix with the dense operator, 0 past T*V.

#include <cuda_runtime.h>
#include <stdint.h>

namespace mocodad_wg32 {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroups = kWarps / 4;   // warpgroups per block

constexpr int kMaxTable = 2048;       // ints of the table in shared memory
constexpr int kMaxE = 16;             // embedding width it unrolls for
constexpr uint32_t kLbo = 128;        // B: the two core matrices along K
constexpr uint32_t kSbo = 256;        // B: successive 8-row groups along N

// table header (offsets in bytes, strides in floats): as
// csrc/denoiser_tc_f32.cu
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
// one op record: kind 0 = a run of an ST-GCNN layer's output tiles over a
// range of its input channels, 1 = a run of a joint re-scaling
enum {
  O_KIND, O_CI,                 // the layer's input channels padded to 16
  O_NT,                         // its output channels padded to 16, over 8
  O_NSPLIT,                     // parts of them, one wgmma width each
  O_TVI, O_TVO, O_MT, O_KS,     // T*V in / out; the run's 16-position
                                //   tiles, 8-position steps in
  O_IN, O_IN_STRIDE, O_OUT, O_OUT_STRIDE, O_SKIP, O_SKIP_STRIDE,
  O_RES,                        // 1: residual mix Wr, 0: identity
  O_P0,                         // the run's first output position
  O_C0, O_C1,                   // its input channels [C0, C1)
  O_NREC,                       // records of the run (their C0 .. C1 in
                                //   turn; the first record's count counts)
  O_BLOB, O_BLOB_BYTES,         // the record's constants in the blob
  O_K,                          // K hi/lo of the run's tiles, fragment
                                //   order (bytes)
  O_KMASK,                      // int32 per tile: K's nonzero 8-position
                                //   blocks along the input (bytes)
  O_W, O_W_LO, O_WR, O_WR_LO,   // W and Wr, hi and lo, in wgmma's B layout
                                //   for input channels C0 .. C1 (bytes)
  O_W_STEP,                     // bytes of W per 8 input channels
  O_BIAS, O_SLOPE, O_RS, O_RT,  // float32 vectors (bytes)
  O_EMB,                        // the layer's first embedding column
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
// done), each term over all G tiles before the next
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

// blob[off .. off + bytes) -> dst by one bulk copy, completing on `bar`;
// one thread issues it, after the block barrier that frees dst (the proxy
// fence orders the generic reads of the record before it against the
// copy's writes)
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
// bits of its mantissa cleared, lo = a - hi exact in float32 (the MMA reads
// its top 19 bits)
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = __float_as_uint(a) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(a - __uint_as_float(h));
}

// the table, read from its copy in shared memory
__device__ __forceinline__ int tab(const int* t, int i) { return t[i]; }
// a table entry broadcast from lane 0: ptxas then knows every branch and
// loop bound around the wgmmas is uniform
__device__ __forceinline__ int utab(const int* t, int i) {
  return __shfl_sync(0xffffffffu, t[i], 0);
}

// ---- wgmma -----------------------------------------------------------------

// the accumulators stay in place around the asynchronous MMAs
template <int NT>
__device__ __forceinline__ void keep(float (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[j][i])::"memory");
}

// B's descriptor: K-major, no swizzle, start at shared address `addr`;
// the low word (start address and leading offset) apart from the high
// word (stride offset), a constant
__device__ __forceinline__ uint32_t b_desc_lo(uint32_t addr) {
  return ((addr & 0x3FFFF) >> 4) | ((kLbo >> 4) << 16);
}
__device__ __forceinline__ uint64_t b_desc(uint32_t lo) {
  return static_cast<uint64_t>(lo) | (static_cast<uint64_t>(kSbo >> 4) << 32);
}

#define WG_D(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
#define WG_IN "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)

// d (64 x 8 NT; this warp's 16 rows as NT accumulator tiles) += a (this
// warp's 16 x 8 TF32 A fragment) * B (8 x 8 NT at desc)
template <int NT>
__device__ __forceinline__ void wgmma(float (&d)[NT][4],
                                      const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (NT == 2) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : WG_D(0), WG_D(1)
        : WG_IN);
  } else if constexpr (NT == 4) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : WG_D(0), WG_D(1), WG_D(2), WG_D(3)
        : WG_IN);
  } else if constexpr (NT == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : WG_D(0), WG_D(1), WG_D(2), WG_D(3), WG_D(4), WG_D(5),
          WG_D(6), WG_D(7)
        : WG_IN);
  } else {
    static_assert(NT == 16, "wgmma of 16, 32, 64 or 128 output channels");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : WG_D(0), WG_D(1), WG_D(2), WG_D(3), WG_D(4), WG_D(5),
          WG_D(6), WG_D(7), WG_D(8), WG_D(9), WG_D(10), WG_D(11),
          WG_D(12), WG_D(13), WG_D(14), WG_D(15)
        : WG_IN);
  }
}

#undef WG_D
#undef WG_IN

// ---- the graph mix ---------------------------------------------------------

// g (16 positions of tile `mi` of the record, 8 JT channels from c0) = K f
// as JT 16x8 accumulator tiles (hi * hi in g, the small terms in gs), over
// the 8-position steps in `mask` (of `ks`), two steps' loads before their
// MMAs; K's hi and lo fragments come whole from `kf` (fragment order) and
// serve the JT tiles, f's are split here
template <int JT>
__device__ __forceinline__ void graph_mix(float (&g)[JT][4],
                                          float (&gs)[JT][4], const uint4* kf,
                                          const float* f, int f_st, int mi,
                                          int c0, int ks, int mask, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  const uint4* k = kf + static_cast<size_t>(mi) * ks * 64 + lane;
  const float* fb = f + tig * f_st + c0 + gid;
  constexpr int LOOK = 2;
  // two steps' loads in flight before their MMAs (three or four spilled
  // and ran slower: PERF.md)
  for (int m = mask; m;) {
    int st[LOOK];
#pragma unroll
    for (int s = 0; s < LOOK; ++s) {
      st[s] = m ? __ffs(m) - 1 : -1;
      m &= m - 1;
    }
    uint4 kh[LOOK], kl[LOOK];
    float b[LOOK][JT][2];
#pragma unroll
    for (int s = 0; s < LOOK; ++s) {
      if (st[s] >= 0) {
        kh[s] = k[st[s] * 64];
        kl[s] = k[st[s] * 64 + 32];
        const float* fs = fb + st[s] * 8 * f_st;
#pragma unroll
        for (int j = 0; j < JT; ++j) {
          b[s][j][0] = fs[j * 8];
          b[s][j][1] = fs[4 * f_st + j * 8];
        }
      }
    }
#pragma unroll
    for (int s = 0; s < LOOK; ++s) {
      if (st[s] >= 0) {
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

// ---- the ops ---------------------------------------------------------------

// the two weight buffers as a pipeline: each record's constants arrive by
// one bulk copy, one record ahead
struct Pipe {
  uint32_t bar[2];              // one mbarrier per buffer
  char* wbuf[2];
  int buf;                      // the buffer of the next record
  uint32_t parity;              // bit b: the phase of buffer b's next
                                //   completion
};

// Wait for record `op`'s constants and the last record's output, then
// stage the record after it (the next tile's first after the last, if
// `more`) into the other buffer; returns the record's buffer
__device__ __forceinline__ const char* next_record(Pipe& pp, int tid,
                                                   const int* ops, int op,
                                                   int nops, bool more,
                                                   const char* blob) {
  mbar_wait(pp.bar[pp.buf], pp.parity >> pp.buf & 1);
  pp.parity ^= 1u << pp.buf;
  __syncthreads();
  const int next = op + 1 < nops ? op + 1 : more ? 0 : -1;
  if (next >= 0 && tid == 0)
    stage(smem_addr(pp.wbuf[pp.buf ^ 1]),
          blob + tab(ops + next * O_LEN, O_BLOB),
          tab(ops + next * O_LEN, O_BLOB_BYTES), pp.bar[pp.buf ^ 1]);
  const char* wb = pp.wbuf[pp.buf];
  pp.buf ^= 1;
  return wb;
}

// A warp's unit of an ST-GCNN run: warpgroup unit v is four (row, 16
// positions) units, one per warp, and one of the layer's O_NSPLIT parts of
// C_out; the same in every record of the run
struct Unit {
  bool live;                    // a unit of the run (else zeros)
  int r, mi, m0;                // its row, tile of the run, first position
  int part;                     // its part of C_out
  const float* f;               // its row's input activations
};

// One record's share of an ST-GCNN unit `u` (8 NT channels of C_out):
// its input channels [C0, C1) in rounds of 8 JT,
// each round the graph mix and split, then 3 (6 with a residual mix)
// wgmmas per k-step of 8 channels, one wait.  A warp past the run's units
// supplies zeros.
template <int NT, int JT, int kRows>
__device__ __forceinline__ void gcn_record(float (&acc)[NT][4], char* sm,
                                           const int* t, const int* d,
                                           const char* wb, const Unit& u,
                                           int warp, int lane) {
  const int ks = tab(d, O_KS);
  const int c0 = utab(d, O_C0), c1 = utab(d, O_C1);
  const int in_st = tab(d, O_IN_STRIDE);
  const bool res = utab(d, O_RES) != 0;
  const bool live = u.live;
  const int mi = u.mi, m0 = u.m0, part = u.part;
  const float* f = u.f;
  const int mask = __shfl_sync(
      0xffffffffu,
      live ? reinterpret_cast<const int*>(wb + tab(d, O_KMASK))[mi] : 0, 0);
  const uint4* kf = reinterpret_cast<const uint4*>(wb + tab(d, O_K));
  // the part's first output channels in W's and Wr's hi and lo at C0: a
  // k-step on is O_W_STEP / 16 more in the address field, which never
  // carries out of its 14 bits (shared addresses stay below 256 KB)
  const uint32_t o_off = part * NT * kSbo;
  const uint32_t dwh = b_desc_lo(smem_addr(wb + tab(d, O_W)) + o_off);
  const uint32_t dwl = b_desc_lo(smem_addr(wb + tab(d, O_W_LO)) + o_off);
  const uint32_t drh = b_desc_lo(smem_addr(wb + tab(d, res ? O_WR : O_W)) +
                                 o_off);
  const uint32_t drl =
      b_desc_lo(smem_addr(wb + tab(d, res ? O_WR_LO : O_W_LO)) + o_off);
  const int dstep = tab(d, O_W_STEP) >> 4;
  const int gid = lane >> 2, tig = lane & 3;
  for (int c = c0; c < c1; c += 8 * JT) {
    float g[JT][4] = {}, gs[JT][4] = {};
    if (live) graph_mix<JT>(g, gs, kf, f, in_st, mi, c, ks, mask, lane);
    // the accumulator tile of g, permuted, is this warp's A fragment
    // (logical column t = channel 2t, t + 4 = channel 2t + 1)
    uint32_t gh[JT][4], gl[JT][4], fh[JT][4], fl[JT][4];
#pragma unroll
    for (int j = 0; j < JT; ++j) {
      split(g[j][0] + gs[j][0], gh[j][0], gl[j][0]);
      split(g[j][2] + gs[j][2], gh[j][1], gl[j][1]);
      split(g[j][1] + gs[j][1], gh[j][2], gl[j][2]);
      split(g[j][3] + gs[j][3], gh[j][3], gl[j][3]);
      if (res) {
        float2 a0 = make_float2(0.f, 0.f), a1 = a0;
        if (live) {
          const float* fa = f + (m0 + gid) * in_st + c + j * 8 + tig * 2;
          a0 = *reinterpret_cast<const float2*>(fa);
          a1 = *reinterpret_cast<const float2*>(fa + 8 * in_st);
        }
        split(a0.x, fh[j][0], fl[j][0]);
        split(a1.x, fh[j][1], fl[j][1]);
        split(a0.y, fh[j][2], fl[j][2]);
        split(a1.y, fh[j][3], fl[j][3]);
      }
    }
    keep<NT>(acc);
    wg_fence();
#pragma unroll
    for (int j = 0; j < JT; ++j) {
      const uint32_t q = ((c - c0) / 8 + j) * dstep;
      wgmma<NT>(acc, gl[j], b_desc(dwh + q));
      wgmma<NT>(acc, gh[j], b_desc(dwl + q));
      wgmma<NT>(acc, gh[j], b_desc(dwh + q));
      if (res) {
        wgmma<NT>(acc, fl[j], b_desc(drh + q));
        wgmma<NT>(acc, fh[j], b_desc(drl + q));
        wgmma<NT>(acc, fh[j], b_desc(drh + q));
      }
    }
    wg_commit();
    // done before the next round's graph mix overwrites the A registers
    // (holding them across it ran no faster: see the note at the top)
    wg_wait_all();
    keep<NT>(acc);
  }
}

// An ST-GCNN unit's epilogue on its accumulator tiles (16 positions from
// m0 of row r, 8 NT channels from o0): (+ f), + bias, PReLU, + embedding,
// every load before the first store; 0 past T*V
template <int NT>
__device__ __forceinline__ void gcn_epilogue(float (&acc)[NT][4], char* sm,
                                             const int* t, const int* d,
                                             const char* wb, int r, int m0,
                                             int o0, int lane) {
  const int row0 = tab(t, H_ROW0), rb = tab(t, H_ROW_BYTES);
  const float* e = reinterpret_cast<const float*>(sm + tab(t, H_EMB_OFF)) +
                   tab(d, O_EMB) + r * tab(t, H_EMB_STRIDE);
  const int tvo = tab(d, O_TVO);
  const bool res = tab(d, O_RES) != 0;
  char* row = sm + row0 + r * rb;
  const float* f = reinterpret_cast<const float*>(row + tab(d, O_IN));
  const int in_st = tab(d, O_IN_STRIDE), out_st = tab(d, O_OUT_STRIDE);
  const float* bias = reinterpret_cast<const float*>(wb + tab(d, O_BIAS));
  const float slope = *reinterpret_cast<const float*>(wb + tab(d, O_SLOPE));
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int o = o0 + n * 8 + tig * 2;
    const float2 b = *reinterpret_cast<const float2*>(bias + o);
    const float2 em = *reinterpret_cast<const float2*>(e + o);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float y0 = acc[n][2 * h] + b.x, y1 = acc[n][2 * h + 1] + b.y;
      if (!res) {
        const float2 x = *reinterpret_cast<const float2*>(
            f + (m0 + gid + h * 8) * in_st + o);
        y0 += x.x;
        y1 += x.y;
      }
      acc[n][2 * h] = (y0 >= 0.f ? y0 : slope * y0) + em.x;
      acc[n][2 * h + 1] = (y1 >= 0.f ? y1 : slope * y1) + em.y;
    }
  }
  float* out = reinterpret_cast<float*>(row + tab(d, O_OUT));
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int o = o0 + n * 8 + tig * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = m0 + gid + h * 8;
      *reinterpret_cast<float2*>(out + p * out_st + o) =
          p < tvo ? make_float2(acc[n][2 * h], acc[n][2 * h + 1])
                  : make_float2(0.f, 0.f);
    }
  }
}

// One run of an ST-GCNN layer, its O_NREC records from `op` on, over the
// tile's rows: each warpgroup unit's accumulators over every record, then
// its epilogue.  A run of several records has at most one warpgroup unit
// per warpgroup (the host plans so); a run of one record walks its units
// in rounds of kGroups.  Returns the records it consumed.
template <int NT, int JT, int kRows>
__device__ __forceinline__ int gcn_run(Pipe& pp, int tid, char* sm,
                                       const int* t, const int* ops, int op,
                                       int nops, bool more,
                                       const char* blob) {
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  const int* d = ops + op * O_LEN;
  const int nrec = utab(d, O_NREC), mt = utab(d, O_MT);
  const int ns = utab(d, O_NSPLIT);
  const int units = (kRows * mt + 3) / 4 * ns;
  const int rounds = nrec > 1 ? 1 : (units + kGroups - 1) / kGroups;
  const char* wb = nullptr;
  for (int round = 0; round < rounds; ++round) {
    const int v = round * kGroups + (warp >> 2);
    Unit u;
    const int unit = v / ns * 4 + (warp & 3);
    u.live = unit < kRows * mt;
    u.r = u.live ? unit / mt : 0;
    u.mi = u.live ? unit % mt : 0;
    u.m0 = tab(d, O_P0) + u.mi * 16;
    u.part = v % ns;
    u.f = reinterpret_cast<const float*>(
        sm + tab(t, H_ROW0) + u.r * tab(t, H_ROW_BYTES) + tab(d, O_IN));
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int k = 0; k < nrec; ++k) {
      if (round == 0)
        wb = next_record(pp, tid, ops, op + k, nops, more, blob);
      if (v < units)
        gcn_record<NT, JT, kRows>(acc, sm, t, ops + (op + k) * O_LEN, wb, u,
                                  warp, lane);
    }
    if (v < units && u.live)
      gcn_epilogue<NT>(acc, sm, t, ops + (op + nrec - 1) * O_LEN, wb, u.r,
                       u.m0, u.part * NT * 8, lane);
  }
  return nrec;
}

// One run of a joint re-scaling: h = D f as a graph mix over D's nonzero
// 8-position blocks, then h * rs + rt and, with a skip, + skip; 0 past
// T*V.  A unit is (row, 16 positions, 32 channels).
template <int kRows>
__device__ __forceinline__ void joint_op(int tid, char* sm, const int* t,
                                         const int* d, const char* wb) {
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = tab(t, H_ROW0), rb = tab(t, H_ROW_BYTES);
  const int cs = tab(d, O_CI), tvo = tab(d, O_TVO), mt = tab(d, O_MT);
  const int ks = tab(d, O_KS), nc = cs / 32, p0 = tab(d, O_P0);
  const int in_off = tab(d, O_IN), in_st = tab(d, O_IN_STRIDE);
  const int out_off = tab(d, O_OUT), out_st = tab(d, O_OUT_STRIDE);
  const int skip_off = tab(d, O_SKIP), skip_st = tab(d, O_SKIP_STRIDE);
  const uint4* kf = reinterpret_cast<const uint4*>(wb + tab(d, O_K));
  const int* kmask = reinterpret_cast<const int*>(wb + tab(d, O_KMASK));
  const float* rs = reinterpret_cast<const float*>(wb + tab(d, O_RS));
  const float* rt = reinterpret_cast<const float*>(wb + tab(d, O_RT));
  const int gid = lane >> 2, tig = lane & 3;
  for (int u = warp; u < kRows * mt * nc; u += kWarps) {
    const int r = u / (mt * nc), mi = u / nc % mt, c0 = u % nc * 32;
    char* row = sm + row0 + r * rb;
    const float* f = reinterpret_cast<const float*>(row + in_off);
    float g[4][4] = {}, gs[4][4] = {};
    graph_mix<4>(g, gs, kf, f, in_st, mi, c0, ks, kmask[mi], lane);
    float2 y[4][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + mi * 16 + gid + h * 8;
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
            (p0 + mi * 16 + gid + h * 8) * out_st + c0 + j * 8 + tig * 2) =
            y[j][h];
  }
}

// One op from record `op` on: a joint re-scaling's record, or an ST-GCNN
// run, one body per wgmma width and round of input channels (32 channels
// where the records' ranges allow and the accumulators leave room, 8 only
// beside the widest wgmmas, where the host may cut W that fine, else 16);
// returns the records consumed
template <int kRows>
__device__ __forceinline__ int run_op(Pipe& pp, int tid, char* sm,
                                      const int* t, const int* ops, int op,
                                      int nops, bool more,
                                      const char* blob) {
  const int* d = ops + op * O_LEN;
  if (utab(d, O_KIND) == 1) {
    const char* wb = next_record(pp, tid, ops, op, nops, more, blob);
    joint_op<kRows>(tid, sm, t, d, wb);
    return 1;
  }
  const int width = utab(d, O_C1) - utab(d, O_C0);
  const int jt = width % 32 == 0 ? 4 : width % 16 == 0 ? 2 : 1;
#define RUN(NT, JT) \
  gcn_run<NT, JT, kRows>(pp, tid, sm, t, ops, op, nops, more, blob)
  switch (utab(d, O_NT) / utab(d, O_NSPLIT)) {
    case 2:
      return jt == 4 ? RUN(2, 4) : RUN(2, 2);
    case 4:
      return jt == 4 ? RUN(4, 4) : RUN(4, 2);
    case 8:
      return jt == 4 ? RUN(8, 4) : jt == 2 ? RUN(8, 2) : RUN(8, 1);
    case 16:
      return jt == 1 ? RUN(16, 1) : RUN(16, 2);
    default:      // the host packs only the widths above
      __trap();
      return 0;
  }
#undef RUN
}

// Every layer's embedding for the tile's rows:
// emb[r][q] = sum_e W_e^T[e][q] silu_emb[r][e] + b_e[q], q over all
// layers' (padded) output channels, W_e^T and b_e read through __ldg (a
// warp's loads are consecutive); a thread takes one q for every row
template <int kRows>
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

// ---- tile I/O --------------------------------------------------------------

// x and silu_emb of rows n0 .. n0 + kRows - 1 below N -> the prefetch
// buffer, one 4-byte cp.async each, as one group issued a tile ahead
template <int kRows>
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
template <int kRows>
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
template <int kRows>
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

// kRows fold rows per tile: 2 up to T = 4 frames at 17 joints, 1 above
// (the host plans for the most that fit, pack_for_wg32_kernel)
template <int kRows>
__global__ void __launch_bounds__(kThreads, 1)
denoiser_kernel_wg32(const float* __restrict__ x,
                     const float* __restrict__ semb,
                     const char* __restrict__ blob,
                     const int* __restrict__ table, float* __restrict__ eps,
                     int n) {
  extern __shared__ __align__(128) char sm[];
  __shared__ int st[kMaxTable];
  __shared__ __align__(8) uint64_t bars[2];   // one per weight buffer
  const int tid = threadIdx.x;
  for (int i = tid; i < H_LEN + __ldg(table + H_NOPS) * O_LEN; i += kThreads)
    st[i] = __ldg(table + i);
  Pipe pp;
  pp.bar[0] = smem_addr(&bars[0]);
  pp.bar[1] = smem_addr(&bars[1]);
  if (tid == 0) {
    mbar_init(pp.bar[0]);
    mbar_init(pp.bar[1]);
  }
  __syncthreads();
  const int* t = st;
  const int nops = tab(t, H_NOPS);
  const int ntiles = (n + kRows - 1) / kRows;
  const int stride = static_cast<int>(gridDim.x);
  const int* ops = t + H_LEN;
  pp.wbuf[0] = sm + tab(t, H_WBUF0);
  pp.wbuf[1] = sm + tab(t, H_WBUF1);
  pp.buf = 0;
  pp.parity = 0;
  if (tid == 0)
    stage(smem_addr(pp.wbuf[0]), blob + tab(ops, O_BLOB),
          tab(ops, O_BLOB_BYTES), pp.bar[0]);
  if (static_cast<int>(blockIdx.x) < ntiles)
    prefetch_tile<kRows>(tid, sm, t, x, semb, n, blockIdx.x * kRows);
  for (int tile = blockIdx.x; tile < ntiles; tile += stride) {
    const int n0 = tile * kRows;
    const bool more = tile + stride < ntiles;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();     // this tile's x and silu_emb have arrived
    load_tile<kRows>(tid, sm, t, n, n0);
    __syncthreads();     // x and silu_emb in place, the prefetch buffer free
    if (more)
      prefetch_tile<kRows>(tid, sm, t, x, semb, n, (tile + stride) * kRows);
    embed_all<kRows>(tid, sm, t, blob);
    for (int op = 0; op < nops;)
      op += run_op<kRows>(pp, tid, sm, t, ops, op, nops, more, blob);
    __syncthreads();
    store_tile<kRows>(tid, sm, t, eps, n, n0);
    __syncthreads();     // before the next tile's loads overwrite x
  }
}

template <int kRows>
int launch_rows(const float* x, const float* semb, const char* blob,
                const int* table, float* eps, int n, int smem_bytes,
                void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      denoiser_kernel_wg32<kRows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n + kRows - 1) / kRows;
  const int grid = tiles < sms ? tiles : sms;
  denoiser_kernel_wg32<kRows><<<grid, kThreads, smem_bytes,
                                static_cast<cudaStream_t>(stream)>>>(
      x, semb, blob, table, eps, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mocodad_wg32

// Launch on `stream` with `rows` fold rows per tile (2 or 1, what the plan
// was packed for): one persistent block per SM (fewer for a small N).
// Returns the CUDA error code (0 on success); allocates nothing and does
// not synchronise.
extern "C" int mocodad_denoiser_wg32_launch(const float* x, const float* semb,
                                            const char* blob,
                                            const int* table, float* eps,
                                            int n, int rows, int smem_bytes,
                                            void* stream) {
  using namespace mocodad_wg32;
  switch (rows) {
    case 2:
      return launch_rows<2>(x, semb, blob, table, eps, n, smem_bytes, stream);
    case 1:
      return launch_rows<1>(x, semb, blob, table, eps, n, smem_bytes, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The plans this build reads: the rows per tile it is built for (a bit
// mask, bit r for r rows), warps per block, the longest table, header and
// op record lengths, the B layout's offsets.  The host checks all six
// before the first launch.
extern "C" int mocodad_denoiser_wg32_row_counts() {
  return (1 << 2) | (1 << 1);
}
extern "C" int mocodad_denoiser_wg32_warps_per_block() {
  return mocodad_wg32::kWarps;
}
extern "C" int mocodad_denoiser_wg32_max_table() {
  return mocodad_wg32::kMaxTable;
}
extern "C" int mocodad_denoiser_wg32_header_len() {
  return mocodad_wg32::H_LEN;
}
extern "C" int mocodad_denoiser_wg32_op_len() { return mocodad_wg32::O_LEN; }
extern "C" int mocodad_denoiser_wg32_sbo() {
  return static_cast<int>(mocodad_wg32::kSbo);
}
