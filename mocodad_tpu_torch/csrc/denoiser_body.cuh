// The shared body of the three eval-mode STSAEUnet denoiser kernels for
// NVIDIA Hopper (sm_90a): denoiser.cu (B1, float32 and bfloat16),
// denoiser_grouped.cu (B2, five layer groups) and denoiser_dma.cu (B3, one
// persistent block per SM with prefetch).  Each kernel runs a table of ops
// built on the host by mocodad_tpu_torch/ops/pallas_unet.py (pack_layers,
// plan_arena, kernel_table); this header holds the table format, the layer
// primitives and the op interpreter.
//
// Layout: a sub-tile is kRows = 4 fold rows worked on by kThreads threads.
// Every activation of a sub-tile lives in dynamic shared memory as float4
// vectors over its 4 rows, element (c, tv) at float4 index c * TVp + tv
// (TVp is T*V rounded up to an odd number, so a quarter-warp that walks
// the channel dimension hits 8 distinct 16-byte bank groups).  A block of
// `nsub` sub-tiles holds `nsub` arenas of the table's H_ARENA float4s, one
// after the other, and kThreads * nsub threads.
//
// Every kernel declares __launch_bounds__(threads, 1): its shared memory
// holds it to one block per SM anyway, and without the second argument
// ptxas trims registers towards more resident blocks, which it cannot
// have, at the price of the hot loops' load-ahead (B1 at N = 51,200 on an
// H100 SXM, chip_smoke.py: float32 25.83 -> 18.8-19.0 ms per call,
// bfloat16 30.15 -> 19.0-19.1 ms).
//
// Precision: products accumulate in float32.  With bfloat16 matrices (WT =
// __nv_bfloat16) the kernel also rounds to bfloat16, to nearest even, at
// the points where the JAX kernel casts (mocodad_tpu/ops/pallas_unet.py
// :157-204): the inputs, every layer output, every joint re-scaling output
// and every skip add.  The arena stays float32 and holds the rounded
// values; a bfloat16 x bfloat16 product is exact in float32, so an FMA on
// them is a bfloat16 dot with float32 accumulation.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace mocodad {

constexpr int kRows = 4;
constexpr int kThreads = 256;
constexpr int kMaxIn = 2;     // activation inputs read from global memory
constexpr int kMaxOut = 2;    // activation outputs written to global memory

// table header, then kMaxIn + kMaxOut I/O records, then the op records
enum {
  H_NOPS, H_T, H_E, H_SEMB, H_EMB,
  H_FINAL_X,  // arena offset added to output 0 before it is stored, or -1
  H_ARENA,    // float4s of one sub-tile's arena
  H_NIN, H_NOUT,
  H_IO,
  H_LEN = H_IO + (kMaxIn + kMaxOut) * 4
};
// one I/O record: a (C, TV, N) tensor in global memory <-> arena offset
enum { IO_C, IO_TV, IO_TVP, IO_OFF, IO_LEN };
// one op record: kind 0 = ST-GCNN layer, 1 = joint re-scaling
enum {
  O_KIND, O_CI, O_CO, O_TVI, O_TVIP, O_TVO, O_TVOP,
  O_IN, O_G, O_OUT, O_SKIP,                  // arena offsets (float4)
  O_K, O_W, O_WR, O_WE,                      // offsets into the matrices
  O_BIAS, O_SLOPE, O_EB, O_RS, O_RT,         // offsets into the vectors
  O_LEN
};

using bf16 = __nv_bfloat16;

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, bf16>::value;

// ---- element access ------------------------------------------------------

__device__ __forceinline__ float load_elem(const float* __restrict__ p,
                                          size_t i) {
  return __ldg(p + i);
}
__device__ __forceinline__ float load_elem(const bf16* __restrict__ p,
                                          size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_elem(float* p, size_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_elem(bf16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// 4 consecutive matrix entries, starting at entry 4 * i
__device__ __forceinline__ float4 load_w4(const float* __restrict__ a, int i) {
  return __ldg(reinterpret_cast<const float4*>(a) + i);
}
__device__ __forceinline__ float4 load_w4(const bf16* __restrict__ a, int i) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(a) + i);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float load_w1(const float* __restrict__ a, int i) {
  return __ldg(a + i);
}
__device__ __forceinline__ float load_w1(const bf16* __restrict__ a, int i) {
  const unsigned short u =
      __ldg(reinterpret_cast<const unsigned short*>(a) + i);
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}

// ---- arithmetic ------------------------------------------------------------

template <bool R>
__device__ __forceinline__ float rnd(float v) {
  if (R) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

template <bool R>
__device__ __forceinline__ float4 rnd4(float4 v) {
  return make_float4(rnd<R>(v.x), rnd<R>(v.y), rnd<R>(v.z), rnd<R>(v.w));
}

__device__ __forceinline__ float4 fma4(float a, float4 v, float4 acc) {
  acc.x = fmaf(a, v.x, acc.x);
  acc.y = fmaf(a, v.y, acc.y);
  acc.z = fmaf(a, v.z, acc.z);
  acc.w = fmaf(a, v.w, acc.w);
  return acc;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 add4s(float4 a, float s) {
  return make_float4(a.x + s, a.y + s, a.z + s, a.w + s);
}

__device__ __forceinline__ float prelu(float y, float slope) {
  return y >= 0.f ? y : slope * y;
}

// ---- layer primitives (one sub-tile; `tid` in [0, kThreads)) ---------------

// out[b][m] = sum_k at[k][m] * in[b][k]   for b < nb, m < M, k < K,
// then optionally  out = round(out * rs[m] + rt[m])  and
// out = round(out + skip[b][m]); with `round_out` and no affine the plain
// product is rounded (B2's graph mix).
// `at` is (K, Mp) row-major with Mp = M rounded up to 4 (zero padded).
// With `blocks` > 1 the operator is block-diagonal, `blocks` blocks of
// (M / blocks) x (K / blocks), and k walks only the blocks of a thread's
// 4 outputs; `blocks` = 1 is a dense operator.
// Threads walk b fastest, so a warp shares its weight column.
template <typename WT>
__device__ void rowmix(int tid, const float4* in, int in_stride, int nb,
                       int K, const WT* __restrict__ at, int M, int blocks,
                       float4* out, int out_stride,
                       const float* __restrict__ rs,
                       const float* __restrict__ rt, const float4* skip,
                       bool round_out) {
  constexpr bool R = kIsBf16<WT>;
  const int mp4 = (M + 3) >> 2;
  const int items = nb * mp4;
  const int mb = M / blocks, kb = K / blocks;
  for (int it = tid; it < items; it += kThreads) {
    const int b = it % nb;
    const int mt = it / nb;
    const int k0 = (mt * 4) / mb * kb;
    const int k1 = (min(mt * 4 + 3, M - 1) / mb + 1) * kb;
    const float4* src = in + b * in_stride;
    float4 acc0 = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 acc1 = acc0, acc2 = acc0, acc3 = acc0;
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      const float4 v = src[k];
      const float4 a = load_w4(at, k * mp4 + mt);
      acc0 = fma4(a.x, v, acc0);
      acc1 = fma4(a.y, v, acc1);
      acc2 = fma4(a.z, v, acc2);
      acc3 = fma4(a.w, v, acc3);
    }
    const float4 acc[4] = {acc0, acc1, acc2, acc3};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = mt * 4 + i;
      if (m < M) {
        float4 y = acc[i];
        if (rs != nullptr) {
          const float s = __ldg(rs + m), t = __ldg(rt + m);
          y = rnd4<R>(make_float4(y.x * s + t, y.y * s + t, y.z * s + t,
                                  y.w * s + t));
          if (skip != nullptr)
            y = rnd4<R>(add4(y, skip[b * out_stride + m]));
        } else if (R && round_out) {
          y = rnd4<true>(y);
        }
        out[b * out_stride + m] = y;
      }
    }
  }
}

// emb[o] = sum_e we[e][o] * semb[e] + eb[o]   (we is (E, Cp), zero padded)
template <typename WT>
__device__ void embed(int tid, const float4* semb, int E, int co,
                      const WT* __restrict__ we,
                      const float* __restrict__ eb, float4* emb) {
  const int cp = ((co + 3) >> 2) << 2;
  for (int o = tid; o < co; o += kThreads) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int e = 0; e < E; ++e)
      acc = fma4(load_w1(we, e * cp + o), semb[e], acc);
    emb[o] = add4s(acc, __ldg(eb + o));
  }
}

// The rest of one ST-GCNN layer, after the graph mix g = K^T f:
//   y[o][q] = round(prelu(sum_c w[c][o] g[c][q] + res[o][q] + bias[o])
//                   + emb[o])
//   res[o][q] = sum_c wr[c][o] f[c][q]   (RES)   or   f[o][q]
// Threads walk q fastest, so a warp shares its weight column.
template <bool RES, typename WT>
__device__ void chanmix(int tid, const float4* g, const float4* f, int ci,
                        int co, int tv, int tvp, const WT* __restrict__ w,
                        const WT* __restrict__ wr,
                        const float* __restrict__ bias, float slope,
                        const float4* emb, float4* out) {
  constexpr bool R = kIsBf16<WT>;
  const int cp4 = (co + 3) >> 2;
  const int items = cp4 * tv;
  for (int it = tid; it < items; it += kThreads) {
    const int q = it % tv;
    const int ot = it / tv;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 acc0 = z, acc1 = z, acc2 = z, acc3 = z;
    float4 res0 = z, res1 = z, res2 = z, res3 = z;
#pragma unroll 4
    for (int c = 0; c < ci; ++c) {
      const float4 gv = g[c * tvp + q];
      const float4 a = load_w4(w, c * cp4 + ot);
      acc0 = fma4(a.x, gv, acc0);
      acc1 = fma4(a.y, gv, acc1);
      acc2 = fma4(a.z, gv, acc2);
      acc3 = fma4(a.w, gv, acc3);
      if (RES) {
        const float4 fv = f[c * tvp + q];
        const float4 r = load_w4(wr, c * cp4 + ot);
        res0 = fma4(r.x, fv, res0);
        res1 = fma4(r.y, fv, res1);
        res2 = fma4(r.z, fv, res2);
        res3 = fma4(r.w, fv, res3);
      }
    }
    const float4 acc[4] = {acc0, acc1, acc2, acc3};
    const float4 res[4] = {res0, res1, res2, res3};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int o = ot * 4 + i;
      if (o < co) {
        const float4 r = RES ? res[i] : f[o * tvp + q];
        float4 y = add4s(add4(acc[i], r), __ldg(bias + o));
        y = make_float4(prelu(y.x, slope), prelu(y.y, slope),
                        prelu(y.z, slope), prelu(y.w, slope));
        out[o * tvp + q] = rnd4<R>(add4(y, emb[o]));
      }
    }
  }
}

// ---- tile I/O --------------------------------------------------------------

// A (C, TV, N) tensor's rows n0 .. n0 + 3 -> arena `dst` (element (c, tv)
// at c * tvp + tv), rounded at the compute precision; rows past N (r >= nv)
// read as 0.
template <bool R, typename IT>
__device__ void load_act(int tid, float4* dst, int C, int tv, int tvp,
                         const IT* __restrict__ src, int n, int n0, int nv) {
  const int items = C * tv * kRows;
  for (int i = tid; i < items; i += kThreads) {
    const int r = i % kRows, ctv = i / kRows;
    const int c = ctv / tv, q = ctv % tv;
    reinterpret_cast<float*>(dst + c * tvp + q)[r] =
        r < nv ? rnd<R>(load_elem(src, static_cast<size_t>(ctv) * n + n0 + r))
               : 0.f;
  }
}

// arena `src` (+ arena `add` if given) -> rows n0 .. n0 + nv - 1 of a
// (C, TV, N) tensor, converted to the output type (round to nearest even
// for bfloat16).
template <typename OT>
__device__ void store_act(int tid, const float4* src, const float4* add,
                          int C, int tv, int tvp, OT* dst, int n, int n0,
                          int nv) {
  const int items = C * tv * kRows;
  for (int i = tid; i < items; i += kThreads) {
    const int r = i % kRows, ctv = i / kRows;
    if (r < nv) {
      const int c = ctv / tv, q = ctv % tv;
      float v = reinterpret_cast<const float*>(src + c * tvp + q)[r];
      if (add != nullptr)
        v += reinterpret_cast<const float*>(add + c * tvp + q)[r];
      store_elem(dst, static_cast<size_t>(ctv) * n + n0 + r, v);
    }
  }
}

// ---- the op interpreter ----------------------------------------------------

// Runs every op of `table` on one sub-tile's arena `sm`.  Every thread of
// the block calls it (it synchronises the block between ops); the x / semb
// regions must be loaded and visible before the call.
template <typename WT, bool ROUND_G>
__device__ void run_ops(int tid, float4* sm, const int* __restrict__ table,
                        const WT* __restrict__ mats,
                        const float* __restrict__ vecs) {
  const int nops = __ldg(table + H_NOPS);
  const int frames = __ldg(table + H_T);
  const int E = __ldg(table + H_E);
  const float4* se = sm + __ldg(table + H_SEMB);
  float4* emb = sm + __ldg(table + H_EMB);
  for (int op = 0; op < nops; ++op) {
    const int* d = table + H_LEN + op * O_LEN;
    const int ci = __ldg(d + O_CI), co = __ldg(d + O_CO);
    const int tvi = __ldg(d + O_TVI), tvip = __ldg(d + O_TVIP);
    const int tvo = __ldg(d + O_TVO), tvop = __ldg(d + O_TVOP);
    const float4* in = sm + __ldg(d + O_IN);
    float4* out = sm + __ldg(d + O_OUT);
    if (__ldg(d + O_KIND) == 0) {
      float4* g = sm + __ldg(d + O_G);
      // the embedding projection and the graph mix are independent
      embed(tid, se, E, co, mats + __ldg(d + O_WE), vecs + __ldg(d + O_EB),
            emb);
      rowmix(tid, in, tvip, ci, tvi, mats + __ldg(d + O_K), tvo, 1, g, tvop,
             nullptr, nullptr, nullptr, ROUND_G);
      __syncthreads();
      const float slope = __ldg(vecs + __ldg(d + O_SLOPE));
      const WT* w = mats + __ldg(d + O_W);
      const float* bias = vecs + __ldg(d + O_BIAS);
      const int wr_off = __ldg(d + O_WR);
      if (wr_off >= 0)
        chanmix<true>(tid, g, in, ci, co, tvo, tvop, w, mats + wr_off, bias,
                      slope, emb, out);
      else
        chanmix<false>(tid, g, in, ci, co, tvo, tvop, w,
                       static_cast<const WT*>(nullptr), bias, slope, emb,
                       out);
    } else {
      const int skip_off = __ldg(d + O_SKIP);
      rowmix(tid, in, tvip, ci, tvi, mats + __ldg(d + O_K), tvo, frames, out,
             tvop, vecs + __ldg(d + O_RS), vecs + __ldg(d + O_RT),
             skip_off >= 0 ? sm + skip_off : nullptr, false);
    }
    __syncthreads();
  }
}

// A tensor's I/O record in the table: input i or output i
__device__ __forceinline__ const int* io_in(const int* table, int i) {
  return table + H_IO + i * IO_LEN;
}
__device__ __forceinline__ const int* io_out(const int* table, int i) {
  return table + H_IO + (kMaxIn + i) * IO_LEN;
}

// One sub-tile end to end: the table's inputs and silu(emb) from global
// memory, every op, the outputs (output 0 + the H_FINAL_X region when the
// table names one) to global memory.
template <typename IT, typename ST, typename OT, typename WT, bool ROUND_G>
__device__ void tile_forward(int tid, float4* sm,
                             const int* __restrict__ table,
                             const IT* const* ins, const ST* semb,
                             OT* const* outs, const WT* __restrict__ mats,
                             const float* __restrict__ vecs, int n, int n0) {
  constexpr bool R = kIsBf16<WT>;
  const int nv = max(0, min(kRows, n - n0));
  const int nin = __ldg(table + H_NIN), nout = __ldg(table + H_NOUT);
  for (int i = 0; i < nin; ++i) {
    const int* io = io_in(table, i);
    load_act<R>(tid, sm + __ldg(io + IO_OFF), __ldg(io + IO_C),
                __ldg(io + IO_TV), __ldg(io + IO_TVP), ins[i], n, n0, nv);
  }
  load_act<R>(tid, sm + __ldg(table + H_SEMB), __ldg(table + H_E), 1, 1,
              semb, n, n0, nv);
  __syncthreads();
  run_ops<WT, ROUND_G>(tid, sm, table, mats, vecs);
  const int fx = __ldg(table + H_FINAL_X);
  for (int i = 0; i < nout; ++i) {
    const int* io = io_out(table, i);
    store_act(tid, sm + __ldg(io + IO_OFF),
              (i == 0 && fx >= 0) ? sm + fx : nullptr, __ldg(io + IO_C),
              __ldg(io + IO_TV), __ldg(io + IO_TVP), outs[i], n, n0, nv);
  }
}

}  // namespace mocodad
