// Eval-mode STSAEUnet denoiser forward, one thread block per tile of fold
// rows, for NVIDIA Hopper (sm_90a).
//
// Replaces: mocodad_tpu/ops/pallas_unet.py:build_pallas_denoiser (the inner
// `kernel`, :141-204), the JAX package's only TPU kernel.  It computes the
// same function on the same folded constants, in the same layer order and
// with the same association: in every ST-GCNN layer the graph operator K^T
// is applied first, then the channel mix W (BN scale folded in), plus the
// residual (a folded 1x1 conv + BN, or identity), the folded bias, PReLU
// with one shared slope, and W_e silu(emb) + b_e.  The four joint
// re-scalings are a block-diagonal (T*V_out x T*V_in) operator, one
// (V_out x V_in) block per frame, plus a per-row affine; then the skip adds
// of d1 and d2, and + x at the end.  Accumulation is
// float32; inputs and outputs are float32.
//
// Contract: eps = denoise(x, silu_emb, folded)
//   x        (C_in, T*V, N)  float32, contiguous
//   silu_emb (E, N)          float32, contiguous
//   eps      (C_in, T*V, N)  float32, contiguous
//   consts   every folded constant in one buffer; `table` (int32) holds the
//            op sequence, the shapes, the offsets into `consts` and the
//            shared-memory plan (built by mocodad_tpu_torch/ops/pallas_unet.py
//            pack_for_kernel).  Any N, including a ragged last tile: rows
//            past N are read as 0 and never written.
//
// What bounds it: at the flagship shapes (C_in 2, T 3, V 17 -> 12 -> 10,
// channels up to 128, E 16) one fold row costs about 5.3 MFLOP (the joint
// re-scalings counted without their zero blocks) and moves 0.9 KB of input
// and output, so a call is bound by float32 arithmetic (the H100 SXM's
// 67 TFLOP/s outside the tensor cores), not by memory: about 4.0 ms for
// N = 51,200.  chip_smoke.py recomputes the bound from the shapes.
//
// Design (right and simple first; no wgmma, TMA or bf16 yet):
//   * kRows = 4 fold rows per block.  Every activation lives in dynamic
//     shared memory as float4 vectors over the 4 rows, element (c, tv) at
//     float4 index c * TVp + tv.  TVp is T*V rounded up to an odd number, so
//     a quarter-warp that walks the channel dimension hits 8 distinct
//     16-byte bank groups.  At the flagship shapes the plan takes 226,656 of
//     the 232,448 bytes a block may use: one block per SM.
//   * The host plans the shared-memory arena (x, silu_emb, the per-layer
//     embedding, the skips d1 and d2, and a work area whose layer input,
//     graph-mixed intermediate and output alternate between its two ends),
//     so nothing is copied between layers: d1_1 and d2_1 write their output
//     straight into the skip buffers.
//   * The folded constants (352 KB at the flagship) are read through the
//     read-only path and stay resident in the 50 MB L2.  They are stored
//     transposed and zero-padded to a multiple of 4 outputs, so one thread
//     loads 4 output rows of a weight column as one float4.
//   * Products are plain FMA loops with float32 accumulators.  Each thread
//     owns 4 outputs x 4 rows (16 float4-lane accumulators, 32 with a
//     residual mix).  Threads that share a warp share the weight addresses,
//     so weight loads are broadcasts.  A joint re-scaling's thread walks
//     only the input frames of its 4 outputs (one frame, or two where the
//     4 outputs straddle a frame boundary), so the zero blocks off the
//     diagonal are skipped; dropping exact zeros changes no sum.
//   * The known cost: with 226 KB of shared memory per block, L1 keeps
//     little of a layer's weights, so weight loads come from L2 and one
//     block of 8 warps per SM hides their latency poorly.  Staging weights
//     in shared memory and wgmma are for a later revision.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 4;
constexpr int kThreads = 256;

// table header
enum {
  H_NOPS, H_CIN, H_T, H_TVA, H_TVAP, H_E, H_X, H_SEMB, H_EMB, H_FINAL, H_LEN
};
// one op record: kind 0 = ST-GCNN layer, 1 = joint re-scaling
enum {
  O_KIND, O_CI, O_CO, O_TVI, O_TVIP, O_TVO, O_TVOP,
  O_IN, O_G, O_OUT, O_SKIP,                 // shared-memory offsets (float4)
  O_K, O_W, O_WR, O_BIAS, O_SLOPE, O_WE, O_EB, O_RS, O_RT,  // consts offsets
  O_LEN
};

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

// out[b][m] = sum_k at[k][m] * in[b][k]   for b < nb, m < M, k < K,
// then optionally  out = out * rs[m] + rt[m]  and  out += skip[b][m].
// `at` is (K, Mp) row-major with Mp = M rounded up to 4 (zero padded).
// With `blocks` > 1 the operator is block-diagonal, `blocks` blocks of
// (M / blocks) x (K / blocks), and k walks only the blocks of a thread's
// 4 outputs; `blocks` = 1 is a dense operator.
// Threads walk b fastest, so a warp shares its weight column.
__device__ void rowmix(const float4* in, int in_stride, int nb, int K,
                       const float* __restrict__ at, int M, int blocks,
                       float4* out, int out_stride,
                       const float* __restrict__ rs,
                       const float* __restrict__ rt, const float4* skip) {
  const int mp4 = (M + 3) >> 2;
  const int items = nb * mp4;
  const int mb = M / blocks, kb = K / blocks;
  const float4* a4 = reinterpret_cast<const float4*>(at);
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
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
      const float4 a = __ldg(a4 + k * mp4 + mt);
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
          y = make_float4(y.x * s + t, y.y * s + t, y.z * s + t, y.w * s + t);
        }
        if (skip != nullptr) y = add4(y, skip[b * out_stride + m]);
        out[b * out_stride + m] = y;
      }
    }
  }
}

// emb[o] = sum_e we[e][o] * semb[e] + eb[o]   (we is (E, Cp), zero padded)
__device__ void embed(const float4* semb, int E, int co,
                      const float* __restrict__ we,
                      const float* __restrict__ eb, float4* emb) {
  const int cp = ((co + 3) >> 2) << 2;
  for (int o = threadIdx.x; o < co; o += blockDim.x) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int e = 0; e < E; ++e) acc = fma4(__ldg(we + e * cp + o), semb[e], acc);
    emb[o] = add4s(acc, __ldg(eb + o));
  }
}

// The rest of one ST-GCNN layer, after the graph mix g = K^T f:
//   y[o][q] = prelu(sum_c w[c][o] g[c][q] + res[o][q] + bias[o]) + emb[o]
//   res[o][q] = sum_c wr[c][o] f[c][q]   (RES)   or   f[o][q]
// Threads walk q fastest, so a warp shares its weight column.
template <bool RES>
__device__ void chanmix(const float4* g, const float4* f, int ci, int co,
                        int tv, int tvp, const float* __restrict__ w,
                        const float* __restrict__ wr,
                        const float* __restrict__ bias, float slope,
                        const float4* emb, float4* out) {
  const int cp4 = (co + 3) >> 2;
  const int items = cp4 * tv;
  const float4* w4 = reinterpret_cast<const float4*>(w);
  const float4* wr4 = reinterpret_cast<const float4*>(wr);
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int q = it % tv;
    const int ot = it / tv;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 acc0 = z, acc1 = z, acc2 = z, acc3 = z;
    float4 res0 = z, res1 = z, res2 = z, res3 = z;
#pragma unroll 4
    for (int c = 0; c < ci; ++c) {
      const float4 gv = g[c * tvp + q];
      const float4 a = __ldg(w4 + c * cp4 + ot);
      acc0 = fma4(a.x, gv, acc0);
      acc1 = fma4(a.y, gv, acc1);
      acc2 = fma4(a.z, gv, acc2);
      acc3 = fma4(a.w, gv, acc3);
      if (RES) {
        const float4 fv = f[c * tvp + q];
        const float4 r = __ldg(wr4 + c * cp4 + ot);
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
        out[o * tvp + q] = add4(y, emb[o]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
denoiser_kernel(const float* __restrict__ x, const float* __restrict__ semb,
                const float* __restrict__ consts,
                const int* __restrict__ table, float* __restrict__ eps,
                int n) {
  extern __shared__ float4 sm[];
  const int n0 = blockIdx.x * kRows;
  const int nv = min(kRows, n - n0);
  const int nops = __ldg(table + H_NOPS);
  const int cin = __ldg(table + H_CIN);
  const int frames = __ldg(table + H_T);
  const int tva = __ldg(table + H_TVA);
  const int tvap = __ldg(table + H_TVAP);
  const int E = __ldg(table + H_E);
  float4* xs = sm + __ldg(table + H_X);
  float4* se = sm + __ldg(table + H_SEMB);
  float4* emb = sm + __ldg(table + H_EMB);

  // x (C_in, T*V, N) and silu_emb (E, N) -> shared, rows past N as 0
  const int nx = cin * tva;
  for (int i = threadIdx.x; i < nx * kRows; i += blockDim.x) {
    const int r = i % kRows, ctv = i / kRows;
    const int c = ctv / tva, tv = ctv % tva;
    reinterpret_cast<float*>(xs + c * tvap + tv)[r] =
        r < nv ? x[static_cast<size_t>(ctv) * n + n0 + r] : 0.f;
  }
  for (int i = threadIdx.x; i < E * kRows; i += blockDim.x) {
    const int r = i % kRows, e = i / kRows;
    reinterpret_cast<float*>(se + e)[r] =
        r < nv ? semb[static_cast<size_t>(e) * n + n0 + r] : 0.f;
  }
  __syncthreads();

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
      embed(se, E, co, consts + __ldg(d + O_WE), consts + __ldg(d + O_EB),
            emb);
      rowmix(in, tvip, ci, tvi, consts + __ldg(d + O_K), tvo, 1, g, tvop,
             nullptr, nullptr, nullptr);
      __syncthreads();
      const float slope = __ldg(consts + __ldg(d + O_SLOPE));
      const float* w = consts + __ldg(d + O_W);
      const float* bias = consts + __ldg(d + O_BIAS);
      const int wr_off = __ldg(d + O_WR);
      if (wr_off >= 0)
        chanmix<true>(g, in, ci, co, tvo, tvop, w, consts + wr_off, bias,
                      slope, emb, out);
      else
        chanmix<false>(g, in, ci, co, tvo, tvop, w, nullptr, bias, slope,
                       emb, out);
    } else {
      const int skip_off = __ldg(d + O_SKIP);
      rowmix(in, tvip, ci, tvi, consts + __ldg(d + O_K), tvo, frames, out,
             tvop, consts + __ldg(d + O_RS), consts + __ldg(d + O_RT),
             skip_off >= 0 ? sm + skip_off : nullptr);
    }
    __syncthreads();
  }

  // eps = f + x
  const float4* fin = sm + __ldg(table + H_FINAL);
  for (int i = threadIdx.x; i < nx * kRows; i += blockDim.x) {
    const int r = i % kRows, ctv = i / kRows;
    if (r < nv) {
      const int c = ctv / tva, tv = ctv % tva;
      eps[static_cast<size_t>(ctv) * n + n0 + r] =
          reinterpret_cast<const float*>(fin + c * tvap + tv)[r] +
          reinterpret_cast<const float*>(xs + c * tvap + tv)[r];
    }
  }
}

}  // namespace

// Launch on `stream`; returns the CUDA error code (0 on success).  Nothing
// is allocated and nothing is synchronised here.
extern "C" int mocodad_denoiser_launch(const float* x, const float* semb,
                                       const float* consts, const int* table,
                                       float* eps, int n, int smem_bytes,
                                       void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      denoiser_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kRows - 1) / kRows;
  denoiser_kernel<<<blocks, kThreads, smem_bytes,
                    static_cast<cudaStream_t>(stream)>>>(x, semb, consts,
                                                         table, eps, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mocodad_denoiser_rows_per_block() { return kRows; }

// The table format this build reads: its header length and its op record
// length.  The host's packer checks both before the first launch.
extern "C" int mocodad_denoiser_header_len() { return H_LEN; }
extern "C" int mocodad_denoiser_op_len() { return O_LEN; }
