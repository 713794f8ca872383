// Device code of the bfloat16 tensor-core denoiser kernels: B1 at bfloat16
// (denoiser_tc.cu), B2 on the tensor cores (denoiser_tc_grouped.cu) and B3
// at bfloat16 (denoiser_tc_dma.cu).  The design is denoiser_tc.cu's (its
// note): per fold row an activation is a (T*V, C) bf16 tile in shared
// memory, M = 16 positions of one row, g chained in registers from the
// graph mix into the channel mix, every op's constants staged by cp.async.
//
// Included inside a kernel's own namespace, after it defines kWarps and
// kThreads and the enums of its table.  The header fields H_E, H_ROW0,
// H_ROW_BYTES, H_SEMB_OFF, H_EMB_OFF, H_EMB_STRIDE and H_EMBW_OFF and the op
// record fields O_* are named as in denoiser_tc.cu; a table's values may
// differ.  The rows per tile are an argument: B1 and B3 pass their constant
// kRows, B2 the rows its host plan chose for the group.

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
// the first `bytes` (0 or 16) of 16 from src, the rest zero filled
__device__ __forceinline__ void cp_async16z(uint32_t dst, const void* src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
// the first `bytes` (0, 2 or 4) of 4 from src, the rest zero filled
__device__ __forceinline__ void cp_async4z(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// every group but the last committed has landed
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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

// One ST-GCNN layer over the tile's `rows` rows: a unit is (row, 16
// positions, NT of the layer's C_out / 8 accumulator tiles: the layer's
// O_NSPLIT parts of C_out); `res`: a residual mix (else identity).
// kRoundG: g rounded once to bf16 before the channel mix (B2's function,
// one MMA per W fragment); else g = g_hi + g_lo in two MMAs (B1's: g stays
// float32 in value).
template <int NT, bool kRoundG>
__device__ void gcn_op(char* sm, const int* t, const int* d, const char* wb,
                       int rows, int warp, int lane, bool res) {
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
  for (int u = warp; u < rows * mt * ns; u += kWarps) {
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
      if constexpr (kRoundG) {
        hi[0] = pack(g[0][0], g[0][1]);
        hi[1] = pack(g[0][2], g[0][3]);
        hi[2] = pack(g[1][0], g[1][1]);
        hi[3] = pack(g[1][2], g[1][3]);
      } else {
        split(g[0][0], g[0][1], hi[0], lo[0]);
        split(g[0][2], g[0][3], hi[1], lo[1]);
        split(g[1][0], g[1][1], hi[2], lo[2]);
        split(g[1][2], g[1][3], hi[3], lo[3]);
      }
      // Wr f, then W g_hi for each pair of output tiles and (B1) W g_lo
      // for the pair before it, from the same W fragment: each fragment is
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
        if constexpr (!kRoundG) {
          if (j > 0) {
            mma(acc[j - 2], lo, wp[0], wp[1]);
            mma(acc[j - 1], lo, wp[2], wp[3]);
          }
        }
        wp[0] = w[0]; wp[1] = w[1]; wp[2] = w[2]; wp[3] = w[3];
      }
      if constexpr (!kRoundG) {
        mma(acc[NT - 2], lo, wp[0], wp[1]);
        mma(acc[NT - 1], lo, wp[2], wp[3]);
      }
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
                         int rows, int warp, int lane) {
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
  for (int u = warp; u < rows * mt; u += kWarps) {
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
// RB rows at a time
template <int RB>
__device__ void embed_all(int tid, char* sm, const int* t, int rows) {
  const int row0 = tab(t, H_ROW0), rb = tab(t, H_ROW_BYTES);
  const int E = tab(t, H_E), so = tab(t, H_SEMB_OFF);
  float* emb = reinterpret_cast<float*>(sm + tab(t, H_EMB_OFF));
  const int es = tab(t, H_EMB_STRIDE);
  const uint16_t* we = reinterpret_cast<const uint16_t*>(
      sm + tab(t, H_EMBW_OFF));
  const float* eb = reinterpret_cast<const float*>(we + es * E);
  for (int q = tid; q < es; q += kThreads) {
    for (int r0 = 0; r0 < rows; r0 += RB) {
      float acc[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] = eb[q];
      for (int k = 0; k < E; ++k) {
        const float w = bf(we[k * es + q]);
#pragma unroll
        for (int r = 0; r < RB; ++r)
          if (r0 + r < rows)
            acc[r] = fmaf(w, reinterpret_cast<const float*>(
                                 sm + row0 + (r0 + r) * rb + so)[k], acc[r]);
      }
#pragma unroll
      for (int r = 0; r < RB; ++r)
        if (r0 + r < rows) emb[(r0 + r) * es + q] = acc[r];
    }
  }
}

template <bool kRoundG>
__device__ void run_op(int tid, char* sm, const int* t, const int* d,
                       const char* wb, int rows) {
  const int warp = tid >> 5, lane = tid & 31;
  if (tab(d, O_KIND) == 1) {
    joint_op(sm, t, d, wb, rows, warp, lane);
    return;
  }
  const bool res = tab(d, O_RES) != 0;
  switch (tab(d, O_NT) / tab(d, O_NSPLIT)) {   // the host packs only these
    case 2:
      gcn_op<2, kRoundG>(sm, t, d, wb, rows, warp, lane, res);
      break;
    case 4:
      gcn_op<4, kRoundG>(sm, t, d, wb, rows, warp, lane, res);
      break;
    case 8:
      gcn_op<8, kRoundG>(sm, t, d, wb, rows, warp, lane, res);
      break;
    default:
      break;
  }
}

// blob[off .. off + bytes) -> dst, 16 bytes per cp.async, as one group
__device__ void stage(int tid, char* dst, const char* __restrict__ blob,
                      int off, int bytes) {
  const char* src = blob + off;
  const uint32_t to = smem_addr(dst);
  for (int i = tid * 16; i < bytes; i += kThreads * 16)
    cp_async16(to + i, src + i);
  cp_async_commit();
}
