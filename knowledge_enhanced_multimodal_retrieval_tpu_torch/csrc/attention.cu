// Tiled online-softmax attention for Hopper (sm_90a), [B, H, S, D].
//
// Replaces two Pallas TPU kernels that compute one function:
//   B6 knowledge_enhanced_multimodal_retrieval_tpu/ops/short_attention.py::_short_forward
//      (128 < s <= 512: the whole sequence in VMEM, one softmax)
//   B7 knowledge_enhanced_multimodal_retrieval_tpu/ops/flash_attention.py::_flash_forward
//      (s > 512: K/V tiles streamed through VMEM, online softmax)
// The short/flash split is a VMEM artifact; one streamed kernel serves every
// length here.
//
// What it computes: scores scaled after the dot, key columns at or past the
// key length (and, when causal, col > row) masked with p = 0 there, an f32
// running (max, sum, accumulator), a zero denominator replaced by 1, one
// cast to the input dtype. D <= 256, ragged Sq / Sk.
//
// What bounds it on the H100: at ViT-L/14 vision shapes (s = 257 or 577,
// hd = 64) the arithmetic intensity is ~s/2 FLOP per byte of q/k/v, so the
// kernel is bound by operations: f32 FMAs (67 TFLOP/s) cannot come near the
// tensor cores' rate, and at hd = 64 the exponentials (16 a clock and SM)
// take as many cycles as the two products at the tensor cores' peak.
//
// bf16, head dims up to 64 (flash_attention_wg_kernel): both products are
// wgmma m64n64k16 (bf16 in, f32 accumulators in registers). A block is one
// warpgroup owning 64 query rows.
// - q . k^T: Q is the A operand in registers (ldmatrix once per block), a
//   K tile of 64 keys the B operand, read from shared memory through a
//   128-byte-swizzle descriptor (rows of 128 bytes, 16-byte chunk c of row r
//   at chunk c ^ (r & 7), tiles 1024-byte aligned).
// - The scores stay in the accumulator fragments: the softmax (max and sum
//   over a row, exp2 of score * scale * log2 e less the running maximum as
//   one fused multiply-add and one ex2, the rescale of the output
//   accumulator) runs on them with two quad shuffles per reduction.
// - p . v: p is the A operand straight from the score fragments, rounded to
//   bf16 (what the tensor cores take, and what mha_plain / mha_xla do),
//   never through shared memory; the running sum adds the f32 p. V is the B
//   operand with its head dim contiguous (the transposed, MN-major form of
//   the same swizzled tile), so no transpose is staged.
// - Asynchronous loads: with D = 64 and 16-byte-aligned tensors, Q and the
//   K/V tiles arrive by TMA (one thread starts the tensor-map boxes, the
//   hardware swizzles and zero-fills rows past the sequence) into a ring of
//   two stages, each completed on an mbarrier; tile j + 1 is in flight while
//   tile j is multiplied, one __syncthreads() a tile frees the slot. The
//   output leaves through the warp's rows of the Q tile as 16-byte stores.
//   Other D <= 64 take the same kernel with cp.async staging (plain loads
//   when D % 8 != 0) and stores from the fragments.
// - Padding: the last key tile multiplies all 64 keys in q . k^T (rows past
//   the last key are zeros) but exponentiates and feeds to p . v only the
//   groups of 16 keys that hold a key: 257 keys cost 272 there (5.5 %
//   padding; 320 and 20 % before) and 577 cost 592 (2.5 %; 640 and 10 %).
//   Query rows come in 64s, the instruction's M: 257 rows cost 320 (20 %),
//   577 cost 640 (10 %). Masks are applied only to a tile that has them.
//   Each tile width has a straight-line body of its own (wg_tile<NGRP>): a
//   wgmma group under a condition of its own is serialized by ptxas.
// - Filling the card: 128 threads at 118 registers and 41 KB of shared
//   memory, so four blocks (four warpgroups) an SM, bound by registers;
//   [64, 16, 257, 64] gives 5,120 blocks and [16, 16, 577, 64] gives 2,560.
//
// bf16, head dims 128 and 256 (flash_attention_tc_kernel): the same
// arithmetic on mma.sync m16n8k16 with ldmatrix (the FlashAttention-2
// shape): a warp owns 16 query rows, a block of 4 warps 64; K fragments come
// from ldmatrix, V fragments from ldmatrix.trans, Q fragments stay in
// registers (DP = 128) or are re-read (DP = 256); K/V tiles of 64 keys
// stream through a ring of 3 stages (2 at DP = 256) filled with 16-byte
// cp.async. DP = 128: 167 registers, 112 KB, two blocks an SM; DP = 256: 254
// registers, 160 KB, one block. These widths were not moved to wgmma: their
// accumulators (64 and 128 registers beside the scores and Q) want another
// split of the work, and no model of the package has such heads.
//
// f32 route (flash_attention_kernel): inputs stay f32 on the CUDA cores
// (TF32 would not hold the f32 tolerance), p stays f32 through p@v. Each of
// 256 threads holds a 4 x 4 score tile and a 4 x D/16 output tile, reading
// q/k/v rows from shared memory.

#include "mma.cuh"
#include <cstring>

// ---- bf16 route: tensor cores -------------------------------------------------

constexpr int TC_BK = 64;  // keys per tile

// A warp owns 16 query rows, a block of 4 warps 64 of them. (At DP = 64,
// before that width moved to wgmma, 8 warps a block took 0.19 / 0.16 ms at
// s = 257 / 577, and two 16-row tiles a warp, which halve the ldmatrix
// traffic per product, 0.27 / 0.21 ms at 222-245 registers.)
template <int DP>
struct TcCfg {
  static constexpr int NW = 4;
  static constexpr int BQ = 16 * NW, THREADS = 32 * NW;
  static constexpr int STAGES = DP <= 128 ? 3 : 2;
  static constexpr int TILE = TC_BK * DP;  // elements of one 64-row tile
  static constexpr size_t SMEM = sizeof(bf16) * ((size_t)BQ * DP + (size_t)TILE * 2 * STAGES);
};

// Stage rows [r0, r0 + ROWS) of the [S, D] matrix src as a swizzled bf16 tile:
// element (r, d) at r * DP + (((d / 8) ^ (r & 7)) * 8 + d % 8); rows past S
// and columns past D are zeros.
template <int DP, int ROWS, int THREADS>
__device__ __forceinline__ void tc_load_tile(bf16* dst, const bf16* __restrict__ src, int r0, int S,
                                             int D, bool vec) {
  constexpr int CH = DP / 8, RS = THREADS / CH;  // chunks a row, rows one round of copies covers
  static_assert(THREADS % CH == 0 && ROWS % RS == 0, "whole copy rounds");
  const uint32_t base = smem_u32(dst);
  const int c = threadIdx.x % CH, rt = threadIdx.x / CH;  // this thread's chunk column and first row
#pragma unroll
  for (int i = 0; i < ROWS / RS; ++i) {
    const int r = rt + RS * i;
    const int row = r0 + r, col = c * 8;
    const int off = r * DP + ((c ^ (r & 7)) * 8);
    if (vec) {
      const bool in = row < S && col < D;  // D % 8 == 0: a chunk is whole or empty
      cp_async16(base + off * 2, in ? src + (size_t)row * D + col : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        dst[off + i] = (row < S && col + i < D) ? src[(size_t)row * D + col + i] : f2bf(0.f);
    }
  }
}

constexpr float TC_MASKED = -1e30f;  // a masked raw score: far below any real one at any scale

// The score fragments of 16 query rows x 64 keys, as both tensor-core routes
// leave them: s[4 j + e] is (row row0 + 8 (e >> 1), key k0 + 8 j + 2 t + (e & 1)),
// row0 the row of this thread's first fragment row, t = lane % 4.
// Masks: key columns at or past kv_end, and col > row when causal.
__device__ __forceinline__ void tc_mask_tile(float (&s)[32], int k0, int kv_end, int causal, int row0, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + 8 * j + 2 * t + (e & 1);
      const int row = row0 + 8 * (e >> 1);
      if (col >= kv_end || (causal && col > row)) s[4 * j + e] = TC_MASKED;
    }
}

// One tile of the online softmax on the fragments: s becomes p (only the
// first ngrp groups of 16 keys hold scores), m the running maximum in units
// of log2 (score * scale * log2 e), l this thread's share of the running
// sum, and the output accumulator (oacc[4 n + e], rows as in s) is rescaled.
template <int NACC>
__device__ __forceinline__ void tc_softmax_tile(float (&s)[32], float (&oacc)[NACC], float (&m)[2],
                                                float (&l)[2], int ngrp, float scale_log2) {
  float mx[2] = {TC_MASKED, TC_MASKED};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if ((j >> 1) < ngrp) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
  }
  float corr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h] * scale_log2);
    corr[h] = ex2_approx(m[h] - m_new);
    m[h] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if ((j >> 1) < ngrp) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // p = 2^(s * scale * log2 e - m); a masked score gives 0
        s[4 * j + e] = ex2_approx(fmaf(s[4 * j + e], scale_log2, -m[e >> 1]));
        sum[e >> 1] += s[4 * j + e];
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];
#pragma unroll
  for (int i = 0; i < NACC; ++i) oacc[i] *= corr[(i >> 1) & 1];
}

// p of key group kg (16 keys) as the A fragments of p . v, rounded to bf16.
__device__ __forceinline__ void tc_pack_p(uint32_t (&p)[4], const float (&s)[32], int kg) {
  p[0] = pack_bf16(s[8 * kg], s[8 * kg + 1]);
  p[1] = pack_bf16(s[8 * kg + 2], s[8 * kg + 3]);
  p[2] = pack_bf16(s[8 * kg + 4], s[8 * kg + 5]);
  p[3] = pack_bf16(s[8 * kg + 6], s[8 * kg + 7]);
}

// Rows row0 and row0 + 8 of the output: the sums of the row's four lanes
// joined, a zero denominator replaced by 1, one cast to bf16.
template <int NACC>
__device__ __forceinline__ void tc_store_rows(bf16* __restrict__ o_bh, const float (&oacc)[NACC], float (&l)[2],
                                              int row0, int Sq, int D, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = row0 + 8 * h;
    if (row >= Sq) continue;
    const float denom = l[h] == 0.f ? 1.f : l[h];
    bf16* orow = o_bh + (size_t)row * D;
#pragma unroll
    for (int n = 0; n < NACC / 4; ++n) {
      const int d = 8 * n + 2 * t;
      const float x0 = oacc[4 * n + 2 * h] / denom, x1 = oacc[4 * n + 2 * h + 1] / denom;
      if ((D & 1) == 0 && d + 1 < D) {
        *reinterpret_cast<uint32_t*>(orow + d) = pack_bf16(x0, x1);
      } else {
        if (d < D) orow[d] = f2bf(x0);
        if (d + 1 < D) orow[d + 1] = f2bf(x1);
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(TcCfg<DP>::THREADS)
flash_attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o, int n_qtiles, int Sq,
                          int Sk, int D, int causal, float scale_log2) {
  using Cfg = TcCfg<DP>;
  constexpr int STAGES = Cfg::STAGES, TILE = Cfg::TILE, BQ = Cfg::BQ, THREADS = Cfg::THREADS;
  constexpr int KK = DP / 16;  // k16 steps of q.k
  constexpr int NO = DP / 8;   // n8 blocks of the output
  constexpr bool Q_IN_REGS = DP <= 128;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* KV = Qs + BQ * DP;  // stage s: K at KV + 2 s TILE, V right behind it

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mat = lane >> 3, mr = lane & 7;  // ldmatrix: this lane addresses row mr of matrix mat
  const size_t bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * BQ;
  const bf16* qb = q + bh * Sq * D;
  const bf16* kb = k + bh * Sk * D;
  const bf16* vb = v + bh * Sk * D;
  const bool vec = (D % 8) == 0;

  // causal: key columns past the block's last row are masked for every row
  const int kv_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int nt = (kv_end + TC_BK - 1) / TC_BK;
  const int w0 = q0 + warp * 16;  // this warp's first query row
  const bool active = w0 < Sq;    // else all 16 rows are padding: the warp only helps to load

  tc_load_tile<DP, BQ, THREADS>(Qs, qb, q0, Sq, D, vec);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nt) {
      tc_load_tile<DP, TC_BK, THREADS>(KV + 2 * s * TILE, kb, s * TC_BK, Sk, D, vec);
      tc_load_tile<DP, TC_BK, THREADS>(KV + (2 * s + 1) * TILE, vb, s * TC_BK, Sk, D, vec);
    }
    cp_async_commit();
  }

  float oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  // rows g and g + 8: the running maximum in units of log2 (score * scale * log2 e),
  // and this thread's share of the running sum
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f};
  uint32_t qf[Q_IN_REGS ? KK : 1][4];
  const int qrow = warp * 16 + (mat & 1) * 8 + mr;  // this lane's row of the Q fragments
  const uint32_t q_base = smem_u32(Qs) + qrow * DP * 2;

  for (int tile = 0; tile < nt; ++tile) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile `tile` has landed for every thread; the slot of tile - 1 is free
    const int nxt = tile + STAGES - 1;
    if (nxt < nt) {
      bf16* slot = KV + 2 * (nxt % STAGES) * TILE;
      tc_load_tile<DP, TC_BK, THREADS>(slot, kb, nxt * TC_BK, Sk, D, vec);
      tc_load_tile<DP, TC_BK, THREADS>(slot + TILE, vb, nxt * TC_BK, Sk, D, vec);
    }
    cp_async_commit();
    const int k0 = tile * TC_BK;
    // under the causal mask this warp's rows see no key of a tile past their diagonal
    if (!active || (causal && k0 > w0 + 15)) continue;
    if (Q_IN_REGS && tile == 0) {
#pragma unroll
      for (int kk = 0; kk < KK; ++kk)
        ldmatrix_x4(qf[Q_IN_REGS ? kk : 0], q_base + (((2 * kk + (mat >> 1)) ^ (qrow & 7)) * 16));
    }
    const uint32_t ks = smem_u32(KV + 2 * (tile % STAGES) * TILE);
    const uint32_t vs = ks + TILE * 2;
    const int ngrp = min(4, (kv_end - k0 + 15) / 16);  // groups of 16 keys that hold a real key

    // s = q . k^T for 16 rows x 64 keys: s[j][e] is (row g + 8 (e >> 1), key 8 j + 2 t + (e & 1))
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      uint32_t a[4];
      if (Q_IN_REGS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[Q_IN_REGS ? kk : 0][i];
      } else {
        ldmatrix_x4(a, q_base + (((2 * kk + (mat >> 1)) ^ (qrow & 7)) * 16));
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (jj < ngrp) {
          const int key = 16 * jj + (mat >> 1) * 8 + mr;
          uint32_t b[4];
          ldmatrix_x4(b, ks + key * DP * 2 + (((2 * kk + (mat & 1)) ^ (key & 7)) * 16));
          mma_bf16_16816(s[2 * jj], a, b[0], b[1]);
          mma_bf16_16816(s[2 * jj + 1], a, b[2], b[3]);
        }
      }
    }

    // masks only where the tile has them: past the last key, or on the causal diagonal
    float(&sf)[32] = reinterpret_cast<float(&)[32]>(s);
    if (k0 + TC_BK > kv_end || (causal && k0 + TC_BK - 1 > w0)) tc_mask_tile(sf, k0, kv_end, causal, w0 + g, t);
    tc_softmax_tile(sf, reinterpret_cast<float(&)[NO * 4]>(oacc), m, l, ngrp, scale_log2);

    // o += p . v with p rounded to bf16, straight from the score fragments
#pragma unroll
    for (int kg = 0; kg < 4; ++kg) {
      if (kg < ngrp) {
        uint32_t p[4];
        tc_pack_p(p, sf, kg);
        const int key = 16 * kg + (mat & 1) * 8 + mr;
#pragma unroll
        for (int n2 = 0; n2 < NO / 2; ++n2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vs + key * DP * 2 + (((2 * n2 + (mat >> 1)) ^ (key & 7)) * 16));
          mma_bf16_16816(oacc[2 * n2], p, b[0], b[1]);
          mma_bf16_16816(oacc[2 * n2 + 1], p, b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!active) return;

  tc_store_rows(o + bh * Sq * D, reinterpret_cast<float(&)[NO * 4]>(oacc), l, w0 + g, Sq, D, t);
}

template <int DP>
static int launch_flash_tc(const void* q, const void* k, const void* v, void* o, int BH, int Sq, int Sk,
                           int D, int causal, float scale, cudaStream_t st) {
  using Cfg = TcCfg<DP>;
  constexpr size_t smem = Cfg::SMEM;
  static_assert(smem <= 227 * 1024, "flash tile exceeds the H100 shared-memory opt-in");
  cudaError_t e = cudaFuncSetAttribute(flash_attention_tc_kernel<DP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_qtiles = (Sq + Cfg::BQ - 1) / Cfg::BQ;
  const long long blocks = (long long)BH * n_qtiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  flash_attention_tc_kernel<DP><<<(unsigned)blocks, Cfg::THREADS, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, n_qtiles, Sq, Sk, D, causal,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// ---- bf16 route, head dims up to 64: wgmma ------------------------------------

// A block is one warpgroup, which owns 64 query rows, over a ring of two K/V
// stages: 41 KB of shared memory and 118 registers a thread, so four blocks
// fit an SM (bound by registers). Two warpgroups a block sharing the ring,
// and three stages, were slower once the loads went through TMA (0.097 /
// 0.084 ms at s = 257 / 577 against 0.087 / 0.082).
struct WgCfg {
  static constexpr int STAGES = 2, BQ = 64, THREADS = 128;
  static constexpr int TILE = TC_BK * 64;  // elements of one 64-key tile
  // + 1024: the swizzled tiles start at a 1024-byte boundary
  static constexpr size_t SMEM = 1024 + sizeof(bf16) * ((size_t)BQ * 64 + (size_t)TILE * 2 * STAGES);
};

// One key tile for a warpgroup's 64 query rows: NGRP groups of 16 keys (4 but
// in the last tile). ks / vs: the K and V tiles in shared memory, 64 rows of
// 128 bytes in the 128-byte swizzle.
template <int NGRP>
__device__ __forceinline__ void wg_tile(float (&oacc)[32], float (&m)[2], float (&l)[2],
                                        const uint32_t (&qf)[4][4], uint32_t ks, uint32_t vs, bool masked,
                                        int k0, int kv_end, int causal, int row0, int t, float scale_log2) {
  // s = q . k^T: q is the A operand in registers; the keys are the N side,
  // K-major: 16 keys lie 2048 bytes apart, a k16 step of the head dim 32 bytes
  float s[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16<0>(s, qf[kk], wgmma_desc_sw128(ks + kk * 32), kk > 0);
  wgmma_commit();
  wgmma_wait0();
  wgmma_fence_regs(s);

  if (masked) tc_mask_tile(s, k0, kv_end, causal, row0, t);
  tc_softmax_tile(s, oacc, m, l, NGRP, scale_log2);

  // o += p . v: p is the A operand in registers, rounded to bf16; the keys are
  // the K side, the head dim contiguous (MN-major), 16 keys 2048 bytes apart
  uint32_t p[NGRP][4];
#pragma unroll
  for (int kg = 0; kg < NGRP; ++kg) tc_pack_p(p[kg], s, kg);
  wgmma_fence_regs(oacc);
  wgmma_fence();
#pragma unroll
  for (int kg = 0; kg < NGRP; ++kg) wgmma_m64n64k16<1>(oacc, p[kg], wgmma_desc_sw128(vs + kg * 2048), 1);
  wgmma_commit();
  wgmma_wait0();
  wgmma_fence_regs(oacc);
}

// TMA = true needs D == 64 and 16-byte-aligned tensors: Q and the K/V tiles
// arrive as tensor-map boxes started by one thread and completed on an
// mbarrier per stage, and the output leaves through shared memory in
// 16-byte stores. TMA = false stages with cp.async (plain loads when
// D % 8 != 0) and stores from the fragments.
template <bool TMA>
__global__ void __launch_bounds__(WgCfg::THREADS)
flash_attention_wg_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, int n_qtiles, int Sq, int Sk, int D,
                          int causal, float scale_log2) {
  using Cfg = WgCfg;
  constexpr int DP = 64, STAGES = Cfg::STAGES, TILE = Cfg::TILE, BQ = Cfg::BQ, THREADS = Cfg::THREADS;
  constexpr uint32_t TILE_BYTES = TILE * sizeof(bf16);
  extern __shared__ unsigned char wg_raw[];
  __shared__ __align__(8) uint64_t full_bar[STAGES];  // TMA: stage s has landed
  bf16* Qs = reinterpret_cast<bf16*>(wg_raw + ((1024 - (smem_u32(wg_raw) & 1023)) & 1023));
  bf16* KV = Qs + BQ * DP;  // stage s: K at KV + 2 s TILE, V right behind it

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mat = lane >> 3, mr = lane & 7;
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * BQ;
  const bf16* qb = q + (size_t)bh * Sq * D;
  const bf16* kb = k + (size_t)bh * Sk * D;
  const bf16* vb = v + (size_t)bh * Sk * D;
  const bool vec = (D % 8) == 0;

  const int kv_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int nt = (kv_end + TC_BK - 1) / TC_BK;

  // Fill ring slot `tile % STAGES` with K/V tile `tile` (TMA: one thread, and Q rides with tile 0).
  auto load_kv = [&](int tile) {
    bf16* slot = KV + 2 * (tile % STAGES) * TILE;
    if constexpr (TMA) {
      if (threadIdx.x == 0) {
        uint64_t* bar = &full_bar[tile % STAGES];
        mbar_expect_tx(bar, 2 * TILE_BYTES + (tile == 0 ? BQ * DP * (uint32_t)sizeof(bf16) : 0u));
        if (tile == 0) tma_load_3d(Qs, &tm_q, 0, q0, bh, bar);
        tma_load_3d(slot, &tm_k, 0, tile * TC_BK, bh, bar);
        tma_load_3d(slot + TILE, &tm_v, 0, tile * TC_BK, bh, bar);
      }
    } else {
      tc_load_tile<DP, TC_BK, THREADS>(slot, kb, tile * TC_BK, Sk, D, vec);
      tc_load_tile<DP, TC_BK, THREADS>(slot + TILE, vb, tile * TC_BK, Sk, D, vec);
    }
  };

  if constexpr (TMA) {
    if (threadIdx.x == 0) {
#pragma unroll
      for (int s = 0; s < STAGES; ++s) mbar_init(&full_bar[s], 1);
      mbar_fence_init();
    }
    __syncthreads();
  } else {
    tc_load_tile<DP, BQ, THREADS>(Qs, qb, q0, Sq, D, vec);
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nt) load_kv(s);
    if constexpr (!TMA) cp_async_commit();
  }

  float oacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) oacc[i] = 0.f;
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f};
  uint32_t qf[4][4];
  const int qrow = warp * 16 + (mat & 1) * 8 + mr;  // this lane's row of the Q fragments
  const uint32_t q_base = smem_u32(Qs) + qrow * DP * 2;
  const int row0 = q0 + warp * 16 + g;  // this thread's fragment rows: row0 and row0 + 8

  for (int tile = 0; tile < nt; ++tile) {
    if constexpr (TMA) {
      mbar_wait(&full_bar[tile % STAGES], (tile / STAGES) & 1);
    } else {
      cp_async_wait<STAGES - 2>();
      fence_proxy_async();  // the copies are read by wgmma, through the asynchronous proxy
    }
    __syncthreads();  // tile `tile` has landed for every thread; the slot of tile - 1 is free
    if (tile + STAGES - 1 < nt) load_kv(tile + STAGES - 1);
    if constexpr (!TMA) cp_async_commit();
    const int k0 = tile * TC_BK;
    if (tile == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(qf[kk], q_base + (((2 * kk + (mat >> 1)) ^ (qrow & 7)) * 16));
    }
    const uint32_t ks = smem_u32(KV + 2 * (tile % STAGES) * TILE);
    const uint32_t vs = ks + TILE_BYTES;
    const int ngrp = min(4, (kv_end - k0 + 15) / 16);  // groups of 16 keys that hold a real key
    const bool masked = k0 + TC_BK > kv_end || (causal && k0 + TC_BK - 1 > q0);
    // one straight-line body per width of the tile: a wgmma group under a
    // condition of its own would be serialized by the compiler
    if (ngrp == 4) wg_tile<4>(oacc, m, l, qf, ks, vs, masked, k0, kv_end, causal, row0, t, scale_log2);
    else if (ngrp == 3) wg_tile<3>(oacc, m, l, qf, ks, vs, masked, k0, kv_end, causal, row0, t, scale_log2);
    else if (ngrp == 2) wg_tile<2>(oacc, m, l, qf, ks, vs, masked, k0, kv_end, causal, row0, t, scale_log2);
    else wg_tile<1>(oacc, m, l, qf, ks, vs, masked, k0, kv_end, causal, row0, t, scale_log2);
  }
  if constexpr (!TMA) cp_async_wait<0>();
  bf16* ob = o + (size_t)bh * Sq * D;
  if constexpr (!TMA) {
    tc_store_rows(ob, oacc, l, row0, Sq, D, t);
  } else {
    // The warp's 16 rows go back through its own rows of the Q tile (its Q
    // fragments are in registers), swizzled as Q was, and leave as 16-byte stores.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const float inv = 1.0f / (l[h] == 0.f ? 1.f : l[h]);
      const int r = warp * 16 + g + 8 * h;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(Qs) + r * 128 + ((n ^ (r & 7)) * 16) + 4 * t) =
            pack_bf16(oacc[4 * n + 2 * h] * inv, oacc[4 * n + 2 * h + 1] * inv);
    }
    __syncwarp();
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int r = warp * 16 + 4 * it + (lane >> 3), c = lane & 7;
      if (q0 + r < Sq)
        *reinterpret_cast<uint4*>(ob + (size_t)(q0 + r) * 64 + c * 8) =
            *reinterpret_cast<const uint4*>(reinterpret_cast<unsigned char*>(Qs) + r * 128 + ((c ^ (r & 7)) * 16));
    }
  }
}

static int launch_flash_wg(const void* q, const void* k, const void* v, void* o, int BH, int Sq, int Sk,
                           int D, int causal, float scale, cudaStream_t st) {
  using Cfg = WgCfg;
  const int n_qtiles = (Sq + Cfg::BQ - 1) / Cfg::BQ;
  const long long blocks = (long long)BH * n_qtiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const float scale_log2 = scale * 1.4426950408889634f;
  const auto al16 = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  CUtensorMap tq, tk, tv;
  const bool tma = D == 64 && al16(q) && al16(k) && al16(v) && al16(o);
  if (tma) {
    int rc = tma_map_rows64(&tq, 2, q, 64, Sq, BH, Cfg::BQ, 1);
    if (rc == 0) rc = tma_map_rows64(&tk, 2, k, 64, Sk, BH, TC_BK, 1);
    if (rc == 0) rc = tma_map_rows64(&tv, 2, v, 64, Sk, BH, TC_BK, 1);
    if (rc != 0) return rc;
  } else {
    memset(&tq, 0, sizeof(tq));  // not read
    tk = tv = tq;
  }
  const auto launch = [&](auto* kernel) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cfg::SMEM);
    if (e != cudaSuccess) return (int)e;
    kernel<<<(unsigned)blocks, Cfg::THREADS, Cfg::SMEM, st>>>((const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o,
                                                               tq, tk, tv, n_qtiles, Sq, Sk, D, causal, scale_log2);
    return (int)cudaGetLastError();
  };
  return tma ? launch(flash_attention_wg_kernel<true>) : launch(flash_attention_wg_kernel<false>);
}

static int flash_dispatch_tc(const void* q, const void* k, const void* v, void* o, int BH, int Sq,
                             int Sk, int D, int causal, float scale, cudaStream_t st) {
  if (D <= 64) return launch_flash_wg(q, k, v, o, BH, Sq, Sk, D, causal, scale, st);
  if (D <= 128) return launch_flash_tc<128>(q, k, v, o, BH, Sq, Sk, D, causal, scale, st);
  if (D <= 256) return launch_flash_tc<256>(q, k, v, o, BH, Sq, Sk, D, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

// ---- f32 route: CUDA cores ----------------------------------------------------

constexpr int FA_BQ = 64, FA_BK = 64, FA_THREADS = 256;

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }

// Max / sum over the 16 lanes that share a row (tx = lane & 15).
__device__ __forceinline__ float row16_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row16_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int DP>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * ((size_t)FA_BQ * (DP + 1) + (size_t)FA_BK * (DP + 1) +
                          (size_t)FA_BK * DP + (size_t)FA_BQ * (FA_BK + 1));
}

// DP: head_dim padded to 32, 64, 128 or 256 (pad columns are zeros).
template <typename T, int DP>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int n_qtiles, int Sq,
                       int Sk, int D, int causal, float scale) {
  extern __shared__ __align__(16) float sm[];
  constexpr int LD = DP + 1;  // odd word stride: conflict-free row reads
  constexpr int LP = FA_BK + 1;
  constexpr int NO = DP / 16;
  float* Qs = sm;               // [BQ][LD]
  float* Ks = Qs + FA_BQ * LD;  // [BK][LD]
  float* Vs = Ks + FA_BK * LD;  // [BK][DP] (read along d: no pad needed)
  float* Ps = Vs + FA_BK * DP;  // [BQ][LP]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * FA_BQ;
  const T* qb = q + bh * Sq * D;
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;

  for (int e = threadIdx.x; e < FA_BQ * DP; e += FA_THREADS) {
    const int r = e / DP, d = e % DP;
    Qs[r * LD + d] = (q0 + r < Sq && d < D) ? to_f(qb[(size_t)(q0 + r) * D + d]) : 0.f;
  }

  float acc[4][NO], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -FLT_MAX;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NO; ++n) acc[i][n] = 0.f;
  }

  // causal: key columns past the tile's last row are masked for every row
  const int kv_end = causal ? min(Sk, q0 + FA_BQ) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += FA_BK) {
    __syncthreads();  // the previous tile's K/V reads are done
    for (int e = threadIdx.x; e < FA_BK * DP; e += FA_THREADS) {
      const int r = e / DP, d = e % DP;
      const bool in = k0 + r < Sk && d < D;
      const size_t g = (size_t)(k0 + r) * D + d;
      Ks[r * LD + d] = in ? to_f(kb[g]) : 0.f;
      Vs[r * DP + d] = in ? to_f(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < DP; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      bool ok[4];
      float mx = -FLT_MAX;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        ok[j] = col < Sk && (!causal || col <= row);
        s[i][j] = ok[j] ? s[i][j] * scale : -FLT_MAX;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row16_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * LP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + row16_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < NO; ++n) acc[i][n] *= corr;
    }
    __syncwarp();  // a row of Ps is written and read by the 16 lanes of one half-warp

    for (int c = 0; c < FA_BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const float vv = Vs[c * DP + tx + 16 * n];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][n] = fmaf(pv[i], vv, acc[i][n]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + (bh * Sq + row) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = tx + 16 * n;
      if (d < D) store_out(orow + d, acc[i][n] / denom);
    }
  }
}

template <typename T, int DP>
static int launch_flash(const void* q, const void* k, const void* v, void* o, int BH, int Sq,
                        int Sk, int D, int causal, float scale, cudaStream_t st) {
  constexpr size_t smem = flash_smem_bytes<DP>();
  static_assert(smem <= 227 * 1024, "flash tile exceeds the H100 shared-memory opt-in");
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_qtiles = (Sq + FA_BQ - 1) / FA_BQ;
  const long long blocks = (long long)BH * n_qtiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  flash_attention_kernel<T, DP><<<(unsigned)blocks, FA_THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, n_qtiles, Sq, Sk, D, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int flash_dispatch(const void* q, const void* k, const void* v, void* o, int BH, int Sq,
                          int Sk, int D, int causal, float scale, cudaStream_t st) {
  if (D <= 32) return launch_flash<T, 32>(q, k, v, o, BH, Sq, Sk, D, causal, scale, st);
  if (D <= 64) return launch_flash<T, 64>(q, k, v, o, BH, Sq, Sk, D, causal, scale, st);
  if (D <= 128) return launch_flash<T, 128>(q, k, v, o, BH, Sq, Sk, D, causal, scale, st);
  if (D <= 256) return launch_flash<T, 256>(q, k, v, o, BH, Sq, Sk, D, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" {

// q [BH, Sq, D], k and v [BH, Sk, D], o [BH, Sq, D], all contiguous, of one
// dtype: 0 = f32 (CUDA cores), 1 = bf16 (tensor cores). D <= 256. Returns
// cudaGetLastError.
int kemr_flash_attention(int dtype, const void* q, const void* k, const void* v, void* o, int BH,
                         int Sq, int Sk, int D, int causal, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return flash_dispatch<float>(q, k, v, o, BH, Sq, Sk, D, causal, scale, st);
  if (dtype == 1) return flash_dispatch_tc(q, k, v, o, BH, Sq, Sk, D, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
