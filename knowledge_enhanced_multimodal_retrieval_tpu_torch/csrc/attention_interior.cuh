// The attention interior of the layer kernels on the tensor cores (sm_90a).
//
// What it computes (_attention_interior of ops/fused_block.py, and behind it
// knowledge_enhanced_multimodal_retrieval_tpu/ops/fused_block.py::_attention_interior):
// qkv [nseq * S, 3W] bf16 -> out [nseq * S, W] bf16, head h in columns
// [64 h, 64 h + 64) of each third. Scores in f32, scaled after the dot, -1e9
// where col >= mask_len or (causal) col > row, f32 softmax, p = e / sum(e)
// normalized and then rounded to bf16, p . v with an f32 accumulator, one
// cast to bf16. NOMAX is the vision profiler's diagnostic interior: the same
// order of operations without the row maximum (exp of the masked, scaled
// score). One function stands behind B3a, B1, B4a and S1; it has no atomics,
// so equal inputs give equal bits.
//
// What bounds it on the H100: per (sequence, head) 4 S^2 64 operations against
// 4 S 64 2 bytes, S / 2 operations a byte: bytes-bound below S ~ 590, and at
// the ViT-L/14 vision shape (64 x 16 heads x 272 rows) ~0.04 ms of traffic
// against 0.02 ms of products. The exponentials (16 a clock and SM) weigh as
// much as the products at head dim 64.
//
// Design. A block is one warpgroup that owns 64 query rows of one head.
// - Both products are wgmma m64n64k16 (bf16 in, f32 accumulators in
//   registers): q . k^T with Q as the A operand in registers (ldmatrix, once)
//   and a K tile of 64 keys as the K-major B operand; p . v with the bf16 p
//   as the A operand straight from the score fragments and the V tile read
//   untransposed as the MN-major B operand. Tiles are 64 rows of 128 bytes in
//   the 128-byte swizzle, 1024-byte aligned.
// - The packed layout is read in place: one 3-d tensor map over qkv (column,
//   row in its sequence, sequence) describes Q, K and V of every head as
//   64-column windows at column 64 h, W + 64 h and 2 W + 64 h. Rows past a
//   sequence's end arrive as zeros, never as the next sequence's rows.
//   Tiles arrive by TMA into a ring of two stages, each completed on an
//   mbarrier; the next tile is in flight under this one's products.
// - p must be normalized before it is rounded, and 64 x S scores do not fit
//   the registers at S = 272 or 592, so the keys are walked twice: pass 1
//   takes q . k^T to a running row maximum and row sum (K tiles only), pass 2
//   takes q . k^T again to p = exp(s - m) / l, rounds, and adds p . v (K and
//   V tiles). Three products for two: they are a small part of the time.
// - The exponentials are what the block spends its instruction slots on, so
//   each is one fused multiply-add and one ex2 on the raw dot:
//   exp(s scale - m scale) = ex2(s c - m c), c = scale log2(e), and in pass 2
//   the division rides in the exponent, p = ex2(s c - (m c + log2 l)). The
//   results differ from the plain version's by f32 roundings (~1e-6
//   relative), far below the bf16 step p is then rounded to.
//   The two passes are two loops with a straight-line body per tile width
//   (ptxas serializes a wgmma group that sits under a condition of its own).
// - A sequence of at most 64 keys (every text bucket but 80) is one tile: its
//   scores stay in registers and one pass does it all, with one load.
// - Short sequences: where S divides 64, 64 / S sequences share a tile (the
//   tensor-map box is S rows of 64 / S sequences) and the scores between
//   different sequences are masked; otherwise a tile holds one sequence.
// - Key tiles that start at or past mask_len (or wholly above the causal
//   diagonal) are never loaded: their weights are exactly 0 (exp underflows
//   in f32, with or without the row maximum). The tile that straddles the
//   limit is masked on the fragments; other tiles skip the mask. Only the
//   groups of 16 keys that hold a visible key are exponentiated and fed to
//   p . v.
// - The grid is one block per (query tile, head, sequence or tile of
//   sequences), query tile fastest so that the blocks that share K and V run
//   together: 5 x 16 x 64 blocks at the vision shape, 10 x 16 x 4 at 336 px.
//   41 KB of shared memory and 127-128 registers a thread, so four blocks
//   share an SM and one block's softmax runs under another's products (a
//   third stage, or a launch bound of four blocks, changed nothing).
// - The output goes back through the warp's own rows of the Q tile and
//   leaves as 16-byte stores into the [N, W] buffer.
#pragma once

#include "mma.cuh"

constexpr int AI_THREADS = 128, AI_STAGES = 2;
constexpr int AI_TILE = 64 * 64;  // elements of a 64-row tile of one head
constexpr uint32_t AI_TILE_BYTES = AI_TILE * sizeof(bf16);
// Q, then per stage a K and a V tile; + 1024: the tiles start at a 1024-byte boundary
constexpr size_t AI_SMEM = 1024 + (size_t)AI_TILE_BYTES * (1 + 2 * AI_STAGES);
// Where a tile's rows and key columns sit in their sequences, and the
// softmax constants. A tile row r (and a key column c of a key tile) belongs
// to sequence r >> seq_shift of the tile, at position (r & pos_mask) past the
// tile's first: seq_shift is 6 (pos_mask 63) when a tile holds one sequence.
// The exponentials run on the raw dots: exp(s scale - m scale) is
// ex2(fma(s, c, -m c)) with c = scale log2(e), one fused multiply-add and one
// ex2 a score; a hidden score is the raw value whose scaled score is -1e9.
struct AiTile {
  int q0;  // position in its sequence of tile row 0
  int pos_mask, seq_shift;
  int mask_len, causal;
  float c, hidden;
};

// s = q . k^T, raw: Q fragments in registers, the K tile at shared address ks.
__device__ __forceinline__ void ai_qk(float (&s)[32], const uint32_t (&qf)[4][4], uint32_t ks) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16<0>(s, qf[kk], wgmma_desc_sw128(ks + kk * 32), kk > 0);
  wgmma_commit();
  wgmma_wait0();
  wgmma_fence_regs(s);
}

// Hides, in the first NGRP groups of 16 keys, what the row may not see.
// s[4 j + e] is (tile row r0 + 8 (e >> 1), key column 8 j + 2 t + (e & 1)).
template <int NGRP>
__device__ __forceinline__ void ai_mask(float (&s)[32], const AiTile& tl, int k0, int r0, int t) {
#pragma unroll
  for (int j = 0; j < 2 * NGRP; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * t + (e & 1), r = r0 + 8 * (e >> 1);
      const int kpos = k0 + (c & tl.pos_mask), qpos = tl.q0 + (r & tl.pos_mask);
      const bool ok = (c >> tl.seq_shift) == (r >> tl.seq_shift) && kpos < tl.mask_len &&
                      (!tl.causal || kpos <= qpos);
      if (!ok) s[4 * j + e] = tl.hidden;
    }
}

// A value of each of the thread's two rows, joined over the four lanes that share the rows.
__device__ __forceinline__ float ai_quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float ai_quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The row maxima of the first NGRP groups, joined with mx.
template <int NGRP>
__device__ __forceinline__ void ai_row_max(float (&mx)[2], const float (&s)[32]) {
#pragma unroll
  for (int i = 0; i < 8 * NGRP; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  mx[0] = ai_quad_max(mx[0]);
  mx[1] = ai_quad_max(mx[1]);
}

// s <- ex2(s c - off) over the first NGRP groups (off is 0 without the row maximum).
template <int NGRP, bool NOMAX>
__device__ __forceinline__ void ai_exp(float (&s)[32], const AiTile& tl, const float (&off)[2]) {
#pragma unroll
  for (int i = 0; i < 8 * NGRP; ++i)
    s[i] = ex2_approx(NOMAX ? s[i] * tl.c : fmaf(s[i], tl.c, -off[(i >> 1) & 1]));
}

// o += p . v: p (already normalized) rounded to bf16 as the A operand, the V
// tile MN-major, 16 keys 2048 bytes apart.
template <int NGRP>
__device__ __forceinline__ void ai_pv(float (&oacc)[32], const float (&s)[32], uint32_t vs) {
  uint32_t p[NGRP][4];
#pragma unroll
  for (int kg = 0; kg < NGRP; ++kg) {
    p[kg][0] = pack_bf16(s[8 * kg], s[8 * kg + 1]);
    p[kg][1] = pack_bf16(s[8 * kg + 2], s[8 * kg + 3]);
    p[kg][2] = pack_bf16(s[8 * kg + 4], s[8 * kg + 5]);
    p[kg][3] = pack_bf16(s[8 * kg + 6], s[8 * kg + 7]);
  }
  wgmma_fence_regs(oacc);
  wgmma_fence();
#pragma unroll
  for (int kg = 0; kg < NGRP; ++kg) wgmma_m64n64k16<1>(oacc, p[kg], wgmma_desc_sw128(vs + kg * 2048), 1);
  wgmma_commit();
  wgmma_wait0();
  wgmma_fence_regs(oacc);
}

// Pass 1, one key tile: the running row maximum m of the raw dots (shared by
// a row's four lanes) and this thread's share l of the running row sum.
template <int NGRP, bool NOMAX>
__device__ __forceinline__ void ai_pass1_tile(float (&m)[2], float (&l)[2], const uint32_t (&qf)[4][4],
                                              uint32_t ks, const AiTile& tl, bool masked, int k0, int r0,
                                              int t) {
  float s[32];
  ai_qk(s, qf, ks);
  if (masked) ai_mask<NGRP>(s, tl, k0, r0, t);
  float off[2] = {0.f, 0.f};
  if constexpr (!NOMAX) {
    float mx[2] = {m[0], m[1]};
    ai_row_max<NGRP>(mx, s);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] *= ex2_approx((m[h] - mx[h]) * tl.c);
      m[h] = mx[h];
      off[h] = mx[h] * tl.c;
    }
  }
  ai_exp<NGRP, NOMAX>(s, tl, off);
#pragma unroll
  for (int i = 0; i < 8 * NGRP; ++i) l[(i >> 1) & 1] += s[i];
}

// Pass 2, one key tile: p = exp(s - m) / l as ex2(s c - (m c + log2 l)),
// rounded to bf16, o += p . v.
template <int NGRP, bool NOMAX>
__device__ __forceinline__ void ai_pass2_tile(float (&oacc)[32], const float (&off)[2],
                                              const uint32_t (&qf)[4][4], uint32_t ks, uint32_t vs,
                                              const AiTile& tl, bool masked, int k0, int r0, int t) {
  float s[32];
  ai_qk(s, qf, ks);
  if (masked) ai_mask<NGRP>(s, tl, k0, r0, t);
  ai_exp<NGRP, false>(s, tl, off);
  ai_pv<NGRP>(oacc, s, vs);
}

// A sequence (or a tile of short sequences) of at most 64 keys: the scores
// stay in registers, so one pass and one q . k^T.
template <int NGRP, bool NOMAX>
__device__ __forceinline__ void ai_single_tile(float (&oacc)[32], const uint32_t (&qf)[4][4], uint32_t ks,
                                               uint32_t vs, const AiTile& tl, bool masked, int r0, int t) {
  float s[32];
  ai_qk(s, qf, ks);
  if (masked) ai_mask<NGRP>(s, tl, 0, r0, t);
  float off[2] = {0.f, 0.f}, l[2] = {0.f, 0.f};
  if constexpr (!NOMAX) {
    float mx[2] = {-FLT_MAX, -FLT_MAX};
    ai_row_max<NGRP>(mx, s);
    off[0] = mx[0] * tl.c;
    off[1] = mx[1] * tl.c;
  }
  ai_exp<NGRP, NOMAX>(s, tl, off);
#pragma unroll
  for (int i = 0; i < 8 * NGRP; ++i) l[(i >> 1) & 1] += s[i];
  const float inv[2] = {1.0f / ai_quad_sum(l[0]), 1.0f / ai_quad_sum(l[1])};
#pragma unroll
  for (int i = 0; i < 8 * NGRP; ++i) s[i] *= inv[(i >> 1) & 1];
  ai_pv<NGRP>(oacc, s, vs);
}

// One straight-line body per width of the tile (groups of 16 keys that hold a visible key).
#define AI_BY_NGRP(ngrp, FN, ...)                      \
  do {                                                 \
    if ((ngrp) == 4) FN<4, NOMAX>(__VA_ARGS__);        \
    else if ((ngrp) == 3) FN<3, NOMAX>(__VA_ARGS__);   \
    else if ((ngrp) == 2) FN<2, NOMAX>(__VA_ARGS__);   \
    else FN<1, NOMAX>(__VA_ARGS__);                    \
  } while (0)

// tm: the map of qkv as [nseq, S, 3W] for boxes of 64 columns x (64 rows of
// one sequence, or S rows of 64 / S sequences when seq_shift < 6). Blocks:
// n_qtiles x heads x tiles of sequences, query tile fastest. 1 <= mask_len <= S.
template <bool NOMAX>
__global__ void __launch_bounds__(AI_THREADS)
attention_wg_kernel(const __grid_constant__ CUtensorMap tm, bf16* __restrict__ out, int N, int W, int heads,
                    int S, int n_qtiles, int seq_shift, int mask_len, int causal, float scale) {
  constexpr int STAGES = AI_STAGES;
  extern __shared__ unsigned char ai_raw[];
  __shared__ __align__(8) uint64_t full_bar[STAGES];  // stage s has landed
  unsigned char* Qs = ai_raw + ((1024 - (smem_u32(ai_raw) & 1023)) & 1023);
  unsigned char* KV = Qs + AI_TILE_BYTES;  // stage s: K at KV + 2 s AI_TILE_BYTES, V right behind it

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mat = lane >> 3, mr = lane & 7;
  const int qt = blockIdx.x % n_qtiles, h = (blockIdx.x / n_qtiles) % heads;
  const int z = blockIdx.x / (n_qtiles * heads);
  const int per_tile = 64 >> seq_shift;  // sequences a tile holds
  const int seq0 = z * per_tile, q0 = qt * 64;

  // keys this tile's rows can see at all, and the tiles that hold them
  const int kv_end = per_tile > 1 ? 64 : min(mask_len, causal ? min(S, q0 + 64) : S);
  const int nt = (kv_end + 63) / 64;
  const int n_loads = nt == 1 ? 1 : 2 * nt;
  const AiTile tl{q0, (1 << seq_shift) - 1, seq_shift, mask_len, causal, scale * 1.4426950408889634f, -1e9f / scale};

  // Load number `it` of the block into ring slot it % STAGES: the K tiles of
  // pass 1, then the K and V tiles of pass 2 (a single tile: K and V at
  // once); Q rides with the first.
  auto load = [&](int it) {
    if (threadIdx.x != 0) return;
    const bool with_v = nt == 1 || it >= nt;
    const int k0 = (it >= nt ? it - nt : it) * 64;
    uint64_t* bar = &full_bar[it % STAGES];
    unsigned char* slot = KV + 2 * (it % STAGES) * AI_TILE_BYTES;
    mbar_expect_tx(bar, ((with_v ? 2u : 1u) + (it == 0 ? 1u : 0u)) * AI_TILE_BYTES);
    if (it == 0) tma_load_3d(Qs, &tm, h * 64, q0, seq0, bar);
    tma_load_3d(slot, &tm, W + h * 64, k0, seq0, bar);
    if (with_v) tma_load_3d(slot + AI_TILE_BYTES, &tm, 2 * W + h * 64, k0, seq0, bar);
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(&full_bar[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s)
    if (s < n_loads) load(s);

  uint32_t qf[4][4];
  const int qrow = warp * 16 + (mat & 1) * 8 + mr;  // this lane's row of the Q fragments
  const uint32_t q_base = smem_u32(Qs) + qrow * 128;
  const int r0 = warp * 16 + g;  // this thread's fragment rows of the tile: r0 and r0 + 8
  float oacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) oacc[i] = 0.f;

  // Wait for load `it`, free the slot of load it - 1 and refill it.
  auto advance = [&](int it) {
    mbar_wait(&full_bar[it % STAGES], (it / STAGES) & 1);
    __syncthreads();  // load `it` has landed for every thread; nobody reads the slot of it - 1 any more
    if (it + STAGES - 1 < n_loads) load(it + STAGES - 1);
    return smem_u32(KV + 2 * (it % STAGES) * AI_TILE_BYTES);
  };
  // Tile k0's width in groups of 16 keys, and whether any of its scores is hidden.
  auto groups = [&](int k0) { return per_tile > 1 ? 4 : min(4, (kv_end - k0 + 15) / 16); };
  auto hidden = [&](int k0) { return per_tile > 1 || k0 + 64 > mask_len || (causal && k0 + 63 > q0); };

  uint32_t ks = advance(0);  // Q came with it
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(qf[kk], q_base + (((2 * kk + (mat >> 1)) ^ (qrow & 7)) * 16));
  if (nt == 1) {
    AI_BY_NGRP(groups(0), ai_single_tile, oacc, qf, ks, ks + AI_TILE_BYTES, tl, hidden(0), r0, t);
  } else {
    float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f};
    for (int tile = 0; tile < nt; ++tile) {
      if (tile > 0) ks = advance(tile);
      const int k0 = tile * 64;
      AI_BY_NGRP(groups(k0), ai_pass1_tile, m, l, qf, ks, tl, hidden(k0), k0, r0, t);
    }
    // pass 2's exponent takes the normalization with it: -(m c + log2 l)
    const float off[2] = {(NOMAX ? 0.f : m[0] * tl.c) + __log2f(ai_quad_sum(l[0])),
                          (NOMAX ? 0.f : m[1] * tl.c) + __log2f(ai_quad_sum(l[1]))};
    for (int tile = 0; tile < nt; ++tile) {
      ks = advance(nt + tile);
      const int k0 = tile * 64;
      AI_BY_NGRP(groups(k0), ai_pass2_tile, oacc, off, qf, ks, ks + AI_TILE_BYTES, tl, hidden(k0), k0, r0, t);
    }
  }

  // The warp's 16 rows go back through its own rows of the Q tile (its Q
  // fragments are in registers), swizzled as Q was, and leave as 16-byte
  // stores. Rows past the sequence (or past the last sequence) are padding.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<uint32_t*>(Qs + r * 128 + ((n ^ (r & 7)) * 16) + 4 * t) =
          pack_bf16(oacc[4 * n + 2 * hh], oacc[4 * n + 2 * hh + 1]);
  }
  __syncwarp();
  const long long row_base = per_tile > 1 ? (long long)z * 64 : (long long)z * S + q0;
  const long long rows_here = per_tile > 1 ? (long long)N - row_base : (long long)(S - q0);
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int r = warp * 16 + 4 * it + (lane >> 3), c = lane & 7;
    if (r < rows_here)
      *reinterpret_cast<uint4*>(out + (size_t)(row_base + r) * W + h * 64 + c * 8) =
          *reinterpret_cast<const uint4*>(Qs + r * 128 + ((c ^ (r & 7)) * 16));
  }
}
