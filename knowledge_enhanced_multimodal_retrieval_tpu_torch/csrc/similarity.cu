// Blended two-tower similarity + top-k over the corpus, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel B2 of knowledge_enhanced_multimodal_retrieval_tpu/ops/similarity.py
// (_fused_kernel + _merge_topk, launched by _fused_topk_call) in its exact
// (bf16 / f32 rows), q8 (int8 rows, f32 per-row scales) and q4 modes
// (nibble-packed int4 rows, f32 per-row scales; _fused_kernel :619-633):
//
//   score[q, n] = a_q * (q_img . img_n) + (1 - a_q) * (q_txt . txt_n)
//   (q8: a_q * (t2i * s_img[n]) + (1 - a_q) * (t2t * s_txt[n]))
//   (q4: t2i = q_lo . lo_n + q_hi . hi_n, the two nibble planes of the
//    [N, D/2] bytes: byte j holds dim j low and dim j + D/2 high)
//
// with pad / NaN scores forced to float32 min, and the k best per query,
// ties to the lowest corpus row. A query with fewer than k finite scores
// gets (float32 min, row 0) fillers, as the TPU merge produces.
//
// What bounds it on the H100: one scan reads the corpus (43,000 x 768 per
// tower: 132 MB in bf16, 66 MB in int8, 33 MB in int4) and does
// 4 * Q * N * D flops (34 GFLOP at Q = 256): 0.04 ms of either at the card's
// peaks, so neither the CUDA cores nor re-reading the corpus per 16 queries
// comes near it. The TPU kernel ran its grid in order and carried the
// running top-k in VMEM scratch; here a block walks a strip of the corpus
// tile by tile and carries the running top-k itself.
//
// bf16 queries (topk_scan_tc_kernel): a streamed GEMM on the tensor cores
// with the selection as its epilogue.
// - A block takes NQ = 128 queries (64 when Q <= 64 or k > 24) against a
//   strip of 128-row corpus tiles; the grid is (strips, query blocks) with
//   strips ~ SMs / query blocks, chosen by the wrapper from the device's SM
//   count. At Q = 256 the corpus crosses L2 twice instead of 16 times.
// - wgmma m64nNQk16, bf16 x bf16 -> f32: the corpus rows are the M side, the
//   A operand in registers (each of the two warpgroups owns 64 rows of the
//   tile), the queries the N side, read from shared memory through a
//   128-byte-swizzle descriptor. bf16 rows reach the A fragments by
//   ldmatrix; int8 rows and int4 nibbles are converted to bf16 in registers
//   on the way (exact: |v| <= 127 and <= 8), the queries are never quantized.
//   In q4 a staged 64-byte chunk feeds two products: the low nibbles against
//   query dims [c, c + 64), the high ones against [D/2 + c, D/2 + c + 64),
//   into one accumulator.
// - Corpus and query chunks of 128 k-elements (int4: 64 packed bytes, both
//   planes) stream through a ring of 2-4 stages (as many as fit beside the
//   lists and the score tile) filled by TMA: one thread starts the stage's
//   tensor-map boxes ([NQ x 64] of the queries, [128 x 64] of the corpus),
//   the hardware swizzles them (bf16 rows of 128 bytes in the 128-byte
//   swizzle, int8 / int4 rows of 64 bytes in the 64-byte one, which keeps the
//   2-byte fragment reads free of bank conflicts) and zero-fills rows past Q
//   or N and columns past the row's end, and an mbarrier per stage counts
//   the bytes in. The ring runs across towers and tiles, so it never drains
//   inside a strip. The queries are re-read from L2 per tile (all of them
//   are 393 KB). Rows that are not 16-byte aligned are staged with plain
//   loads into the same layout.
// - A stage is eight k16 steps in two wgmma groups of four, left in flight:
//   the second half's fragments are loaded (and converted) under the first
//   half's products, the next stage's first half under this stage's second,
//   so the int8 / int4 conversion costs no time of its own. One
//   __syncthreads() a stage frees the slot that is refilled.
// - The two towers accumulate one after the other into two register
//   accumulators (2 x NQ / 2 floats a thread); after the text tower the
//   epilogue blends them as the formula above: the 128 x NQ tile of scores
//   goes to shared memory, and each warp folds the scores of its queries,
//   two queries at a time, into their sorted running lists (fold_tile,
//   topk.cuh). The [Q, N] score matrix never reaches device memory.
// - At the end of the strip the block writes its lists to [Q, strips, k]
//   (above k = 128 they live there from the start); kemr_topk_merge picks
//   the final k of strips * k candidates per query (a few hundred to a few
//   thousand instead of ceil(N / 128) * k). k up to 512 runs in one pass,
//   a larger k in passes under a ceiling (topk.cuh).
//
// f32 queries (topk_scan_f32_kernel) keep f32 scoring on the CUDA cores
// (TF32 would lose the 1e-5 agreement; f32 queries against int8 / int4 rows
// are not exact in bf16 either): one block per (16 queries x strip), one
// warp per corpus row with lanes across D, and the same running lists.

#include "mma.cuh"
#include "topk.cuh"

#include <cstring>

constexpr int TK_T = 128;  // corpus rows per tile (both routes)
constexpr int TK_THREADS = 256;

// ---- bf16 queries: tensor cores ------------------------------------------------

constexpr int SC_KC = 64;      // k elements (bf16, int8 rows) or packed bytes (int4 rows) of one sub-chunk
constexpr int SC_LD = TK_T + 4; // floats between the score tile's query rows: the epilogue's stores hit 32 banks

// CM: corpus mode 1 = bf16, 2 = int8, 3 = int4 nibble-packed.
template <int CM, int NQ>
struct ScanCfg {
  // A stage holds KSUB sub-chunks of 64 k-elements: eight wgmma k16 steps
  // between two block barriers (int4: one sub-chunk, whose two nibble
  // planes make the eight steps).
  static constexpr int KSUB = CM == 3 ? 1 : 2;
  static constexpr int QCH = CM == 3 ? 2 : 1;  // query tiles per sub-chunk
  static constexpr int Q_BYTES = NQ * 128 * QCH;
  static constexpr int ROW_BYTES = CM == 1 ? 128 : 64;  // bytes of one row's sub-chunk
  static constexpr int C_BYTES = TK_T * ROW_BYTES;
  static constexpr int SUB = Q_BYTES + C_BYTES;  // a multiple of 1024
  static constexpr int STAGE = KSUB * SUB;
};

// Bytes of running lists a block keeps in shared memory (none above TOPK_SMEM_K).
static size_t smem_list_bytes(int nq, int k) { return k <= TOPK_SMEM_K ? (size_t)nq * k * 8 : 0; }

static size_t scan_fixed_bytes(int nq, int k) {
  // alpha, score tile, lists; the kernel's static arrays (survivors' rows, barriers)
  return (size_t)nq * 4 + (size_t)nq * SC_LD * 4 + smem_list_bytes(nq, k) + TK_THREADS / 16 * TK_T + 64;
}

// Two int8 values (the low two bytes of `two`) or two 4-bit values (nibbles
// lo and lo + 8 bits) as packed bf16, exactly. An integer u in [0, 2^23) put
// into the mantissa of 2^23 is the float 2^23 + u, so the biased value goes
// in with one byte permute or one shift-and-mask and its bias comes off
// with one f32 subtraction: no I2F, which runs at a quarter of the rate.
__device__ __forceinline__ uint32_t cvt_i8x2(uint32_t two) {
  const uint32_t x = two ^ 0x8080u;  // v + 128 in each byte
  const float a = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540)) - 8388736.0f;  // 2^23 + 128
  const float b = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7541)) - 8388736.0f;
  return pack_bf16(a, b);
}
__device__ __forceinline__ uint32_t cvt_4x2(uint32_t biased, int lo) {
  const float a = __uint_as_float(((biased >> lo) & 0xFu) | 0x4B000000u) - 8388616.0f;  // 2^23 + 8
  const float b = __uint_as_float(((biased >> (lo + 8)) & 0xFu) | 0x4B000000u) - 8388616.0f;
  return pack_bf16(a, b);
}
__device__ __forceinline__ uint32_t cvt_lo4x2(uint32_t two) { return cvt_4x2(two ^ 0x8888u, 0); }
__device__ __forceinline__ uint32_t cvt_hi4x2(uint32_t two) { return cvt_4x2(two ^ 0x8888u, 4); }

// The A fragments of one staged sub-chunk's four k16 steps. PLANE picks the
// nibbles of an int4 row: 0 the low ones (dims [c, c + 64)), 1 the high ones.
template <int CM, int NQ, int PLANE>
__device__ __forceinline__ void scan_load_a(uint32_t (&a)[4][4], const unsigned char* sub) {
  using Cfg = ScanCfg<CM, NQ>;
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3, wg = threadIdx.x >> 7;
  if constexpr (CM == 1) {
    const int mat = lane >> 3, mr = lane & 7;
    const int row = wg * 64 + w * 16 + (mat & 1) * 8 + mr;
    const uint32_t rb = smem_u32(sub) + Cfg::Q_BYTES + row * 128;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(a[kk], rb + (((2 * kk + (mat >> 1)) ^ (row & 7)) * 16));
  } else {
    const int g = lane >> 2, t = lane & 3;
    // rows of 64 bytes in the 64-byte swizzle: 16-byte chunk c of row r at chunk c ^ ((r >> 1) & 3),
    // the same for rows r and r + 8; the 2-byte reads of a k16 step then hit 16 banks once each
    const int row = wg * 64 + w * 16 + g, sw = (row >> 1) & 3;
    const unsigned char* rp = sub + Cfg::Q_BYTES + row * 64 + 2 * t;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // rows g and g + 8, bytes 2 t, 2 t + 1 and 8 + 2 t, 9 + 2 t of the k16 step: the m16n8k16 A layout
      const unsigned char* cp = rp + ((kk ^ sw) * 16);
      const uint32_t x[4] = {*reinterpret_cast<const uint16_t*>(cp), *reinterpret_cast<const uint16_t*>(cp + 8 * 64),
                             *reinterpret_cast<const uint16_t*>(cp + 8),
                             *reinterpret_cast<const uint16_t*>(cp + 8 * 64 + 8)};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[kk][i] = CM == 2 ? cvt_i8x2(x[i]) : (PLANE == 0 ? cvt_lo4x2(x[i]) : cvt_hi4x2(x[i]));
    }
  }
}

// A stage is eight k16 steps in two halves (bf16 / int8: the stage's two
// sub-chunks; int4: the two nibble planes of its one sub-chunk). Half a
// stage's A fragments, loaded and, for int8 / int4 rows, converted:
template <int CM, int NQ>
__device__ __forceinline__ void scan_load_half(uint32_t (&a)[4][4], const unsigned char* stage, int half) {
  using Cfg = ScanCfg<CM, NQ>;
  const unsigned char* sub = stage + (CM == 3 ? 0 : half * Cfg::SUB);
  if (CM == 3 && half == 1) scan_load_a<CM, NQ, 1>(a, sub);
  else scan_load_a<CM, NQ, 0>(a, sub);
}
// Their four products into the accumulator, as one wgmma group left in
// flight. Steps past the contraction length multiply zero-filled chunks.
template <int CM, int NQ>
__device__ __forceinline__ void scan_mma_half(float (&acc)[NQ / 2], const uint32_t (&a)[4][4],
                                              const unsigned char* stage, int half, bool first) {
  using Cfg = ScanCfg<CM, NQ>;
  const uint32_t qb = smem_u32(stage) + (CM == 3 ? half * NQ * 128 : half * Cfg::SUB);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ra<NQ>(acc, a[kk], wgmma_desc_sw128(qb + kk * 32), (first && kk == 0) ? 0 : 1);
  wgmma_commit();
}

// WIDE: k > TOPK_SMEM_K (lists in device memory, the wide fold, a ceiling).
template <int CM, int NQ, bool WIDE>
__global__ void __launch_bounds__(TK_THREADS, 1)
topk_scan_tc_kernel(const bf16* __restrict__ q_img, const bf16* __restrict__ q_txt,
                    const unsigned char* __restrict__ img, const unsigned char* __restrict__ txt,
                    const __grid_constant__ CUtensorMap tm_qi, const __grid_constant__ CUtensorMap tm_qt,
                    const __grid_constant__ CUtensorMap tm_ci, const __grid_constant__ CUtensorMap tm_ct,
                    const float* __restrict__ img_s, const float* __restrict__ txt_s,
                    const float* __restrict__ alpha, const float* __restrict__ ceil_v,
                    const int* __restrict__ ceil_r, int Q, int N, int D, int k, int n_tiles, int stages,
                    int aligned, float* __restrict__ cand_v, int* __restrict__ cand_i) {
  using Cfg = ScanCfg<CM, NQ>;
  extern __shared__ unsigned char sc_raw[];
  __shared__ unsigned char fold_rows[TK_THREADS / 16][TK_T];  // a warp's packed survivors' row offsets
  __shared__ __align__(8) uint64_t full_bar[4];                // stage s has landed
  unsigned char* sm = sc_raw + ((1024 - (smem_u32(sc_raw) & 1023)) & 1023);  // swizzled tiles: 1024-byte aligned
  float* alpha_s = reinterpret_cast<float*>(sm + (size_t)stages * Cfg::STAGE);
  float* sc = alpha_s + NQ;                              // [NQ][SC_LD] the tile's blended scores

  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int strip = blockIdx.x, n_strips = gridDim.x, q0 = blockIdx.y * NQ;
  const int t_begin = (int)((long long)strip * n_tiles / n_strips);
  const int t_end = (int)((long long)(strip + 1) * n_tiles / n_strips);
  const Lists L = block_lists<!WIDE>(sc + NQ * SC_LD, NQ, k, q0, strip, n_strips, cand_v, cand_i);
  const int row_bytes = CM == 1 ? D * 2 : (CM == 2 ? D : D / 2);
  const int kdim = CM == 3 ? D / 2 : D;  // contraction length of one product
  constexpr int STAGE_K = SC_KC * Cfg::KSUB;  // contraction elements per stage and plane
  const int n_k = (kdim + STAGE_K - 1) / STAGE_K;
  const int total = (t_end - t_begin) * 2 * n_k;

  for (int e = tid; e < NQ; e += TK_THREADS) alpha_s[e] = q0 + e < Q ? alpha[q0 + e] : 0.f;
  lists_init(L.v, L.r, NQ, L.lds, k);
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full_bar[s], 1);
    mbar_fence_init();
  }
  __syncthreads();

  // Where a chunk of the strip lies: corpus tile, tower, k-chunk of the tower, ring slot
  // and the parity of the slot's barrier phase.
  struct Pos {
    int tl, tower, kc, slot, phase;
  };
  auto advance = [&](Pos& p) {
    if (++p.kc == n_k) {
      p.kc = 0;
      if (++p.tower == 2) {
        p.tower = 0;
        ++p.tl;
      }
    }
    if (++p.slot == stages) {
      p.slot = 0;
      p.phase ^= 1;
    }
  };

  // One stage by TMA: per sub-chunk the queries' box(es) of [NQ x 64] and the corpus tile's of
  // [128 x 64 elements], started by one thread and counted on the slot's barrier. Rows past Q
  // or N and columns past the row's end arrive as zeros.
  auto fill_tma = [&](const Pos& p) {
    if (tid != 0) return;
    unsigned char* st = sm + (size_t)p.slot * Cfg::STAGE;
    uint64_t* bar = &full_bar[p.slot];
    const CUtensorMap* tq = p.tower ? &tm_qt : &tm_qi;
    const CUtensorMap* tc = p.tower ? &tm_ct : &tm_ci;
    mbar_expect_tx(bar, Cfg::STAGE);
#pragma unroll
    for (int sub = 0; sub < Cfg::KSUB; ++sub) {
      const int k_off = p.kc * STAGE_K + sub * SC_KC;
#pragma unroll
      for (int h = 0; h < Cfg::QCH; ++h) tma_load_3d(st + sub * Cfg::SUB + h * NQ * 128, tq, k_off, h, q0, bar);
      tma_load_3d(st + sub * Cfg::SUB + Cfg::Q_BYTES, tc, k_off, p.tl * TK_T, 0, bar);
    }
  };
  // The same stage with plain loads, for tensors whose rows are not 16-byte aligned.
  constexpr int CCH = Cfg::ROW_BYTES / 16;  // 16-byte chunks of one corpus row's sub-chunk
  auto fill_slow = [&](const Pos& p) {
    unsigned char* st = sm + (size_t)p.slot * Cfg::STAGE;
    const bf16* qsrc = p.tower ? q_txt : q_img;
    for (int e = tid; e < Cfg::KSUB * Cfg::QCH * NQ * 8; e += TK_THREADS) {
      const int sub = e / (Cfg::QCH * NQ * 8), h = (e / (NQ * 8)) % Cfg::QCH, r = (e / 8) % NQ, c = e % 8;
      const int q = q0 + r;
      const int kel = h * kdim + p.kc * STAGE_K + sub * SC_KC + c * 8;
      const int n_el = q < Q ? max(0, min(8, (h + 1) * kdim - kel)) : 0;
      bf16* d = reinterpret_cast<bf16*>(st + sub * Cfg::SUB + h * NQ * 128 + r * 128 + ((c ^ (r & 7)) * 16));
      for (int i = 0; i < 8; ++i) d[i] = i < n_el ? qsrc[(size_t)q * D + kel + i] : f2bf(0.f);
    }
    const unsigned char* csrc = p.tower ? txt : img;
    for (int e = tid; e < Cfg::KSUB * TK_T * CCH; e += TK_THREADS) {
      const int sub = e / (TK_T * CCH), r = (e / CCH) % TK_T, c = e % CCH;
      const long long n = (long long)p.tl * TK_T + r;
      const int boff = (p.kc * Cfg::KSUB + sub) * Cfg::ROW_BYTES + c * 16;
      const int nb = n < N ? max(0, min(16, row_bytes - boff)) : 0;
      unsigned char* dst = st + sub * Cfg::SUB + Cfg::Q_BYTES +
                           (CM == 1 ? r * 128 + ((c ^ (r & 7)) * 16) : r * 64 + ((c ^ ((r >> 1) & 3)) * 16));
      for (int i = 0; i < 16; ++i) dst[i] = i < nb ? csrc[(size_t)n * row_bytes + boff + i] : 0;
    }
  };
  Pos ld = {t_begin, 0, 0, 0, 0}, at = {t_begin, 0, 0, 0, 0};  // the next chunk to load, the chunk to multiply
  auto fill = [&]() {
    if (aligned) fill_tma(ld);
    else fill_slow(ld);
    advance(ld);
  };
  for (int s = 0; s < stages - 1 && s < total; ++s) fill();

  // acc takes the tower being multiplied; acc_img keeps the image tower's sums
  float acc[NQ / 2], acc_img[NQ / 2];
#pragma unroll
  for (int e = 0; e < NQ / 2; ++e) acc[e] = acc_img[e] = 0.f;
  const int rl = (wid & 3) * 16 + (wid >> 2) * 64 + g;  // this thread's rows of a tile: rl and rl + 8
  float si[2] = {1.f, 1.f}, sx[2] = {1.f, 1.f};         // their scales in the tile that is ending
  uint32_t a[2][4][4];
  bool tower_ended = false, tile_ended = false;  // of the chunk whose products are in flight
  int n0_ended = 0;

  // The products of a chunk are left in flight while the next chunk's first fragments are
  // loaded (and converted); `finish` completes them and does what the chunk's end asks for.
  auto finish = [&]() {
    wgmma_wait0();
    wgmma_fence_regs(acc);
    if (tower_ended && !tile_ended) {
#pragma unroll
      for (int e = 0; e < NQ / 2; ++e) acc_img[e] = acc[e];
    }
    if (!tile_ended) return;
    // epilogue of the tile: blend into the score tile, then one warp per query folds
    // its 128 scores into the running list
    const int n0 = n0_ended;
#pragma unroll
    for (int j = 0; j < NQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + 2 * t + (e & 1);
        const int r = rl + 8 * (e >> 1);
        float s = -FLT_MAX;
        if (n0 + r < N && q0 + qi < Q) {
          const float al = alpha_s[qi];
          if (CM != 1) s = al * (acc_img[4 * j + e] * si[e >> 1]) + (1.0f - al) * (acc[4 * j + e] * sx[e >> 1]);
          else s = al * acc_img[4 * j + e] + (1.0f - al) * acc[4 * j + e];
          if (isnan(s) || (WIDE && excluded(s, n0 + r, ceil_v, ceil_r, q0 + qi))) s = -FLT_MAX;
        }
        sc[qi * SC_LD + r] = s;
      }
    }
    __syncthreads();
    // the next epilogue's stores come after the barriers of the chunks in between
    fold_block<TK_T, WIDE>(sc, SC_LD, NQ, &fold_rows[0][0], n0, L.v, L.r, L.lds, k);
  };

  for (int it = 0; it < total; ++it) {
    const unsigned char* stage = sm + (size_t)at.slot * Cfg::STAGE;
    if (aligned) {
      mbar_wait(&full_bar[at.slot], at.phase);
    } else {
      fence_proxy_async();  // plain stores, read by wgmma through the asynchronous proxy
      __syncthreads();
    }
    wgmma_wait1();  // the previous chunk's first half is done with a[0]
    scan_load_half<CM, NQ>(a[0], stage, 0);
    finish();
    __syncthreads();  // every warp is done with the slot of chunk it - 1
    if (it + stages - 1 < total) fill();

    const bool tower_ends = at.kc == n_k - 1, tile_ends = tower_ends && at.tower == 1;
    if (CM != 1 && tile_ends) {  // the rows' scales, asked for before the tile's last products
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = at.tl * TK_T + rl + 8 * h;
        si[h] = n < N ? img_s[n] : 1.f;
        sx[h] = n < N ? txt_s[n] : 1.f;
      }
    }
    scan_mma_half<CM, NQ>(acc, a[0], stage, 0, at.kc == 0);
    scan_load_half<CM, NQ>(a[1], stage, 1);
    scan_mma_half<CM, NQ>(acc, a[1], stage, 1, false);
    tower_ended = tower_ends;
    tile_ended = tile_ends;
    n0_ended = at.tl * TK_T;
    advance(at);
  }
  finish();
  __syncthreads();
  if (L.smem) lists_store(L.v, L.r, NQ, q0, Q, k, strip, n_strips, cand_v, cand_i);
}

// ---- f32 queries: CUDA cores ---------------------------------------------------

constexpr int TK_QG = 16;  // queries per block

// Q4 = true: TC is int8_t and each corpus row holds D / 2 packed bytes.
template <typename TC, bool Q4, bool WIDE>
__global__ void __launch_bounds__(TK_THREADS)
topk_scan_f32_kernel(const float* __restrict__ q_img, const float* __restrict__ q_txt,
                     const TC* __restrict__ img, const TC* __restrict__ txt,
                     const float* __restrict__ img_s, const float* __restrict__ txt_s,
                     const float* __restrict__ alpha, const float* __restrict__ ceil_v,
                     const int* __restrict__ ceil_r, int Q, int N, int D, int k, int n_tiles,
                     float* __restrict__ cand_v, int* __restrict__ cand_i) {
  extern __shared__ __align__(16) float qs[];  // [TK_QG][D], then the lists [TK_QG][k] x 2 (k <= TOPK_SMEM_K)
  __shared__ float t2i[TK_QG][TK_T];
  __shared__ float sc[TK_QG][TK_T];
  __shared__ unsigned char fold_rows[TK_THREADS / 16][TK_T];  // a warp's packed survivors' row offsets
  const int strip = blockIdx.x, n_strips = gridDim.x, q0 = blockIdx.y * TK_QG;
  const Lists L = block_lists<!WIDE>(qs + TK_QG * D, TK_QG, k, q0, strip, n_strips, cand_v, cand_i);
  const int t_begin = (int)((long long)strip * n_tiles / n_strips);
  const int t_end = (int)((long long)(strip + 1) * n_tiles / n_strips);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int dc = Q4 ? D / 2 : D;  // stored elements per corpus row
  lists_init(L.v, L.r, TK_QG, L.lds, k);

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int n0 = tile * TK_T;
    for (int tower = 0; tower < 2; ++tower) {
      const float* qsrc = tower == 0 ? q_img : q_txt;
      const TC* corpus = tower == 0 ? img : txt;
      __syncthreads();  // the previous tower's reads of qs, the previous tile's of sc, are done
      for (int e = threadIdx.x; e < TK_QG * D; e += blockDim.x) {
        const int g = e / D, d = e % D;
        qs[e] = (q0 + g < Q) ? qsrc[(size_t)(q0 + g) * D + d] : 0.f;
      }
      __syncthreads();
      for (int r = warp; r < TK_T; r += nw) {
        const int n = n0 + r;
        float acc[TK_QG], acc_hi[TK_QG];
#pragma unroll
        for (int g = 0; g < TK_QG; ++g) acc[g] = acc_hi[g] = 0.f;
        if (n < N) {
          const TC* row = corpus + (size_t)n * dc;
          for (int d = lane; d < dc; d += 32) {
            if constexpr (Q4) {
              // the two nibble planes, sign-extended: dim d (low) and d + D/2 (high)
              const int b = (int)row[d];
              const float lo = (float)((int)((unsigned)b << 28) >> 28);
              const float hi = (float)(b >> 4);
#pragma unroll
              for (int g = 0; g < TK_QG; ++g) {
                acc[g] += qs[g * D + d] * lo;
                acc_hi[g] += qs[g * D + dc + d] * hi;
              }
            } else {
              const float c = to_f(row[d]);
#pragma unroll
              for (int g = 0; g < TK_QG; ++g) acc[g] += qs[g * D + d] * c;
            }
          }
        }
#pragma unroll
        for (int g = 0; g < TK_QG; ++g) {
          // q4: q_lo . lo + q_hi . hi, one sum per plane as the TPU kernel dots
          float s = warp_sum(acc[g]);
          if constexpr (Q4) s = s + warp_sum(acc_hi[g]);
          if (lane == 0) (tower == 0 ? t2i[g][r] : sc[g][r]) = s;
        }
      }
    }
    __syncthreads();

    // blend in place, then one warp per query folds the tile into the running list
    for (int e = threadIdx.x; e < TK_QG * TK_T; e += blockDim.x) {
      const int g = e / TK_T, r = e % TK_T;
      const int n = n0 + r, q = q0 + g;
      float s = -FLT_MAX;
      if (n < N && q < Q) {
        const float a = alpha[q];
        if (img_s != nullptr) s = a * (t2i[g][r] * img_s[n]) + (1.0f - a) * (sc[g][r] * txt_s[n]);
        else s = a * t2i[g][r] + (1.0f - a) * sc[g][r];
        if (isnan(s) || (WIDE && excluded(s, n, ceil_v, ceil_r, q))) s = -FLT_MAX;
      }
      sc[g][r] = s;
    }
    __syncthreads();
    fold_block<TK_T, WIDE>(&sc[0][0], TK_T, TK_QG, &fold_rows[0][0], n0, L.v, L.r, L.lds, k);
  }
  __syncthreads();
  if (L.smem) lists_store(L.v, L.r, TK_QG, q0, Q, k, strip, n_strips, cand_v, cand_i);
}

// ---- merge ---------------------------------------------------------------------

// k <= TOPK_SMEM_K, one block per query: the final k of M = n_lists * k
// candidates, k rounds of a block arg-max. Taken candidates are overwritten
// with -inf in the scratch buffer.
__global__ void __launch_bounds__(TK_THREADS)
topk_merge_kernel(float* __restrict__ cand_v, const int* __restrict__ cand_i, int M, int k,
                  float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ float rv[32];
  __shared__ int ri[32], rp[32];
  const int q = blockIdx.x;
  float* cv = cand_v + (size_t)q * M;
  const int* ci = cand_i + (size_t)q * M;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int round = 0; round < k; ++round) {
    float bv = -INFINITY;
    int bi = INT_MAX, bp = -1;
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
      const float v = cv[m];
      const int i = ci[m];
      if (better(v, i, bv, bi)) {
        bv = v;
        bi = i;
        bp = m;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float v2 = __shfl_xor_sync(0xffffffffu, bv, o);
      const int i2 = __shfl_xor_sync(0xffffffffu, bi, o);
      const int p2 = __shfl_xor_sync(0xffffffffu, bp, o);
      if (better(v2, i2, bv, bi)) {
        bv = v2;
        bi = i2;
        bp = p2;
      }
    }
    if (lane == 0) {
      rv[warp] = bv;
      ri[warp] = bi;
      rp[warp] = bp;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < nw; ++w)
        if (better(rv[w], ri[w], bv, bi)) {
          bv = rv[w];
          bi = ri[w];
          bp = rp[w];
        }
      out_v[(size_t)q * k + round] = bv;
      // fillers (no finite score left) come back as row 0, like the TPU merge
      out_i[(size_t)q * k + round] = bv > -FLT_MAX ? bi : 0;
      cv[bp] = -INFINITY;
    }
    __syncthreads();
  }
}

// k > TOPK_SMEM_K: one merge of two sorted lists of k into the k best of
// both, one block per (pair, query). Lists 2p and 2p + 1 of query q's n_lists
// (the last one alone when n_lists is odd) are staged in shared memory; an
// entry's place is its index plus the entries of the other list that rank
// above it (a binary search), ties broken the same way from both sides (list
// A's entry first), so fillers (float32 min, TOPK_NO_ROW) that repeat get
// distinct places too. The last merge (one list left) writes out_v / out_i
// with fillers as row 0.
__global__ void __launch_bounds__(TK_THREADS)
topk_merge_pairs_kernel(const float* __restrict__ in_v, const int* __restrict__ in_i, int n_lists, int k,
                        float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char mp_raw[];
  float* av = reinterpret_cast<float*>(mp_raw);
  int* ai = reinterpret_cast<int*>(av + k);
  float* bv = reinterpret_cast<float*>(ai + k);
  int* bi = reinterpret_cast<int*>(bv + k);
  const int p = blockIdx.x, q = blockIdx.y, n_out = (n_lists + 1) / 2;
  const bool has_b = 2 * p + 1 < n_lists, last = n_out == 1;
  const size_t base = ((size_t)q * n_lists + 2 * p) * k;
  for (int e = threadIdx.x; e < k; e += blockDim.x) {
    av[e] = in_v[base + e];
    ai[e] = in_i[base + e];
    if (has_b) {
      bv[e] = in_v[base + k + e];
      bi[e] = in_i[base + k + e];
    }
  }
  __syncthreads();
  const size_t o = ((size_t)q * n_out + p) * k;
  for (int e = threadIdx.x; e < (has_b ? 2 * k : k); e += blockDim.x) {
    const bool in_a = e < k;
    const int i = in_a ? e : e - k;
    const float v = in_a ? av[i] : bv[i];
    const int r = in_a ? ai[i] : bi[i];
    int pos = i;
    if (has_b) {
      // entries of the other list placed before this one: for A's, those of B that rank
      // strictly above it; for B's, those of A that rank at or above it
      const float* ov = in_a ? bv : av;
      const int* oi = in_a ? bi : ai;
      int lo = 0, hi = k;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const bool before = in_a ? better(ov[mid], oi[mid], v, r) : !better(v, r, ov[mid], oi[mid]);
        if (before) lo = mid + 1;
        else hi = mid;
      }
      pos += lo;
    }
    if (pos >= k) continue;
    out_v[o + pos] = v;
    out_i[o + pos] = last ? (v > -FLT_MAX ? r : 0) : r;
  }
}

int kemr_topk_merge(float* cand_v, int* cand_i, int Q, int n_lists, int k, float* scratch_v, int* scratch_i,
                    float* out_v, int* out_i, cudaStream_t st) {
  if (k <= TOPK_SMEM_K) {
    topk_merge_kernel<<<Q, TK_THREADS, 0, st>>>(cand_v, cand_i, n_lists * k, k, out_v, out_i);
    KEMR_CHECK_LAUNCH();
    return 0;
  }
  float* src_v = cand_v;
  int* src_i = cand_i;
  float* dst_v = scratch_v;
  int* dst_i = scratch_i;
  do {
    const int n_out = (n_lists + 1) / 2;
    topk_merge_pairs_kernel<<<dim3(n_out, Q), TK_THREADS, (size_t)k * 16, st>>>(
        src_v, src_i, n_lists, k, n_out == 1 ? out_v : dst_v, n_out == 1 ? out_i : dst_i);
    KEMR_CHECK_LAUNCH();
    n_lists = n_out;
    float* tv = src_v;
    int* ti = src_i;
    src_v = dst_v;
    src_i = dst_i;
    dst_v = tv;
    dst_i = ti;
  } while (n_lists > 1);
  return 0;
}

extern "C" int kemr_topk_query_block(int q_dtype, int Q, int k);

template <int CM, int NQ, bool WIDE>
static int scan_tc_launch(const void* q_img, const void* q_txt, const void* img, const void* txt,
                          const float* img_s, const float* txt_s, const float* alpha, const float* ceil_v,
                          const int* ceil_r, int Q, int N, int D, int k, int n_strips, float* cand_v, int* cand_i,
                          cudaStream_t st) {
  using Cfg = ScanCfg<CM, NQ>;
  const size_t fixed = scan_fixed_bytes(NQ, k) + 1024;  // + the alignment slack
  const size_t fit = (227 * 1024 - fixed) / Cfg::STAGE;
  const int stages = fit < 4 ? (int)fit : 4;
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const size_t smem = fixed + (size_t)stages * Cfg::STAGE - (TK_THREADS / 16 * TK_T + 64);  // less the static arrays
  cudaError_t e = cudaFuncSetAttribute(topk_scan_tc_kernel<CM, NQ, WIDE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int row_elems = CM == 3 ? D / 2 : D, row_bytes = CM == 1 ? D * 2 : row_elems;
  const int kdim = CM == 3 ? D / 2 : D;
  const auto al16 = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  // tensor maps need 16-byte-aligned rows (and, in q4, an aligned second plane of the query)
  const int aligned = al16(q_img) && al16(q_txt) && (kdim * 2) % 16 == 0 && al16(img) && al16(txt) &&
                      row_bytes % 16 == 0;
  CUtensorMap tqi, tqt, tci, tct;
  if (aligned) {
    // queries as [Q, planes, kdim] in boxes of [NQ, 1, 64]; corpus rows as [N, row] in boxes of [128, 64]
    const int planes = CM == 3 ? 2 : 1, ce = CM == 1 ? 2 : 1;
    int rc = tma_map_rows64(&tqi, 2, q_img, kdim, planes, Q, 1, NQ);
    if (rc == 0) rc = tma_map_rows64(&tqt, 2, q_txt, kdim, planes, Q, 1, NQ);
    if (rc == 0) rc = tma_map_rows64(&tci, ce, img, row_elems, N, 1, TK_T, 1);
    if (rc == 0) rc = tma_map_rows64(&tct, ce, txt, row_elems, N, 1, TK_T, 1);
    if (rc != 0) return rc;
  } else {
    memset(&tqi, 0, sizeof(tqi));
    tqt = tci = tct = tqi;
  }
  const int n_tiles = (N + TK_T - 1) / TK_T;
  dim3 grid(n_strips, (Q + NQ - 1) / NQ);
  topk_scan_tc_kernel<CM, NQ, WIDE><<<grid, TK_THREADS, smem, st>>>(
      (const bf16*)q_img, (const bf16*)q_txt, (const unsigned char*)img, (const unsigned char*)txt, tqi, tqt, tci,
      tct, img_s, txt_s, alpha, ceil_v, ceil_r, Q, N, D, k, n_tiles, stages, aligned, cand_v, cand_i);
  return (int)cudaGetLastError();
}

template <int CM>
static int scan_tc(const void* q_img, const void* q_txt, const void* img, const void* txt,
                   const float* img_s, const float* txt_s, const float* alpha, const float* ceil_v, const int* ceil_r,
                   int Q, int N, int D, int k, int n_strips, float* cand_v, int* cand_i, cudaStream_t st) {
  // k > 24 takes 64 queries a block (kemr_topk_query_block), so the wide kernels are all NQ = 64
  if (k > TOPK_SMEM_K)
    return scan_tc_launch<CM, 64, true>(q_img, q_txt, img, txt, img_s, txt_s, alpha, ceil_v, ceil_r, Q, N, D, k,
                                        n_strips, cand_v, cand_i, st);
  if (kemr_topk_query_block(1, Q, k) == 128)
    return scan_tc_launch<CM, 128, false>(q_img, q_txt, img, txt, img_s, txt_s, alpha, ceil_v, ceil_r, Q, N, D, k,
                                          n_strips, cand_v, cand_i, st);
  return scan_tc_launch<CM, 64, false>(q_img, q_txt, img, txt, img_s, txt_s, alpha, ceil_v, ceil_r, Q, N, D, k,
                                       n_strips, cand_v, cand_i, st);
}

template <typename TC, bool Q4, bool WIDE>
static int scan_f32_launch(const void* q_img, const void* q_txt, const void* img, const void* txt,
                    const float* img_s, const float* txt_s, const float* alpha, const float* ceil_v,
                    const int* ceil_r, int Q, int N, int D, int k, int n_strips, float* cand_v, int* cand_i,
                    cudaStream_t st) {
  const size_t smem = (size_t)TK_QG * D * sizeof(float) + smem_list_bytes(TK_QG, k);
  cudaError_t e = cudaFuncSetAttribute(topk_scan_f32_kernel<TC, Q4, WIDE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_strips, (Q + TK_QG - 1) / TK_QG);
  topk_scan_f32_kernel<TC, Q4, WIDE><<<grid, TK_THREADS, smem, st>>>(
      (const float*)q_img, (const float*)q_txt, (const TC*)img, (const TC*)txt, img_s, txt_s, alpha, ceil_v, ceil_r,
      Q, N, D, k, (N + TK_T - 1) / TK_T, cand_v, cand_i);
  return (int)cudaGetLastError();
}

template <typename TC, bool Q4>
static int scan_f32(const void* q_img, const void* q_txt, const void* img, const void* txt,
                    const float* img_s, const float* txt_s, const float* alpha, const float* ceil_v,
                    const int* ceil_r, int Q, int N, int D, int k, int n_strips, float* cand_v, int* cand_i,
                    cudaStream_t st) {
  if (k > TOPK_SMEM_K)
    return scan_f32_launch<TC, Q4, true>(q_img, q_txt, img, txt, img_s, txt_s, alpha, ceil_v, ceil_r, Q, N, D, k,
                                         n_strips, cand_v, cand_i, st);
  return scan_f32_launch<TC, Q4, false>(q_img, q_txt, img, txt, img_s, txt_s, alpha, ceil_v, ceil_r, Q, N, D, k,
                                        n_strips, cand_v, cand_i, st);
}

extern "C" {

// Queries one block takes: 16 on the f32 route (q_dtype 0); on the bf16 route
// 128, or 64 when that covers all queries or the lists of k > 24 would not
// leave room for two stages of the ring beside the 128-wide score tile. The
// wrapper sizes the grid's strips and the candidate buffer with it.
int kemr_topk_query_block(int q_dtype, int Q, int k) {
  if (q_dtype == 0) return TK_QG;
  return (Q > 64 && k <= 24) ? 128 : 64;
}

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8, 3 = int4 nibble-packed
// int8 [N, D / 2] (corpus only; 2 and 3 take f32 per-row scales). D is
// the query width. The corpus is cut into n_strips (1 .. ceil(N / 128))
// strips of 128-row tiles; k is 1 .. TOPK_KL. ceil_v / ceil_r [Q] (null in a
// first pass): the ceiling of a later pass (topk.cuh). Scratch: cand_v f32 /
// cand_i i32 of [Q rounded up to kemr_topk_query_block, n_strips, k], and
// for k > TOPK_SMEM_K merge_v / merge_i of [Q, ceil(n_strips / 2), k].
int kemr_similarity_topk(int q_dtype, int c_dtype, const void* q_img, const void* q_txt,
                         const void* img, const void* txt, const void* img_s, const void* txt_s,
                         const void* alpha, const void* ceil_v, const void* ceil_r, int Q, int N, int D, int k,
                         int n_strips, void* cand_v, void* cand_i, void* merge_v, void* merge_i, void* out_v,
                         void* out_i, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* is = (const float*)img_s;
  const float* ts = (const float*)txt_s;
  const float* a = (const float*)alpha;
  const float* cv = (const float*)ceil_v;
  const int* cr = (const int*)ceil_r;
  float* c_v = (float*)cand_v;
  int* c_i = (int*)cand_i;
  if (k < 1 || k > TOPK_KL || n_strips < 1 || n_strips > (N + TK_T - 1) / TK_T) return (int)cudaErrorInvalidValue;
  int rc = (int)cudaErrorInvalidValue;
  if (q_dtype == 0 && c_dtype == 0)
    rc = scan_f32<float, false>(q_img, q_txt, img, txt, is, ts, a, cv, cr, Q, N, D, k, n_strips, c_v, c_i, st);
  else if (q_dtype == 0 && c_dtype == 2)
    rc = scan_f32<int8_t, false>(q_img, q_txt, img, txt, is, ts, a, cv, cr, Q, N, D, k, n_strips, c_v, c_i, st);
  else if (q_dtype == 0 && c_dtype == 3 && D % 2 == 0)
    rc = scan_f32<int8_t, true>(q_img, q_txt, img, txt, is, ts, a, cv, cr, Q, N, D, k, n_strips, c_v, c_i, st);
  else if (q_dtype == 1 && c_dtype == 1)
    rc = scan_tc<1>(q_img, q_txt, img, txt, is, ts, a, cv, cr, Q, N, D, k, n_strips, c_v, c_i, st);
  else if (q_dtype == 1 && c_dtype == 2)
    rc = scan_tc<2>(q_img, q_txt, img, txt, is, ts, a, cv, cr, Q, N, D, k, n_strips, c_v, c_i, st);
  else if (q_dtype == 1 && c_dtype == 3 && D % 2 == 0)
    rc = scan_tc<3>(q_img, q_txt, img, txt, is, ts, a, cv, cr, Q, N, D, k, n_strips, c_v, c_i, st);
  if (rc != 0) return rc;
  return kemr_topk_merge(c_v, c_i, Q, n_strips, k, (float*)merge_v, (int*)merge_i, (float*)out_v, (int*)out_i, st);
}

}  // extern "C"
