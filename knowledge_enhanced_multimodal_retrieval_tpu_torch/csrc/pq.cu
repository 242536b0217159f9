// Product-quantized ADC scan + top-k over the corpus, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel B5 of knowledge_enhanced_multimodal_retrieval_tpu/ops/pq.py
// (_pq_adc_kernel, launched by fused_pq_topk):
//
//   score[q, n] = a_q * (s_img[n] * sum_m LUT_img[m, q, code_img[n, m]])
//               + (1 - a_q) * (s_txt[n] * sum_m LUT_txt[m, q, code_txt[n, m]])
//
// with bf16 LUTs [M, Q, K] per tower (ops/pq.py pq_luts), uint8 codes
// [N, M] and f32 per-row scales [N] (a zero-scale pad row scores exactly 0).
// The TPU kernel turned each subspace into a one-hot matmul to avoid
// gathers; every one-hot product is a bf16 LUT value times 1, exact in f32,
// so this kernel gathers the same values, widens them to f32 exactly (a
// 16-bit shift) and adds them in the same order (subspace m = 0 .. M-1,
// f32), then scales and blends as the oracle does: its scores are the
// oracle's bit for bit. Rows past N and NaN scores become float32 min;
// selection is the running lists of topk.cuh.
//
// What bounds it on the H100: Q * N * M lookups per tower (2.1 G at Q = 256,
// N = 43,000, M = 96) out of shared memory, at random codes, and the LUT
// staging from L2. The one-hot formulation would cost 2 * Q * N * M * K
// bf16 operations per tower (1.08 TFLOP in all at 43,000 rows), more than
// the gathers' floor, so the kernel gathers. Its design:
// - The wrapper hands the LUTs over query-interleaved, [Q / 16][M][K][16]
//   bf16 (pq_lut_interleave, a plain permute): one entry holds 16 queries'
//   values for one (subspace, code), so two 16-byte shared loads serve 16
//   queries of one (row, subspace), and the slice of a run of subspaces of
//   one 16-query group is one contiguous run of bytes (64 KB for 8
//   subspaces at K = 256). The entries of codes with bit 2 set hold their
//   two halves swapped (queries 8-15 first): the load of queries 0-7 then
//   reads 16-byte bank group 2 c + bit 2 of c (mod 8), spread over all
//   eight groups by random codes, where the unswizzled layout would use four.
// - A block takes 16 queries and a strip of 1024-row tiles (the grid is
//   strips x query groups, about one block an SM); each thread owns 4 rows of
//   a tile and keeps 4 x 16 f32 sums, so each staged LUT group serves 1024
//   rows: 48 bytes of L2 traffic per (row, query) and tower pair, against
//   ~384 for one row per thread and 256-row tiles.
// - The groups (8 subspaces, or 4 where the lists of a large k need the
//   room) stream through a ring of two stages by 1-d bulk copies
//   (cp.async.bulk on an mbarrier), across towers and tiles, so the next
//   group lands under this group's gathers. Codes are read from device
//   memory, 8 a row at a time.
// - After the image tower a tile's a * (t2i * s_img) goes to the score tile
//   in shared memory, after the text tower the blend; the tile is then folded
//   128 rows at a time into the running lists (fold_block, topk.cuh), which
//   stay in shared memory at every k up to 512 (16 x 512 x 8 bytes beside
//   4-subspace groups). kemr_topk_merge picks the final k; a k above 512
//   runs in passes under a ceiling.

#include "mma.cuh"
#include "topk.cuh"

constexpr int PQ_QG = 16;      // queries per block: one LUT entry, 32 bytes
constexpr int PQ_ROWS = 4;     // corpus rows per thread
constexpr int PQ_THREADS = 256;
constexpr int PQ_T = PQ_THREADS * PQ_ROWS;  // corpus rows per tile
constexpr int PQ_G = 8;        // the most subspaces per staged LUT group (codes are read 8 at a time)
constexpr int PQ_STAGES = 2;
constexpr int PQ_SEG = 128;    // rows per fold

__host__ __device__ inline size_t pq_stage_bytes(int group, int K) { return (size_t)group * K * PQ_QG * sizeof(bf16); }

static size_t pq_smem_bytes(int group, int K, int k) {
  return PQ_STAGES * pq_stage_bytes(group, K) + (size_t)PQ_QG * PQ_T * sizeof(float) + PQ_QG * sizeof(float) +
         (size_t)PQ_QG * k * 8;
}

// The 16 bf16 values of one LUT entry (queries 0-7, 8-15: halves swapped
// when bit 2 of the code is set), widened to f32 and added to acc.
__device__ __forceinline__ void add_entry(float (&acc)[PQ_QG], const unsigned char* entry, uint32_t code) {
  const uint32_t swap = (code & 4u) << 2;  // 16 bytes when bit 2 is set
  const uint4 a = *reinterpret_cast<const uint4*>(entry + swap);
  const uint4 b = *reinterpret_cast<const uint4*>(entry + (16u - swap));
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc[2 * i] += __uint_as_float(w[i] << 16);
    acc[2 * i + 1] += __uint_as_float(w[i] & 0xffff0000u);
  }
}

__global__ void __launch_bounds__(PQ_THREADS, 1)
pq_adc_scan_kernel(const bf16* __restrict__ lut_i, const bf16* __restrict__ lut_t,
                   const uint8_t* __restrict__ codes_i, const uint8_t* __restrict__ codes_t,
                   const float* __restrict__ s_i, const float* __restrict__ s_t, const float* __restrict__ alpha,
                   const float* __restrict__ ceil_v, const int* __restrict__ ceil_r, int Q, int N, int M, int K,
                   int k, int n_tiles, int group, int vec_codes, float* __restrict__ cand_v,
                   int* __restrict__ cand_i) {
  extern __shared__ __align__(128) unsigned char pq_smem[];
  __shared__ unsigned char fold_rows[PQ_THREADS / 16][PQ_SEG];  // a warp's packed survivors' row offsets
  __shared__ __align__(8) uint64_t full_bar[PQ_STAGES];          // stage s has landed
  const size_t stage_bytes = pq_stage_bytes(group, K);
  float* sc = reinterpret_cast<float*>(pq_smem + PQ_STAGES * stage_bytes);  // [PQ_QG][PQ_T]
  float* alpha_s = sc + PQ_QG * PQ_T;

  const int tid = threadIdx.x;
  const int strip = blockIdx.x, n_strips = gridDim.x, qg = blockIdx.y, q0 = qg * PQ_QG;
  const int t_begin = (int)((long long)strip * n_tiles / n_strips);
  const int t_end = (int)((long long)(strip + 1) * n_tiles / n_strips);
  const Lists L = block_lists<true>(alpha_s + PQ_QG, PQ_QG, k, q0, strip, n_strips, cand_v, cand_i);
  const int n_groups = (M + group - 1) / group, per_tile = 2 * n_groups;
  const int total = (t_end - t_begin) * per_tile;

  for (int e = tid; e < PQ_QG; e += PQ_THREADS) alpha_s[e] = q0 + e < Q ? alpha[q0 + e] : 0.f;
  lists_init(L.v, L.r, PQ_QG, L.lds, k);
  if (tid == 0) {
    for (int s = 0; s < PQ_STAGES; ++s) mbar_init(&full_bar[s], 1);
    mbar_fence_init();
  }
  __syncthreads();

  // Step `it` of the strip: tile it / per_tile, tower, subspace group; its LUT slice is contiguous.
  auto issue = [&](int it) {
    const int tower = (it / n_groups) & 1, g = it % n_groups;
    const int G = min(group, M - g * group);
    const bf16* src = (tower ? lut_t : lut_i) + ((size_t)qg * M + (size_t)g * group) * K * PQ_QG;
    const uint32_t bytes = (uint32_t)G * K * PQ_QG * sizeof(bf16);
    uint64_t* bar = &full_bar[it % PQ_STAGES];
    mbar_expect_tx(bar, bytes);
    bulk_load(pq_smem + (it % PQ_STAGES) * stage_bytes, src, bytes, bar);
  };
  if (tid == 0)
    for (int s = 0; s < PQ_STAGES && s < total; ++s) issue(s);

  float acc[PQ_ROWS][PQ_QG];
  for (int it = 0; it < total; ++it) {
    const int n0 = (t_begin + it / per_tile) * PQ_T, tower = (it / n_groups) & 1, g = it % n_groups;
    const int m0 = g * group, G = min(group, M - m0);
    const uint8_t* codes = tower ? codes_t : codes_i;
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < PQ_ROWS; ++j)
#pragma unroll
        for (int e = 0; e < PQ_QG; ++e) acc[j][e] = 0.f;
    }
    // this group's codes of the thread's rows, up to 8 in a pair of words (rows past N: code 0, discarded)
    uint32_t cw[PQ_ROWS][2];
#pragma unroll
    for (int j = 0; j < PQ_ROWS; ++j) {
      const int r = n0 + tid + j * PQ_THREADS;
      cw[j][0] = cw[j][1] = 0u;
      if (r < N) {
        const uint8_t* src = codes + (size_t)r * M + m0;
        if (vec_codes && group == PQ_G) {
          const uint2 w = __ldg(reinterpret_cast<const uint2*>(src));
          cw[j][0] = w.x;
          cw[j][1] = w.y;
        } else if (vec_codes) {  // 4-subspace groups
          cw[j][0] = __ldg(reinterpret_cast<const uint32_t*>(src));
        } else {
          uint32_t w0 = 0u, w1 = 0u;
          for (int mm = 0; mm < G; ++mm) {
            const uint32_t b = (uint32_t)__ldg(src + mm) << (8 * (mm & 3));
            if (mm < 4) w0 |= b;
            else w1 |= b;
          }
          cw[j][0] = w0;
          cw[j][1] = w1;
        }
      }
    }
    mbar_wait(&full_bar[it % PQ_STAGES], (it / PQ_STAGES) & 1);
    const unsigned char* lut_s = pq_smem + (it % PQ_STAGES) * stage_bytes;
#pragma unroll
    for (int mm = 0; mm < PQ_G; ++mm) {
      if (mm < G) {  // G < PQ_G in 4-subspace groups and a ragged last group
#pragma unroll
        for (int j = 0; j < PQ_ROWS; ++j) {
          const uint32_t code = (cw[j][mm >> 2] >> (8 * (mm & 3))) & 0xFFu;
          add_entry(acc[j], lut_s + ((size_t)mm * K + code) * (PQ_QG * sizeof(bf16)), code);
        }
      }
    }
    __syncthreads();  // every thread is done with the slot
    if (tid == 0 && it + PQ_STAGES < total) issue(it + PQ_STAGES);
    if (g != n_groups - 1) continue;

    // the tower is complete: the image tower's weighted scores, then the blend
#pragma unroll
    for (int j = 0; j < PQ_ROWS; ++j) {
      const int r = n0 + tid + j * PQ_THREADS;
#pragma unroll
      for (int e = 0; e < PQ_QG; ++e) {
        float* at = sc + e * PQ_T + tid + j * PQ_THREADS;
        if (tower == 0) {
          *at = r < N ? alpha_s[e] * (acc[j][e] * s_i[r]) : 0.f;
        } else {
          float s = -FLT_MAX;
          if (r < N && q0 + e < Q) {
            s = *at + (1.0f - alpha_s[e]) * (acc[j][e] * s_t[r]);
            if (isnan(s) || excluded(s, r, ceil_v, ceil_r, q0 + e)) s = -FLT_MAX;
          }
          *at = s;
        }
      }
    }
    if (tower == 0) continue;
    __syncthreads();
    for (int seg = 0; seg < PQ_T; seg += PQ_SEG)
      if (k > TOPK_SMEM_K) fold_block<PQ_SEG, true>(sc + seg, PQ_T, PQ_QG, &fold_rows[0][0], n0 + seg, L.v, L.r, L.lds, k);
      else fold_block<PQ_SEG, false>(sc + seg, PQ_T, PQ_QG, &fold_rows[0][0], n0 + seg, L.v, L.r, L.lds, k);
    __syncthreads();  // the next tile's scores overwrite the tile
  }
  lists_store(L.v, L.r, PQ_QG, q0, Q, k, strip, n_strips, cand_v, cand_i);
}

// Subspaces per staged group: 8 where the ring, the score tile and the lists
// fit the 227 KB opt-in, else 4 (k = 512 at K = 256: 192 KB); 0 if neither.
static int pq_group(int K, int k) {
  for (int group = PQ_G; group >= 4; group /= 2)
    if (pq_smem_bytes(group, K, k) <= 227 * 1024) return group;
  return 0;
}

extern "C" {

// LUTs bf16 [ceil(Q / 16)][M][K][16] per tower (pq_lut_interleave; 16-byte
// aligned), codes uint8 [N, M], scales f32 [N], alpha f32 [Q]; ceil_v /
// ceil_r [Q] or null (a later pass, topk.cuh). The corpus is cut into
// n_strips (1 .. ceil(N / 1024)) strips of 1024-row tiles; k is 1 .. 512.
// Scratch: cand_v f32 / cand_i i32 of [ceil(Q / 16) * 16, n_strips, k], and
// for k > 128 merge_v / merge_i of [Q, ceil(n_strips / 2), k].
int kemr_pq_adc_topk(const void* lut_i, const void* lut_t, const void* codes_i, const void* codes_t,
                     const void* scale_i, const void* scale_t, const void* alpha, const void* ceil_v,
                     const void* ceil_r, int Q, int N, int M, int K, int k, int n_strips, void* cand_v,
                     void* cand_i, void* merge_v, void* merge_i, void* out_v, void* out_i, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = (N + PQ_T - 1) / PQ_T;
  if (k < 1 || k > TOPK_KL || K < 1 || K > 256 || M < 1 || n_strips < 1 || n_strips > n_tiles)
    return (int)cudaErrorInvalidValue;
  const int group = pq_group(K, k);
  if (group == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = pq_smem_bytes(group, K, k);
  cudaError_t e = cudaFuncSetAttribute(pq_adc_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const auto al8 = [](const void* p) { return ((uintptr_t)p & 7) == 0; };
  const int vec_codes = M % group == 0 && al8(codes_i) && al8(codes_t);  // whole groups, aligned
  dim3 grid(n_strips, (Q + PQ_QG - 1) / PQ_QG);
  pq_adc_scan_kernel<<<grid, PQ_THREADS, smem, st>>>(
      (const bf16*)lut_i, (const bf16*)lut_t, (const uint8_t*)codes_i, (const uint8_t*)codes_t,
      (const float*)scale_i, (const float*)scale_t, (const float*)alpha, (const float*)ceil_v, (const int*)ceil_r,
      Q, N, M, K, k, n_tiles, group, vec_codes, (float*)cand_v, (int*)cand_i);
  KEMR_CHECK_LAUNCH();
  return kemr_topk_merge((float*)cand_v, (int*)cand_i, Q, n_strips, k, (float*)merge_v, (int*)merge_i,
                         (float*)out_v, (int*)out_i, st);
}

}  // extern "C"
