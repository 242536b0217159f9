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
//    [N, D/2] bytes: byte j holds dim j low and dim j + D/2 high; the
//    nibbles sign-extend in registers as (b << 28) >> 28 and b >> 4)
//
// with pad / NaN scores forced to float32 min, and the k best per query,
// ties to the lowest corpus row. A query with fewer than k finite scores
// gets (float32 min, row 0) fillers, as the TPU merge produces.
//
// What bounds it on the H100: one full scan reads the corpus (43,000 x 768
// per tower: 132 MB in bf16, 66 MB in int8, 33 MB in int4) and does
// 4 * Q * N * D flops (34 GFLOP at Q = 256). The TPU kernel ran its grid in
// order and carried the running top-k in VMEM scratch; Hopper blocks run in
// parallel with no carried state, so the scan is two passes:
//   1. topk_tiles_kernel: one block per (16 queries x 128 corpus rows)
//      scores the tile (one warp per corpus row, lanes across D, coalesced
//      row reads, queries from shared memory, f32 accumulation) and writes
//      each query's top-k of the tile ([Q, n_tiles, k] candidates);
//   2. topk_merge_kernel: one block per query selects the final k from
//      n_tiles * k candidates with the same (value desc, row asc) order.
// The [Q, N] score matrix never reaches device memory. Each corpus tile is
// read once per 16-query group (L2 absorbs most re-reads). Tensor-core
// scoring and a register-resident query block are later work.

#include "topk.cuh"

constexpr int TK_QG = 16;       // queries per block
constexpr int TK_T = 128;       // corpus rows per tile (>= k, k <= 128)
constexpr int TK_THREADS = 256;

// Q4 = true: TC is int8_t and each corpus row holds D / 2 packed bytes.
template <typename TQ, typename TC, bool Q4>
__global__ void __launch_bounds__(TK_THREADS)
topk_tiles_kernel(const TQ* __restrict__ q_img, const TQ* __restrict__ q_txt,
                  const TC* __restrict__ img, const TC* __restrict__ txt,
                  const float* __restrict__ img_s, const float* __restrict__ txt_s,
                  const float* __restrict__ alpha, int Q, int N, int D, int k,
                  float* __restrict__ cand_v, int* __restrict__ cand_i) {
  extern __shared__ __align__(16) float qs[];  // [TK_QG][D]
  __shared__ float t2i[TK_QG][TK_T];
  __shared__ float sc[TK_QG][TK_T];

  const int tile = blockIdx.x, n_tiles = gridDim.x;
  const int q0 = blockIdx.y * TK_QG, n0 = tile * TK_T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int dc = Q4 ? D / 2 : D;  // stored elements per corpus row

  for (int tower = 0; tower < 2; ++tower) {
    const TQ* qsrc = tower == 0 ? q_img : q_txt;
    const TC* corpus = tower == 0 ? img : txt;
    for (int e = threadIdx.x; e < TK_QG * D; e += blockDim.x) {
      const int g = e / D, d = e % D;
      qs[e] = (q0 + g < Q) ? to_f(qsrc[(size_t)(q0 + g) * D + d]) : 0.f;
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
    __syncthreads();
  }

  for (int e = threadIdx.x; e < TK_QG * TK_T; e += blockDim.x) {
    const int g = e / TK_T, r = e % TK_T;
    const int n = n0 + r, q = q0 + g;
    float s = -FLT_MAX;
    if (n < N && q < Q) {
      const float a = alpha[q];
      if (img_s != nullptr)
        s = a * (t2i[g][r] * img_s[n]) + (1.0f - a) * (sc[g][r] * txt_s[n]);
      else
        s = a * t2i[g][r] + (1.0f - a) * sc[g][r];
      if (isnan(s)) s = -FLT_MAX;
    }
    sc[g][r] = s;
  }
  __syncthreads();
  select_tile_topk<TK_T>(&sc[0][0], TK_QG, q0, Q, n0, tile, n_tiles, k, cand_v, cand_i);
}

// One block per query: the final k of M candidates. Taken candidates are
// overwritten with -inf in the scratch buffer.
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

int kemr_topk_merge(float* cand_v, const int* cand_i, int Q, int M, int k, float* out_v,
                    int* out_i, cudaStream_t st) {
  topk_merge_kernel<<<Q, TK_THREADS, 0, st>>>(cand_v, cand_i, M, k, out_v, out_i);
  KEMR_CHECK_LAUNCH();
  return 0;
}

template <typename TQ, typename TC, bool Q4>
static int topk_launch(const void* q_img, const void* q_txt, const void* img, const void* txt,
                       const float* img_s, const float* txt_s, const float* alpha, int Q, int N,
                       int D, int k, float* cand_v, int* cand_i, float* out_v, int* out_i,
                       cudaStream_t st) {
  const int n_tiles = (N + TK_T - 1) / TK_T;
  const size_t smem = (size_t)TK_QG * D * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(topk_tiles_kernel<TQ, TC, Q4>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_tiles, (Q + TK_QG - 1) / TK_QG);
  topk_tiles_kernel<TQ, TC, Q4><<<grid, TK_THREADS, smem, st>>>(
      (const TQ*)q_img, (const TQ*)q_txt, (const TC*)img, (const TC*)txt, img_s, txt_s, alpha, Q,
      N, D, k, cand_v, cand_i);
  KEMR_CHECK_LAUNCH();
  return kemr_topk_merge(cand_v, cand_i, Q, n_tiles * k, k, out_v, out_i, st);
}

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8, 3 = int4 nibble-packed
// int8 [N, D / 2] (corpus only; 2 and 3 take f32 per-row scales). D is
// the query width. Scratch: cand_v f32 / cand_i i32 of [Q, ceil(N / 128), k].
int kemr_similarity_topk(int q_dtype, int c_dtype, const void* q_img, const void* q_txt,
                         const void* img, const void* txt, const void* img_s, const void* txt_s,
                         const void* alpha, int Q, int N, int D, int k, void* cand_v, void* cand_i,
                         void* out_v, void* out_i, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* is = (const float*)img_s;
  const float* ts = (const float*)txt_s;
  const float* a = (const float*)alpha;
  float* cv = (float*)cand_v;
  int* ci = (int*)cand_i;
  float* ov = (float*)out_v;
  int* oi = (int*)out_i;
  if (q_dtype == 0 && c_dtype == 0)
    return topk_launch<float, float, false>(q_img, q_txt, img, txt, is, ts, a, Q, N, D, k, cv, ci, ov, oi, st);
  if (q_dtype == 1 && c_dtype == 1)
    return topk_launch<bf16, bf16, false>(q_img, q_txt, img, txt, is, ts, a, Q, N, D, k, cv, ci, ov, oi, st);
  if (q_dtype == 1 && c_dtype == 2)
    return topk_launch<bf16, int8_t, false>(q_img, q_txt, img, txt, is, ts, a, Q, N, D, k, cv, ci, ov, oi, st);
  if (q_dtype == 0 && c_dtype == 2)
    return topk_launch<float, int8_t, false>(q_img, q_txt, img, txt, is, ts, a, Q, N, D, k, cv, ci, ov, oi, st);
  if (D % 2 == 0 && q_dtype == 1 && c_dtype == 3)
    return topk_launch<bf16, int8_t, true>(q_img, q_txt, img, txt, is, ts, a, Q, N, D, k, cv, ci, ov, oi, st);
  if (D % 2 == 0 && q_dtype == 0 && c_dtype == 3)
    return topk_launch<float, int8_t, true>(q_img, q_txt, img, txt, is, ts, a, Q, N, D, k, cv, ci, ov, oi, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
