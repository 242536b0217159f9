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
// so this kernel gathers the same values and adds them in the same order
// (subspace m = 0 .. M-1, f32) and reproduces the oracle's sums. Rows past N
// and NaN scores become float32 min; selection is B2's (topk.cuh).
//
// What bounds it on the H100: Q * N * M lookups per tower (2.1 G at
// Q = 256, N = 43,000, M = 96), each a shared-memory gather at a random
// column of a query's LUT row, so shared-memory bank conflicts and the
// LUT staging (a 16-query block reads 48 KB per subspace group and tower
// from L2 for every 256-row tile) bound it; the codes are only M bytes a
// row. One block scores 16 queries x 256 corpus rows, one row per thread,
// with the 16 running sums in registers. The LUT slices of 8 subspaces
// (8 x 16 x 256 bf16 = 64 KB) stage in shared memory at a time, inside
// the 227 KB opt-in; the tile's codes stage once per tower with an odd
// word stride, so a warp's code reads hit 32 distinct banks.

#include "topk.cuh"

constexpr int PQ_QG = 16;       // queries per block
constexpr int PQ_T = 256;       // corpus rows per tile, one per thread (>= k, k <= 128)
constexpr int PQ_THREADS = 256;
constexpr int PQ_G = 8;         // subspaces whose LUT slices stage at a time

// Bytes of one staged code row: a multiple of 4 whose word count is odd.
__host__ __device__ inline int pq_code_stride(int M) {
  int words = (M + 3) / 4;
  if (words % 2 == 0) ++words;
  return 4 * words;
}

__host__ __device__ inline size_t pq_lut_bytes(int K) {
  return ((size_t)PQ_G * PQ_QG * K * sizeof(bf16) + 15) / 16 * 16;
}

static size_t pq_smem_bytes(int M, int K) {
  return pq_lut_bytes(K) + (size_t)PQ_T * pq_code_stride(M) + (size_t)PQ_QG * PQ_T * sizeof(float);
}

__global__ void __launch_bounds__(PQ_THREADS)
pq_adc_tiles_kernel(const bf16* __restrict__ lut_i, const bf16* __restrict__ lut_t,
                    const uint8_t* __restrict__ codes_i, const uint8_t* __restrict__ codes_t,
                    const float* __restrict__ s_i, const float* __restrict__ s_t,
                    const float* __restrict__ alpha, int Q, int N, int M, int K, int k,
                    float* __restrict__ cand_v, int* __restrict__ cand_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* lut_s = (bf16*)smem;                           // [PQ_G][PQ_QG][K]
  uint8_t* codes_s = smem + pq_lut_bytes(K);           // [PQ_T][stride]
  const int stride = pq_code_stride(M);
  float* sc = (float*)(codes_s + (size_t)PQ_T * stride);  // [PQ_QG][PQ_T]

  const int tile = blockIdx.x, n_tiles = gridDim.x;
  const int q0 = blockIdx.y * PQ_QG, n0 = tile * PQ_T;
  const int r = threadIdx.x, n = n0 + r;
  const int rows = min(PQ_T, N - n0);
  const bool vec = (K % 8) == 0;  // 16-byte LUT copies (rows of K bf16 stay aligned)

  float t2i[PQ_QG], acc[PQ_QG];
  for (int tower = 0; tower < 2; ++tower) {
    const bf16* lut = tower == 0 ? lut_i : lut_t;
    const uint8_t* codes = tower == 0 ? codes_i : codes_t;
    __syncthreads();  // the previous tower's last reads of codes_s / lut_s are done
    for (int e = threadIdx.x; e < rows * M; e += blockDim.x)
      codes_s[(e / M) * stride + e % M] = codes[(size_t)n0 * M + e];
#pragma unroll
    for (int g = 0; g < PQ_QG; ++g) acc[g] = 0.f;

    for (int m0 = 0; m0 < M; m0 += PQ_G) {
      const int G = min(PQ_G, M - m0);
      __syncthreads();  // reads of the previous group's slices are done
      // slice (m, q0 .. q0 + 15) of the [M, Q, K] LUT is 16 contiguous rows
      for (int mm = 0; mm < G; ++mm) {
        const bf16* src = lut + ((size_t)(m0 + mm) * Q + q0) * K;
        bf16* dst = lut_s + (size_t)mm * PQ_QG * K;
        const int valid = min(PQ_QG, Q - q0) * K;  // elements of real queries
        if (vec) {
          for (int e = threadIdx.x * 8; e < PQ_QG * K; e += blockDim.x * 8) {
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (e < valid) v = *reinterpret_cast<const uint4*>(src + e);
            *reinterpret_cast<uint4*>(dst + e) = v;
          }
        } else {
          for (int e = threadIdx.x; e < PQ_QG * K; e += blockDim.x)
            dst[e] = e < valid ? src[e] : __float2bfloat16_rn(0.f);
        }
      }
      __syncthreads();
      if (r < rows) {
        for (int mm = 0; mm < G; ++mm) {
          const int code = codes_s[r * stride + m0 + mm];
          const bf16* col = lut_s + (size_t)mm * PQ_QG * K + code;
#pragma unroll
          for (int g = 0; g < PQ_QG; ++g) acc[g] += __bfloat162float(col[g * K]);
        }
      }
    }
    if (tower == 0) {
#pragma unroll
      for (int g = 0; g < PQ_QG; ++g) t2i[g] = acc[g];
    }
  }

#pragma unroll
  for (int g = 0; g < PQ_QG; ++g) {
    const int q = q0 + g;
    float s = -FLT_MAX;
    if (r < rows && q < Q) {
      const float a = alpha[q];
      s = a * (t2i[g] * s_i[n]) + (1.0f - a) * (acc[g] * s_t[n]);
      if (isnan(s)) s = -FLT_MAX;
    }
    sc[g * PQ_T + r] = s;
  }
  __syncthreads();
  select_tile_topk<PQ_T>(sc, PQ_QG, q0, Q, n0, tile, n_tiles, k, cand_v, cand_i);
}

extern "C" {

// Shared memory one scan block needs at M subspaces and K centroids (the
// wrapper refuses shapes above the 227 KB opt-in).
int kemr_pq_smem_bytes(int M, int K) { return (int)pq_smem_bytes(M, K); }

// LUTs bf16 [M, Q, K] per tower, codes uint8 [N, M], scales f32 [N], alpha
// f32 [Q]. Scratch: cand_v f32 / cand_i i32 of [Q, ceil(N / 256), k].
int kemr_pq_adc_topk(const void* lut_i, const void* lut_t, const void* codes_i,
                     const void* codes_t, const void* scale_i, const void* scale_t,
                     const void* alpha, int Q, int N, int M, int K, int k, void* cand_v,
                     void* cand_i, void* out_v, void* out_i, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = pq_smem_bytes(M, K);
  cudaError_t e = cudaFuncSetAttribute(pq_adc_tiles_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = (N + PQ_T - 1) / PQ_T;
  dim3 grid(n_tiles, (Q + PQ_QG - 1) / PQ_QG);
  pq_adc_tiles_kernel<<<grid, PQ_THREADS, smem, st>>>(
      (const bf16*)lut_i, (const bf16*)lut_t, (const uint8_t*)codes_i, (const uint8_t*)codes_t,
      (const float*)scale_i, (const float*)scale_t, (const float*)alpha, Q, N, M, K, k,
      (float*)cand_v, (int*)cand_i);
  KEMR_CHECK_LAUNCH();
  return kemr_topk_merge((float*)cand_v, (const int*)cand_i, Q, n_tiles * k, k, (float*)out_v,
                         (int*)out_i, st);
}

}  // extern "C"
