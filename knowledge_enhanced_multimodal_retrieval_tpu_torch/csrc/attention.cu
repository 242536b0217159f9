// Tiled online-softmax attention for Hopper (sm_90a), [B, H, S, D].
//
// Replaces two Pallas TPU kernels that compute one function:
//   B6 knowledge_enhanced_multimodal_retrieval_tpu/ops/short_attention.py::_short_forward
//      (128 < s <= 512: the whole sequence in VMEM, one softmax)
//   B7 knowledge_enhanced_multimodal_retrieval_tpu/ops/flash_attention.py::_flash_forward
//      (s > 512: K/V tiles streamed through VMEM, online softmax)
// The short/flash split is a VMEM artifact: an SM's 227 KB of shared memory
// holds no whole ViT-L/14 sequence of f32 scores, so one streamed kernel
// serves every length here.
//
// Numerics follow the Pallas kernels: q, k, v read as f32, scores scaled
// after the dot, columns at or past the key length (and, when causal,
// col > row) set to f32 min with p = 0 there, an f32 running (max, sum,
// accumulator), p kept in f32 through p@v, a zero denominator replaced by 1,
// and the output cast to the input dtype once.
//
// What bounds it on the H100: at ViT-L/14 vision shapes (s = 257, hd = 64)
// the arithmetic intensity is ~s/2 FLOP per byte of q/k/v, so the kernel is
// compute bound, and this first version runs on the CUDA cores (f32 FMA,
// p stays f32 as the TPU kernel kept it): each thread holds a 4 x 4 score
// tile and a 4 x D/16 output tile, reading q/k/v rows from shared memory
// (2 FMA per shared load). Tensor cores (p rounded to bf16, wgmma, TMA)
// are later work.
//
// Block: 64 query rows x one (batch, head); 256 threads as 16 x 16, thread
// (ty, tx) owns rows ty + 16 i and key columns tx + 16 j (interleaved, so
// the shared-memory reads are conflict-free). K/V tiles of 64 rows stream
// through shared memory; under the causal mask tiles entirely above the
// diagonal are skipped (their p is exactly zero).

#include "common.cuh"

constexpr int FA_BQ = 64, FA_BK = 64, FA_THREADS = 256;

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(bf16* p, float x) { *p = f2bf(x); }

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
// dtype: 0 = f32, 1 = bf16. D <= 256. Returns cudaGetLastError.
int kemr_flash_attention(int dtype, const void* q, const void* k, const void* v, void* o, int BH,
                         int Sq, int Sk, int D, int causal, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return flash_dispatch<float>(q, k, v, o, BH, Sq, Sk, D, causal, scale, st);
  if (dtype == 1) return flash_dispatch<bf16>(q, k, v, o, BH, Sq, Sk, D, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
