// Transformer-layer kernels of the serving text encoder, for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of knowledge_enhanced_multimodal_retrieval_tpu/ops/fused_block.py:
//   B3a fused_attention_block  (_attention_block_kernel, _attention_interior)
//   B3b fused_mlp_block        (_mlp_block_kernel)
//   B1  fused_layer_q8         (_layer_q8_kernel = _attn_half_q8 + _mlp_half_q8)
//
// What bounds them on the H100: at ViT-L/14 text serving shapes
// ([256 x 32, 768], ff 3072) the four projections are ~116 GFLOP per layer
// against ~50 MB of activations, far above the card's ~295 FLOP/byte ridge,
// so the projections are tensor-core bound; the LayerNorms, the row
// quantization and the attention interior (s <= 80, head_dim 64) are memory
// and latency bound. The TPU kernels kept one row tile's whole layer in
// VMEM; an SM has 227 KB of shared memory, so here each TPU kernel is a few
// launches that share four building blocks:
//   ln_rows_kernel     row LayerNorm (f32 math), bf16 out or an int8
//                      per-row quant epilogue;
//   gemm_kernel        64x64x32 tiles on WMMA tensor cores, bf16 x bf16 -> f32
//                      or s8 x s8 -> s32, with bias / QuickGELU / dequant /
//                      residual / f32-accumulate epilogues;
//   attention_kernel   one (sequence, head) per block, the whole sequence in
//                      shared memory, one warp per query row;
//   quant_rows_kernel  per-row dynamic int8 (max|h| / 127, round half-even).
// Intermediates ([N, 3W] qkv, [N, ff] activations) round-trip device memory;
// keeping them on chip (wgmma, TMA, whole-layer fusion) is later work.
//
// Numerics follow the Pallas kernels, not the XLA references: f32
// accumulators, bias added in f32 before the cast to bf16, p cast to bf16
// before p@v, the residual added in bf16, and in B1 the c_fc activations
// requantized per FF chunk of ff / n_chunks columns (materialized in f32,
// then one row-max pass, then the int8 c_proj GEMM accumulating in f32).

#include "common.cuh"

#include <mma.h>
#include <type_traits>

using namespace nvcuda;

#define KEMR_TRY(expr)            \
  do {                            \
    int _s = (expr);              \
    if (_s != 0) return _s;       \
  } while (0)

// ---------------------------------------------------------------------------
// Row LayerNorm (+ optional int8 quantization of the f32 result)
// ---------------------------------------------------------------------------

// One block per row. h_out != nullptr: write bf16(LN(x)). Otherwise write
// q_out = rint(LN(x) / r) and r_out = max(max|LN(x)| / 127, 1e-12) — the
// f32 LN output is quantized directly, as _attn_half_q8 / _mlp_half_q8 do.
__global__ void ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                               const float* __restrict__ b, int W, float eps,
                               bf16* __restrict__ h_out, int8_t* __restrict__ q_out,
                               float* __restrict__ r_out) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const bf16* xr = x + row * W;
  float s = 0.f;
  for (int i = threadIdx.x; i < W; i += blockDim.x) s += to_f(xr[i]);
  const float mu = block_sum(s, red) / (float)W;
  float v = 0.f;
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    float d = to_f(xr[i]) - mu;
    v += d * d;
  }
  const float var = block_sum(v, red) / (float)W;
  const float inv = rsqrtf(var + eps);
  if (h_out != nullptr) {
    for (int i = threadIdx.x; i < W; i += blockDim.x)
      h_out[row * W + i] = f2bf(((to_f(xr[i]) - mu) * inv) * g[i] + b[i]);
    return;
  }
  float m = 0.f;
  for (int i = threadIdx.x; i < W; i += blockDim.x)
    m = fmaxf(m, fabsf(((to_f(xr[i]) - mu) * inv) * g[i] + b[i]));
  const float r = fmaxf(block_max(m, red) / 127.0f, 1e-12f);
  for (int i = threadIdx.x; i < W; i += blockDim.x)
    q_out[row * W + i] = quant_i8(((to_f(xr[i]) - mu) * inv) * g[i] + b[i], r);
  if (threadIdx.x == 0) r_out[row] = r;
}

// ---------------------------------------------------------------------------
// Per-row dynamic int8 quantization (_quantize_rows)
// ---------------------------------------------------------------------------

template <typename TX>
__global__ void quant_rows_kernel(const TX* __restrict__ x, int C, int8_t* __restrict__ q,
                                  float* __restrict__ r_out) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const TX* xr = x + row * C;
  float m = 0.f;
  for (int i = threadIdx.x; i < C; i += blockDim.x) m = fmaxf(m, fabsf(to_f(xr[i])));
  const float r = fmaxf(block_max(m, red) / 127.0f, 1e-12f);
  for (int i = threadIdx.x; i < C; i += blockDim.x) q[row * C + i] = quant_i8(to_f(xr[i]), r);
  if (threadIdx.x == 0) r_out[row] = r;
}

// ---------------------------------------------------------------------------
// Tiled tensor-core GEMM with fused epilogues
// ---------------------------------------------------------------------------

enum {
  EPI_BIAS_BF16 = 0,       // out = bf16(v + bias)
  EPI_BIAS_RES_BF16 = 1,   // out = res + bf16(v + bias)           (bf16 add)
  EPI_BIAS_GELU_BF16 = 2,  // out = bf16(quick_gelu(v + bias))
  EPI_BIAS_GELU_F32 = 3,   // out_f32 = quick_gelu(v + bias)
  EPI_ACC_F32 = 4,         // acc (+)= v; on the last chunk out = res + bf16(acc + bias)
};

struct Epi {
  const float* bias;       // [N] (offset to the GEMM's first column)
  const float* row_scale;  // [M] activation scales (integer GEMMs)
  const float* col_scale;  // [N] weight scales (integer GEMMs)
  const bf16* res;         // residual [M, ldo]
  bf16* out;               // [M, ldo]
  float* out_f32;          // [M, ldo] (EPI_BIAS_GELU_F32) or the accumulator (EPI_ACC_F32)
  int ldo;
  int first, last;         // EPI_ACC_F32 chunk position
};

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ bf16 zero_of<bf16>() { return __float2bfloat16(0.f); }
template <> __device__ __forceinline__ int8_t zero_of<int8_t>() { return 0; }

__device__ __forceinline__ float quick_gelu(float f) {
  return f * (1.0f / (1.0f + expf(-(1.702f * f))));
}

constexpr int GEMM_BM = 64, GEMM_BN = 64, GEMM_BK = 32, GEMM_THREADS = 128;

// C[M, N] = A[M, K] @ B[K, N], both row-major (B is the [in, out] weight
// layout of the JAX plans). Shared tiles are stored per 16-deep k slice
// (A as [k/16][m][16], B as [k/16][n][16], i.e. column-major B) so that
// every WMMA fragment pointer is 256-bit aligned for both element widths.
// Ragged edges load zeros; K needs no particular multiple.
template <typename T, typename TAcc, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const T* __restrict__ A, int lda, const T* __restrict__ B, int ldb, int M, int N,
            int K, Epi ep) {
  __shared__ __align__(128) T As[GEMM_BK / 16][GEMM_BM][16];
  __shared__ __align__(128) T Bs[GEMM_BK / 16][GEMM_BN][16];
  __shared__ __align__(128) TAcc Cs[GEMM_BM][GEMM_BN + 4];

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // 2 x 2 warps, 32 x 32 each
  const int m0 = blockIdx.y * GEMM_BM, n0 = blockIdx.x * GEMM_BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, TAcc> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], (TAcc)0);

  for (int k0 = 0; k0 < K; k0 += GEMM_BK) {
    for (int e = tid; e < GEMM_BM * GEMM_BK; e += GEMM_THREADS) {
      const int r = e / GEMM_BK, c = e % GEMM_BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c >> 4][r][c & 15] = (gm < M && gk < K) ? A[(size_t)gm * lda + gk] : zero_of<T>();
    }
    for (int e = tid; e < GEMM_BK * GEMM_BN; e += GEMM_THREADS) {
      const int kk = e / GEMM_BN, n = e % GEMM_BN;
      const int gk = k0 + kk, gn = n0 + n;
      Bs[kk >> 4][n][kk & 15] = (gk < K && gn < N) ? B[(size_t)gk * ldb + gn] : zero_of<T>();
    }
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < GEMM_BK / 16; ++kc) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], &As[kc][wm * 32 + i * 16][0], 16);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], &Bs[kc][wn * 32 + j * 16][0], 16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm * 32 + i * 16][wn * 32 + j * 16], acc[i][j], GEMM_BN + 4,
                              wmma::mem_row_major);
  __syncthreads();

  for (int e = tid; e < GEMM_BM * GEMM_BN; e += GEMM_THREADS) {
    const int r = e / GEMM_BN, c = e % GEMM_BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    float v;
    if constexpr (std::is_same<TAcc, int>::value) {
      // acc.astype(f32) * r_row * s_col, in that order
      v = (float)Cs[r][c] * ep.row_scale[gm] * ep.col_scale[gn];
    } else {
      v = Cs[r][c];
    }
    const size_t o = (size_t)gm * ep.ldo + gn;
    if constexpr (EPI == EPI_BIAS_BF16) {
      ep.out[o] = f2bf(v + ep.bias[gn]);
    } else if constexpr (EPI == EPI_BIAS_RES_BF16) {
      ep.out[o] = f2bf(to_f(ep.res[o]) + to_f(f2bf(v + ep.bias[gn])));
    } else if constexpr (EPI == EPI_BIAS_GELU_BF16) {
      ep.out[o] = f2bf(quick_gelu(v + ep.bias[gn]));
    } else if constexpr (EPI == EPI_BIAS_GELU_F32) {
      ep.out_f32[o] = quick_gelu(v + ep.bias[gn]);
    } else {  // EPI_ACC_F32
      const float a = ep.first ? v : ep.out_f32[o] + v;
      if (ep.last)
        ep.out[o] = f2bf(to_f(ep.res[o]) + to_f(f2bf(a + ep.bias[gn])));
      else
        ep.out_f32[o] = a;
    }
  }
}

template <typename T, typename TAcc, int EPI>
static int gemm(const T* A, int lda, const T* B, int ldb, int M, int N, int K, const Epi& ep,
                cudaStream_t st) {
  dim3 grid((N + GEMM_BN - 1) / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM);
  gemm_kernel<T, TAcc, EPI><<<grid, GEMM_THREADS, 0, st>>>(A, lda, B, ldb, M, N, K, ep);
  return (int)cudaGetLastError();
}

static Epi epi(const float* bias, bf16* out, int ldo) {
  Epi e{};
  e.bias = bias;
  e.out = out;
  e.ldo = ldo;
  return e;
}

// ---------------------------------------------------------------------------
// Per-(sequence, head) attention over row-contiguous sequences
// ---------------------------------------------------------------------------

constexpr int ATTN_THREADS = 128;

// qkv [nseq * S, 3W] bf16 -> out [nseq * S, W] bf16, head h in columns
// [h*hd, (h+1)*hd). Scores in f32, scaled after the dot, -1e9 where
// col >= mask_len or (causal) col > row, f32 softmax, p rounded to bf16
// before p@v with an f32 accumulator — _attention_interior's arithmetic.
__global__ void __launch_bounds__(ATTN_THREADS)
attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int W, int heads, int S,
                 int mask_len, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = W / heads;
  const int ld = hd + 2;  // odd word stride: conflict-free column reads
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + S * ld;
  bf16* Vs = Ks + S * ld;
  float* P = reinterpret_cast<float*>(Vs + S * ld);

  const int seq = blockIdx.x, h = blockIdx.y;
  const size_t W3 = 3 * (size_t)W;
  const bf16* base = qkv + (size_t)seq * S * W3;
  for (int e = threadIdx.x; e < S * hd; e += blockDim.x) {
    const int r = e / hd, d = e % hd;
    const bf16* row = base + r * W3 + h * hd + d;
    Qs[r * ld + d] = row[0];
    Ks[r * ld + d] = row[W];
    Vs[r * ld + d] = row[2 * W];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  float* p = P + warp * S;
  for (int i = warp; i < S; i += nw) {
    const __nv_bfloat162* qi = reinterpret_cast<const __nv_bfloat162*>(Qs + i * ld);
    float mx = -FLT_MAX;
    for (int j = lane; j < S; j += 32) {
      const __nv_bfloat162* kj = reinterpret_cast<const __nv_bfloat162*>(Ks + j * ld);
      float s = 0.f;
      for (int d2 = 0; d2 < hd / 2; ++d2) {
        const float2 a = __bfloat1622float2(qi[d2]);
        const float2 b = __bfloat1622float2(kj[d2]);
        s += a.x * b.x;
        s += a.y * b.y;
      }
      const bool ok = j < mask_len && (!causal || j <= i);
      s = ok ? s * scale : -1e9f;
      p[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(p[j] - mx);
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < S; j += 32) p[j] = to_f(f2bf(p[j] / sum));
    __syncwarp();
    for (int d = 2 * lane; d < hd; d += 64) {
      float o0 = 0.f, o1 = 0.f;
      for (int j = 0; j < S; ++j) {
        const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Vs + j * ld + d));
        o0 += p[j] * v.x;
        o1 += p[j] * v.y;
      }
      bf16* o = out + ((size_t)seq * S + i) * W + h * hd + d;
      o[0] = f2bf(o0);
      o[1] = f2bf(o1);
    }
    __syncwarp();
  }
}

static int attention(const bf16* qkv, bf16* out, int N, int W, int heads, int S, int mask_len,
                     int causal, cudaStream_t st) {
  const int hd = W / heads;
  const size_t smem = 3 * (size_t)S * (hd + 2) * sizeof(bf16) +
                      (ATTN_THREADS / 32) * (size_t)S * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const float scale = 1.0f / sqrtf((float)hd);
  dim3 grid(N / S, heads);
  attention_kernel<<<grid, ATTN_THREADS, smem, st>>>(qkv, out, W, heads, S, mask_len, causal,
                                                     scale);
  return (int)cudaGetLastError();
}

static int ln_rows(const bf16* x, const float* g, const float* b, int N, int W, float eps,
                   bf16* h, int8_t* q, float* r, cudaStream_t st) {
  ln_rows_kernel<<<N, 256, 0, st>>>(x, g, b, W, eps, h, q, r);
  return (int)cudaGetLastError();
}

template <typename TX>
static int quant_rows(const TX* x, int N, int C, int8_t* q, float* r, cudaStream_t st) {
  quant_rows_kernel<TX><<<N, 256, 0, st>>>(x, C, q, r);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// C entry points (ctypes). Every pointer is a device pointer; outputs and
// scratch are allocated by the Python wrapper. Each returns cudaGetLastError.
// ---------------------------------------------------------------------------

extern "C" {

const char* kemr_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// B3a: out = x + out_proj(attention(LN1(x))). Scratch: h [N, W], qkv [N, 3W],
// attn [N, W], all bf16.
int kemr_attention_block_bf16(const void* x, const void* ln_g, const void* ln_b, const void* wqkv,
                              const void* bqkv, const void* wo, const void* bo, void* out,
                              void* h, void* qkv, void* attn, int N, int W, int heads, int S,
                              int mask_len, int causal, float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* xb = (const bf16*)x;
  KEMR_TRY(ln_rows(xb, (const float*)ln_g, (const float*)ln_b, N, W, eps, (bf16*)h, nullptr,
                   nullptr, st));
  KEMR_TRY((gemm<bf16, float, EPI_BIAS_BF16>((const bf16*)h, W, (const bf16*)wqkv, 3 * W, N,
                                              3 * W, W, epi((const float*)bqkv, (bf16*)qkv, 3 * W),
                                              st)));
  KEMR_TRY(attention((const bf16*)qkv, (bf16*)attn, N, W, heads, S, mask_len, causal, st));
  Epi e = epi((const float*)bo, (bf16*)out, W);
  e.res = xb;
  KEMR_TRY((gemm<bf16, float, EPI_BIAS_RES_BF16>((const bf16*)attn, W, (const bf16*)wo, W, N, W,
                                                  W, e, st)));
  return 0;
}

// B3b: out = x + c_proj(quick_gelu(c_fc(LN2(x)))). Scratch: h [N, W] and
// f [N, FF] bf16. The FF-chunked f32 accumulation of the TPU kernel is one
// f32 accumulator over the full FF depth here.
int kemr_mlp_block_bf16(const void* x, const void* ln_g, const void* ln_b, const void* w1,
                        const void* b1, const void* w2, const void* b2, void* out, void* h,
                        void* f, int N, int W, int FF, float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* xb = (const bf16*)x;
  KEMR_TRY(ln_rows(xb, (const float*)ln_g, (const float*)ln_b, N, W, eps, (bf16*)h, nullptr,
                   nullptr, st));
  KEMR_TRY((gemm<bf16, float, EPI_BIAS_GELU_BF16>((const bf16*)h, W, (const bf16*)w1, FF, N, FF,
                                                   W, epi((const float*)b1, (bf16*)f, FF), st)));
  Epi e = epi((const float*)b2, (bf16*)out, W);
  e.res = xb;
  KEMR_TRY((gemm<bf16, float, EPI_BIAS_RES_BF16>((const bf16*)f, FF, (const bf16*)w2, W, N, W, FF,
                                                  e, st)));
  return 0;
}

// B1: one whole W8A8 pre-LN layer. Scratch (wrapper-allocated):
//   hq int8 [N, W], hr f32 [N], qkv bf16 [N, 3W], attn bf16 [N, W],
//   y bf16 [N, W] (after the attention half), fbuf f32 [N, ck],
//   fq int8 [N, ck], fr f32 [N], acc f32 [N, W];  ck = FF / n_chunks.
int kemr_layer_q8(const void* x, const void* ln1_g, const void* ln1_b, const void* wqkv_q,
                  const void* wqkv_s, const void* bqkv, const void* wo_q, const void* wo_s,
                  const void* bo, const void* ln2_g, const void* ln2_b, const void* w1_q,
                  const void* w1_s, const void* b1, const void* w2_q, const void* w2_s,
                  const void* b2, void* out, void* hq, void* hr, void* qkv, void* attn, void* y,
                  void* fbuf, void* fq, void* fr, void* acc, int N, int W, int FF, int heads,
                  int S, int mask_len, int n_chunks, int causal, float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* xb = (const bf16*)x;
  int8_t* hq8 = (int8_t*)hq;
  float* hrf = (float*)hr;

  // attention half (_attn_half_q8)
  KEMR_TRY(ln_rows(xb, (const float*)ln1_g, (const float*)ln1_b, N, W, eps, nullptr, hq8, hrf,
                   st));
  Epi e = epi((const float*)bqkv, (bf16*)qkv, 3 * W);
  e.row_scale = hrf;
  e.col_scale = (const float*)wqkv_s;
  KEMR_TRY((gemm<int8_t, int, EPI_BIAS_BF16>(hq8, W, (const int8_t*)wqkv_q, 3 * W, N, 3 * W, W, e,
                                             st)));
  KEMR_TRY(attention((const bf16*)qkv, (bf16*)attn, N, W, heads, S, mask_len, causal, st));
  KEMR_TRY(quant_rows<bf16>((const bf16*)attn, N, W, hq8, hrf, st));
  e = epi((const float*)bo, (bf16*)y, W);
  e.row_scale = hrf;
  e.col_scale = (const float*)wo_s;
  e.res = xb;
  KEMR_TRY((gemm<int8_t, int, EPI_BIAS_RES_BF16>(hq8, W, (const int8_t*)wo_q, W, N, W, W, e, st)));

  // MLP half (_mlp_half_q8), FF-chunked with per-chunk requantization
  KEMR_TRY(ln_rows((const bf16*)y, (const float*)ln2_g, (const float*)ln2_b, N, W, eps, nullptr,
                   hq8, hrf, st));
  const int ck = FF / n_chunks;
  for (int c = 0; c < n_chunks; ++c) {
    Epi e1{};
    e1.bias = (const float*)b1 + c * ck;
    e1.row_scale = hrf;
    e1.col_scale = (const float*)w1_s + c * ck;
    e1.out_f32 = (float*)fbuf;
    e1.ldo = ck;
    KEMR_TRY((gemm<int8_t, int, EPI_BIAS_GELU_F32>(hq8, W, (const int8_t*)w1_q + c * ck, FF, N, ck,
                                                   W, e1, st)));
    KEMR_TRY(quant_rows<float>((const float*)fbuf, N, ck, (int8_t*)fq, (float*)fr, st));
    Epi e2{};
    e2.bias = (const float*)b2;
    e2.row_scale = (const float*)fr;
    e2.col_scale = (const float*)w2_s;
    e2.res = (const bf16*)y;
    e2.out = (bf16*)out;
    e2.out_f32 = (float*)acc;
    e2.ldo = W;
    e2.first = c == 0;
    e2.last = c == n_chunks - 1;
    KEMR_TRY((gemm<int8_t, int, EPI_ACC_F32>((const int8_t*)fq, ck,
                                             (const int8_t*)w2_q + (size_t)c * ck * W, W, N, W,
                                             ck, e2, st)));
  }
  return 0;
}

}  // extern "C"
