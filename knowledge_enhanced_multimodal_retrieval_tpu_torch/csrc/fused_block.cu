// Transformer-layer kernels of the serving encoders (text and vision), for Hopper (sm_90a).
//
// Replaces five Pallas TPU kernels of knowledge_enhanced_multimodal_retrieval_tpu/ops/fused_block.py:
//   B3a fused_attention_block     (_attention_block_kernel, _attention_interior)
//   B3b fused_mlp_block           (_mlp_block_kernel)
//   B1  fused_layer_q8            (_layer_q8_kernel = _attn_half_q8 + _mlp_half_q8)
//   B4a fused_attention_block_q8  (_attention_block_q8_kernel = _attn_half_q8)
//   B4b fused_mlp_block_q8        (_mlp_block_q8_kernel = _mlp_half_q8)
// and the two diagnostic kernels of scripts/profile_vision_interior.py:
//   S1  attn_q8_variant  (B4a with a selectable softmax interior)
//   S2  mlp_q8_diag      (B4b with QuickGELU and the requantization switchable)
// B1 is attn_half_q8 then mlp_half_q8 below; B4a, B4b, S1 and S2 call the
// same two functions, so the pair and the whole layer are one arithmetic.
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
//   attention_kernel   one (sequence, head) per block, K and V of the whole
//                      sequence in shared memory, one warp per query row;
//   quant_rows_kernel  per-row dynamic int8 (max|h| / 127, round half-even).
// Intermediates ([N, 3W] qkv, [N, ff] activations) round-trip device memory;
// keeping them on chip (wgmma, TMA, whole-layer fusion) is later work.
//
// Numerics follow the Pallas kernels, not the XLA references: f32
// accumulators, bias added in f32 before the cast to bf16, p cast to bf16
// before p@v, the residual added in bf16, and in B1 the c_fc activations
// requantized per FF chunk of ff / n_chunks columns (materialized in f32,
// then one row-max pass, then the int8 c_proj GEMM accumulating in f32).
// S1's other interior drops the row-max pass of the softmax (mask to -1e9,
// exp, divide by the row sum, p cast to bf16); S2 without requantization
// casts f and the int8 c_proj chunk to bf16 (exact), multiplies them on the
// tensor cores in f32 and scales by the weight scales after the product.

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
  EPI_BIAS_F32 = 5,        // out_f32 = v + bias                   (S2 without QuickGELU)
  EPI_SCALE_ACC_F32 = 6,   // EPI_ACC_F32 with v = acc_f32 * col_scale (S2's bf16 c_proj)
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
    } else if constexpr (EPI == EPI_SCALE_ACC_F32) {
      v = Cs[r][c] * ep.col_scale[gn];  // scaled after the product
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
    } else if constexpr (EPI == EPI_BIAS_F32) {
      ep.out_f32[o] = v + ep.bias[gn];
    } else {  // EPI_ACC_F32, EPI_SCALE_ACC_F32
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
// K and V of the whole sequence sit in shared memory; each warp copies only
// the query row it is working on, so the need is 2·S·(hd+2)·2 + 4·S·4 bytes
// plus four query rows: ~166 KB at S = 592 (ViT-L/14@336px), inside the
// H100's 227 KB opt-in. NOMAX is S1's diagnostic interior: the same order of
// operations without the row-max pass (exp of the masked, scaled score).
template <bool NOMAX>
__global__ void __launch_bounds__(ATTN_THREADS)
attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int W, int heads, int S,
                 int mask_len, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = W / heads;
  const int ld = hd + 2;  // odd word stride: conflict-free column reads
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + S * ld;
  bf16* Qw = Vs + S * ld;  // one query row per warp
  float* P = reinterpret_cast<float*>(Qw + nw * ld);

  const int seq = blockIdx.x, h = blockIdx.y;
  const size_t W3 = 3 * (size_t)W;
  const bf16* base = qkv + (size_t)seq * S * W3;
  for (int e = threadIdx.x; e < S * hd; e += blockDim.x) {
    const int r = e / hd, d = e % hd;
    const bf16* row = base + r * W3 + h * hd + d;
    Ks[r * ld + d] = row[W];
    Vs[r * ld + d] = row[2 * W];
  }
  __syncthreads();

  float* p = P + warp * S;
  bf16* qw = Qw + warp * ld;
  for (int i = warp; i < S; i += nw) {
    for (int d = lane; d < hd; d += 32) qw[d] = base[i * W3 + h * hd + d];
    __syncwarp();
    const __nv_bfloat162* qi = reinterpret_cast<const __nv_bfloat162*>(qw);
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
      const float e = NOMAX ? expf(p[j]) : expf(p[j] - mx);
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
    __syncwarp();  // p and qw are reused by the warp's next row
  }
}

template <bool NOMAX>
static int attention_launch(const bf16* qkv, bf16* out, int N, int W, int heads, int S,
                            int mask_len, int causal, cudaStream_t st) {
  const int hd = W / heads;
  const size_t nw = ATTN_THREADS / 32;
  const size_t smem = (2 * (size_t)S + nw) * (hd + 2) * sizeof(bf16) + nw * (size_t)S * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(attention_kernel<NOMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const float scale = 1.0f / sqrtf((float)hd);
  dim3 grid(N / S, heads);
  attention_kernel<NOMAX><<<grid, ATTN_THREADS, smem, st>>>(qkv, out, W, heads, S, mask_len,
                                                            causal, scale);
  return (int)cudaGetLastError();
}

// interior: 0 = the production softmax, 1 = S1's no-max-subtract diagnostic.
static int attention(const bf16* qkv, bf16* out, int N, int W, int heads, int S, int mask_len,
                     int causal, int interior, cudaStream_t st) {
  if (interior == 0) return attention_launch<false>(qkv, out, N, W, heads, S, mask_len, causal, st);
  if (interior == 1) return attention_launch<true>(qkv, out, N, W, heads, S, mask_len, causal, st);
  return (int)cudaErrorInvalidValue;
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

// int8 -> bf16, exact (|v| <= 127): S2's bf16 copy of one c_proj chunk.
__global__ void i8_to_bf16_kernel(const int8_t* __restrict__ x, bf16* __restrict__ y, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = f2bf((float)x[i]);
}

static int i8_to_bf16(const int8_t* x, bf16* y, size_t n, cudaStream_t st) {
  i8_to_bf16_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(x, y, n);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The two halves of a W8A8 layer (_attn_half_q8, _mlp_half_q8): the one
// implementation behind B1, B4a, B4b, S1 and S2.
// ---------------------------------------------------------------------------

// out = x + out_proj_q8(attention(qkv_q8(LN(x)))). Scratch: hq int8 [N, W],
// hr f32 [N], qkv bf16 [N, 3W], attn bf16 [N, W].
static int attn_half_q8(const bf16* x, const float* ln_g, const float* ln_b, const int8_t* wqkv_q,
                        const float* wqkv_s, const float* bqkv, const int8_t* wo_q,
                        const float* wo_s, const float* bo, bf16* out, int8_t* hq, float* hr,
                        bf16* qkv, bf16* attn, int N, int W, int heads, int S, int mask_len,
                        int causal, int interior, float eps, cudaStream_t st) {
  KEMR_TRY(ln_rows(x, ln_g, ln_b, N, W, eps, nullptr, hq, hr, st));
  Epi e = epi(bqkv, qkv, 3 * W);
  e.row_scale = hr;
  e.col_scale = wqkv_s;
  KEMR_TRY((gemm<int8_t, int, EPI_BIAS_BF16>(hq, W, wqkv_q, 3 * W, N, 3 * W, W, e, st)));
  KEMR_TRY(attention(qkv, attn, N, W, heads, S, mask_len, causal, interior, st));
  KEMR_TRY(quant_rows<bf16>(attn, N, W, hq, hr, st));
  e = epi(bo, out, W);
  e.row_scale = hr;
  e.col_scale = wo_s;
  e.res = x;
  KEMR_TRY((gemm<int8_t, int, EPI_BIAS_RES_BF16>(hq, W, wo_q, W, N, W, W, e, st)));
  return 0;
}

// out = x + c_proj(act(c_fc_q8(LN(x)))), FF-chunked (ck = FF / n_chunks) with
// an f32 accumulator over the chunks. gelu: act is QuickGELU, else identity.
// requant: each chunk of f is requantized per row and c_proj is s8 x s8;
// else f and the int8 c_proj chunk go to bf16 (fbf [N, ck], w2bf [ck, W])
// and the product is bf16 x bf16 in f32, times w2_s. Scratch: hq int8 [N, W],
// hr f32 [N], fbuf f32 [N, ck], fq int8 [N, ck], fr f32 [N], acc f32 [N, W];
// fbf and w2bf only when requant == 0 (fbuf, fq and fr only otherwise).
static int mlp_half_q8(const bf16* x, const float* ln_g, const float* ln_b, const int8_t* w1_q,
                       const float* w1_s, const float* b1, const int8_t* w2_q, const float* w2_s,
                       const float* b2, bf16* out, int8_t* hq, float* hr, float* fbuf, int8_t* fq,
                       float* fr, float* acc, bf16* fbf, bf16* w2bf, int N, int W, int FF,
                       int n_chunks, int gelu, int requant, float eps, cudaStream_t st) {
  KEMR_TRY(ln_rows(x, ln_g, ln_b, N, W, eps, nullptr, hq, hr, st));
  const int ck = FF / n_chunks;
  for (int c = 0; c < n_chunks; ++c) {
    Epi e1{};
    e1.bias = b1 + c * ck;
    e1.row_scale = hr;
    e1.col_scale = w1_s + c * ck;
    e1.out_f32 = fbuf;
    e1.out = fbf;
    e1.ldo = ck;
    const int8_t* w1_c = w1_q + c * ck;
    const int8_t* w2_c = w2_q + (size_t)c * ck * W;
    Epi e2{};
    e2.bias = b2;
    e2.col_scale = w2_s;
    e2.res = x;
    e2.out = out;
    e2.out_f32 = acc;
    e2.ldo = W;
    e2.first = c == 0;
    e2.last = c == n_chunks - 1;
    if (requant) {
      if (gelu)
        KEMR_TRY((gemm<int8_t, int, EPI_BIAS_GELU_F32>(hq, W, w1_c, FF, N, ck, W, e1, st)));
      else
        KEMR_TRY((gemm<int8_t, int, EPI_BIAS_F32>(hq, W, w1_c, FF, N, ck, W, e1, st)));
      KEMR_TRY(quant_rows<float>(fbuf, N, ck, fq, fr, st));
      e2.row_scale = fr;
      KEMR_TRY((gemm<int8_t, int, EPI_ACC_F32>(fq, ck, w2_c, W, N, W, ck, e2, st)));
    } else {
      if (gelu)
        KEMR_TRY((gemm<int8_t, int, EPI_BIAS_GELU_BF16>(hq, W, w1_c, FF, N, ck, W, e1, st)));
      else
        KEMR_TRY((gemm<int8_t, int, EPI_BIAS_BF16>(hq, W, w1_c, FF, N, ck, W, e1, st)));
      KEMR_TRY(i8_to_bf16(w2_c, w2bf, (size_t)ck * W, st));
      KEMR_TRY((gemm<bf16, float, EPI_SCALE_ACC_F32>(fbf, ck, w2bf, W, N, W, ck, e2, st)));
    }
  }
  return 0;
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
  KEMR_TRY(attention((const bf16*)qkv, (bf16*)attn, N, W, heads, S, mask_len, causal, 0, st));
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
  KEMR_TRY(attn_half_q8((const bf16*)x, (const float*)ln1_g, (const float*)ln1_b,
                        (const int8_t*)wqkv_q, (const float*)wqkv_s, (const float*)bqkv,
                        (const int8_t*)wo_q, (const float*)wo_s, (const float*)bo, (bf16*)y,
                        (int8_t*)hq, (float*)hr, (bf16*)qkv, (bf16*)attn, N, W, heads, S, mask_len,
                        causal, 0, eps, st));
  return mlp_half_q8((const bf16*)y, (const float*)ln2_g, (const float*)ln2_b,
                     (const int8_t*)w1_q, (const float*)w1_s, (const float*)b1,
                     (const int8_t*)w2_q, (const float*)w2_s, (const float*)b2, (bf16*)out,
                     (int8_t*)hq, (float*)hr, (float*)fbuf, (int8_t*)fq, (float*)fr, (float*)acc,
                     nullptr, nullptr, N, W, FF, n_chunks, 1, 1, eps, st);
}

// S1 (and, with interior 0, B4a): the attention half of B1 as its own
// launch. interior 0 = production softmax, 1 = no-max-subtract diagnostic.
int kemr_attention_block_q8_variant(const void* x, const void* ln_g, const void* ln_b,
                                    const void* wqkv_q, const void* wqkv_s, const void* bqkv,
                                    const void* wo_q, const void* wo_s, const void* bo, void* out,
                                    void* hq, void* hr, void* qkv, void* attn, int N, int W,
                                    int heads, int S, int mask_len, int causal, int interior,
                                    float eps, void* stream) {
  return attn_half_q8((const bf16*)x, (const float*)ln_g, (const float*)ln_b,
                      (const int8_t*)wqkv_q, (const float*)wqkv_s, (const float*)bqkv,
                      (const int8_t*)wo_q, (const float*)wo_s, (const float*)bo, (bf16*)out,
                      (int8_t*)hq, (float*)hr, (bf16*)qkv, (bf16*)attn, N, W, heads, S, mask_len,
                      causal, interior, eps, (cudaStream_t)stream);
}

// B4a: out = x + out_proj_q8(attention(qkv_q8(LN1(x)))).
int kemr_attention_block_q8(const void* x, const void* ln_g, const void* ln_b, const void* wqkv_q,
                            const void* wqkv_s, const void* bqkv, const void* wo_q,
                            const void* wo_s, const void* bo, void* out, void* hq, void* hr,
                            void* qkv, void* attn, int N, int W, int heads, int S, int mask_len,
                            int causal, float eps, void* stream) {
  return kemr_attention_block_q8_variant(x, ln_g, ln_b, wqkv_q, wqkv_s, bqkv, wo_q, wo_s, bo, out,
                                         hq, hr, qkv, attn, N, W, heads, S, mask_len, causal, 0,
                                         eps, stream);
}

// S2 (and, with gelu = requant = 1, B4b): the MLP half of B1 as its own
// launch; fbf bf16 [N, ck] and w2bf bf16 [ck, W] are read only when
// requant == 0 (and fbuf, fq, fr only when it is 1).
int kemr_mlp_block_q8_diag(const void* x, const void* ln_g, const void* ln_b, const void* w1_q,
                           const void* w1_s, const void* b1, const void* w2_q, const void* w2_s,
                           const void* b2, void* out, void* hq, void* hr, void* fbuf, void* fq,
                           void* fr, void* acc, void* fbf, void* w2bf, int N, int W, int FF,
                           int n_chunks, int gelu, int requant, float eps, void* stream) {
  return mlp_half_q8((const bf16*)x, (const float*)ln_g, (const float*)ln_b, (const int8_t*)w1_q,
                     (const float*)w1_s, (const float*)b1, (const int8_t*)w2_q,
                     (const float*)w2_s, (const float*)b2, (bf16*)out, (int8_t*)hq, (float*)hr,
                     (float*)fbuf, (int8_t*)fq, (float*)fr, (float*)acc, (bf16*)fbf, (bf16*)w2bf,
                     N, W, FF, n_chunks, gelu, requant, eps, (cudaStream_t)stream);
}

// B4b: out = x + c_proj_q8(quick_gelu(c_fc_q8(LN2(x)))), per-chunk requant.
int kemr_mlp_block_q8(const void* x, const void* ln_g, const void* ln_b, const void* w1_q,
                      const void* w1_s, const void* b1, const void* w2_q, const void* w2_s,
                      const void* b2, void* out, void* hq, void* hr, void* fbuf, void* fq,
                      void* fr, void* acc, int N, int W, int FF, int n_chunks, float eps,
                      void* stream) {
  return kemr_mlp_block_q8_diag(x, ln_g, ln_b, w1_q, w1_s, b1, w2_q, w2_s, b2, out, hq, hr, fbuf,
                                fq, fr, acc, nullptr, nullptr, N, W, FF, n_chunks, 1, 1, eps,
                                stream);
}

}  // extern "C"
