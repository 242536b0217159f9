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
//   gemm_wg_kernel     the projections: wgmma on operand tiles that TMA
//                      brings into a ring of swizzled shared-memory stages,
//                      bf16 x bf16 -> f32 or s8 x s8 -> s32, with bias /
//                      QuickGELU / dequant / residual / f32-accumulate
//                      epilogues on the accumulator fragments;
//   attention_wg_kernel  the attention interior (attention_interior.cuh):
//                      wgmma for q . k^T and p . v on K/V tiles that TMA
//                      brings into a ring, one block per (64 query rows,
//                      head, sequence); head dim 64. Other head dims and
//                      operands TMA cannot describe take attention_kernel
//                      (one (sequence, head) per block, K and V of the whole
//                      sequence in shared memory, one warp per query row),
//                      by shape and alignment alone;
//   quant_rows_kernel  per-row dynamic int8 (max|h| / 127, round half-even).
// Intermediates ([N, 3W] qkv, [N, ff] activations) round-trip device memory.
//
// The GEMM (gemm_wg_kernel). Only wgmma reaches the tensor cores' rate, and
// it reads its operands from shared memory, so the design is about keeping
// 128-byte-swizzled tiles arriving while the tensor cores work:
// - A block computes a 128 x 128 tile of C. Two consumer warpgroups own 64
//   rows each (wgmma m64n128: 64 accumulator registers a thread); a ninth
//   warp holds the producer thread.
// - The producer starts TMA box copies of A [128 x 128 bytes of K] and B into
//   a ring of three 32 KB stages, each stage completed on an mbarrier; a
//   consumer waits for a stage, starts four wgmma (k16 bf16 / k32 int8) as
//   one group, and hands the previous stage back on its empty barrier once
//   the group before has finished, so a group is always queued behind the
//   running one. TMA zero-fills past M, N and K: no edge needs a branch.
// - Three stages and at most 112 registers a thread (288 threads, no
//   register hand-over between roles: wgmma m64n128 does not compile under
//   the 80 registers that a third whole warpgroup would leave) let two
//   blocks share an SM, so one block's epilogue and first loads hide under
//   the other's
//   products; the projections here have short K (384 .. 4096), where a
//   single block per SM would leave the tensor cores idle at both ends.
// - bf16: A [M, K] is K-major; the [in, out] weight is [K, N] with N
//   contiguous, which wgmma takes as an MN-major B operand (two 64-column
//   boxes a stage), so the weights keep their layout.
// - int8: 8-bit wgmma operands have no transpose bit, so B must be K-major:
//   the kernels read an [out, in] copy of each int8 weight, made once when a
//   plan is packed (ops/fused_block.py::k_major; the wrappers make it per
//   call for callers that hand in only the [in, out] weight). Transposing
//   tiles in shared memory instead would spend the instruction slots the
//   epilogues need; the copy costs one more byte per weight. The [in, out]
//   weight stays the contract of the wrappers and of the plain versions.
// - Epilogues run on the accumulator fragments in the order of operations of
//   the first version ((float)acc * row_scale * col_scale, + bias, tail; the
//   build disables fused multiply-add), so the int8 paths give the same bits
//   (s32 sums are exact in any order). bf16 results go through the warp's
//   own 4 KB of the (by then idle) ring and leave as 16-byte row-contiguous
//   stores, the residual read the same way; f32 results (the chunk buffer
//   and the accumulator between FF chunks) leave from the fragments as
//   8-byte pairs, which fill whole 32-byte sectors.
// - B1's c_proj adds one s8 x s8 product per FF chunk, each with its own row
//   scales, into an f32 accumulator. One launch per chunk (K = 384 or 512:
//   three or four stages) is all epilogue, reading and writing the f32
//   accumulator in device memory; the CHUNKED instantiation runs all chunks
//   in one launch and folds each chunk's s32 sums into an f32 accumulator in
//   registers, in the same order of additions (the same bits). It holds two
//   accumulator sets, so one block an SM with a ring of six stages.
// - Tensor maps are encoded once per (pointer, shape) and kept in a table:
//   a layer has up to eighteen GEMMs over six distinct operands.
// - Second route, gemm_kernel (WMMA 16x16x16 fragments, 64x64x32 tiles,
//   scalar loads): taken by shape and alignment alone, when TMA cannot
//   describe an operand (a base or row stride that is no multiple of 16
//   bytes) or the output's row stride is no multiple of 8 elements. A failed
//   encode or launch on the first route is returned as an error.
//
// Numerics follow the Pallas kernels, not the XLA references: f32
// accumulators, bias added in f32 before the cast to bf16, p cast to bf16
// before p@v, the residual added in bf16, and in B1 the c_fc activations
// requantized per FF chunk of ff / n_chunks columns (materialized in f32,
// then one row-max pass, then the int8 c_proj product of that chunk added
// to an f32 accumulator, chunk after chunk).
// S1's other interior drops the row-max pass of the softmax (mask to -1e9,
// exp, divide by the row sum, p cast to bf16); S2 without requantization
// casts f and the int8 c_proj chunk to bf16 (exact), multiplies them on the
// tensor cores in f32 and scales by the weight scales after the product.

#include "attention_interior.cuh"

#include <mma.h>
#include <map>
#include <mutex>
#include <tuple>
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

// q has ldq elements between rows (a column block of a wider matrix is fine).
template <typename TX>
__global__ void quant_rows_kernel(const TX* __restrict__ x, int C, int8_t* __restrict__ q, int ldq,
                                  float* __restrict__ r_out) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const TX* xr = x + row * C;
  float m = 0.f;
  for (int i = threadIdx.x; i < C; i += blockDim.x) m = fmaxf(m, fabsf(to_f(xr[i])));
  const float r = fmaxf(block_max(m, red) / 127.0f, 1e-12f);
  for (int i = threadIdx.x; i < C; i += blockDim.x) q[row * ldq + i] = quant_i8(to_f(xr[i]), r);
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

// ---- the wgmma route --------------------------------------------------------

constexpr int WG_BM = 128, WG_BN = 128;
constexpr int WG_STAGES = 3;          // two blocks an SM
constexpr int WG_STAGES_CHUNKED = 6;  // one block an SM (the chunked c_proj: two accumulator sets)
constexpr int WG_THREADS = 288;                    // two consumer warpgroups and the producer warp
constexpr uint32_t WG_TILE_BYTES = 128 * 128;      // one operand's tile: 128 rows of 128 bytes
constexpr uint32_t WG_STAGE_BYTES = 2 * WG_TILE_BYTES;
// + 1024: the swizzled tiles start at a 1024-byte boundary
constexpr size_t wg_smem(int stages) { return 1024 + (size_t)stages * WG_STAGE_BYTES; }

template <int EPI> constexpr bool epi_is_acc = EPI == EPI_ACC_F32 || EPI == EPI_SCALE_ACC_F32;
template <int EPI> constexpr bool epi_is_f32 = EPI == EPI_BIAS_GELU_F32 || EPI == EPI_BIAS_F32;
template <int EPI> constexpr bool epi_has_res = EPI == EPI_BIAS_RES_BF16 || epi_is_acc<EPI>;

// The product's value before the bias, in gemm_kernel's order of operations.
template <int EPI, typename TAcc>
__device__ __forceinline__ float epi_value(TAcc a, float rs, float cs) {
  if constexpr (std::is_same<TAcc, int>::value) return (float)a * rs * cs;
  else if constexpr (EPI == EPI_SCALE_ACC_F32) return a * cs;
  else return a;
}

// Eight bf16 pairs res + y, each sum rounded once (the bf16 residual add).
__device__ __forceinline__ uint4 add_bf16x8(uint4 res, uint4 y) {
  const uint32_t* r = reinterpret_cast<const uint32_t*>(&res);
  const uint32_t* v = reinterpret_cast<const uint32_t*>(&y);
  uint4 o;
  uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r[i]));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v[i]));
    ow[i] = pack_bf16(a.x + b.x, a.y + b.y);
  }
  return o;
}

// C[M, N] = A[M, K] @ B. tm_a boxes A as [128 rows x 128 bytes of K]. bf16:
// tm_b boxes the [K, N] weight as [64 rows of K x 64 columns]; int8: tm_b
// boxes the [N, K] copy as [128 rows of N x 128 bytes of K].
//
// CHUNKED (int8, EPI_ACC_F32): the whole FF-chunked c_proj of a W8A8 MLP half
// in one launch. K runs over all chunks of ck_steps stages each; A's rows were
// quantized per chunk, so ep.row_scale is [K / ck, M]. At the end of a chunk
// the s32 sums are scaled and added to an f32 accumulator kept in registers,
// in the order the chunk-by-chunk launches of EPI_ACC_F32 add them through
// device memory (first chunk: a = v; then a = a + v), so the bits are the
// same and the f32 accumulator never leaves the SM. Two accumulator sets are
// 128 registers a thread: one block an SM, and a deeper ring instead.
template <typename T, int EPI, bool CHUNKED>
__global__ void __launch_bounds__(WG_THREADS, CHUNKED ? 1 : 2)
gemm_wg_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b, int M, int N,
               int K, int ck_steps, Epi ep) {
  constexpr bool INT8 = std::is_same<T, int8_t>::value;
  static_assert(!CHUNKED || (INT8 && EPI == EPI_ACC_F32), "the chunked GEMM is the int8 c_proj");
  using TAcc = typename std::conditional<INT8, int, float>::type;
  constexpr int BK = 128 / (int)sizeof(T);
  constexpr int WG_STAGES = CHUNKED ? WG_STAGES_CHUNKED : ::WG_STAGES;
  extern __shared__ unsigned char wg_raw[];
  __shared__ __align__(8) uint64_t full_bar[WG_STAGES];   // stage s has landed
  __shared__ __align__(8) uint64_t empty_bar[WG_STAGES];  // stage s has been multiplied
  unsigned char* ring = wg_raw + ((1024 - (smem_u32(wg_raw) & 1023)) & 1023);

  const int wg = threadIdx.x >> 7;
  const int m0 = blockIdx.y * WG_BM, n0 = blockIdx.x * WG_BN;
  const int nk = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], 8);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer -----------------------------------------------------------
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % WG_STAGES;
        mbar_wait(&empty_bar[s], ((kt / WG_STAGES) & 1) ^ 1);
        unsigned char* a = ring + s * WG_STAGE_BYTES;
        unsigned char* b = a + WG_TILE_BYTES;
        mbar_expect_tx(&full_bar[s], WG_STAGE_BYTES);
        tma_load_2d(a, &tm_a, kt * BK, m0, &full_bar[s]);
        if constexpr (INT8) {
          tma_load_2d(b, &tm_b, kt * BK, n0, &full_bar[s]);
        } else {
          tma_load_2d(b, &tm_b, n0, kt * BK, &full_bar[s]);
          tma_load_2d(b + WG_TILE_BYTES / 2, &tm_b, n0 + 64, kt * BK, &full_bar[s]);
        }
      }
    }
  } else {
    // ---- consumers ----------------------------------------------------------
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const int wrow = m0 + wg * 64 + warp * 16;  // the warp's first row of C
    TAcc acc[64];
    float accf[CHUNKED ? 64 : 1];  // CHUNKED: the f32 sum over the chunks so far
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    int rel = 0;  // the next stage to hand back

    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % WG_STAGES;
      mbar_wait(&full_bar[s], (kt / WG_STAGES) & 1);
      const uint32_t a = smem_u32(ring + s * WG_STAGE_BYTES) + wg * (WG_TILE_BYTES / 2);
      const uint32_t b = smem_u32(ring + s * WG_STAGE_BYTES + WG_TILE_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (INT8)
          wgmma_ss_m64n128k32(acc, wgmma_desc_sw128(a + kk * 32), wgmma_desc_sw128(b + kk * 32));
        else  // 16 rows of K are 2048 bytes; the second 64 columns lie 8192 bytes on
          wgmma_ss_m64n128k16<1>(acc, wgmma_desc_sw128(a + kk * 32),
                                 wgmma_desc_sw128_lbo(b + kk * 2048, WG_TILE_BYTES / 2));
      }
      wgmma_commit();
      const bool chunk_end = CHUNKED && (kt + 1) % ck_steps == 0;
      if (chunk_end) wgmma_wait0();
      else wgmma_wait1();  // the group before has finished: its stage is free
      for (const int upto = chunk_end ? kt : kt - 1; rel <= upto; ++rel)
        if (lane == 0) mbar_arrive(&empty_bar[rel % WG_STAGES]);
      if constexpr (CHUNKED) {
        if (chunk_end) {
          wgmma_fence_regs(acc);
          const int c = kt / ck_steps;
          const float* rsc = ep.row_scale + (size_t)c * M;
          const float r0 = wrow + g < M ? rsc[wrow + g] : 0.f, r1 = wrow + g + 8 < M ? rsc[wrow + g + 8] : 0.f;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int col = n0 + 8 * j + 2 * t;
            const float cs0 = col < N ? ep.col_scale[col] : 0.f, cs1 = col + 1 < N ? ep.col_scale[col + 1] : 0.f;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float v = (float)acc[4 * j + e] * (e < 2 ? r0 : r1) * ((e & 1) ? cs1 : cs0);
              accf[4 * j + e] = c == 0 ? v : accf[4 * j + e] + v;
              acc[4 * j + e] = 0;
            }
          }
        }
      }
    }
    wgmma_wait0();
    wgmma_fence_regs(acc);
    // both warpgroups are done with the ring: it now stages the bf16 results
    asm volatile("bar.sync 1, 256;\n" ::: "memory");

    float rs[2] = {1.f, 1.f};
    if constexpr (INT8 && !CHUNKED) {
#pragma unroll
      for (int h = 0; h < 2; ++h) rs[h] = wrow + g + 8 * h < M ? ep.row_scale[wrow + g + 8 * h] : 0.f;
    }
    constexpr bool SCALED = INT8 || EPI == EPI_SCALE_ACC_F32;
    bool f32_out = epi_is_f32<EPI>;
    if constexpr (epi_is_acc<EPI> && !CHUNKED) f32_out = !ep.last;

    if (f32_out) {
      // f32 results leave from the fragments: a quad's four pairs are 32 bytes
      if constexpr (epi_is_f32<EPI> || epi_is_acc<EPI>) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = n0 + 8 * j + 2 * t;
          const bool in0 = c < N, in1 = c + 1 < N;
          float cs0 = 1.f, cs1 = 1.f, b0 = 0.f, b1 = 0.f;
          if constexpr (SCALED) {
            cs0 = in0 ? ep.col_scale[c] : 0.f;
            cs1 = in1 ? ep.col_scale[c + 1] : 0.f;
          }
          if constexpr (epi_is_f32<EPI>) {
            b0 = in0 ? ep.bias[c] : 0.f;
            b1 = in1 ? ep.bias[c + 1] : 0.f;
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wrow + g + 8 * h;
            if (r >= M || !in0) continue;
            float v0 = epi_value<EPI>(acc[4 * j + 2 * h], rs[h], cs0);
            float v1 = epi_value<EPI>(acc[4 * j + 2 * h + 1], rs[h], cs1);
            float* o = ep.out_f32 + (size_t)r * ep.ldo + c;
            if constexpr (EPI == EPI_BIAS_GELU_F32) {
              v0 = quick_gelu(v0 + b0);
              v1 = quick_gelu(v1 + b1);
            } else if constexpr (EPI == EPI_BIAS_F32) {
              v0 = v0 + b0;
              v1 = v1 + b1;
            } else if (!ep.first) {
              if (in1) {
                const float2 p = *reinterpret_cast<const float2*>(o);
                v0 = p.x + v0;
                v1 = p.y + v1;
              } else {
                v0 = o[0] + v0;
              }
            }
            if (in1) *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
            else o[0] = v0;
          }
        }
      }
    } else {
      if constexpr (!epi_is_f32<EPI>) {
        // bf16 results: rounded on the fragments, staged in the warp's 16 rows
        // of 256 bytes (16-byte chunk c of row r at chunk c ^ (r & 7)), then
        // out in 16-byte stores with the residual added on the way
        unsigned char* stg = ring + (wg * 4 + warp) * 4096;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = n0 + 8 * j + 2 * t;
          const bool in0 = c < N, in1 = c + 1 < N;
          float cs0 = 1.f, cs1 = 1.f;
          if constexpr (SCALED && !CHUNKED) {
            cs0 = in0 ? ep.col_scale[c] : 0.f;
            cs1 = in1 ? ep.col_scale[c + 1] : 0.f;
          }
          const float b0 = in0 ? ep.bias[c] : 0.f, b1 = in1 ? ep.bias[c + 1] : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wrow + g + 8 * h;
            float v0, v1;
            if constexpr (CHUNKED) {
              v0 = accf[4 * j + 2 * h];
              v1 = accf[4 * j + 2 * h + 1];
            } else {
              v0 = epi_value<EPI>(acc[4 * j + 2 * h], rs[h], cs0);
              v1 = epi_value<EPI>(acc[4 * j + 2 * h + 1], rs[h], cs1);
            }
            if constexpr (epi_is_acc<EPI> && !CHUNKED) {
              if (!ep.first && r < M && in0) {
                const float* o = ep.out_f32 + (size_t)r * ep.ldo + c;
                v0 = o[0] + v0;
                if (in1) v1 = o[1] + v1;
              }
            }
            if constexpr (EPI == EPI_BIAS_GELU_BF16) {
              v0 = quick_gelu(v0 + b0);
              v1 = quick_gelu(v1 + b1);
            } else {
              v0 = v0 + b0;
              v1 = v1 + b1;
            }
            *reinterpret_cast<uint32_t*>(stg + (g + 8 * h) * 256 + ((j ^ g) * 16) + 4 * t) = pack_bf16(v0, v1);
          }
        }
        __syncwarp();
#pragma unroll
        for (int it = 0; it < 8; ++it) {
          const int rl = 2 * it + (lane >> 4), ch = lane & 15;
          const int r = wrow + rl, c = n0 + ch * 8;
          if (r >= M || c >= N) continue;
          uint4 y = *reinterpret_cast<const uint4*>(stg + rl * 256 + ((ch ^ (rl & 7)) * 16));
          const size_t o = (size_t)r * ep.ldo + c;
          if (c + 8 <= N) {
            if constexpr (epi_has_res<EPI>) y = add_bf16x8(*reinterpret_cast<const uint4*>(ep.res + o), y);
            *reinterpret_cast<uint4*>(ep.out + o) = y;
          } else {
            const bf16* yy = reinterpret_cast<const bf16*>(&y);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              if (c + e >= N) continue;
              if constexpr (epi_has_res<EPI>) ep.out[o + e] = f2bf(to_f(ep.res[o + e]) + to_f(yy[e]));
              else ep.out[o + e] = yy[e];
            }
          }
        }
      }
    }
  }
}

// Tensor maps by (pointer, shape): weights and the allocator's scratch blocks
// repeat from GEMM to GEMM and from call to call, and an encode costs
// microseconds of host time. A map holds addresses and extents only, so an
// entry never goes stale.
using MapKey = std::tuple<const void*, uint64_t, uint64_t, uint64_t, uint32_t, uint32_t, int>;

template <typename Encode>
static int tma_map_lookup(CUtensorMap* tm, const MapKey& key, Encode encode) {
  static std::mutex mu;
  static std::map<MapKey, CUtensorMap> table;
  std::lock_guard<std::mutex> lock(mu);
  auto it = table.find(key);
  if (it == table.end()) {
    CUtensorMap fresh;
    KEMR_TRY(encode(&fresh));
    if (table.size() >= 8192) table.clear();
    it = table.emplace(key, fresh).first;
  }
  *tm = it->second;
  return 0;
}

static int tma_map_cached(CUtensorMap* tm, int elem_bytes, const void* base, uint64_t cols, uint64_t rows,
                          uint64_t row_stride_bytes, uint32_t box_cols, uint32_t box_rows) {
  return tma_map_lookup(tm, MapKey(base, cols, rows, row_stride_bytes, box_cols, box_rows, elem_bytes),
                        [&](CUtensorMap* fresh) {
                          return tma_map_2d(fresh, elem_bytes, base, cols, rows, row_stride_bytes, box_cols, box_rows);
                        });
}

// The attention interior's map of qkv [nseq * S, cols] bf16 as [nseq, S, cols]
// for boxes of 64 columns x box_rows rows x box_seqs sequences (a table of
// its own: the lambda's type keys the template).
static int tma_map_qkv_cached(CUtensorMap* tm, const void* qkv, uint64_t cols, uint64_t S, uint64_t nseq,
                              uint32_t box_rows, uint32_t box_seqs) {
  return tma_map_lookup(tm, MapKey(qkv, cols, S, nseq, box_rows, box_seqs, 2), [&](CUtensorMap* fresh) {
    return tma_map_rows64(fresh, 2, qkv, cols, S, nseq, box_rows, box_seqs);
  });
}

// A [M, K] row-major (lda); B the [K, N] weight (bf16, ldb) or its [N, K]
// copy (int8, ldb).
// ck > 0 (CHUNKED): K is whole chunks of ck, a multiple of 128.
template <typename T, int EPI, bool CHUNKED = false>
static int gemm_wg(const T* A, int lda, const T* B, int ldb, int M, int N, int K, const Epi& ep,
                   cudaStream_t st, int ck = 0) {
  constexpr bool INT8 = std::is_same<T, int8_t>::value;
  constexpr size_t WG_SMEM = wg_smem(CHUNKED ? WG_STAGES_CHUNKED : WG_STAGES);
  auto* kernel = gemm_wg_kernel<T, EPI, CHUNKED>;
  CUtensorMap ta, tb;
  KEMR_TRY(tma_map_cached(&ta, sizeof(T), A, K, M, (uint64_t)lda * sizeof(T), 128 / sizeof(T), WG_BM));
  if constexpr (INT8) KEMR_TRY(tma_map_cached(&tb, 1, B, K, N, ldb, 128, WG_BN));
  else KEMR_TRY(tma_map_cached(&tb, 2, B, N, K, (uint64_t)ldb * 2, 64, 64));
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WG_SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + WG_BN - 1) / WG_BN, (M + WG_BM - 1) / WG_BM);
  kernel<<<grid, WG_THREADS, WG_SMEM, st>>>(ta, tb, M, N, K, ck / 128, ep);
  return (int)cudaGetLastError();
}

// ---- route ------------------------------------------------------------------

// Tests compare the two routes bit for bit: 1 sends every GEMM to gemm_kernel.
static int g_force_wmma = 0;
// GEMMs launched on the wgmma route [0] and on the WMMA route [1], for tests
// that a shape took the route it should (host counters, not synchronized).
static long long g_route_count[2] = {0, 0};

static bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// What the wgmma route needs of one GEMM: operands TMA can describe (16-byte
// aligned bases and row strides) and output rows that take 16-byte stores.
template <typename T>
static bool gemm_takes_wg(const T* A, int lda, const T* Bw, int ldw, const Epi& ep) {
  return !g_force_wmma && Bw != nullptr && aligned16(A) && aligned16(Bw) &&
         ((size_t)lda * sizeof(T)) % 16 == 0 && ((size_t)ldw * sizeof(T)) % 16 == 0 && ep.ldo % 8 == 0 &&
         aligned16(ep.out) && aligned16(ep.res) && aligned16(ep.out_f32);
}

// C = A @ B with the EPI epilogue. B is the [K, N] weight; Bt is its [N, K]
// copy (int8 only: what the wgmma route reads; bf16 passes nullptr). The
// wgmma route is taken when TMA can describe the operands and the output
// rows can be stored in 16-byte pieces; gemm_kernel otherwise.
template <typename T, typename TAcc, int EPI>
static int gemm(const T* A, int lda, const T* B, int ldb, const T* Bt, int ldbt, int M, int N, int K,
                const Epi& ep, cudaStream_t st) {
  constexpr bool INT8 = std::is_same<T, int8_t>::value;
  const T* Bw = INT8 ? Bt : B;
  const int ldw = INT8 ? ldbt : ldb;
  const bool wg = gemm_takes_wg(A, lda, Bw, ldw, ep);
  ++g_route_count[wg ? 0 : 1];
  if (wg) return gemm_wg<T, EPI>(A, lda, Bw, ldw, M, N, K, ep, st);
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

// The interior on the tensor cores (attention_interior.cuh). Where S divides
// 64, a tile holds 64 / S sequences; otherwise one. 1 <= mask_len.
template <bool NOMAX>
static int attention_wg_launch(const bf16* qkv, bf16* out, int N, int W, int heads, int S, int mask_len,
                               int causal, cudaStream_t st) {
  const int nseq = N / S;
  int seq_shift = 6;
  if (S <= 64 && 64 % S == 0)
    for (seq_shift = 0; (1 << seq_shift) < S; ++seq_shift) {}
  const int per_tile = 64 >> seq_shift;
  const int n_qtiles = per_tile > 1 ? 1 : (S + 63) / 64;
  const long long blocks = (long long)n_qtiles * heads * ((nseq + per_tile - 1) / per_tile);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap tm;
  KEMR_TRY(tma_map_qkv_cached(&tm, qkv, 3 * (uint64_t)W, S, nseq, per_tile > 1 ? S : 64, per_tile));
  if (AI_SMEM > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(attention_wg_kernel<NOMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)AI_SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  attention_wg_kernel<NOMAX><<<(unsigned)blocks, AI_THREADS, AI_SMEM, st>>>(
      tm, out, N, W, heads, S, n_qtiles, seq_shift, mask_len < S ? mask_len : S, causal, 0.125f);  // 1 / sqrt(64)
  return (int)cudaGetLastError();
}

// Tests compare the two interiors' routes: 1 sends every call to attention_kernel.
static int g_force_attention_rows = 0;
// Interiors launched on the wgmma route [0] and on attention_kernel [1]
// (host counters, not synchronized).
static long long g_attn_route_count[2] = {0, 0};

// interior: 0 = the production softmax, 1 = S1's no-max-subtract diagnostic.
// The wgmma route is taken by shape and alignment alone: head dim 64 (row
// strides are then multiples of 16 bytes) and 16-byte-aligned buffers, which
// TMA and the 16-byte stores need; a mask_len < 1 (every key hidden: uniform
// weights over all S keys) stays with attention_kernel as well.
static int attention(const bf16* qkv, bf16* out, int N, int W, int heads, int S, int mask_len,
                     int causal, int interior, cudaStream_t st) {
  if (interior != 0 && interior != 1) return (int)cudaErrorInvalidValue;
  const bool wg = !g_force_attention_rows && W == 64 * heads && mask_len >= 1 && aligned16(qkv) && aligned16(out);
  ++g_attn_route_count[wg ? 0 : 1];
  if (wg)
    return interior ? attention_wg_launch<true>(qkv, out, N, W, heads, S, mask_len, causal, st)
                    : attention_wg_launch<false>(qkv, out, N, W, heads, S, mask_len, causal, st);
  return interior ? attention_launch<true>(qkv, out, N, W, heads, S, mask_len, causal, st)
                  : attention_launch<false>(qkv, out, N, W, heads, S, mask_len, causal, st);
}

static int ln_rows(const bf16* x, const float* g, const float* b, int N, int W, float eps,
                   bf16* h, int8_t* q, float* r, cudaStream_t st) {
  ln_rows_kernel<<<N, 256, 0, st>>>(x, g, b, W, eps, h, q, r);
  return (int)cudaGetLastError();
}

template <typename TX>
static int quant_rows(const TX* x, int N, int C, int8_t* q, int ldq, float* r, cudaStream_t st) {
  quant_rows_kernel<TX><<<N, 256, 0, st>>>(x, C, q, ldq, r);
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

// out = x + out_proj_q8(attention(qkv_q8(LN(x)))). wqkv_qt [3W, W] and wo_qt
// [W, W] are the [out, in] copies of the int8 weights. Scratch: hq int8
// [N, W], hr f32 [N], qkv bf16 [N, 3W], attn bf16 [N, W].
static int attn_half_q8(const bf16* x, const float* ln_g, const float* ln_b, const int8_t* wqkv_q,
                        const float* wqkv_s, const float* bqkv, const int8_t* wo_q,
                        const float* wo_s, const float* bo, const int8_t* wqkv_qt,
                        const int8_t* wo_qt, bf16* out, int8_t* hq, float* hr,
                        bf16* qkv, bf16* attn, int N, int W, int heads, int S, int mask_len,
                        int causal, int interior, float eps, cudaStream_t st) {
  KEMR_TRY(ln_rows(x, ln_g, ln_b, N, W, eps, nullptr, hq, hr, st));
  Epi e = epi(bqkv, qkv, 3 * W);
  e.row_scale = hr;
  e.col_scale = wqkv_s;
  KEMR_TRY((gemm<int8_t, int, EPI_BIAS_BF16>(hq, W, wqkv_q, 3 * W, wqkv_qt, W, N, 3 * W, W, e, st)));
  KEMR_TRY(attention(qkv, attn, N, W, heads, S, mask_len, causal, interior, st));
  KEMR_TRY(quant_rows<bf16>(attn, N, W, hq, W, hr, st));
  e = epi(bo, out, W);
  e.row_scale = hr;
  e.col_scale = wo_s;
  e.res = x;
  KEMR_TRY((gemm<int8_t, int, EPI_BIAS_RES_BF16>(hq, W, wo_q, W, wo_qt, W, N, W, W, e, st)));
  return 0;
}

// out = x + c_proj(act(c_fc_q8(LN(x)))), FF-chunked (ck = FF / n_chunks) with
// an f32 accumulator over the chunks. gelu: act is QuickGELU, else identity.
// requant: each chunk of f is requantized per row (fq [N, FF], chunk c in
// columns [c ck, (c + 1) ck); fr [n_chunks, N]) and c_proj is s8 x s8: one
// chunked launch that keeps the f32 accumulator in registers where the wgmma
// route takes the shape, else one launch per chunk accumulating in acc (the
// same additions in the same order: the same bits). Without requant f and
// the int8 c_proj chunk go to bf16 (fbf [N, ck], w2bf [ck, W]) and the
// product is bf16 x bf16 in f32, times w2_s. w1_qt [FF, W] and w2_qt
// [W, FF] are the [out, in] copies of the int8 weights: c_fc chunk c is rows
// [c ck, (c + 1) ck) of w1_qt, c_proj chunk c is columns [c ck, (c + 1) ck)
// of w2_qt (row stride FF). Scratch: hq int8 [N, W], hr f32 [N], fbuf f32
// [N, ck], fq, fr, acc f32 [N, W]; fbf and w2bf only when requant == 0 (fbuf,
// fq and fr only otherwise).
static int mlp_half_q8(const bf16* x, const float* ln_g, const float* ln_b, const int8_t* w1_q,
                       const float* w1_s, const float* b1, const int8_t* w2_q, const float* w2_s,
                       const float* b2, const int8_t* w1_qt, const int8_t* w2_qt, bf16* out,
                       int8_t* hq, float* hr, float* fbuf, int8_t* fq,
                       float* fr, float* acc, bf16* fbf, bf16* w2bf, int N, int W, int FF,
                       int n_chunks, int gelu, int requant, float eps, cudaStream_t st) {
  KEMR_TRY(ln_rows(x, ln_g, ln_b, N, W, eps, nullptr, hq, hr, st));
  const int ck = FF / n_chunks;
  Epi e2{};
  e2.bias = b2;
  e2.col_scale = w2_s;
  e2.res = x;
  e2.out = out;
  e2.out_f32 = acc;
  e2.ldo = W;
  for (int c = 0; c < n_chunks; ++c) {
    Epi e1{};
    e1.bias = b1 + c * ck;
    e1.row_scale = hr;
    e1.col_scale = w1_s + c * ck;
    e1.out_f32 = fbuf;
    e1.out = fbf;
    e1.ldo = ck;
    const int8_t* w1_c = w1_q + c * ck;
    const int8_t* w1t_c = w1_qt + (size_t)c * ck * W;
    if (requant) {
      if (gelu)
        KEMR_TRY((gemm<int8_t, int, EPI_BIAS_GELU_F32>(hq, W, w1_c, FF, w1t_c, W, N, ck, W, e1, st)));
      else
        KEMR_TRY((gemm<int8_t, int, EPI_BIAS_F32>(hq, W, w1_c, FF, w1t_c, W, N, ck, W, e1, st)));
      KEMR_TRY(quant_rows<float>(fbuf, N, ck, fq + c * ck, FF, fr + (size_t)c * N, st));
    } else {
      if (gelu)
        KEMR_TRY((gemm<int8_t, int, EPI_BIAS_GELU_BF16>(hq, W, w1_c, FF, w1t_c, W, N, ck, W, e1, st)));
      else
        KEMR_TRY((gemm<int8_t, int, EPI_BIAS_BF16>(hq, W, w1_c, FF, w1t_c, W, N, ck, W, e1, st)));
      e2.first = c == 0;
      e2.last = c == n_chunks - 1;
      KEMR_TRY(i8_to_bf16(w2_q + (size_t)c * ck * W, w2bf, (size_t)ck * W, st));
      KEMR_TRY((gemm<bf16, float, EPI_SCALE_ACC_F32>(fbf, ck, w2bf, W, nullptr, 0, N, W, ck, e2, st)));
    }
  }
  if (!requant) return 0;
  e2.row_scale = fr;
  if (ck % 128 == 0 && gemm_takes_wg(fq, FF, w2_qt, FF, e2)) {
    ++g_route_count[0];
    e2.first = e2.last = 1;
    return gemm_wg<int8_t, EPI_ACC_F32, true>(fq, FF, w2_qt, FF, N, W, FF, e2, st, ck);
  }
  for (int c = 0; c < n_chunks; ++c) {
    e2.row_scale = fr + (size_t)c * N;
    e2.first = c == 0;
    e2.last = c == n_chunks - 1;
    KEMR_TRY((gemm<int8_t, int, EPI_ACC_F32>(fq + c * ck, FF, w2_q + (size_t)c * ck * W, W, w2_qt + c * ck, FF, N, W,
                                              ck, e2, st)));
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
  KEMR_TRY((gemm<bf16, float, EPI_BIAS_BF16>((const bf16*)h, W, (const bf16*)wqkv, 3 * W, nullptr, 0,
                                              N, 3 * W, W, epi((const float*)bqkv, (bf16*)qkv, 3 * W),
                                              st)));
  KEMR_TRY(attention((const bf16*)qkv, (bf16*)attn, N, W, heads, S, mask_len, causal, 0, st));
  Epi e = epi((const float*)bo, (bf16*)out, W);
  e.res = xb;
  KEMR_TRY((gemm<bf16, float, EPI_BIAS_RES_BF16>((const bf16*)attn, W, (const bf16*)wo, W, nullptr,
                                                  0, N, W, W, e, st)));
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
  KEMR_TRY((gemm<bf16, float, EPI_BIAS_GELU_BF16>((const bf16*)h, W, (const bf16*)w1, FF, nullptr, 0,
                                                   N, FF, W, epi((const float*)b1, (bf16*)f, FF), st)));
  Epi e = epi((const float*)b2, (bf16*)out, W);
  e.res = xb;
  KEMR_TRY((gemm<bf16, float, EPI_BIAS_RES_BF16>((const bf16*)f, FF, (const bf16*)w2, W, nullptr, 0,
                                                  N, W, FF, e, st)));
  return 0;
}

// B1: one whole W8A8 pre-LN layer. The four *_qt pointers are the [out, in]
// copies of the int8 weights (wqkv_qt [3W, W], wo_qt [W, W], w1_qt [FF, W],
// w2_qt [W, FF]). Scratch (wrapper-allocated):
//   hq int8 [N, W], hr f32 [N], qkv bf16 [N, 3W], attn bf16 [N, W],
//   y bf16 [N, W] (after the attention half), fbuf f32 [N, ck],
//   fq int8 [N, FF], fr f32 [n_chunks, N], acc f32 [N, W];  ck = FF / n_chunks.
int kemr_layer_q8(const void* x, const void* ln1_g, const void* ln1_b, const void* wqkv_q,
                  const void* wqkv_s, const void* bqkv, const void* wo_q, const void* wo_s,
                  const void* bo, const void* ln2_g, const void* ln2_b, const void* w1_q,
                  const void* w1_s, const void* b1, const void* w2_q, const void* w2_s,
                  const void* b2, const void* wqkv_qt, const void* wo_qt, const void* w1_qt,
                  const void* w2_qt, void* out, void* hq, void* hr, void* qkv, void* attn, void* y,
                  void* fbuf, void* fq, void* fr, void* acc, int N, int W, int FF, int heads,
                  int S, int mask_len, int n_chunks, int causal, float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  KEMR_TRY(attn_half_q8((const bf16*)x, (const float*)ln1_g, (const float*)ln1_b,
                        (const int8_t*)wqkv_q, (const float*)wqkv_s, (const float*)bqkv,
                        (const int8_t*)wo_q, (const float*)wo_s, (const float*)bo,
                        (const int8_t*)wqkv_qt, (const int8_t*)wo_qt, (bf16*)y, (int8_t*)hq,
                        (float*)hr, (bf16*)qkv, (bf16*)attn, N, W, heads, S, mask_len, causal, 0, eps,
                        st));
  return mlp_half_q8((const bf16*)y, (const float*)ln2_g, (const float*)ln2_b,
                     (const int8_t*)w1_q, (const float*)w1_s, (const float*)b1,
                     (const int8_t*)w2_q, (const float*)w2_s, (const float*)b2,
                     (const int8_t*)w1_qt, (const int8_t*)w2_qt, (bf16*)out, (int8_t*)hq, (float*)hr,
                     (float*)fbuf, (int8_t*)fq, (float*)fr, (float*)acc, nullptr, nullptr, N, W, FF,
                     n_chunks, 1, 1, eps, st);
}

// S1 (and, with interior 0, B4a): the attention half of B1 as its own
// launch. interior 0 = production softmax, 1 = no-max-subtract diagnostic.
int kemr_attention_block_q8_variant(const void* x, const void* ln_g, const void* ln_b,
                                    const void* wqkv_q, const void* wqkv_s, const void* bqkv,
                                    const void* wo_q, const void* wo_s, const void* bo,
                                    const void* wqkv_qt, const void* wo_qt, void* out, void* hq,
                                    void* hr, void* qkv, void* attn, int N, int W, int heads, int S,
                                    int mask_len, int causal, int interior, float eps, void* stream) {
  return attn_half_q8((const bf16*)x, (const float*)ln_g, (const float*)ln_b,
                      (const int8_t*)wqkv_q, (const float*)wqkv_s, (const float*)bqkv,
                      (const int8_t*)wo_q, (const float*)wo_s, (const float*)bo,
                      (const int8_t*)wqkv_qt, (const int8_t*)wo_qt, (bf16*)out, (int8_t*)hq,
                      (float*)hr, (bf16*)qkv, (bf16*)attn, N, W, heads, S, mask_len, causal, interior,
                      eps, (cudaStream_t)stream);
}

// B4a: out = x + out_proj_q8(attention(qkv_q8(LN1(x)))).
int kemr_attention_block_q8(const void* x, const void* ln_g, const void* ln_b, const void* wqkv_q,
                            const void* wqkv_s, const void* bqkv, const void* wo_q,
                            const void* wo_s, const void* bo, const void* wqkv_qt,
                            const void* wo_qt, void* out, void* hq, void* hr, void* qkv, void* attn,
                            int N, int W, int heads, int S, int mask_len, int causal, float eps,
                            void* stream) {
  return kemr_attention_block_q8_variant(x, ln_g, ln_b, wqkv_q, wqkv_s, bqkv, wo_q, wo_s, bo,
                                         wqkv_qt, wo_qt, out, hq, hr, qkv, attn, N, W, heads, S,
                                         mask_len, causal, 0, eps, stream);
}

// S2 (and, with gelu = requant = 1, B4b): the MLP half of B1 as its own
// launch; fbf bf16 [N, ck] and w2bf bf16 [ck, W] are read only when
// requant == 0 (and fbuf, fq, fr only when it is 1).
int kemr_mlp_block_q8_diag(const void* x, const void* ln_g, const void* ln_b, const void* w1_q,
                           const void* w1_s, const void* b1, const void* w2_q, const void* w2_s,
                           const void* b2, const void* w1_qt, const void* w2_qt, void* out, void* hq,
                           void* hr, void* fbuf, void* fq, void* fr, void* acc, void* fbf,
                           void* w2bf, int N, int W, int FF, int n_chunks, int gelu, int requant,
                           float eps, void* stream) {
  return mlp_half_q8((const bf16*)x, (const float*)ln_g, (const float*)ln_b, (const int8_t*)w1_q,
                     (const float*)w1_s, (const float*)b1, (const int8_t*)w2_q,
                     (const float*)w2_s, (const float*)b2, (const int8_t*)w1_qt,
                     (const int8_t*)w2_qt, (bf16*)out, (int8_t*)hq, (float*)hr, (float*)fbuf,
                     (int8_t*)fq, (float*)fr, (float*)acc, (bf16*)fbf, (bf16*)w2bf, N, W, FF, n_chunks,
                     gelu, requant, eps, (cudaStream_t)stream);
}

// B4b: out = x + c_proj_q8(quick_gelu(c_fc_q8(LN2(x)))), per-chunk requant.
int kemr_mlp_block_q8(const void* x, const void* ln_g, const void* ln_b, const void* w1_q,
                      const void* w1_s, const void* b1, const void* w2_q, const void* w2_s,
                      const void* b2, const void* w1_qt, const void* w2_qt, void* out, void* hq,
                      void* hr, void* fbuf, void* fq, void* fr, void* acc, int N, int W, int FF,
                      int n_chunks, float eps, void* stream) {
  return kemr_mlp_block_q8_diag(x, ln_g, ln_b, w1_q, w1_s, b1, w2_q, w2_s, b2, w1_qt, w2_qt, out, hq,
                                hr, fbuf, fq, fr, acc, nullptr, nullptr, N, W, FF, n_chunks, 1, 1,
                                eps, stream);
}

// 1: every GEMM of this file takes gemm_kernel (the WMMA route) whatever its
// shape; 0: the route follows shape and alignment. For comparing the routes.
void kemr_gemm_force_wmma(int on) { g_force_wmma = on; }

// GEMMs launched so far on route 0 (wgmma + TMA) or 1 (WMMA).
long long kemr_gemm_route_count(int route) { return g_route_count[route ? 1 : 0]; }

// 1: every attention interior of this file takes attention_kernel whatever
// its shape; 0: the route follows shape and alignment. For comparing the routes.
void kemr_attention_force_rows(int on) { g_force_attention_rows = on; }

// Interiors launched so far on route 0 (wgmma + TMA) or 1 (attention_kernel).
long long kemr_attention_route_count(int route) { return g_attn_route_count[route ? 1 : 0]; }

// The attention interior alone, for testing it at shapes no layer has: qkv
// [N, 3W] bf16 -> out [N, W] bf16, whole sequences of S rows. interior as in
// kemr_attention_block_q8_variant.
int kemr_attention_interior(const void* qkv, void* out, int N, int W, int heads, int S, int mask_len,
                            int causal, int interior, void* stream) {
  return attention((const bf16*)qkv, (bf16*)out, N, W, heads, S, mask_len, causal, interior,
                   (cudaStream_t)stream);
}

// One GEMM with one epilogue, for testing the GEMM at shapes no layer has.
// a [M, K]; b the [K, N] weight; bt its [N, K] copy (int8) or null (bf16).
// is_int8 picks s8 x s8 -> s32 (row_scale [M], col_scale [N]) or bf16. epi
// is an EPI_* value; first / last as in EPI_ACC_F32.
int kemr_gemm_epilogue(const void* a, const void* b, const void* bt, const void* bias,
                       const void* row_scale, const void* col_scale, const void* res, void* out,
                       void* out_f32, int M, int N, int K, int is_int8, int epi, int first, int last,
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Epi e{};
  e.bias = (const float*)bias;
  e.row_scale = (const float*)row_scale;
  e.col_scale = (const float*)col_scale;
  e.res = (const bf16*)res;
  e.out = (bf16*)out;
  e.out_f32 = (float*)out_f32;
  e.ldo = N;
  e.first = first;
  e.last = last;
#define KEMR_GEMM_CASE(T, TAcc, EPI) \
  case EPI:                          \
    return gemm<T, TAcc, EPI>((const T*)a, K, (const T*)b, N, (const T*)bt, K, M, N, K, e, st)
  if (is_int8) {
    switch (epi) {
      KEMR_GEMM_CASE(int8_t, int, EPI_BIAS_BF16);
      KEMR_GEMM_CASE(int8_t, int, EPI_BIAS_RES_BF16);
      KEMR_GEMM_CASE(int8_t, int, EPI_BIAS_GELU_BF16);
      KEMR_GEMM_CASE(int8_t, int, EPI_BIAS_GELU_F32);
      KEMR_GEMM_CASE(int8_t, int, EPI_ACC_F32);
      KEMR_GEMM_CASE(int8_t, int, EPI_BIAS_F32);
    }
  } else {
    switch (epi) {
      KEMR_GEMM_CASE(bf16, float, EPI_BIAS_BF16);
      KEMR_GEMM_CASE(bf16, float, EPI_BIAS_RES_BF16);
      KEMR_GEMM_CASE(bf16, float, EPI_BIAS_GELU_BF16);
      KEMR_GEMM_CASE(bf16, float, EPI_SCALE_ACC_F32);
    }
  }
#undef KEMR_GEMM_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
