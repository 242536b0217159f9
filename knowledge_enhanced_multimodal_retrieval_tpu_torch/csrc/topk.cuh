// Top-k selection shared by the scan kernels (B2 in similarity.cu, B5 in
// pq.cu). A scan block scores one tile of corpus rows for a group of
// queries into shared memory, then select_tile_topk writes each query's k
// best of the tile to the candidate buffer [Q, n_tiles, k]; the merge
// kernel (kemr_topk_merge, defined in similarity.cu) then picks the final k
// of n_tiles * k candidates per query. Order everywhere: value descending,
// then corpus row ascending; scores that are pad rows or NaN arrive as
// float32 min, and a query with fewer than k finite scores is filled with
// (float32 min, row 0), as the TPU merge produces.
#pragma once

#include "common.cuh"

#include <climits>

// (va, ia) ranks above (vb, ib): larger value, then lower row.
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// Per query of the group (one warp per query): k rounds of a warp argmax
// over the tile's TILE scores sc[g * TILE + r] (rows n0 + r).
template <int TILE>
__device__ __forceinline__ void select_tile_topk(const float* sc, int n_queries, int q0, int Q,
                                                 int n0, int tile, int n_tiles, int k,
                                                 float* __restrict__ cand_v,
                                                 int* __restrict__ cand_i) {
  constexpr int PER_LANE = TILE / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int g = warp; g < n_queries; g += nw) {
    const int q = q0 + g;
    if (q >= Q) continue;
    float v[PER_LANE];
    int id[PER_LANE];
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) {
      v[t] = sc[g * TILE + lane + 32 * t];
      id[t] = n0 + lane + 32 * t;
    }
    float* ov = cand_v + ((size_t)q * n_tiles + tile) * k;
    int* oi = cand_i + ((size_t)q * n_tiles + tile) * k;
    for (int round = 0; round < k; ++round) {
      float bv = -INFINITY;
      int bi = INT_MAX;
#pragma unroll
      for (int t = 0; t < PER_LANE; ++t)
        if (better(v[t], id[t], bv, bi)) {
          bv = v[t];
          bi = id[t];
        }
      for (int o = 16; o > 0; o >>= 1) {
        const float ov2 = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi2 = __shfl_xor_sync(0xffffffffu, bi, o);
        if (better(ov2, oi2, bv, bi)) {
          bv = ov2;
          bi = oi2;
        }
      }
      if (lane == 0) {
        ov[round] = bv;
        oi[round] = bi;
      }
#pragma unroll
      for (int t = 0; t < PER_LANE; ++t)
        if (id[t] == bi) v[t] = -INFINITY;  // taken (below every real score)
    }
  }
}

// Final k per query from cand_v / cand_i [Q, M] (M = n_tiles * k), written
// to out_v / out_i [Q, k]. Overwrites taken candidates in cand_v.
int kemr_topk_merge(float* cand_v, const int* cand_i, int Q, int M, int k, float* out_v,
                    int* out_i, cudaStream_t st);
