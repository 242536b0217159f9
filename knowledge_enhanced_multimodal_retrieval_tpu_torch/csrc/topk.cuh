// Top-k selection shared by the scan kernels (B2 in similarity.cu, B5 in
// pq.cu). Order everywhere: value descending, then corpus row ascending;
// scores that are pad rows or NaN arrive as float32 min, and a query with
// fewer than k finite scores is filled with (float32 min, row 0), as the TPU
// merge produces.
//
// Two selections feed one merge:
// - B2 walks a strip of the corpus tile by tile and carries each query's
//   running k best as a sorted list in shared memory. A score is looked at
//   only if it beats the list's k-th value (rows arrive in ascending order
//   in a strip, so an equal score that comes later cannot win); the
//   survivors of a tile are merged in by rank in one pass (fold_tile,
//   fold_block). Each block writes its lists to the candidate buffer
//   [Q, n_strips, k].
// - B5 scores one tile per block and select_tile_topk writes the tile's k
//   best per query ([Q, n_tiles, k]) with k rounds of a warp arg-max.
// kemr_topk_merge (defined in similarity.cu) then picks the final k of a
// query's candidates.
#pragma once

#include "common.cuh"

#include <climits>

// (va, ia) ranks above (vb, ib): larger value, then lower row.
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// Unused slots of a running list: below every real score, above no row.
constexpr int TOPK_NO_ROW = INT_MAX;

// One warp folds one tile's scores for two queries into their running lists,
// the two folds interleaved instruction by instruction: a fold is a chain of
// dependent shared-memory round trips, and a block has too few warps to hide
// them otherwise. Per query z: sc[z] holds the scores of corpus rows n0 ..
// n0 + TILE - 1 (pad and NaN already float32 min) and is overwritten;
// lv[z] / lr[z] [k] is the list in shared memory, sorted, fillers (float32
// min, TOPK_NO_ROW) at its end; rows[z] [TILE] is scratch.
// A score is looked at only if it beats the list's k-th value as it stood
// before the tile: one load, one compare and one ballot per 32 scores when
// nothing does. The survivors (tens per query over a strip of a few tiles,
// all 128 of its first tile) are merged in by rank, all at once:
// - crowded tiles, k <= 32: the k-th largest of the 32 lanes' maxima has k
//   scores at or above it, so the tile's k best all are, and whatever lies
//   below it is dropped first;
// - the survivors are packed to the front of sc (values) and rows (offsets
//   in the tile) in row order, by a prefix count of the ballots;
// - lane l owns survivors l, l + 32, ..., and list entry 32 w + l in register
//   slot w (KPL = ceil(k / 32) slots). Every lane reads the survivors back one
//   by one, a broadcast load each and no shuffle or vote in the loop: an
//   entry counts the survivors that outrank it, a survivor the survivors and
//   the list entries that outrank it, and each writes itself to its new
//   place if that is below k.
// Scores arrive in ascending row order, so between a survivor and a list
// entry of the same value the entry ranks first, and between two survivors
// the earlier one.
template <int TILE, int KPL>
__device__ __forceinline__ void fold_tile(float* const (&sc)[2], unsigned char* const (&rows)[2], int n0,
                                          float* const (&lv)[2], int* const (&lr)[2], int k) {
  constexpr int PER_LANE = TILE / 32, Z = 2;
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  float kth[Z], s[Z][PER_LANE];
  unsigned word[Z][PER_LANE], any = 0;
  int crowd = 0;
#pragma unroll
  for (int z = 0; z < Z; ++z) kth[z] = lv[z][k - 1];
#pragma unroll
  for (int z = 0; z < Z; ++z) {
    int c = 0;
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u) {
      s[z][u] = sc[z][lane + 32 * u];
      word[z][u] = __ballot_sync(FULL, s[z][u] > kth[z]);
      any |= word[z][u];
      c += __popc(word[z][u]);
    }
    crowd = max(crowd, c);
  }
  if (any == 0) return;

  if (k <= 32 && crowd > 48) {
    float mx[Z];
    int rank[Z];  // lanes whose maximum outranks this lane's
#pragma unroll
    for (int z = 0; z < Z; ++z) {
      mx[z] = s[z][0];
#pragma unroll
      for (int u = 1; u < PER_LANE; ++u) mx[z] = fmaxf(mx[z], s[z][u]);
      rank[z] = 0;
    }
#pragma unroll
    for (int o = 1; o < 32; ++o) {
      const int src = (lane + o) & 31;
#pragma unroll
      for (int z = 0; z < Z; ++z) {
        const float other = __shfl_sync(FULL, mx[z], src);
        rank[z] += (int)(other > mx[z]) | ((int)(other == mx[z]) & (int)(src < lane));
      }
    }
#pragma unroll
    for (int z = 0; z < Z; ++z) {
      const unsigned at = __ballot_sync(FULL, rank[z] == k - 1);
      const float floor_v = __shfl_sync(FULL, mx[z], __ffs(at) - 1);
#pragma unroll
      for (int u = 0; u < PER_LANE; ++u) word[z][u] = __ballot_sync(FULL, s[z][u] > kth[z] && s[z][u] >= floor_v);
    }
  }

  // pack the survivors (value, row offset in the tile) in row order
  int n[Z];
  __syncwarp();  // every lane has read its scores
#pragma unroll
  for (int z = 0; z < Z; ++z) {
    n[z] = 0;
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u) {
      if ((word[z][u] >> lane) & 1u) {
        const int at_u = n[z] + __popc(word[z][u] & ((1u << lane) - 1u));
        sc[z][at_u] = s[z][u];
        rows[z][at_u] = (unsigned char)(32 * u + lane);
      }
      n[z] += __popc(word[z][u]);
    }
  }
  float ev[Z][KPL];
  int er[Z][KPL], shift[Z][KPL];
#pragma unroll
  for (int z = 0; z < Z; ++z)
#pragma unroll
    for (int w = 0; w < KPL; ++w) {
      const int i = 32 * w + lane;
      ev[z][w] = i < k ? lv[z][i] : -INFINITY;
      er[z][w] = i < k ? lr[z][i] : TOPK_NO_ROW;
      shift[z][w] = 0;
    }
  __syncwarp();  // the survivors are packed
  // mv: the survivors this lane owns; above: the list entries and survivors that outrank each
  float mv[Z][PER_LANE];
  int above[Z][PER_LANE];
#pragma unroll
  for (int z = 0; z < Z; ++z)
#pragma unroll
    for (int c = 0; c < PER_LANE; ++c) {
      mv[z][c] = lane + 32 * c < n[z] ? sc[z][lane + 32 * c] : INFINITY;
      above[z][c] = 0;
    }
  const int n_max = max(n[0], n[1]);
  if (n_max <= 32) {  // the common case: one survivor a lane
#pragma unroll 4
    for (int i = 0; i < k; ++i)
#pragma unroll
      for (int z = 0; z < Z; ++z) above[z][0] += (int)(lv[z][i] >= mv[z][0]);
#pragma unroll 4
    for (int j = 0; j < n_max; ++j)
#pragma unroll
      for (int z = 0; z < Z; ++z) {
        const float v = j < n[z] ? sc[z][j] : -INFINITY;  // past the survivors: outranks nothing
#pragma unroll
        for (int w = 0; w < KPL; ++w) shift[z][w] += (int)(v > ev[z][w]);
        above[z][0] += (int)(v > mv[z][0]) | ((int)(v == mv[z][0]) & (int)(j < lane));
      }
  } else {
#pragma unroll 2
    for (int i = 0; i < k; ++i)
#pragma unroll
      for (int z = 0; z < Z; ++z) {
        const float e = lv[z][i];
#pragma unroll
        for (int c = 0; c < PER_LANE; ++c) above[z][c] += (int)(e >= mv[z][c]);
      }
#pragma unroll 2
    for (int j = 0; j < n_max; ++j)
#pragma unroll
      for (int z = 0; z < Z; ++z) {
        const float v = j < n[z] ? sc[z][j] : -INFINITY;
#pragma unroll
        for (int w = 0; w < KPL; ++w) shift[z][w] += (int)(v > ev[z][w]);
#pragma unroll
        for (int c = 0; c < PER_LANE; ++c)
          above[z][c] += (int)(v > mv[z][c]) | ((int)(v == mv[z][c]) & (int)(j < lane + 32 * c));
      }
  }
  __syncwarp();  // the lists have been read
#pragma unroll
  for (int z = 0; z < Z; ++z) {
#pragma unroll
    for (int w = 0; w < KPL; ++w) {
      const int i = 32 * w + lane + shift[z][w];
      if (shift[z][w] > 0 && i < k) {  // i < k: the entry was a real slot and stays in the list
        lv[z][i] = ev[z][w];
        lr[z][i] = er[z][w];
      }
    }
#pragma unroll
    for (int c = 0; c < PER_LANE; ++c)
      if (lane + 32 * c < n[z] && above[z][c] < k) {
        lv[z][above[z][c]] = mv[z][c];
        lr[z][above[z][c]] = n0 + rows[z][lane + 32 * c];
      }
  }
  __syncwarp();
}

// A block folds the score tile sc [n_queries][ld] (an even count; queries
// past the last score float32 min throughout) into the lists lv / lr
// [n_queries][k]: each warp takes pairs of queries. rows: [warps][2][TILE]
// bytes of scratch.
template <int TILE>
__device__ __forceinline__ void fold_block(float* sc, int ld, int n_queries, unsigned char* rows, int n0,
                                           float* lv, int* lr, int k) {
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  unsigned char* const rz[2] = {rows + (2 * warp) * TILE, rows + (2 * warp + 1) * TILE};
  for (int qa = warp; qa < n_queries / 2; qa += nw) {
    const int qb = qa + n_queries / 2;
    float* const scz[2] = {sc + qa * ld, sc + qb * ld};
    float* const lvz[2] = {lv + qa * k, lv + qb * k};
    int* const lrz[2] = {lr + qa * k, lr + qb * k};
    if (k <= 32) fold_tile<TILE, 1>(scz, rz, n0, lvz, lrz, k);
    else if (k <= 64) fold_tile<TILE, 2>(scz, rz, n0, lvz, lrz, k);
    else fold_tile<TILE, 4>(scz, rz, n0, lvz, lrz, k);
  }
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

// Final k per query from cand_v / cand_i [Q, M] (M = lists per query * k),
// written to out_v / out_i [Q, k]. Overwrites taken candidates in cand_v.
int kemr_topk_merge(float* cand_v, const int* cand_i, int Q, int M, int k, float* out_v,
                    int* out_i, cudaStream_t st);
