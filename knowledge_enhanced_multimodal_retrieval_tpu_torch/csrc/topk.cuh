// Top-k selection shared by the scan kernels (B2 in similarity.cu, B5 in
// pq.cu). Order everywhere: value descending, then corpus row ascending;
// scores that are pad rows or NaN arrive as float32 min, and a query with
// fewer than k finite scores is filled with (float32 min, row 0), as the TPU
// merge produces.
//
// A scan block walks a strip of the corpus tile by tile and carries each
// query's running k best as a sorted list. A score is looked at only if it
// beats the list's k-th value (rows arrive in ascending order in a strip, so
// an equal score that comes later cannot win); the survivors of a tile are
// merged in by rank in one pass (fold_tile, fold_tile_wide, fold_block).
// Lists that fit beside the kernel's tiles live in shared memory and go out
// to the candidate buffer [Q, n_strips, k] at the strip's end (B2 up to
// TOPK_SMEM_K, B5 at every k); the others live in the block's own slice of
// that buffer in device memory from the start. kemr_topk_merge (defined in similarity.cu) then picks the final k of
// a query's n_strips lists. A k above TOPK_KL runs as passes of at most
// TOPK_KL each: a pass after the first is given a per-query ceiling (the last
// (value, row) of the pass before), and the scan drops every score that ranks
// at or above it (excluded()).
#pragma once

#include "common.cuh"

#include <climits>

// (va, ia) ranks above (vb, ib): larger value, then lower row.
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// Unused slots of a running list: below every real score, above no row.
constexpr int TOPK_NO_ROW = INT_MAX;
// Lists up to this k stay in shared memory; the largest k of one pass.
constexpr int TOPK_SMEM_K = 128;
constexpr int TOPK_KL = 512;

// Score s of corpus row n is taken by an earlier pass: it ranks at or above
// query q's ceiling (cv, cr are null in a first pass). Passes carry more than
// 256 rows each, so only the wide kernels check it.
__device__ __forceinline__ bool excluded(float s, int n, const float* cv, const int* cr, int q) {
  return cv != nullptr && !better(cv[q], cr[q], s, n);
}

// Running lists start as fillers: n_queries lists of k, lds elements apart.
__device__ __forceinline__ void lists_init(float* lv, int* lr, int n_queries, int lds, int k) {
  for (int e = threadIdx.x; e < n_queries * k; e += blockDim.x) {
    lv[(e / k) * lds + e % k] = -FLT_MAX;
    lr[(e / k) * lds + e % k] = TOPK_NO_ROW;
  }
}

// Where a block's running lists live: shared memory at `at` (lds = k), or
// its own slice of the candidate buffer [Q rounded up to the query block,
// n_strips, k] (lds = n_strips * k).
struct Lists {
  float* v;
  int* r;
  int lds;
  bool smem;
};
template <bool IN_SMEM>
__device__ __forceinline__ Lists block_lists(void* at, int nq, int k, int q0, int strip, int n_strips,
                                             float* cand_v, int* cand_i) {
  if constexpr (IN_SMEM) {
    float* v = reinterpret_cast<float*>(at);
    return {v, reinterpret_cast<int*>(v + nq * k), k, true};
  }
  const size_t o = ((size_t)q0 * n_strips + strip) * k;
  return {cand_v + o, cand_i + o, n_strips * k, false};
}

// Shared-memory lists [n_queries][k] out to the candidate buffer [Q, n_strips, k].
__device__ __forceinline__ void lists_store(const float* lv, const int* lr, int n_queries, int q0, int Q,
                                            int k, int strip, int n_strips, float* __restrict__ cand_v,
                                            int* __restrict__ cand_i) {
  for (int e = threadIdx.x; e < n_queries * k; e += blockDim.x) {
    const int q = q0 + e / k;
    if (q >= Q) continue;
    const size_t o = ((size_t)q * n_strips + strip) * k + e % k;
    cand_v[o] = lv[e];
    cand_i[o] = lr[e];
  }
}

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

// The length of the prefix of [0, len) on which pred holds (pred is true on a
// prefix and false after it), found in power-of-two steps from STEP (a power
// of two, 2 STEP > len) down: no data-dependent branch, so independent
// searches overlap.
template <int STEP, typename Pred>
__device__ __forceinline__ int prefix_len(int len, Pred pred) {
  int lo = 0;
#pragma unroll
  for (int step = STEP; step > 0; step >>= 1)
    if (lo + step <= len && pred(lo + step - 1)) lo += step;
  return lo;
}

// Bitonic sort of the 32 C elements e = lane + 32 c (c < C) held by a warp:
// value descending, then row ascending; equal pairs (the (-inf, no row)
// padding) never swap.
template <int C>
__device__ __forceinline__ void warp_sort(float (&v)[C], int (&r)[C]) {
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32 * C; size <<= 1) {
#pragma unroll
    for (int d = size >> 1; d > 0; d >>= 1) {
      if (d >= 32) {  // partners in one lane: slots c and c + d / 32
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int c2 = c ^ (d >> 5), e = lane + 32 * c;
          if (c2 < c) continue;
          const bool up = (e & size) == 0;  // this run sorts best first
          if (better(v[c2], r[c2], v[c], r[c]) == up) {
            const float tv = v[c];
            const int tr = r[c];
            v[c] = v[c2];
            r[c] = r[c2];
            v[c2] = tv;
            r[c2] = tr;
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int e = lane + 32 * c;
          const float pv = __shfl_xor_sync(FULL, v[c], d);
          const int pr = __shfl_xor_sync(FULL, r[c], d);
          const bool keep_better = ((e & d) == 0) == ((e & size) == 0);
          if (keep_better ? better(pv, pr, v[c], r[c]) : better(v[c], r[c], pv, pr)) {
            v[c] = pv;
            r[c] = pr;
          }
        }
      }
    }
  }
}

// Survivors packed at sc[0, n) / rows[0, n) into the warp's slots (element e
// = lane + 32 c: v, r), sorted over the fewest 32 C >= n elements.
template <int PER_LANE>
__device__ __forceinline__ void sort_survivors(const float* sc, const unsigned char* rows, int n,
                                               float (&v)[PER_LANE], int (&r)[PER_LANE]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < PER_LANE; ++c) {
    const int e = lane + 32 * c;
    v[c] = e < n ? sc[e] : -INFINITY;
    r[c] = e < n ? (int)rows[e] : TOPK_NO_ROW;
  }
  if (n <= 32) {
    float v1[1] = {v[0]};
    int r1[1] = {r[0]};
    warp_sort<1>(v1, r1);
    v[0] = v1[0];
    r[0] = r1[0];
  } else if (PER_LANE >= 2 && n <= 64) {
    float v2[2] = {v[0], v[PER_LANE > 1 ? 1 : 0]};
    int r2[2] = {r[0], r[PER_LANE > 1 ? 1 : 0]};
    warp_sort<2>(v2, r2);
#pragma unroll
    for (int c = 0; c < 2 && c < PER_LANE; ++c) {
      v[c] = v2[c];
      r[c] = r2[c];
    }
  } else {
    warp_sort<PER_LANE>(v, r);
  }
}

// The same for one query and a long list (k > TOPK_SMEM_K), in shared or
// device memory. The tile's survivors are packed as in fold_tile, sorted
// (value descending, row ascending) by a bitonic sort over the warp
// (sort_survivors) and written back to the front of sc / rows. A
// survivor's place is its index plus the list entries at or above its
// value (a binary search: the list is sorted and its rows precede the
// tile's); a list entry moves down by the survivors above its value (a
// binary search in the sorted survivors), chunk by chunk from the list's
// end: an entry only ever moves to a higher slot, and slots below the chunks
// being moved are read later. Entries at or above the best survivor stay,
// and fillers are not moved (the slots they would reach hold fillers or are
// overwritten).
template <int TILE>
__device__ __forceinline__ void fold_tile_wide(float* sc, unsigned char* rows, int n0, float* lv, int* lr, int k) {
  constexpr int PER_LANE = TILE / 32;
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const float kth = lv[k - 1];
  float v[PER_LANE];  // element e = lane + 32 c: the tile's scores, then the sorted survivors
  int r[PER_LANE];
  unsigned word[PER_LANE], any = 0;
#pragma unroll
  for (int c = 0; c < PER_LANE; ++c) {
    v[c] = sc[lane + 32 * c];
    word[c] = __ballot_sync(FULL, v[c] > kth);
    any |= word[c];
  }
  if (any == 0) return;
  int n = 0;
  __syncwarp();  // every lane has read its scores
#pragma unroll
  for (int c = 0; c < PER_LANE; ++c) {
    if ((word[c] >> lane) & 1u) {
      const int at = n + __popc(word[c] & ((1u << lane) - 1u));
      sc[at] = v[c];
      rows[at] = (unsigned char)(32 * c + lane);
    }
    n += __popc(word[c]);
  }
  __syncwarp();  // the survivors are packed
  sort_survivors<PER_LANE>(sc, rows, n, v, r);
  __syncwarp();  // every lane has read the packed survivors
  int above[PER_LANE];
#pragma unroll
  for (int c = 0; c < PER_LANE; ++c) {
    const int e = lane + 32 * c;
    if (e < n) {
      sc[e] = v[c];
      rows[e] = (unsigned char)r[c];
    }
    const float x = v[c];  // its place: the list entries with a value >= x, then the survivors before it
    above[c] = e + prefix_len<TOPK_KL>(e < n ? k : 0, [&](int i) { return lv[i] >= x; });
  }
  __syncwarp();  // the survivors are sorted in sc
  // Entries at or above the best survivor stay, fillers need not move: the chunks from the
  // one that holds the first entry below the best survivor to the last real one move, four
  // at a time from the end, each four read and searched together before any is written.
  const float best = sc[0];
  const int first = prefix_len<TOPK_KL>(k, [&](int i) { return lv[i] >= best; });
  const int real = prefix_len<TOPK_KL>(k, [&](int i) { return lr[i] != TOPK_NO_ROW; });
  constexpr int GROUP = 4;
  for (int hi = (real + 31) / 32; hi > first / 32; hi -= GROUP) {
    float ev[GROUP];
    int er[GROUP], shift[GROUP];
#pragma unroll
    for (int t = 0; t < GROUP; ++t) {
      const int i = 32 * (hi - 1 - t) + lane;
      const bool in = hi - 1 - t >= first / 32 && i < real;
      ev[t] = in ? lv[i] : -FLT_MAX;
      er[t] = in ? lr[i] : TOPK_NO_ROW;
      shift[t] = 0;
    }
#pragma unroll
    for (int step = TILE; step > 0; step >>= 1)
#pragma unroll
      for (int t = 0; t < GROUP; ++t)
        if (er[t] != TOPK_NO_ROW && shift[t] + step <= n && sc[shift[t] + step - 1] > ev[t]) shift[t] += step;
    __syncwarp();  // the four chunks have been read
#pragma unroll
    for (int t = 0; t < GROUP; ++t) {
      const int i = 32 * (hi - 1 - t) + lane;
      if (shift[t] > 0 && i + shift[t] < k) {
        lv[i + shift[t]] = ev[t];
        lr[i + shift[t]] = er[t];
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int c = 0; c < PER_LANE; ++c)
    if (lane + 32 * c < n && above[c] < k) {
      lv[above[c]] = v[c];
      lr[above[c]] = n0 + r[c];
    }
  __syncwarp();
}

// A block folds the score tile sc [n_queries][ld] (an even count; queries
// past the last score float32 min throughout) into the lists lv / lr (query
// q's list of k at q * lds): each warp takes pairs of queries (WIDE false,
// k <= TOPK_SMEM_K) or one query at a time (WIDE, k above it; a kernel that
// never takes a large k leaves the wide fold's code out). rows:
// [warps][2][TILE] bytes of scratch. A warp keeps the same queries from call
// to call, so consecutive calls need no barrier.
template <int TILE, bool WIDE>
__device__ __forceinline__ void fold_block(float* sc, int ld, int n_queries, unsigned char* rows, int n0,
                                           float* lv, int* lr, int lds, int k) {
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  unsigned char* const rz[2] = {rows + (2 * warp) * TILE, rows + (2 * warp + 1) * TILE};
  if constexpr (WIDE) {
    for (int q = warp; q < n_queries; q += nw) fold_tile_wide<TILE>(sc + q * ld, rz[0], n0, lv + q * lds, lr + q * lds, k);
    return;
  }
  for (int qa = warp; qa < n_queries / 2; qa += nw) {
    const int qb = qa + n_queries / 2;
    float* const scz[2] = {sc + qa * ld, sc + qb * ld};
    float* const lvz[2] = {lv + qa * lds, lv + qb * lds};
    int* const lrz[2] = {lr + qa * lds, lr + qb * lds};
    if (k <= 32) fold_tile<TILE, 1>(scz, rz, n0, lvz, lrz, k);
    else if (k <= 64) fold_tile<TILE, 2>(scz, rz, n0, lvz, lrz, k);
    else fold_tile<TILE, 4>(scz, rz, n0, lvz, lrz, k);
  }
}

// Final k per query from the n_lists sorted lists of k per query in cand_v /
// cand_i [Q, n_lists, k], written to out_v / out_i [Q, k]. k <= TOPK_SMEM_K:
// k rounds of a block arg-max (overwrites taken candidates in cand_v); above
// it: pairwise merges of the sorted lists, ping-ponging between cand and
// scratch ([Q, ceil(n_lists / 2), k] each).
int kemr_topk_merge(float* cand_v, int* cand_i, int Q, int n_lists, int k, float* scratch_v, int* scratch_i,
                    float* out_v, int* out_i, cudaStream_t st);
