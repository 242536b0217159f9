// Exact f32 rescore of fetched candidate rows — the host half of the
// two-tier rerank (ops/similarity.py::rerank_scores_host semantics).
//
// NumPy's vectorized form materializes a [Q, R, D] gather (tens of MB per
// tower) before the einsum; this kernel streams each candidate row once
// with no temporaries: out[q, r] = a_q * <query_q, image[idx]> +
// (1 - a_q) * <query_q, text[idx]>. Invalid rows (idx < 0 — the ANN
// sentinel — or idx >= N) score -inf so the caller's sort drops them.
// ctypes releases the GIL around the call, so server threads rescore
// concurrently on real multi-core hosts.
//
// No reference counterpart (the reference has no rerank tier at all).

#include <cstdint>
#include <limits>

extern "C" {

void rerank_scores(const float* queries,  // [Q, D] row-major
                   const float* image,    // [N, D]
                   const float* text,     // [N, D]
                   const int32_t* idx,    // [Q, R]
                   const float* alpha,    // [Q]
                   float* out,            // [Q, R]
                   int64_t Q, int64_t R, int64_t D, int64_t N) {
  const float neg_inf = -std::numeric_limits<float>::infinity();
  for (int64_t q = 0; q < Q; ++q) {
    const float* qv = queries + q * D;
    const float a = alpha[q];
    const float b = 1.0f - a;
    for (int64_t r = 0; r < R; ++r) {
      const int64_t row = idx[q * R + r];
      if (row < 0 || row >= N) {
        out[q * R + r] = neg_inf;
        continue;
      }
      const float* iv = image + row * D;
      const float* tv = text + row * D;
      float si = 0.0f, st = 0.0f;
      // one fused pass over both towers: qv stays hot in L1, each corpus
      // row is touched exactly once (gcc -O3 auto-vectorizes this loop)
      for (int64_t d = 0; d < D; ++d) {
        si += qv[d] * iv[d];
        st += qv[d] * tv[d];
      }
      out[q * R + r] = a * si + b * st;
    }
  }
}

}  // extern "C"
