"""Product-quantized corpus: codebook codes, the decode path and the ADC scan.

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/ops/pq.py``.
Each embedding row splits into ``M`` subvectors; each subvector is replaced
by the index of its nearest centroid in a per-subspace codebook (classic
product quantization), and the row's norm rides as an f32 scale (a zero pad
row packs to scale 0 and scores exactly 0).

- **Host side (NumPy), the JAX package's code bit for bit:** codebook
  training (plain Lloyd, anisotropic / score-aware, OPQ rotation) and the
  encoders. The JAX module imports ``jax`` at the top, so the port keeps
  its own copies.
- **Scoring.** :func:`pq_similarity_topk` routes by device: a CUDA tensor
  runs the ADC kernel B5 (``csrc/pq.cu``) at every k (up to 512 rows a
  pass, passes above that, as B2 does: ``similarity.topk_passes``); CPU
  tensors the decode-and-matmul path (:func:`pq_similarity_topk_xla`),
  which is what the JAX package runs off the TPU. The TPU kernel's caps
  (k <= 64 on the chip, 128 in :func:`fused_pq_topk`) were VMEM artifacts;
  :func:`fused_pq_topk` keeps the JAX refusal above 128, and the router
  calls the kernel's wrapper directly. Filtered search
  (:func:`masked_pq_similarity_topk`) takes the decode path on every
  device, as the JAX package does.
- **Sharded.** :func:`sharded_pq_similarity_topk` and
  :func:`sharded_masked_pq_similarity_topk` scan a row-sharded code corpus
  shard by shard (B5 on each CUDA shard; the codebooks replicate) and merge
  the winners (``similarity.sharded_scan``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import dispatch
from .dispatch import I, P
from .similarity import (
    _masked_topk_from_scores,
    _merge_shard_winners,
    _ptr,
    _segmented_topk_from_scores,
    _sm_count,
    alpha_column,
    random_rotation,
    scan_scratch,
    scan_strips,
    sharded_masked_topk,
    sharded_scan,
    topk_passes,
    topk_plain,
)

# corpus rows reconstructed per scoring step of the decode path
_DECODE_CHUNK = 4096
_FUSED_K_CAP = 128  # fused_pq_topk's refusal, the JAX package's
_PQ_QUERY_GROUP = 16  # queries per block of B5 (csrc/pq.cu PQ_QG)
_PQ_TILE = 1024  # corpus rows per tile of B5 (PQ_T)


def train_pq_codebooks(
    rows,
    m: int,
    k: int = 256,
    iters: int = 12,
    seed: int = 0,
    train_rows: int = 8192,
) -> np.ndarray:
    """Host k-means per subspace: ``[N, D] -> codebooks [M, K, ds]`` f32.

    Rows are treated as DIRECTIONS (callers pass L2-normalized embeddings;
    zero rows are dropped from training). Each of the ``m`` subspaces of
    width ``ds = D/m`` gets an independent ``k``-centroid Lloyd fit on (a
    ``train_rows`` subsample of) the corpus — per-subspace problems are tiny
    ([train_rows, ds] with ds ~ 8), so host BLAS handles production corpora
    in seconds. Deterministic per seed. ``k`` clamps to the available
    training rows and must stay <= 256 (codes are uint8).
    """
    rows = np.asarray(rows, np.float32)
    n, d = rows.shape
    if d % m:
        raise ValueError(f"pq subspaces m={m} must divide the embedding dim {d}")
    if k > 256:
        raise ValueError(f"pq codebook size k={k} exceeds uint8 codes (max 256)")
    live = rows[np.linalg.norm(rows, axis=1) > 0]
    if live.shape[0] == 0:
        raise ValueError("cannot train pq codebooks on an all-zero corpus")
    rng = np.random.default_rng(np.uint64(seed) + 0x9C)
    if live.shape[0] > train_rows:
        live = live[rng.choice(live.shape[0], train_rows, replace=False)]
    k = min(k, live.shape[0])
    ds = d // m
    sub = live.reshape(live.shape[0], m, ds)  # [N, M, ds]
    codebooks = np.empty((m, k, ds), np.float32)
    for j in range(m):
        x = sub[:, j, :]  # [N, ds]
        cent = x[rng.choice(x.shape[0], k, replace=False)].copy()
        for _ in range(iters):
            # argmin ||x - c||^2 == argmax (x.c - 0.5 ||c||^2)
            aff = x @ cent.T - 0.5 * np.sum(cent * cent, axis=1)[None, :]
            assign = np.argmax(aff, axis=1)
            onehot = np.zeros((x.shape[0], k), np.float32)
            onehot[np.arange(x.shape[0]), assign] = 1.0
            counts = onehot.sum(axis=0)  # [K]
            sums = onehot.T @ x  # [K, ds]
            empty = counts == 0
            cent = np.where(
                empty[:, None], cent, sums / np.maximum(counts, 1.0)[:, None]
            )
            if empty.any():
                # re-seed dead centroids onto random data rows
                cent[empty] = x[rng.choice(x.shape[0], int(empty.sum()))]
        codebooks[j] = cent
    return codebooks


def anisotropic_eta(t: float, dim: int) -> float:
    """The parallel/orthogonal residual weight ratio ``η`` for score-aware
    (anisotropic) quantization at score threshold ``t`` (Guo et al., ICML
    2020, "Accelerating Large-Scale Inference with Anisotropic Vector
    Quantization" — the ScaNN objective): for unit-norm datapoints and
    queries that matter above cosine ``t``, η = (d−1)·t²/(1−t²). ``t=0.2``
    is the paper's default operating point."""
    if not 0.0 < t < 1.0:
        raise ValueError(f"anisotropic threshold t must be in (0, 1), got {t}")
    return float((dim - 1) * t * t / (1.0 - t * t))


def _aniso_assign(
    dirs: np.ndarray, codebooks: np.ndarray, eta: float, passes: int,
    codes: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Coordinate-descent code assignment under the anisotropic loss.

    The score-aware loss couples subspaces through the parallel residual
    ``(r·x̂)² = (Σ_m (c_m − x_m)·x_m)²`` (``x̂`` is the unit row, so its
    ``m``-th block IS ``x_m``), so codes cannot be chosen independently per
    subspace like vanilla PQ — each pass sweeps the subspaces, re-picking
    one code with the others' parallel contribution ``ρ₋ₘ`` held fixed:

        loss_m(k) = ‖c_k − x_m‖² + (η−1)·(ρ₋ₘ + (c_k − x_m)·x_m)²

    Returns ``(codes [N, M] int32, d_cur [N, M], ρ [N])`` where ``d_cur[m]
    = (c_code − x_m)·x_m`` and ``ρ = Σ_m d_cur[m]`` (the parallel residual
    dot) — callers reuse them for the codebook update. Vectorized numpy:
    one ``[N, K]`` affinity per (pass, subspace)."""
    n, d = dirs.shape
    m_sub, k, ds = codebooks.shape
    xb = dirs.reshape(n, m_sub, ds)
    xnorm2 = np.einsum("nmd,nmd->nm", xb, xb)  # [N, M] block sq-norms
    if codes is None:
        # warm start: vanilla independent assignment (η=1 solution)
        codes = np.empty((n, m_sub), np.int32)
        for j in range(m_sub):
            aff = xb[:, j, :] @ codebooks[j].T - 0.5 * np.sum(
                codebooks[j] * codebooks[j], axis=1
            )[None, :]
            codes[:, j] = np.argmax(aff, axis=1)
    else:
        codes = codes.astype(np.int32).copy()
    d_cur = np.empty((n, m_sub), np.float32)
    for j in range(m_sub):
        d_cur[:, j] = (
            np.einsum("nd,nd->n", codebooks[j][codes[:, j]], xb[:, j, :])
            - xnorm2[:, j]
        )
    rho = d_cur.sum(axis=1)  # [N]
    rows_idx = np.arange(n)
    for _ in range(passes):
        for j in range(m_sub):
            dot = xb[:, j, :] @ codebooks[j].T  # [N, K]
            cb2 = np.sum(codebooks[j] * codebooks[j], axis=1)[None, :]
            l2 = cb2 - 2.0 * dot + xnorm2[:, j][:, None]
            dk = dot - xnorm2[:, j][:, None]  # (c − x_m)·x_m
            rho_minus = rho - d_cur[:, j]
            loss = l2 + (eta - 1.0) * np.square(rho_minus[:, None] + dk)
            new = np.argmin(loss, axis=1)
            codes[:, j] = new
            d_cur[:, j] = dk[rows_idx, new]
            rho = rho_minus + d_cur[:, j]
    return codes, d_cur, rho


def train_pq_codebooks_anisotropic(
    rows,
    m: int,
    k: int = 256,
    t: float = 0.2,
    eta: Optional[float] = None,
    iters: int = 8,
    passes: int = 2,
    seed: int = 0,
    train_rows: int = 8192,
) -> np.ndarray:
    """Score-aware PQ codebooks (ScaNN's anisotropic objective).

    Vanilla PQ minimizes reconstruction MSE, but for INNER-PRODUCT serving
    the residual component PARALLEL to the datapoint is what biases scores
    for the queries that matter (those scoring high on it); the orthogonal
    component averages out. The anisotropic loss weights parallel error
    ``η``× (``η`` from :func:`anisotropic_eta`; ``t=0.2`` default), trained
    by alternating coordinate-descent assignment (:func:`_aniso_assign`)
    with the closed-form per-centroid update — a ``ds × ds`` ridge solve:

        [|S|·I + (η−1)·Σ_S x_m x_mᵀ] c = Σ_S x_m + (η−1)·Σ_S (‖x_m‖² − ρ₋ₘ)·x_m

    Drop-in with the vanilla trainer: the returned codebooks feed the SAME
    encoders and serving kernels (the ADC kernel and the decode path — only the values
    change). Encode with :func:`pq_encode_host_anisotropic` so assignment
    uses the same loss. Deterministic per seed. No reference counterpart.
    """
    rows = np.asarray(rows, np.float32)
    n, d = rows.shape
    if d % m:
        raise ValueError(f"pq subspaces m={m} must divide the embedding dim {d}")
    if k > 256:
        raise ValueError(f"pq codebook size k={k} exceeds uint8 codes (max 256)")
    if eta is None:
        eta = anisotropic_eta(t, d)
    norms = np.linalg.norm(rows, axis=1)
    live = rows[norms > 0] / norms[norms > 0][:, None]
    if live.shape[0] == 0:
        raise ValueError("cannot train pq codebooks on an all-zero corpus")
    rng = np.random.default_rng(np.uint64(seed) + 0xA9C)
    if live.shape[0] > train_rows:
        live = live[rng.choice(live.shape[0], train_rows, replace=False)]
    k = min(k, live.shape[0])
    ds = d // m
    # vanilla Lloyd warm start keeps the alternation stable
    cb = train_pq_codebooks(live, m, k=k, iters=4, seed=seed, train_rows=live.shape[0])
    xb = live.reshape(live.shape[0], m, ds)
    xnorm2 = np.einsum("nmd,nmd->nm", xb, xb)
    eye = np.eye(ds, dtype=np.float32)
    codes = None
    for _ in range(iters):
        codes, d_cur, rho = _aniso_assign(live, cb, eta, passes, codes)
        for j in range(m):
            onehot = np.zeros((live.shape[0], k), np.float32)
            onehot[np.arange(live.shape[0]), codes[:, j]] = 1.0
            counts = onehot.sum(axis=0)  # [K]
            x = xb[:, j, :]
            rho_minus = rho - d_cur[:, j]
            # optimize=True: contract (nd,ne->nde) then one [K,N]@[N,ds²]
            # BLAS matmul — the default path is orders slower at N=8192
            sxx = np.einsum("nk,nd,ne->kde", onehot, x, x, optimize=True)
            sx = onehot.T @ x  # [K, ds]
            w = xnorm2[:, j] - rho_minus  # [N]
            swx = onehot.T @ (w[:, None] * x)  # [K, ds]
            a = counts[:, None, None] * eye[None] + (eta - 1.0) * sxx
            a += 1e-6 * eye[None]  # ridge: empty/degenerate groups stay solvable
            b = sx + (eta - 1.0) * swx
            new_c = np.linalg.solve(a, b[..., None])[..., 0].astype(np.float32)
            empty = counts == 0
            if empty.any():
                new_c[empty] = x[rng.choice(x.shape[0], int(empty.sum()))]
            cb[j] = new_c
            # keep d_cur/rho consistent with the moved centroids
            d_cur[:, j] = (
                np.einsum("nd,nd->n", cb[j][codes[:, j]], x) - xnorm2[:, j]
            )
        rho = d_cur.sum(axis=1)
    return cb


def pq_encode_host_anisotropic(
    rows, codebooks: np.ndarray, t: float = 0.2, eta: Optional[float] = None,
    passes: int = 3,
) -> Tuple[np.ndarray, np.ndarray]:
    """Anisotropic-loss encode: like :func:`pq_encode_host` (codes quantize
    the row DIRECTION, ``scale = ‖row‖``, zero rows pack to scale 0) but the
    code assignment runs the coordinate-descent sweep of
    :func:`_aniso_assign` under the same η used in training — independent
    per-subspace argmin would silently optimize the wrong (MSE) objective."""
    rows = np.asarray(rows, np.float32)
    n, d = rows.shape
    m, k, ds = codebooks.shape
    if m * ds != d:
        raise ValueError(f"codebooks [{m}, {k}, {ds}] do not tile dim {d}")
    if eta is None:
        eta = anisotropic_eta(t, d)
    norms = np.linalg.norm(rows, axis=1, keepdims=True)
    dirs = rows / np.maximum(norms, 1e-12)
    codes = np.empty((n, m), np.uint8)
    for lo in range(0, n, 65536):
        hi = min(n, lo + 65536)
        c, _, _ = _aniso_assign(dirs[lo:hi], codebooks, eta, passes)
        codes[lo:hi] = c.astype(np.uint8)
    scale = norms.astype(np.float32)
    scale[norms[:, 0] == 0] = 0.0
    return codes, scale


def _pq_encode_decode_host(x: np.ndarray, codebooks: np.ndarray) -> np.ndarray:
    """Host encode+reconstruct ``[N, D]`` under per-subspace codebooks
    (assignment math identical to :func:`pack_pq_host`, rows taken as-is)."""
    n, d = x.shape
    m, k, ds = codebooks.shape
    sub = x.reshape(n, m, ds)
    recon = np.empty_like(x)
    half_c2 = 0.5 * np.sum(codebooks * codebooks, axis=2)  # [M, K]
    for j in range(m):
        aff = sub[:, j, :] @ codebooks[j].T - half_c2[j][None, :]
        recon[:, j * ds : (j + 1) * ds] = codebooks[j][np.argmax(aff, axis=1)]
    return recon


def train_opq_rotation(
    rows,
    m: int,
    k: int = 256,
    opq_iters: int = 10,
    kmeans_iters: int = 4,
    seed: int = 0,
    train_rows: int = 8192,
) -> np.ndarray:
    """Learn an orthonormal rotation minimizing PQ reconstruction error.

    Non-parametric OPQ (Ge et al., CVPR 2013): starting from the seeded
    random rotation, alternate (a) a short per-subspace k-means fit of the
    PQ codebooks in the rotated space with (b) the orthogonal Procrustes
    update ``R = U V^T`` from ``svd(X^T Y)``, where ``Y`` is the current
    reconstruction of the rotated rows — the rotation that best aligns the
    data with what the codebooks can express. Beats the random rotation
    exactly where PQ hurts most: correlated/anisotropic subspaces.

    ``rows`` [N, D] corpus rows (both towers stacked — serving rotates
    queries ONCE, so one R must serve both packed towers); zero rows drop
    and the rest train as DIRECTIONS, matching :func:`pack_pq_host`.
    Host-side, deterministic per seed; subsampled to ``train_rows``.
    Returns ``R [D, D]`` f32 — exact inner products are invariant, so it
    drops into the ``rotate=`` seam unchanged.
    """
    rows = np.asarray(rows, np.float32)
    norms = np.linalg.norm(rows, axis=1, keepdims=True)
    live = rows[norms[:, 0] > 0] / np.maximum(norms[norms[:, 0] > 0], 1e-12)
    if live.shape[0] == 0:
        raise ValueError("cannot train an OPQ rotation on an all-zero corpus")
    d = live.shape[1]
    if d % m:
        raise ValueError(f"pq subspaces m={m} must divide the embedding dim {d}")
    rng = np.random.default_rng(np.uint64(seed) + 0x09C)
    if live.shape[0] > train_rows:
        live = live[rng.choice(live.shape[0], train_rows, replace=False)]
    r = random_rotation(d, seed)
    for t in range(opq_iters):
        xr = live @ r
        cb = train_pq_codebooks(
            xr, m, k=k, iters=kmeans_iters, seed=seed + t,
            train_rows=xr.shape[0],
        )
        recon = _pq_encode_decode_host(xr, cb)
        # min_R ||X R - Y||_F over orthogonal R: R = U V^T of svd(X^T Y)
        u, _, vt = np.linalg.svd(live.T @ recon, full_matrices=False)
        r = np.ascontiguousarray((u @ vt).astype(np.float32))
    return r


def pq_encode_host(rows, codebooks: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host encode ``[N, D]`` rows -> ``(codes uint8 [N, M], scale f32 [N, 1])``.

    ``recon(row) = scale * concat_m codebooks[m, codes[m]]`` where the codes
    quantize the row's DIRECTION (row / ||row||) and ``scale = ||row||``.
    Zero rows (capacity padding) pack to ``scale = 0`` — they score exactly
    0 regardless of codes, matching every other packing tier. Pure numpy so
    both the flat PQ corpus (:func:`pack_pq_host`) and the IVF-PQ packer
    (``retrieval.ann.build_ivf_index(quantize="pq")``) share one encoder.
    """
    rows = np.asarray(rows, np.float32)
    n, d = rows.shape
    m, k, ds = codebooks.shape
    if m * ds != d:
        raise ValueError(f"codebooks [{m}, {k}, {ds}] do not tile dim {d}")
    norms = np.linalg.norm(rows, axis=1, keepdims=True)  # [N, 1]
    dirs = rows / np.maximum(norms, 1e-12)
    sub = dirs.reshape(n, m, ds)
    codes = np.empty((n, m), np.uint8)
    # chunk rows so the [chunk, K] affinity stays cache-friendly
    half_c2 = 0.5 * np.sum(codebooks * codebooks, axis=2)  # [M, K]
    for lo in range(0, n, 65536):
        hi = min(n, lo + 65536)
        for j in range(m):
            aff = sub[lo:hi, j, :] @ codebooks[j].T - half_c2[j][None, :]
            codes[lo:hi, j] = np.argmax(aff, axis=1).astype(np.uint8)
    scale = norms.astype(np.float32)
    scale[norms[:, 0] == 0] = 0.0
    return codes, scale


def pack_pq_host(rows, codebooks: np.ndarray, aniso_t: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`pq_encode_host` (or, with ``aniso_t > 0``, the score-aware
    :func:`pq_encode_host_anisotropic`): ``(codes uint8 [N, M], scale f32
    [N, 1])`` on the host."""
    if aniso_t:
        return pq_encode_host_anisotropic(rows, codebooks, t=aniso_t)
    return pq_encode_host(rows, codebooks)


def decode_pq(codes: torch.Tensor, scale: torch.Tensor, codebooks: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Reconstruct ``[N, D]`` rows from codes: the centroid gather in
    ``dtype``, the per-row scale applied in f32."""
    m, k, ds = codebooks.shape
    flat = codebooks.reshape(m * k, ds).to(dtype)
    idx = codes.long() + (torch.arange(m, device=codes.device) * k)[None, :]
    recon = flat[idx].reshape(codes.shape[0], m * ds)
    return (recon.float() * scale.float()).to(dtype)


def _tower_scores_pq(q: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor, codebooks: torch.Tensor,
                     chunk: int) -> torch.Tensor:
    """``[Q, D] x (codes [N, M], scale [N, 1]) -> f32 [Q, N]``: per corpus
    chunk, gather the centroid rows at the query dtype, dot with f32
    accumulation, then the per-row scales on the score columns."""
    m, k, ds = codebooks.shape
    flat = codebooks.reshape(m * k, ds).to(q.dtype)
    offs = (torch.arange(m, device=codes.device) * k)[None, :]
    out = []
    for lo in range(0, codes.shape[0], chunk):
        c, s = codes[lo : lo + chunk], scale[lo : lo + chunk]
        recon = flat[c.long() + offs].reshape(c.shape[0], m * ds)
        out.append((q.float() @ recon.float().T) * s.float().reshape(1, -1))
    return torch.cat(out, dim=1)


def blended_scores_pq(queries, img_codes, img_scale, txt_codes, txt_scale, cb_img, cb_txt, alpha,
                      chunk: int = _DECODE_CHUNK) -> torch.Tensor:
    """[Q, N] blended scores over a product-quantized corpus (decode path)."""
    a = alpha_column(alpha, queries.shape[0], queries.device)
    t2i = _tower_scores_pq(queries, img_codes, img_scale, cb_img, chunk)
    t2t = _tower_scores_pq(queries, txt_codes, txt_scale, cb_txt, chunk)
    return a * t2i + (1.0 - a) * t2t


def pq_similarity_topk_xla(queries, img_codes, img_scale, txt_codes, txt_scale, cb_img, cb_txt, k: int,
                           alpha=0.5, chunk: int = _DECODE_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode-and-matmul scores + segmented top-k: the JAX package's
    off-TPU path of the same name, and the port's CPU route."""
    n = img_codes.shape[0]
    scores = blended_scores_pq(queries, img_codes, img_scale, txt_codes, txt_scale, cb_img, cb_txt, alpha, chunk)
    return _segmented_topk_from_scores(scores, min(k, n), segment=4096)


def masked_pq_similarity_topk(queries, img_codes, img_scale, txt_codes, txt_scale, cb_img, cb_txt, mask, k: int,
                              alpha=0.5, chunk: int = _DECODE_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Filtered top-k over a PQ corpus: the decode path's scores, a bool row
    mask, ``-1`` row sentinels on dead slots (as ``masked_similarity_topk``)."""
    n = img_codes.shape[0]
    scores = blended_scores_pq(queries, img_codes, img_scale, txt_codes, txt_scale, cb_img, cb_txt, alpha, chunk)
    return _masked_topk_from_scores(scores, mask, min(k, n))


def pq_luts(queries: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """``[Q, D] x [M, K, ds] -> bf16 LUT [M, Q, K]``: ``LUT[m, q, k] =
    q_sub[q, m] . cb[m, k]`` in f32, cast to bf16 (the one rounding the ADC
    path adds beyond PQ itself)."""
    m, n_k, ds = codebooks.shape
    q_sub = queries.float().reshape(queries.shape[0], m, ds)
    lut = torch.einsum("qmd,mkd->mqk", q_sub, codebooks.float())
    return lut.to(torch.bfloat16)


def adc_scores_from_luts(lut: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """One tower's ADC scores ``[Q, N]``: ``scale_n * sum_m LUT[m, q,
    codes[n, m]]``, the bf16 LUT values added in f32 in subspace order
    (each one-hot product of the TPU kernel is exactly one LUT value)."""
    m, qn, _ = lut.shape
    idx = codes.long()
    acc = torch.zeros((qn, codes.shape[0]), dtype=torch.float32, device=lut.device)
    for mm in range(m):
        acc = acc + lut[mm].float()[:, idx[:, mm]]
    return acc * scale.float().reshape(1, -1)


def blended_adc_from_luts(alpha_col, lut_i, lut_t, codes_i, scale_i, codes_t, scale_t) -> torch.Tensor:
    """B5's plain version: ``[Q, N]`` blended ADC scores from the LUTs."""
    t2i = adc_scores_from_luts(lut_i, codes_i, scale_i)
    t2t = adc_scores_from_luts(lut_t, codes_t, scale_t)
    return alpha_col * t2i + (1.0 - alpha_col) * t2t


def blended_scores_pq_adc(queries, img_codes, img_scale, txt_codes, txt_scale, cb_img, cb_txt, alpha) -> torch.Tensor:
    """The ADC kernel's exact math from the query embeddings: bf16 LUTs,
    f32 sums in subspace order, per-row scales, then the alpha blend."""
    a = alpha_column(alpha, queries.shape[0], queries.device)
    return blended_adc_from_luts(
        a, pq_luts(queries, cb_img), pq_luts(queries, cb_txt), img_codes, img_scale, txt_codes, txt_scale
    )


def pq_similarity_topk_adc(queries, img_codes, img_scale, txt_codes, txt_scale, cb_img, cb_txt, k: int,
                           alpha=0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain ADC scores + segmented top-k: the JAX package's big-k route on
    the TPU, kept for parity; the port's CUDA route is B5 at every k."""
    n = img_codes.shape[0]
    scores = blended_scores_pq_adc(queries, img_codes, img_scale, txt_codes, txt_scale, cb_img, cb_txt, alpha)
    return _segmented_topk_from_scores(scores, min(k, n), segment=4096)


def _swap_halves(lut: torch.Tensor) -> torch.Tensor:
    """``[..., K, 16]``: the two 8-query halves swapped in the entries of
    codes with bit 2 set (an involution; B5's bank spreading)."""
    n_k = lut.shape[-2]
    swap = ((torch.arange(n_k, device=lut.device) >> 2) & 1).bool()[:, None, None]
    pairs = lut.reshape(*lut.shape[:-1], 2, 8)
    return torch.where(swap, pairs.flip(-2), pairs).reshape(lut.shape)


def pq_lut_interleave(lut: torch.Tensor) -> torch.Tensor:
    """B5's LUT layout, a plain permute: ``[M, Q, K] -> [ceil(Q / 16), M, K,
    16]``, entry ``[g, m, c]`` holding ``lut[m, 16 g .. 16 g + 15, c]``
    (queries past Q are zeros), its two 8-query halves swapped where bit 2
    of the code c is set. One (subspace, code) entry holds 16 queries'
    values, and the slice of a 16-query group and a run of subspaces is
    contiguous."""
    m, qn, n_k = lut.shape
    qp = -(-qn // _PQ_QUERY_GROUP) * _PQ_QUERY_GROUP
    lut = torch.nn.functional.pad(lut, (0, 0, 0, qp - qn))
    lut = lut.reshape(m, qp // _PQ_QUERY_GROUP, _PQ_QUERY_GROUP, n_k).permute(1, 0, 3, 2)
    return _swap_halves(lut).contiguous()


_PQ_ARGS = [P] * 9 + [I] * 6 + [P] * 6 + [P]


@dispatch.counted
def pq_adc_topk_kernel(alpha_col, lut_i, lut_t, codes_i, scale_i, codes_t, scale_t, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch B5 on CUDA tensors: bf16 LUTs ``[M, Q, K]`` per tower, uint8
    codes ``[N, M]``, f32 scales ``[N, 1]``, f32 alpha ``[Q, 1]``. The LUTs
    go to the kernel query-interleaved (:func:`pq_lut_interleave`); one
    launch a pass, ``pass_sizes(k)[0]`` passes."""
    dev = lut_i.device
    m, qn, n_k = lut_i.shape
    n = codes_i.shape[0]
    if not 0 < k <= n:
        raise ValueError(f"kernel k must be in 1..{n} (the corpus rows), got {k}")
    if not 0 < n_k <= 256:
        raise ValueError(f"codebook size {n_k} does not fit uint8 codes")
    dispatch.require(lut_i, "lut_i", torch.bfloat16, dev, (m, qn, n_k))
    dispatch.require(lut_t, "lut_t", torch.bfloat16, dev, (m, qn, n_k))
    dispatch.require(codes_i, "codes_i", torch.uint8, dev, (n, m))
    dispatch.require(codes_t, "codes_t", torch.uint8, dev, (n, m))
    dispatch.require(scale_i, "scale_i", torch.float32, dev, (n, 1))
    dispatch.require(scale_t, "scale_t", torch.float32, dev, (n, 1))
    dispatch.require(alpha_col, "alpha", torch.float32, dev, (qn, 1))
    li, lt = pq_lut_interleave(lut_i), pq_lut_interleave(lut_t)
    n_strips = scan_strips(n, -(-qn // _PQ_QUERY_GROUP), _sm_count(dev), tile=_PQ_TILE)
    fn = dispatch.kernel("kemr_pq_adc_topk", _PQ_ARGS)

    def launch(kp, ceil_v, ceil_r):
        scratch = scan_scratch(qn, _PQ_QUERY_GROUP, n_strips, kp, dev)
        vals = torch.empty((qn, kp), dtype=torch.float32, device=dev)
        idx = torch.empty((qn, kp), dtype=torch.int32, device=dev)
        status = fn(
            li.data_ptr(), lt.data_ptr(), codes_i.data_ptr(), codes_t.data_ptr(), scale_i.data_ptr(),
            scale_t.data_ptr(), alpha_col.data_ptr(), _ptr(ceil_v), _ptr(ceil_r), qn, n, m, n_k, kp, n_strips,
            *map(_ptr, scratch), vals.data_ptr(), idx.data_ptr(), dispatch.stream_of(lut_i),
        )
        dispatch.check(status, "pq_adc_topk_kernel")
        dispatch.count_launch(pq_adc_topk_kernel)
        return vals, idx

    return topk_passes(launch, qn, k, dev)


def pq_adc_topk(alpha_col, lut_i, lut_t, codes_i, scale_i, codes_t, scale_t, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B5 on the Pallas kernel's operands: the kernel on CUDA tensors, its
    plain version (ADC scores + the kernel's selection) on CPU tensors."""
    if not dispatch.use_kernel(lut_i):
        return topk_plain(blended_adc_from_luts(alpha_col, lut_i, lut_t, codes_i, scale_i, codes_t, scale_t), k)
    return pq_adc_topk_kernel(alpha_col, lut_i, lut_t, codes_i, scale_i, codes_t, scale_t, k)


def _adc_topk(queries, img_codes, img_scale, txt_codes, txt_scale, cb_img, cb_txt, k: int, alpha
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The LUTs (a small einsum outside the kernel, as in JAX), then B5."""
    n, m = img_codes.shape
    if cb_img.shape[0] != m:
        raise ValueError(f"codebooks [{cb_img.shape[0]}] do not match codes [{m}] subspaces")
    a = alpha_column(alpha, queries.shape[0], queries.device)
    return pq_adc_topk(
        a, pq_luts(queries, cb_img), pq_luts(queries, cb_txt),
        img_codes, img_scale.reshape(-1, 1), txt_codes, txt_scale.reshape(-1, 1), min(k, n),
    )


def fused_pq_topk(queries, img_codes, img_scale, txt_codes, txt_scale, cb_img, cb_txt, k: int,
                  alpha=0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused ADC scan + top-k over a PQ corpus, k <= 128 as in JAX; scores
    match :func:`blended_scores_pq_adc`."""
    if k > _FUSED_K_CAP:
        raise ValueError(f"fused_pq_topk caps k at {_FUSED_K_CAP}; use pq_similarity_topk")
    return _adc_topk(queries, img_codes, img_scale, txt_codes, txt_scale, cb_img, cb_txt, k, alpha)


def pq_similarity_topk(queries, img_codes, img_scale, txt_codes, txt_scale, cb_img, cb_txt, k: int,
                       alpha=0.5, chunk: int = _DECODE_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blended top-k over a PQ corpus, routed by device (module doc)."""
    args = (queries, img_codes, img_scale, txt_codes, txt_scale, cb_img, cb_txt)
    if not dispatch.use_kernel(queries):
        return pq_similarity_topk_xla(*args, k, alpha, chunk)
    return _adc_topk(*args, k, alpha)


def sharded_pq_similarity_topk(queries, img_codes, img_scale, txt_codes, txt_scale, cb_img, cb_txt, k: int,
                               alpha, mesh, axis: str = "data", chunk: int = _DECODE_CHUNK
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PQ top-k over a row-sharded code corpus: each device scans only its
    codes (B5 on a CUDA shard, the decode path on a CPU one; the codebooks
    replicate), and only the per-shard ``[Q, k]`` winners move for the merge."""
    n = img_codes.shape[0]
    k = min(k, n)
    a = alpha_column(alpha, queries.shape[0], queries.device)

    def scan(dev, g, shard_n, ci, si, ct, st):
        return pq_similarity_topk(queries.to(dev), ci, si, ct, st, cb_img.to(dev), cb_txt.to(dev),
                                  k=min(k, shard_n), alpha=a.to(dev), chunk=chunk)

    all_v, all_i, _, _ = sharded_scan(mesh, axis, (img_codes, img_scale, txt_codes, txt_scale), scan)
    return _merge_shard_winners(all_v, all_i, k)


def sharded_masked_pq_similarity_topk(queries, img_codes, img_scale, txt_codes, txt_scale, cb_img, cb_txt, mask,
                                      k: int, alpha, mesh, axis: str = "data", chunk: int = _DECODE_CHUNK
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Filtered PQ top-k over a row-sharded code corpus (the decode path a
    shard; the mask shards with the rows; ``-1`` sentinels on dead slots)."""
    def score(q, ci, si, ct, st, a):
        return blended_scores_pq(q, ci, si, ct, st, cb_img.to(q.device), cb_txt.to(q.device), a, chunk)

    return sharded_masked_topk(score, queries, (img_codes, img_scale, txt_codes, txt_scale), mask, k, alpha,
                               mesh, axis)
