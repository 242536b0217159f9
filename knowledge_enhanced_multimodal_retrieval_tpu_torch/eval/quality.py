"""Retrieval-quality sweep across corpus packings — "should I enable int4?"

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/eval/quality.py``.
The packed-corpus modes (int8, int4, product quantization, binary sketches,
IVF probing, the host rerank) trade precision or probe width for capacity
and latency; this measures what each trade costs on your embeddings: top-k
agreement with the exact brute-force ranking, top-1 retention and score
error.

The exact ranking is the plain one in f32 (``blended_scores`` +
``topk_plain``). The packed rows go through the serving wrappers
(``fused_similarity_topk_q8`` / ``_q4``, ``pq_similarity_topk``), so on a
CUDA device the sweep measures what the kernels B2, B2-q4 and B5 serve; the
binary rows through ``hamming_topk`` and the IVF rows through an index built
on the sweep's device. Queries stay f32 throughout, as in the JAX sweep.
Run ``python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts.quality_sweep
--store store.npz`` for the CLI.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.binary_sketch import hamming_topk, pack_sign_bits_host
from ..ops.pq import (
    pack_pq_host,
    pq_similarity_topk,
    train_opq_rotation,
    train_pq_codebooks,
    train_pq_codebooks_anisotropic,
)
from ..ops.similarity import (
    blended_scores,
    fused_similarity_topk_q4,
    fused_similarity_topk_q8,
    prefix_normalize_host,
    quantize_corpus_host,
    quantize_corpus_host_q4,
    random_rotation,
    rerank_scores_host,
    topk_plain,
)
from ..retrieval.ann import build_ivf_index, ivf_search


def _agreement(exact_idx: np.ndarray, got_idx: np.ndarray) -> Dict[str, float]:
    q, k = exact_idx.shape
    overlap = np.mean(
        [len(set(exact_idx[i]) & set(got_idx[i][got_idx[i] >= 0])) / k for i in range(q)]
    )
    top1 = np.mean(exact_idx[:, 0] == got_idx[:, 0])
    return {"recall_at_k": float(overlap), "top1_retained": float(top1)}


def _host(out):
    v, i = out
    return v.float().cpu().numpy(), i.cpu().numpy()


def quality_sweep(
    image: np.ndarray,
    text: np.ndarray,
    queries: np.ndarray,
    *,
    k: int = 10,
    alpha: float = 0.5,
    rerank_factor: int = 4,
    nprobes: Sequence[int] = (),
    nlist: Optional[int] = None,
    truncate_dims: Sequence[int] = (),
    rotate: bool = False,
    rotate_seed: int = 0,
    pq_aniso_t: float = 0.0,
    device="cuda",
) -> List[Dict]:
    """Measure each packing mode against exact brute force, on ``device``.

    ``image``/``text`` [N, D] L2-normalized corpus towers, ``queries``
    [Q, D] L2-normalized query embeddings. Returns one row per config:
    ``{"config", "recall_at_k", "top1_retained", "score_mae"}`` (score_mae
    over the rows both rankings agree on; 0 for exact). ``nprobes`` adds IVF
    rows (``nlist`` defaults to sqrt(N)); ``rotate`` the ``+rot`` rows and
    the learned-rotation ``pq+opq`` rows; ``pq_aniso_t`` the score-aware
    ``pq+aniso`` rows; ``truncate_dims`` the Matryoshka prefix rows.
    """
    image = np.asarray(image, np.float32)
    text = np.asarray(text, np.float32)
    queries = np.asarray(queries, np.float32)
    n = image.shape[0]
    k = min(k, n)
    dev = torch.device(device)

    def on(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=dev)

    def exact_topk(qs, im, tx, kk):
        return _host(topk_plain(blended_scores(on(qs), on(im), on(tx), alpha), kk))

    ev, ei = exact_topk(queries, image, text, k)
    exact_score = {
        (qi, int(r)): float(v) for qi, (rr, vv) in enumerate(zip(ei, ev)) for r, v in zip(rr, vv)
    }

    def score_mae(idx, vals):
        diffs = [
            abs(exact_score[(qi, int(r))] - float(v))
            for qi, (rr, vv) in enumerate(zip(idx, vals))
            for r, v in zip(rr, vv)
            if (qi, int(r)) in exact_score
        ]
        # None (JSON null), not NaN: the CLI promises a parseable JSON line
        return float(np.mean(diffs)) if diffs else None

    rows = [{"config": "exact", "recall_at_k": 1.0, "top1_retained": 1.0, "score_mae": 0.0}]
    kf = min(rerank_factor * k, n)

    def add(config, scan):
        """A row for ``scan(kk) -> (values, rows)`` at k, and its +rerank row
        (fetch rerank_factor * k, rescore exactly on the host as serving
        does, keep k)."""
        v, i = scan(k)
        rows.append({"config": config, **_agreement(ei, i), "score_mae": score_mae(i, v)})
        _, i = scan(kf)
        rv, ri = rerank_scores_host(queries, image, text, i, alpha)
        rv, ri = rv[:, :k], ri[:, :k]
        rows.append({"config": f"{config}+rerank{rerank_factor}x", **_agreement(ei, ri), "score_mae": score_mae(ri, rv)})

    def add_pq(config, im, tx, qs, cb_i, cb_t, aniso_t=0.0):
        (pi, psi), (pt, pst) = pack_pq_host(im, cb_i, aniso_t=aniso_t), pack_pq_host(tx, cb_t, aniso_t=aniso_t)
        args = (on(qs), on(pi), on(psi), on(pt), on(pst), on(cb_i), on(cb_t))
        add(config, lambda kk: _host(pq_similarity_topk(*args, kk, alpha)))

    # (suffix, corpus / query views): "" = as is; "+rot" = the rotated space
    # CLIPRetrieval(rotate=True) scans (exact scores invariant, the packing
    # roundings differ). The rerank rescores with the original towers.
    spaces = [("", image, text, queries)]
    if rotate:
        rot = random_rotation(image.shape[1], rotate_seed)
        spaces.append(("+rot", image @ rot, text @ rot, queries @ rot))

    for suffix, im, tx, qs in spaces:
        for name, fn, quantizer in (
            ("int8", fused_similarity_topk_q8, quantize_corpus_host),
            ("int4", fused_similarity_topk_q4, quantize_corpus_host_q4),
        ):
            (ci, si), (ct, st) = quantizer(im), quantizer(tx)
            args = (on(qs), on(ci), on(si), on(ct), on(st))
            add(name + suffix, lambda kk, args=args, fn=fn: _host(fn(*args, kk, alpha)))

        # product quantization: codebooks train per space (rotated rows get
        # rotated codebooks, as CLIPRetrieval(quantize_corpus="pq", rotate=True))
        m = max(1, im.shape[1] // 8)
        add_pq("pq" + suffix, im, tx, qs, train_pq_codebooks(im, m=m), train_pq_codebooks(tx, m=m))

        # score-aware PQ (opt-in, base space only)
        if pq_aniso_t and suffix == "":
            add_pq("pq+aniso", im, tx, qs, train_pq_codebooks_anisotropic(im, m=m, t=pq_aniso_t),
                   train_pq_codebooks_anisotropic(tx, m=m, t=pq_aniso_t), aniso_t=pq_aniso_t)

        # binary sketch: candidate quality with and without the rerank that
        # serving makes mandatory
        bi, bt = on(pack_sign_bits_host(im).view(np.int32)), on(pack_sign_bits_host(tx).view(np.int32))
        add("binary" + suffix,
            lambda kk, qs=qs, bi=bi, bt=bt, d=im.shape[1]: _host(hamming_topk(on(qs), bi, bt, dim=d, k=kk, alpha=alpha)))

    if rotate:
        # OPQ (pq only): the learned rotation instead of the random one, what
        # CLIPRetrieval(rotate="opq", quantize_corpus="pq") serves
        m = max(1, image.shape[1] // 8)
        r_opq = train_opq_rotation(np.concatenate([image, text], axis=0), m=m, seed=rotate_seed)
        im, tx = image @ r_opq, text @ r_opq
        add_pq("pq+opq", im, tx, queries @ r_opq, train_pq_codebooks(im, m=m), train_pq_codebooks(tx, m=m))

    # Matryoshka prefixes (CLIPRetrieval(truncate_dim=d)): the d-dim exact scan
    for d in truncate_dims:
        if not 0 < d <= image.shape[1]:
            raise ValueError(f"truncate dim {d} not in 1..{image.shape[1]}")
        ti, tt, tq = (prefix_normalize_host(x, d) for x in (image, text, queries))
        add(f"trunc{d}", lambda kk, ti=ti, tt=tt, tq=tq: exact_topk(tq, ti, tt, kk))

    if nprobes:
        index = build_ivf_index(image, text, nlist or max(1, int(np.sqrt(n))), device=dev)
        for p in nprobes:
            p = min(p, index.nlist)
            v, i = _host(ivf_search(on(queries), index, k=k, nprobe=p, alpha=alpha))
            rows.append({"config": f"ivf-nprobe{p}/{index.nlist}", **_agreement(ei, i), "score_mae": score_mae(i, v)})
    return rows


def format_table(rows: List[Dict]) -> str:
    head = f"{'config':24} {'recall@k':>9} {'top1':>6} {'score_mae':>10}"
    lines = [head, "-" * len(head)]
    for r in rows:
        mae = "-" if r["score_mae"] is None else f"{r['score_mae']:.5f}"
        lines.append(f"{r['config']:24} {r['recall_at_k']:9.4f} {r['top1_retained']:6.3f} {mae:>10}")
    return "\n".join(lines)
