"""Whether the search window's answers are right, judged against the plain
reference.

For every batch the window sampled (one of each length bucket, and the
batches the seed picks), the reference works everything out again from
the inputs: the token ids (its own BPE over the same merge table, trimmed
to the bucket), the int8 text tower (its own quantization of the seeded
weights, float32 elsewhere, TF32 off), the int8 corpus and its per-row
scales, and the blended scores of every corpus row. Compared:

- ``token_mismatch``: ids that differ from the program's (limit 0);
- ``malformed``: answers that are not k distinct known uuids in
  descending score (limit 0);
- ``emb_gap``: the largest L2 distance between the program's unit query
  embedding and the reference's;
- ``score_gap``: the largest difference between a returned score and the
  reference's score of the row its uuid names;
- ``rank_gap``: the largest amount by which a returned row's reference
  score lies below the reference's k-th best for that query.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import gen
from ..runners.common import free, vocabulary
from ..reference import clip as ref_clip
from ..reference.bpe import trim_to_bucket

Item = Tuple[Sequence[str], Optional[np.ndarray], Optional[torch.Tensor], List[List[dict]]]


def buckets(traffic: dict) -> List[int]:
    return sorted(int(c["bucket"]) for c in traffic["batch_mix"])


def compare(run) -> List[Tuple[str, float, float]]:
    st = run.state
    items = [(st.queries[i], st.ids.get(i), st.q.get(i), st.results[i]) for i in sorted(st.results)]
    return judge(run, items)


def judge(run, items: Sequence[Item]) -> List[Tuple[str, float, float]]:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr, a, dev, seed, lim = run.traffic, run.arch, run.device, run.seed, run.limits
    k, alpha = int(tr["k"]), float(tr["alpha"])
    _, _, tok = vocabulary(tr)
    w = gen.clip_weights(a, seed, dev)
    mm = ref_clip.Quant(8, int(tr["int8"]["ff_group"]))
    mismatch, emb_gap, malformed = 0, 0.0, 0
    q_ref, rows, scores = [], [], []
    prefix = gen.uuid_prefix(seed)
    n_rows = int(tr["corpus_rows"])
    with torch.no_grad():
        for queries, ids, q, results in items:
            rid = trim_to_bucket(tok(queries), buckets(tr))
            if ids is None or np.shape(ids) != rid.shape:
                mismatch += rid.size
            else:
                mismatch += int((np.asarray(ids) != rid).sum())
            qr = ref_clip.encode_text(w, torch.from_numpy(rid).to(dev), a, mm)
            if q is not None:
                emb_gap = max(emb_gap, float(torch.linalg.vector_norm(q.to(dev).float() - qr, dim=1).max()))
            q_ref.append(qr)
            for res in results:
                r = [-1] * k
                s = [float("nan")] * k
                ok = len(res) == k and len({e["uuid"] for e in res}) == k
                for j, e in enumerate(res[:k]):
                    u = e["uuid"]
                    if u.startswith(prefix) and u[len(prefix):].isdigit() and int(u[len(prefix):]) < n_rows:
                        r[j] = int(u[len(prefix):])
                    else:
                        ok = False
                    s[j] = float(e["score"])
                ok = ok and all(x >= y for x, y in zip(s, s[1:]))
                malformed += int(not ok)
                rows.append(r)
                scores.append(s)
        del w
        q_ref = torch.cat(q_ref)
        rows_t = torch.tensor(rows, dtype=torch.long, device=dev)
        prog_scores = torch.tensor(scores, dtype=torch.float32, device=dev)
        kth, ret = scan(q_ref, rows_t, seed, n_rows, a.embed_dim, alpha, k, dev, bits=8)
    known = rows_t >= 0
    score_gap = float((prog_scores - ret).abs()[known].max()) if bool(known.any()) else float("inf")
    low = torch.where(known, ret, torch.full_like(ret, float("-inf"))).amin(dim=1)
    rank_gap = float((kth - low).clamp_min(0).max())
    free(dev)
    return [
        ("token_mismatch", float(mismatch), float(lim["token_mismatch"])),
        ("malformed", float(malformed), float(lim["malformed"])),
        ("emb_gap", emb_gap, float(lim["emb_gap"])),
        ("score_gap", score_gap, float(lim["score_gap"])),
        ("rank_gap", rank_gap, float(lim["rank_gap"])),
    ]


def corpus_blocks(seed: int, n_rows: int, dim: int, dev, bits: int):
    """The seeded corpus, quantized per row to ``bits`` as the serving
    configuration states it: ``(start, img values, img scales, txt values,
    txt scales)`` blocks, values as float32 integers."""
    start = 0
    for xi, xt in zip(gen.corpus_chunks(seed, "image", n_rows, dim, dev),
                      gen.corpus_chunks(seed, "text", n_rows, dim, dev)):
        qi, si = ref_clip.quantize_sym(xi, bits, dim=1)
        qt, st = ref_clip.quantize_sym(xt, bits, dim=1)
        yield start, qi, si, qt, st
        start += xi.shape[0]


def scan(q: torch.Tensor, rows: torch.Tensor, seed: int, n_rows: int, dim: int, alpha: float, k: int, dev,
         bits: int, want_topk: bool = False):
    """Over the whole corpus: each query's k-th best blended score and the
    score of each row in ``rows`` [Q, k] (-inf where the row is -1); with
    ``want_topk`` also the best k ``(scores, rows)``."""
    n = q.shape[0]
    best_v = torch.full((n, k), float("-inf"), device=dev)
    best_i = torch.full((n, k), -1, dtype=torch.long, device=dev)
    ret = torch.full(rows.shape, float("-inf"), device=dev)
    for start, qi, si, qt, st in corpus_blocks(seed, n_rows, dim, dev, bits):
        s = alpha * (q @ qi.t()) * si.t() + (1 - alpha) * (q @ qt.t()) * st.t()
        m = s.shape[1]
        v, i = torch.topk(s, min(k, m), dim=1)
        v, order = torch.topk(torch.cat([best_v, v], 1), k, dim=1)
        best_i = torch.gather(torch.cat([best_i, i + start], 1), 1, order)
        best_v = v
        inside = (rows >= start) & (rows < start + m)
        local = torch.where(inside, rows - start, torch.zeros_like(rows))
        ret = torch.where(inside, torch.gather(s, 1, local), ret)
    if want_topk:
        return best_v[:, -1], ret, (best_v, best_i)
    return best_v[:, -1], ret


def control_items(run, queries: Sequence[Sequence[str]], bits: int) -> List[Item]:
    """The reference in the program's place at ``bits``-bit weights,
    activations and corpus: its ids, unit embeddings and top-k answers."""
    tr, a, dev, seed = run.traffic, run.arch, run.device, run.seed
    k, alpha = int(tr["k"]), float(tr["alpha"])
    _, _, tok = vocabulary(tr)
    w = gen.clip_weights(a, seed, dev)
    mm = ref_clip.Quant(bits, int(tr["int8"]["ff_group"]))
    uu = gen.uuid_prefix(seed)
    out = []
    with torch.no_grad():
        for qs in queries:
            ids = trim_to_bucket(tok(qs), buckets(tr))
            q = ref_clip.encode_text(w, torch.from_numpy(ids).to(dev), a, mm)
            none = torch.full((q.shape[0], k), -1, dtype=torch.long, device=dev)
            _, _, (v, i) = scan(q, none, seed, int(tr["corpus_rows"]), a.embed_dim, alpha, k, dev, bits, True)
            res = [[{"uuid": f"{uu}{int(r):07d}", "score": float(x)} for x, r in zip(vr.tolist(), ir.tolist())]
                   for vr, ir in zip(v, i)]
            out.append((qs, ids, q.cpu(), res))
    return out
