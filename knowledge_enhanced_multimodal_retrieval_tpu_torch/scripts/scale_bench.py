"""Corpus-scale serving bench: top-k scan time and recall at 1M+ rows.

Counterpart of the reference's ``scripts/scale_bench.py``. Only the
candidate scan depends on the corpus size (encode does not), so this times
the top-k scans of the packing ladder directly over ``--rows`` rows per
tower on one card and reports each tier's recall@10 against the exact f32
blend:

- ``int8`` / ``int4``: B2's q8 / q4 modes over the host quantizers' rows;
- ``pq`` (m = dim / 8): B5 (``ops.pq.pq_similarity_topk``) over codebooks
  trained on the host (8,192 sampled rows) and codes assigned on
  ``--device`` (:func:`pq_encode`, the host encoder's arithmetic);
- ``bf16`` (``--exact``): B2's exact mode;
- ``--ivf-rows N``: IVF over int8 / int4 / pq lists on a separate clustered
  corpus (``retrieval.ann.ivf_search``, plain PyTorch: no kernel).

Synthetic corpus: unit rows with a planted low-rank structure, made on
``--device`` from a seeded generator; queries are noisy copies of corpus
rows (so recall@10 has signal and ties are rare). The exact ranking is the
f32 blend on ``--device`` (:func:`exact_topk`). Each tier: event and
device-only medians (``scripts.timing``), q/s, recall@10, device bytes and
the kernel launches of one call.

    python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts.scale_bench \
        [--rows 1000000] [--exact] [--ivf-rows 250000] [--device cuda] [--out PATH]

The JSON goes to ``--out`` (default ``chiprun_out/scale_bench.json``; an
empty string disables the write).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..cli.common import resolve_device
from ..ops.pq import pq_similarity_topk, train_pq_codebooks
from ..ops.similarity import (
    fused_similarity_topk,
    fused_similarity_topk_q4,
    fused_similarity_topk_q8,
    quantize_corpus_host,
    quantize_corpus_host_q4,
)
from .timing import card, default_out, launches_of, ms_of, sync, time_ms, write_json

DEFAULT_OUT = default_out("scale_bench.json")


def recall_at(ids, exact_ids, k: int = 10) -> float:
    """Mean share of each query's exact top ``k`` rows found in its top ``k``."""
    ids, exact_ids = np.asarray(ids), np.asarray(exact_ids)
    return float(np.mean([
        len(set(ids[i, :k].tolist()) & set(exact_ids[i, :k].tolist())) / k for i in range(ids.shape[0])
    ]))


def exact_topk(q, img, txt, alpha: float, k: int, device, chunk: int = 65536) -> np.ndarray:
    """Row ids [Q, k] of the exact f32 blend ``alpha (q . img) + (1 - alpha)
    (q . txt)``, best first, computed on ``device`` in row chunks."""
    as_f32 = lambda x: torch.as_tensor(x).to(device=device, dtype=torch.float32)  # noqa: E731
    q = as_f32(q)
    best_v = torch.full((q.shape[0], 0), -float("inf"), device=device)
    best_i = torch.zeros((q.shape[0], 0), dtype=torch.long, device=device)
    for lo in range(0, img.shape[0], chunk):
        s = alpha * (q @ as_f32(img[lo : lo + chunk]).T) + (1 - alpha) * (q @ as_f32(txt[lo : lo + chunk]).T)
        v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
        best_v, pos = torch.topk(torch.cat([best_v, v], 1), min(k, best_v.shape[1] + v.shape[1]), dim=1)
        best_i = torch.gather(torch.cat([best_i, i + lo], 1), 1, pos)
    return best_i.cpu().numpy()


def normed(gen: torch.Generator, n: int, d: int, device, rank: int = 32) -> torch.Tensor:
    """Unit rows [n, d] f32 with a shared rank-``rank`` structure (the
    anisotropy of real embeddings), made on ``device``."""
    basis = torch.randn((rank, d), generator=gen, device=device)
    x = torch.randn((n, rank), generator=gen, device=device) @ basis
    x += 0.3 * torch.randn((n, d), generator=gen, device=device)
    return x / x.norm(dim=1, keepdim=True).clamp_min(1e-9)


def pq_encode(rows: torch.Tensor, codebooks: np.ndarray, chunk: int = 8192):
    """``ops.pq.pq_encode_host``'s codes and scales, computed where ``rows``
    lie: each subspace of a row's direction takes the centroid of largest
    ``x . c - ||c||^2 / 2`` (the first on a tie); the scale is the row norm."""
    cb = torch.as_tensor(codebooks, device=rows.device)
    m, _, ds = cb.shape
    half_c2 = 0.5 * (cb * cb).sum(dim=2)  # [M, K]
    norms = rows.norm(dim=1, keepdim=True)
    codes = torch.empty((rows.shape[0], m), dtype=torch.uint8, device=rows.device)
    for lo in range(0, rows.shape[0], chunk):
        sub = (rows[lo : lo + chunk] / norms[lo : lo + chunk].clamp_min(1e-12)).reshape(-1, m, ds)
        aff = torch.einsum("nmd,mkd->nmk", sub, cb) - half_c2[None]
        codes[lo : lo + chunk] = aff.argmax(dim=2).to(torch.uint8)
    return codes, norms


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rows", type=int, default=1_000_000)
    p.add_argument("--ivf-rows", type=int, default=0,
                   help="opt-in IVF tier row count (0 = off), on a separate clustered corpus: recall per probe "
                   "is a property of cluster structure, which the flat tiers' low-rank corpus lacks")
    p.add_argument("--dim", type=int, default=768)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--pq-m", type=int, default=0, help="default dim/8")
    p.add_argument("--exact", action="store_true", help="add the bf16 tier")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=DEFAULT_OUT,
                   help="artifact path (empty string disables the write)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    n, d, b, k = args.rows, args.dim, args.batch, args.k
    m = args.pq_m or d // 8

    t_start = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"generating corpus [{n}, {d}] x2 towers + {b} queries on {dev} ...", flush=True)
    img, txt = normed(gen, n, d, dev), normed(gen, n, d, dev)
    tgt = torch.randperm(n, generator=gen, device=dev)[:b]
    q = img[tgt] + 0.25 * torch.randn((b, d), generator=gen, device=dev)
    q = q / q.norm(dim=1, keepdim=True).clamp_min(1e-9)
    sync(dev)
    t0 = time.perf_counter()
    exact_ids = exact_topk(q, img, txt, args.alpha, max(10, k), dev)
    stage_s = {"data": t0 - t_start, "exact": time.perf_counter() - t0}
    qd = q.bfloat16()

    results, failed = {}, {}

    def tier(name, fn, ops, device_bytes, queries=None, truth=None):
        qq = qd if queries is None else queries
        call = lambda: fn(qq, *ops, k, alpha=args.alpha)  # noqa: E731
        try:
            rec = recall_at(call()[1].cpu().numpy(), exact_ids if truth is None else truth)
            t = time_ms(call, dev, iters=args.iters)
        except Exception as e:  # noqa: BLE001 — the record keeps the failure beside the other tiers
            failed[name] = f"{type(e).__name__}: {e}"
            print(f"{name:>12}: FAILED ({failed[name][:160]})", flush=True)
            return
        results[name] = {**t, "qps": b / ms_of(t) * 1e3, "recall@10": rec, "device_gb": device_bytes / 2**30,
                         "launches": launches_of(call, dev)}
        print(f"{name:>12}: " + " ".join(f"{key} {v:8.3f}" for key, v in t.items())
              + f"  {results[name]['qps']:9.1f} q/s  recall@10 {rec:.4f}  {device_bytes / 2**30:.2f} GB", flush=True)

    host = {}

    def on_host(name, x):
        if name not in host:
            host[name] = x.cpu().numpy()
        return host[name]

    for name, quant, fn, row_bytes in (("int8", quantize_corpus_host, fused_similarity_topk_q8, d),
                                       ("int4", quantize_corpus_host_q4, fused_similarity_topk_q4, d // 2)):
        t0 = time.perf_counter()
        ops = [torch.as_tensor(a, device=dev) for a in (*quant(on_host("img", img)), *quant(on_host("txt", txt)))]
        stage_s[f"stage {name}"] = time.perf_counter() - t0
        tier(name, fn, ops, 2 * n * row_bytes + 2 * n * 4)
        del ops
    t0 = time.perf_counter()
    cbs = [train_pq_codebooks(on_host(x, t), m=m) for x, t in (("img", img), ("txt", txt))]
    (ci, si), (ct, st) = pq_encode(img, cbs[0]), pq_encode(txt, cbs[1])
    stage_s["stage pq"] = time.perf_counter() - t0
    tier("pq", pq_similarity_topk, [ci, si, ct, st, *(torch.as_tensor(c, device=dev) for c in cbs)],
         2 * n * m + 2 * n * 4)
    del ci, ct
    if args.exact:
        tier("bf16", fused_similarity_topk, [img.bfloat16(), txt.bfloat16()], 4 * n * d)
    del img, txt, host

    if args.ivf_rows:
        from ..retrieval.ann import IVFIndex, build_ivf_index, ivf_search, probed_fraction

        # clustered corpus (blobs tight enough that noise * sqrt(D) << 1, the
        # regime where recall per probe means something); queries perturb
        # corpus rows
        ni = min(args.ivf_rows, n)
        nc = max(64, ni // 256)
        centers = normed(gen, nc, d, dev, rank=min(d, 128))
        own = torch.randint(0, nc, (ni,), generator=gen, device=dev)
        unit = lambda x: x / x.norm(dim=1, keepdim=True).clamp_min(1e-9)  # noqa: E731
        img_i = unit(centers[own] + 0.02 * torch.randn((ni, d), generator=gen, device=dev))
        txt_i = unit(centers[own] + 0.02 * torch.randn((ni, d), generator=gen, device=dev))
        qi = img_i[torch.randperm(ni, generator=gen, device=dev)[:b]]
        qi = unit(qi + 0.05 * torch.randn((b, d), generator=gen, device=dev))
        exact_i = exact_topk(qi, img_i, txt_i, args.alpha, max(10, k), dev)
        img_h, txt_h = img_i.cpu().numpy(), txt_i.cpu().numpy()
        nlist = max(64, int(2 * np.sqrt(ni)) // 64 * 64)
        nprobe = max(4, nlist // 32)
        for quant in ("int8", "int4", "pq"):
            npq = min(nprobe, 8) if quant == "pq" else nprobe
            t0 = time.perf_counter()
            index = build_ivf_index(img_h, txt_h, nlist, quantize=quant, train_rows=min(ni, 131072), device=dev)
            stage_s[f"build ivf-{quant}"] = time.perf_counter() - t0
            print(f"ivf-{quant} at {ni} rows: nlist {nlist}, nprobe {npq}, build {stage_s[f'build ivf-{quant}']:.1f}"
                  f" s, probed fraction {probed_fraction(index, npq):.3f}", flush=True)

            def ivf_fn(qq, index: IVFIndex, k, alpha, _np=npq):
                return ivf_search(qq.float(), index, k=k, nprobe=_np, alpha=alpha)

            tier(f"ivf-{quant}@{ni // 1000}k", ivf_fn, [index], 2 * index.packed_img.numel()
                 * index.packed_img.element_size(), queries=qi.bfloat16(), truth=exact_i)

    payload = {"script": "scale_bench", "device": str(dev), "card": card(dev), "rows": n, "dim": d, "batch": b,
               "k": k, "iters": args.iters, "tiers": results, "failed_tiers": failed, "stage_s": stage_s,
               "wall_s": time.perf_counter() - t_start}
    write_json(payload, args.out)
    return payload


if __name__ == "__main__":
    main()
