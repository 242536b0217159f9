"""Time the PQ corpus scan beside the other packing tiers.

Counterpart of the reference's ``scripts/profile_pq.py``: ``--q`` seeded
unit queries against a seeded ``--n`` x ``--d`` corpus per tower, k =
``--k``, alpha 0.5, one line per tier:

- ``bf16 exact``, ``int8``, ``int4``: B2 in its exact, q8 and q4 modes;
- ``pq m=<d/8> decode``: ``ops.pq.pq_similarity_topk_xla``, the decode
  and matmul route in plain PyTorch (the reference's off-TPU path);
- ``pq m=<d/8> adc``: B5 (``ops.pq.fused_pq_topk``).

Each line: event and device-only medians (``scripts.timing``), bytes a row
a tower, recall@10 against the exact f32 blend (``scale_bench.recall_at``),
and the kernel launches of one call. The codebooks train and the rows
pack on the host (one-time staging, timed apart).

    python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts.profile_pq \
        [--n 43000] [--d 768] [--q 256] [--k 20] [--iters 30] [--device cuda] [--out PATH]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..cli.common import resolve_device
from ..ops.pq import fused_pq_topk, pack_pq_host, pq_similarity_topk_xla, train_pq_codebooks
from ..ops.similarity import (
    fused_similarity_topk,
    fused_similarity_topk_q4,
    fused_similarity_topk_q8,
    quantize_corpus_host,
    quantize_corpus_host_q4,
)
from .scale_bench import exact_topk, recall_at
from .timing import card, default_out, launches_of, time_ms, write_json

DEFAULT_OUT = default_out("profile_pq.json")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=43000)
    p.add_argument("--d", type=int, default=768)
    p.add_argument("--q", type=int, default=256)
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=DEFAULT_OUT)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    norm = lambda x: (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)  # noqa: E731
    img = norm(rng.standard_normal((args.n, args.d)))
    txt = norm(rng.standard_normal((args.n, args.d)))
    q32 = norm(rng.standard_normal((args.q, args.d)))
    q = torch.as_tensor(q32, device=dev).bfloat16()
    k = args.k
    on = lambda *xs: [torch.as_tensor(x, device=dev) for x in xs]  # noqa: E731
    exact_ids = exact_topk(q32, img, txt, 0.5, max(10, k), dev)

    m = args.d // 8
    t0 = time.perf_counter()
    cb_i, cb_t = train_pq_codebooks(img, m=m), train_pq_codebooks(txt, m=m)
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (pi, psi), (pt, pst) = pack_pq_host(img, cb_i), pack_pq_host(txt, cb_t)
    pack_s = time.perf_counter() - t0
    pq_ops = on(pi, psi, pt, pst, cb_i, cb_t)
    tiers = [
        ("bf16 exact", fused_similarity_topk, [t.bfloat16() for t in on(img, txt)], 2 * args.d),
        ("int8", fused_similarity_topk_q8, on(*quantize_corpus_host(img), *quantize_corpus_host(txt)), args.d + 4),
        ("int4", fused_similarity_topk_q4, on(*quantize_corpus_host_q4(img), *quantize_corpus_host_q4(txt)),
         args.d // 2 + 4),
        (f"pq m={m} decode", pq_similarity_topk_xla, pq_ops, m + 4),
        (f"pq m={m} adc", fused_pq_topk, pq_ops, m + 4),
    ]
    rows = {}
    for name, fn, ops, bytes_per_row in tiers:
        call = lambda fn=fn, ops=ops: fn(q, *ops, k)  # noqa: E731
        ids = call()[1].cpu().numpy()
        t = time_ms(call, dev, iters=args.iters)
        rows[name] = {**t, "bytes_per_row_per_tower": bytes_per_row, "recall@10": recall_at(ids, exact_ids),
                      "launches": launches_of(call, dev)}
        print(f"  {name:14} " + " ".join(f"{key} {v:8.3f}" for key, v in t.items())
              + f"  {bytes_per_row:5d} B/row/tower  recall@10 {rows[name]['recall@10']:.4f}", flush=True)
    print(f"pq codebook train {train_s:.1f} s, pack {pack_s:.1f} s (host, one-time staging)", flush=True)
    payload = {"script": "profile_pq", "device": str(dev), "card": card(dev), "n": args.n, "d": args.d,
               "q": args.q, "k": k, "iters": args.iters, "tiers": rows, "pq_train_s": train_s, "pq_pack_s": pack_s}
    write_json(payload, args.out)
    return payload


if __name__ == "__main__":
    main()
