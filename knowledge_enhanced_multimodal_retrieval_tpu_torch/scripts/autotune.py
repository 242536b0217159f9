"""Serving-config autotuner CLI: the cheapest packing meeting a recall target.

The port's counterpart of the repo's ``scripts/autotune.py``:

    python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts.autotune \
        --store data/embeddings/store.npz [--recall-target 0.98] [--k 10] \
        [--alpha 0.5] [--no-rerank] [--device cuda]
    python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts.autotune \
        --synthetic 4096,512 --recall-target 0.95 --device cpu

Measures the packing ladder (int8 / int4 / pq / binary x rotation x host
rerank) with the quality sweep, picks the highest-capacity rung that meets
the target, and prints the serve-CLI flags that enable it, then one JSON
line for scripting. ``--device`` defaults to ``cuda`` and never falls back.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..cli.common import resolve_device
from ..eval.autotune import recommend_config
from ..eval.quality import format_table
from .quality_sweep import load_towers


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--store", help="EmbeddingStore .npz (image/text towers + uuids)")
    src.add_argument("--synthetic", help="N,D synthetic corpus instead of a store")
    p.add_argument("--recall-target", type=float, default=0.98)
    p.add_argument("--queries", type=int, default=256)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--rerank-factor", type=int, default=4)
    p.add_argument("--no-rerank", action="store_true", help="exclude host-rerank configs")
    p.add_argument("--no-rotate", action="store_true", help="exclude rotated configs")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False

    image, text = load_towers(args, np.random.default_rng(args.seed))
    rec = recommend_config(
        image, text,
        recall_target=args.recall_target, k=args.k, alpha=args.alpha,
        rerank_factor=args.rerank_factor, rerank_ok=not args.no_rerank,
        rotate=not args.no_rotate, rotate_seed=args.seed,
        n_queries=args.queries, seed=args.seed, device=device,
    )
    print(format_table(rec["rows"]))
    print()
    print(f"recommendation: {rec['config']}  "
          f"(recall@{rec['k']} {rec['predicted_recall_at_k']:.4f} >= {rec['recall_target']}, "
          f"{rec['capacity_multiplier']:.0f}x corpus capacity/chip)")
    print(f"serve flags: {rec['serve_flags'] or '(defaults — exact corpus)'}")
    out = {k: v for k, v in rec.items() if k != "rows"}
    print(json.dumps(out))
    return rec


if __name__ == "__main__":
    main()
