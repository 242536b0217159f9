"""Quality sweep CLI: what do the corpus packing modes cost on YOUR data?

The port's counterpart of the repo's ``scripts/quality_sweep.py``:

    python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts.quality_sweep \
        --store data/embeddings/store.npz [--queries 256] [--k 10] [--alpha 0.5] \
        [--nprobes 4,8,16] [--rotate] [--truncate-dims 256] [--device cuda]
    python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts.quality_sweep \
        --synthetic 4096,512 --device cpu   # no store needed

Prints a table of recall@k / top-1 retention / score MAE against exact
brute force for int8, int4, pq and binary, their host-rerank variants,
optionally the rotated, OPQ, Matryoshka and IVF rows, then one JSON line for
scripting. Queries are a random sample of the store's text-tower rows.
``--device`` defaults to ``cuda`` (the packed rows then go through the
kernels B2, B2-q4 and B5) and never falls back.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..cli.common import resolve_device
from ..eval.quality import format_table, quality_sweep


def load_towers(args, rng):
    """``(image, text)`` f32 towers from ``--store`` or ``--synthetic N,D``."""
    if args.synthetic:
        n, d = (int(x) for x in args.synthetic.split(","))
        norm = lambda x: x / np.linalg.norm(x, axis=1, keepdims=True)  # noqa: E731
        image = norm(rng.standard_normal((n, d))).astype(np.float32)
        text = norm(rng.standard_normal((n, d))).astype(np.float32)
        return image, text
    from ..retrieval.embedding_store import EmbeddingStore

    store = EmbeddingStore.load(args.store)
    return np.asarray(store.image, np.float32), np.asarray(store.text, np.float32)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--store", help="EmbeddingStore .npz (image/text towers + uuids)")
    src.add_argument("--synthetic", help="N,D synthetic corpus instead of a store")
    p.add_argument("--queries", type=int, default=256)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--rerank-factor", type=int, default=4)
    p.add_argument("--nprobes", default="", help="comma-separated IVF probe widths")
    p.add_argument("--truncate-dims", default="", help="comma-separated Matryoshka prefix widths")
    p.add_argument("--rotate", action="store_true", help="add +rot rows and the pq+opq rows")
    p.add_argument("--pq-aniso-t", type=float, default=0.0,
                   help="add pq+aniso rows (score-aware codebooks at this threshold; 0.2 is the standard point)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # the exact ranking is f32

    rng = np.random.default_rng(args.seed)
    image, text = load_towers(args, rng)
    q = text[rng.choice(len(text), min(args.queries, len(text)), replace=False)]
    rows = quality_sweep(
        image, text, q, k=args.k, alpha=args.alpha, rerank_factor=args.rerank_factor,
        nprobes=tuple(int(x) for x in args.nprobes.split(",") if x.strip()),
        truncate_dims=tuple(int(x) for x in args.truncate_dims.split(",") if x.strip()),
        rotate=args.rotate, rotate_seed=args.seed, pq_aniso_t=args.pq_aniso_t, device=device,
    )
    out = {"k": args.k, "alpha": args.alpha, "rows": rows}
    print(format_table(rows))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
