"""Offline IVF index builder.

The port's counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/cli/index.py``:
clustering and packing are the expensive index-build steps at corpus scale,
so this runs them once and writes the fingerprinted cache that serving
loads (``cli.serve --eval.ann=ivf --eval.ann_index=ivf.npz``):

    python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.cli.index \\
        --store store.npz --out ivf.npz \\
        [--eval.ann_nlist=256] [--eval.quantize_corpus=int8|int4|pq] \\
        [--calibrate=0.95 --calibrate-k=10 --calibrate-sample=256] \\
        [--eval.mmap_store=true] [--device=cuda]

The file is the JAX package's format: either package serves it. It binds
to the store by content fingerprint, so serving another (or an updated)
store with it rebuilds instead of serving wrong results. ``--device``
(default ``cuda``, as every entry point of the port; it never falls back,
so the CPU takes ``--device=cpu``) runs k-means and the calibration probes
there.
``--eval.mmap_store`` memory-maps the store's rows.
"""

from __future__ import annotations

import logging
import sys

import numpy as np

from ..utils.config import config_from_argv, resolve_quantize_corpus

from ..retrieval.ann import build_ivf_index, calibrate_nprobe, corpus_fingerprint, save_ivf_index
from ..retrieval.embedding_store import EmbeddingStore
from .common import pop_flag, resolve_device

logger = logging.getLogger("kemr_torch.cli.index")


def main(argv=None) -> str:
    args = list(sys.argv[1:] if argv is None else argv)
    store_path = pop_flag(args, "--store")
    out = pop_flag(args, "--out")
    # --calibrate=<target recall>: after building, sweep nprobe on a sample
    # of the store's own text rows and report the smallest width that meets
    # the target (pass it to serving as --eval.ann_nprobe)
    calibrate = pop_flag(args, "--calibrate")
    calibrate_k = int(pop_flag(args, "--calibrate-k", "10"))
    calibrate_sample = int(pop_flag(args, "--calibrate-sample", "256"))
    device = resolve_device(pop_flag(args, "--device", "cuda"))
    if not store_path or not out:
        raise ValueError("--store and --out are required")
    cfg = config_from_argv(args)
    logging.basicConfig(level=logging.INFO)

    store = EmbeddingStore.load(store_path, mmap=cfg.eval.mmap_store)
    nlist = cfg.eval.ann_nlist or max(1, int(np.sqrt(len(store))))
    quantize = resolve_quantize_corpus(cfg.eval.quantize_corpus)
    if quantize == "binary":
        raise ValueError("IVF composes with int8, int4, or pq corpus packing")
    logger.info("clustering %d rows into %d lists%s", len(store), nlist,
                f" ({quantize}-packed)" if quantize else "")
    index = build_ivf_index(
        store.image, store.text, nlist, quantize=quantize or None, pq_m=cfg.eval.pq_m or None, device=device,
    )
    save_ivf_index(out, index, fingerprint=corpus_fingerprint(store.image, store.text))
    logger.info("saved index to %s (nlist=%d cap=%d spill=%.3f)", out, index.nlist, index.cap, index.spill_fraction)
    if calibrate is not None:
        rng = np.random.default_rng(0)
        rows = rng.choice(len(store), size=min(calibrate_sample, len(store)), replace=False)
        result = calibrate_nprobe(
            index, np.asarray(store.text[rows], np.float32), store.image, store.text,
            k=calibrate_k, target_recall=float(calibrate),
        )
        for r in result["report"]:
            logger.info("  nprobe=%-4d recall@%d=%.4f", r["nprobe"], calibrate_k, r["recall"])
        logger.info(
            "recommended probe width: serve with --eval.ann_nprobe=%d (recall@%d %.4f >= target %s)",
            result["nprobe"], calibrate_k, result["achieved"], calibrate,
        )
    return out


if __name__ == "__main__":
    main()
