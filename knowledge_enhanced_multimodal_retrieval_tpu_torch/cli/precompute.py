"""Precompute the serving corpus embedding store.

The port's counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/cli/precompute.py``:

    python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.cli.precompute \
        --model.name=ViT-L/14 [--model.checkpoint=openai.pt] \
        --data.dataset=synthetic:1000 --eval.encoder=flax|fast|int8 \
        --out=data/embeddings/store.npz [--device=cuda]

writes the ``.npz`` store that both packages' ``EmbeddingStore.load`` read.
``--device`` defaults to ``cuda`` and never falls back.
"""

from __future__ import annotations

import logging
import os
import sys

from ..utils.config import config_from_argv, resolve_encoder

from ..retrieval.embedding_store import build_embedding_store
from .common import build_model, build_pipeline, build_runtime, pop_flag, resolve_device

logger = logging.getLogger("kemr_torch.cli.precompute")


def main(argv=None) -> str:
    args = list(sys.argv[1:] if argv is None else argv)
    out = pop_flag(args, "--out", "data/embeddings/store.npz")
    device = resolve_device(pop_flag(args, "--device", "cuda"))
    cfg = config_from_argv(args)
    if cfg.eval.compile_cache:
        raise NotImplementedError("--eval.compile_cache is a JAX executable cache; the port runs eagerly")
    use_fast, quantize = resolve_encoder(cfg.eval.encoder)
    rt = build_runtime(cfg, device)
    model = build_model(cfg, device)
    if cfg.data.image_size != model.arch.image_resolution:
        raise ValueError(
            f"--data.image_size={cfg.data.image_size} but the model takes "
            f"{model.arch.image_resolution} px images"
        )
    pipe = build_pipeline(cfg, cfg.data.split_test)
    store = build_embedding_store(model, pipe, batch_size=cfg.eval.batch_size, use_fast=use_fast, quantize=quantize,
                                  rt=rt)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    store.save(out)
    logger.info("saved %d x %d embedding store to %s", len(store), store.dim, out)
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
