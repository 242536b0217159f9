"""Mine hard negatives for contrastive fine-tuning.

The port's counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/cli/mine_negatives.py``,
the offline half of the mined-negatives loop (``train.negatives``):

    python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.cli.mine_negatives \
        --model.name=ViT-L/14 [--model.checkpoint=...] \
        --out=data/negatives.npz --k=16 --by=query [--eval.encoder=int8] [--device=cuda]

encodes the training split with the model (``--eval.encoder``: the module
towers, or the ``fast`` / ``int8`` serving encoders), finds each example's
top-k highest-scoring other target texts (``--by=query`` anchors on the
query embedding, the T2T hard case; ``--by=image`` on the image, the T2I
one) and saves the fingerprinted table that ``--train.hard_negatives=<out>``
reads. ``--device`` defaults to ``cuda`` and never falls back.
"""

from __future__ import annotations

import logging
import os
import sys

import torch

from ..eval.evaluator import encode_dataset
from ..train.negatives import mine_hard_negatives, save_negatives
from ..utils.config import config_from_argv, resolve_encoder
from .common import build_model, build_pipeline, build_runtime, pop_flag, resolve_device

logger = logging.getLogger("kemr_torch.cli.mine_negatives")


def main(argv=None) -> str:
    args = list(sys.argv[1:] if argv is None else argv)
    out = pop_flag(args, "--out", "data/negatives.npz")
    k = int(pop_flag(args, "--k", "16"))
    by = pop_flag(args, "--by", "query")
    if by not in ("query", "image"):
        raise SystemExit(f"--by must be 'query' or 'image', got {by!r}")
    device = resolve_device(pop_flag(args, "--device", "cuda"))
    cfg = config_from_argv(args)
    rt = build_runtime(cfg, device)
    torch.backends.cuda.matmul.allow_tf32 = False  # the mining product runs in f32

    model = build_model(cfg, device)
    pipe = build_pipeline(cfg, cfg.data.split_train)
    use_fast, quantize = resolve_encoder(cfg.eval.encoder)
    enc = encode_dataset(model, pipe, batch_size=cfg.eval.batch_size, use_fast=use_fast, quantize=quantize, rt=rt)
    anchors = enc.query if by == "query" else enc.image
    idx = mine_hard_negatives(anchors, enc.target, k, device=device)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    save_negatives(out, idx, enc.uuids, meta={"by": by, "k": k})
    logger.info("mined [%d, %d] hard-negative table (by=%s) -> %s", *idx.shape, by, out)
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
