"""Stage-2 fusion-head training entry point.

The port's counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/cli/train_fusion.py``:
encode the train split with a frozen CLIP, train one of the six heads on
the frozen embeddings, encode the test split, evaluate the head blockwise
against the linear baseline, and save the head artifact (servable by either
package's ``cli.serve --fusion.head_params=<path>``) beside its
``<out>.metrics.json``:

    python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.cli.train_fusion \
        --out=experiments/head.npz --fusion.head=simple_gated \
        --model.name=ViT-L/14 [--model.checkpoint=openai.pt] \
        [--data.dataset=synthetic:128] [--eval.encoder=int8] \
        [--train.epochs=10] [--train.lr=1e-3] [--device=cuda]

``--device`` defaults to ``cuda`` and never falls back.
"""

from __future__ import annotations

import json
import logging
import os
import sys

import torch

from ..eval.evaluator import encode_dataset
from ..models.fusion_heads import FusionModel
from ..train.fusion_trainer import evaluate_fusion_model, save_fusion_head, train_fusion_head
from ..utils.config import config_from_argv, resolve_encoder
from .common import build_model, build_pipeline, build_runtime, pop_flag, resolve_device

logger = logging.getLogger("kemr_torch.cli.train_fusion")


def main(argv=None) -> dict:
    args = list(sys.argv[1:] if argv is None else argv)
    out_path = pop_flag(args, "--out", "experiments/fusion_head.npz")
    device = resolve_device(pop_flag(args, "--device", "cuda"))
    cfg = config_from_argv(args)
    if cfg.eval.compile_cache:
        raise NotImplementedError("--eval.compile_cache is a JAX executable cache; the port runs eagerly")
    torch.backends.cuda.matmul.allow_tf32 = False

    rt = build_runtime(cfg, device)
    model = build_model(cfg, device)
    use_fast, quantize = resolve_encoder(cfg.eval.encoder)

    def encode(split):
        pipe = build_pipeline(cfg, split)
        return encode_dataset(model, pipe, batch_size=cfg.eval.batch_size, use_fast=use_fast, quantize=quantize,
                              rt=rt)

    enc_train = encode(cfg.data.split_train)
    fm = FusionModel(cfg.fusion.head, embed_dim=enc_train.query.shape[1])
    logger.info("training %s head on %d frozen-embedding rows", cfg.fusion.head, enc_train.query.shape[0])
    fparams, history = train_fusion_head(
        fm, enc_train,
        epochs=cfg.train.epochs,
        batch_size=cfg.train.batch_size,
        lr=cfg.train.lr,
        temperature=cfg.train.temperature,
        seed=cfg.train.seed,
        device=device,
    )

    enc_test = encode(cfg.data.split_test)
    report = evaluate_fusion_model(
        fm, fparams, enc_test, k_values=cfg.eval.ks,
        baseline_weights=(cfg.eval.t2i_weight, cfg.eval.t2t_weight),
    )

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    save_fusion_head(out_path, fm, fparams)
    metrics_path = os.path.splitext(out_path)[0] + ".metrics.json"
    with open(metrics_path, "w") as f:
        json.dump({"history": history, "eval": report}, f, indent=2, default=float)
    logger.info("saved head -> %s, metrics -> %s", out_path, metrics_path)
    for key, prefix in (("fusion", "FUSION"), ("baseline", "BASELINE")):
        logger.info("%s MRR = %s", key, report[key].get(f"{prefix}_MRR"))
    return report


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
