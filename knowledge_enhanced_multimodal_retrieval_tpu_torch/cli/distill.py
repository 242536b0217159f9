"""Distillation entry point: a fine-tuned teacher into a small serving student.

The port's counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/cli/distill.py``
(``train.distill``), two stages in one command:

1. **teacher encode**, skipped when ``--teacher-embeddings`` names an
   existing file: the teacher (``--teacher-name``, weights from
   ``--teacher-checkpoint`` or seeded by ``train.seed``) encodes the training
   split once, through ``--teacher-encoder`` (``flax``: the module towers;
   ``fast`` / ``int8``: the serving encoders), saved row-aligned with the
   uuids (``eval.output_dir/teacher_train.npz`` unless named);
2. **student training**: ``CLIPTrainer`` with ``train.distill_teacher``, so
   the step minimizes the similarity-matrix KL to the teacher (and the
   cosine term where the dimensions match); early stopping watches the
   student's validation MRR.

    python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.cli.distill \
        --model.name=ViT-B/32 --teacher-name=ViT-L/14 [--teacher-checkpoint=best.pt] \
        [--teacher-encoder=int8] [--teacher-embeddings=teacher_train.npz] \
        [--train.distill_embed_weight=0]   # required across embed dims
        [--device=cuda]

``--device`` defaults to ``cuda`` and never falls back.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys

import torch

from ..eval.evaluator import encode_dataset
from ..train.distill import load_encoded_dataset, save_encoded_dataset
from ..train.trainer import CLIPTrainer
from ..utils.config import config_from_argv, resolve_encoder
from ..parallel.mesh import runtime_init
from .common import build_model, build_pipeline, build_runtime, pop_flag, resolve_device

logger = logging.getLogger("kemr_torch.cli.distill")


def main(argv=None) -> dict:
    args = list(sys.argv[1:] if argv is None else argv)
    teacher_name = pop_flag(args, "--teacher-name")
    teacher_ckpt = pop_flag(args, "--teacher-checkpoint", "")
    teacher_encoder = pop_flag(args, "--teacher-encoder", "flax")
    teacher_path = pop_flag(args, "--teacher-embeddings", "")
    device = resolve_device(pop_flag(args, "--device", "cuda"))
    cfg = config_from_argv(args)
    runtime_init()  # a no-op unless launched as several processes (torchrun's variables)
    rt = build_runtime(cfg, device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = cfg.eval.output_dir
    os.makedirs(out_dir, exist_ok=True)

    if not (teacher_path and os.path.exists(teacher_path)):
        if not teacher_name:
            raise ValueError(
                "need --teacher-name (+ --teacher-checkpoint) to encode the teacher, "
                "or --teacher-embeddings pointing at an existing artifact"
            )
        teacher_cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, name=teacher_name, checkpoint=teacher_ckpt, adapters="")
        )
        teacher = build_model(teacher_cfg, device, seed=cfg.train.seed)
        use_fast, quantize = resolve_encoder(teacher_encoder)
        pipe = build_pipeline(cfg, cfg.data.split_train)
        logger.info("encoding teacher %s over %s (%s towers)", teacher_name, cfg.data.split_train, teacher_encoder)
        enc = encode_dataset(teacher, pipe, batch_size=cfg.eval.batch_size, use_fast=use_fast, quantize=quantize,
                             rt=rt)
        teacher_path = teacher_path or os.path.join(out_dir, "teacher_train.npz")
        save_encoded_dataset(teacher_path, enc)
        logger.info("saved %d teacher rows -> %s", len(enc.uuids), teacher_path)
        del teacher, enc  # the student loop never needs them
        if device.type == "cuda":
            torch.cuda.empty_cache()
    else:
        logger.info("loaded %d teacher rows from %s", len(load_encoded_dataset(teacher_path).uuids), teacher_path)

    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, distill_teacher=teacher_path))
    model = build_model(cfg, device, seed=cfg.train.seed)
    train_pipe = build_pipeline(cfg, cfg.data.split_train)
    synthetic = cfg.data.dataset.startswith("synthetic:")
    val_pipe = train_pipe if synthetic else build_pipeline(cfg, cfg.data.split_val)
    trainer = CLIPTrainer(model, train_pipe, val_pipe, cfg.train, out_dir=out_dir, rt=rt)
    result = trainer.train()
    logger.info("distilled %s: best val %.4f @ epoch %d", cfg.model.name, result["best_metric"], result["best_epoch"])
    return dict(result, teacher_embeddings=teacher_path)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
