"""Fine-tuning entry point.

The port's counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/cli/train.py``:

    python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.cli.train \
        --model.name=ViT-L/14 --train.epochs=20 --train.lr=5e-6 \
        [--config base.json] [--data.dataset=synthetic:256] [--device=cuda]

Weights come from ``--model.checkpoint`` or are seeded by ``train.seed``.
``--device`` defaults to ``cuda`` and never falls back; f32 products run
with TF32 off. A ``synthetic:N`` dataset validates on its training split.
Checkpoints go to ``train.checkpoint_dir``, metrics to ``eval.output_dir``.
A LoRA run (``--train.lora_rank=r``) also writes the best epoch's adapters
(the last epoch's without a best checkpoint) to
``eval.output_dir/lora_adapters.npz`` with ``rank`` / ``alpha`` /
``targets`` / ``model`` meta: ``--model.adapters`` of every entry point
merges them into the base.
"""

from __future__ import annotations

import logging
import os
import sys

import torch

from ..train import checkpoint as ckpt
from ..train.lora import save_adapters
from ..train.trainer import CLIPTrainer
from ..utils.config import config_from_argv
from ..parallel.mesh import runtime_init
from .common import build_model, build_pipeline, build_runtime, pop_flag, resolve_device

logger = logging.getLogger("kemr_torch.cli.train")


def main(argv=None) -> dict:
    args = list(sys.argv[1:] if argv is None else argv)
    device = resolve_device(pop_flag(args, "--device", "cuda"))
    cfg = config_from_argv(args)
    if cfg.eval.compile_cache:
        raise NotImplementedError("--eval.compile_cache is a JAX executable cache; the port runs eagerly")
    runtime_init()  # a no-op unless launched as several processes (torchrun's variables)
    rt = build_runtime(cfg, device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    logger.info("training %s on %s (%s)", cfg.model.name, cfg.data.dataset, device)

    model = build_model(cfg, device, seed=cfg.train.seed)
    train_pipe = build_pipeline(cfg, cfg.data.split_train)
    synthetic = cfg.data.dataset.startswith("synthetic:")
    val_pipe = train_pipe if synthetic else build_pipeline(cfg, cfg.data.split_val)
    trainer = CLIPTrainer(model, train_pipe, val_pipe, cfg.train, out_dir=cfg.eval.output_dir, rt=rt)
    result = trainer.train()
    logger.info("done: best %.4f @ epoch %d", result["best_metric"], result["best_epoch"])
    if trainer.lora:
        # ship the best epoch's adapters (early stopping runs patience epochs past it)
        adapters = trainer.state.adapters
        if ckpt.checkpoint_exists(cfg.train.checkpoint_dir, "best"):
            adapters = ckpt.load_checkpoint(cfg.train.checkpoint_dir, "best")[0]["params"]
        path = os.path.join(cfg.eval.output_dir, "lora_adapters.npz")
        save_adapters(path, adapters, {"rank": cfg.train.lora_rank, "alpha": cfg.train.lora_alpha,
                                       "targets": cfg.train.lora_targets, "model": cfg.model.name})
        logger.info("saved LoRA adapters to %s", path)
        result = dict(result, adapters_path=path)
    return result


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
