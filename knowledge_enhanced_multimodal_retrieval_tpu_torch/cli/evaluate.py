"""Evaluation entry point.

The port's counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/cli/evaluate.py``:
zero-shot when no checkpoint is given (seeded weights here), a checkpoint
in any layout ``models.convert.load_clip_state_dict`` reads otherwise; the optional Text2SPARQL fusion
sweep reads a results JSON (``{query uuid: [artefact URI, ...]}``):

    python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.cli.evaluate \
        --model.name=ViT-L/14 [--model.checkpoint=openai.pt] \
        [--data.dataset=synthetic:1024] [--eval.encoder=flax|fast|int8] \
        [--eval.output_dir=experiments] [--t2s_results=path.json] [--device=cuda]

writes ``eval_<model>_{zeroshot,finetuned}.json`` into ``eval.output_dir``.
``--device`` defaults to ``cuda`` and never falls back; the metric products
run in f32 with TF32 off.
"""

from __future__ import annotations

import json
import logging
import os
import sys

import torch

from ..eval.evaluator import run_full_evaluation
from ..utils.config import config_from_argv
from .common import build_model, build_pipeline, build_runtime, pop_flag, resolve_device

logger = logging.getLogger("kemr_torch.cli.evaluate")


def main(argv=None) -> dict:
    args = list(sys.argv[1:] if argv is None else argv)
    t2s_path = pop_flag(args, "--t2s_results")
    device = resolve_device(pop_flag(args, "--device", "cuda"))
    cfg = config_from_argv(args)
    if cfg.eval.compile_cache:
        raise NotImplementedError("--eval.compile_cache is a JAX executable cache; the port runs eagerly")
    torch.backends.cuda.matmul.allow_tf32 = False  # evaluation runs in f32

    rt = build_runtime(cfg, device)
    model = build_model(cfg, device)
    pipe = build_pipeline(cfg, cfg.data.split_test)
    t2s_results = None
    if t2s_path:
        with open(t2s_path) as f:
            t2s_results = json.load(f)

    tag = "finetuned" if cfg.model.checkpoint else "zeroshot"
    out = os.path.join(cfg.eval.output_dir, f"eval_{cfg.model.name.replace('/', '-')}_{tag}.json")
    report = run_full_evaluation(
        model,
        pipe,
        batch_size=cfg.eval.batch_size,
        k_values=cfg.eval.ks,
        t2i_weight=cfg.eval.t2i_weight,
        t2t_weight=cfg.eval.t2t_weight,
        text2sparql_results=t2s_results,
        output_json=out,
        encoder=cfg.eval.encoder,
        rt=rt,
    )
    logger.info("saved %s", out)
    for key, value in report["per_task"].items():
        logger.info("%s = %.4f", key, value)
    return report


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
