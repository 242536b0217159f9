"""Text-only baseline evaluation entry point.

The port's counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/cli/baseline_text.py``
(the reference's ``python baselines/evaluate_text_models.py``):

    python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.cli.baseline_text \
        --model_name sentence-transformers/all-mpnet-base-v2 \
        --texts_dir path/to/texts --splits path/to/splits.json \
        --description_type hybrid_o1 --mode multi [--device cuda]

The sentence encoder and the rank computation run on ``--device`` (the
card by default; ``--device=cpu`` asks for the CPU). The encoder needs
``sentence_transformers`` and its weights on disk.
"""

from __future__ import annotations

import argparse
import os

from ..baselines.text_models import SentenceTransformerEncoder, evaluate_text_model, load_text_variants
from ..utils.data_utils import load_splits_from_json
from ..utils.logging_utils import save_metrics_to_json, setup_logger
from .common import resolve_device


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--model_name", required=True)
    p.add_argument("--texts_dir", required=True)
    p.add_argument("--splits", required=True, help="splits JSON (save_splits_to_json format)")
    p.add_argument("--split", default="test", choices=["train", "val", "test"])
    p.add_argument("--description_type", default="hybrid_o1")
    p.add_argument("--mode", default="multi", choices=["single", "multi"])
    p.add_argument("--output_dir", default="experiments/baselines")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    logger = setup_logger("kemr_torch.cli.baseline_text")
    device = resolve_device(args.device)
    train, val, test = load_splits_from_json(args.splits)
    uuids = {"train": train, "val": val, "test": test}[args.split]
    texts = load_text_variants(uuids, args.texts_dir, args.description_type)
    encoder = SentenceTransformerEncoder(args.model_name, device=str(device))
    metrics = evaluate_text_model(encoder, texts, mode=args.mode, device=device)

    out = os.path.join(
        args.output_dir,
        f"text_{args.model_name.split('/')[-1]}_{args.description_type}_{args.mode}.json",
    )
    save_metrics_to_json(metrics, out)
    for k, v in metrics.items():
        logger.info("%s = %.4f", k, v)
    return metrics


if __name__ == "__main__":
    main()
