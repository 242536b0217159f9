#!/usr/bin/env bash
# Zero-shot ViT-L/14 baseline (the PyTorch port, on the card).
set -euo pipefail
python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.cli.evaluate \
  --model.name=ViT-L/14 --model.checkpoint="${OPENAI_L14_CHECKPOINT:-}" \
  --data.dataset="${DATASET:-xuemduan/reevaluate-image-text-pairs}" "$@"
