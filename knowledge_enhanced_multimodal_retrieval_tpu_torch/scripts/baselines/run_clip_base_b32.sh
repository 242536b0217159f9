#!/usr/bin/env bash
# Zero-shot ViT-B/32 baseline (the PyTorch port, on the card).
set -euo pipefail
python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.cli.evaluate \
  --model.name=ViT-B/32 --model.checkpoint="${OPENAI_B32_CHECKPOINT:-}" \
  --data.dataset="${DATASET:-xuemduan/reevaluate-image-text-pairs}" "$@"
