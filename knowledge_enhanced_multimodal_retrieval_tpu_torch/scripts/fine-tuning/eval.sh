#!/usr/bin/env bash
# Evaluate the best fine-tuned checkpoint on the test split (the PyTorch
# port, on the card).
set -euo pipefail
python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.cli.evaluate \
  --model.name=ViT-L/14 \
  --model.checkpoint="${CLIP_CHECKPOINT:?set CLIP_CHECKPOINT to the converted best checkpoint}" \
  --data.dataset="${DATASET:-xuemduan/reevaluate-image-text-pairs}" "$@"
