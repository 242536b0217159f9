#!/usr/bin/env bash
# Canonical ViT-L/14 fine-tuning run of the PyTorch port, on the card
# (hyperparameters live in the typed config defaults).
set -euo pipefail
python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.cli.train \
  --model.name=ViT-L/14 \
  --model.checkpoint="${CLIP_CHECKPOINT:-}" \
  --data.dataset="${DATASET:-xuemduan/reevaluate-image-text-pairs}" \
  --train.batch_size=64 --train.epochs=20 --train.lr=5e-6 \
  --train.weight_decay=0.02 --train.t2i_weight=0.7 --train.t2t_weight=0.3 \
  --train.seed=42 "$@"
