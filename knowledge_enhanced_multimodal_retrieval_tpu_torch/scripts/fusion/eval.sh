#!/usr/bin/env bash
# Weighted T2I+T2T combined eval at 0.5/0.5 (the PyTorch port, on the card).
set -euo pipefail
python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.cli.evaluate \
  --model.name=ViT-L/14 --model.checkpoint="${CLIP_CHECKPOINT:-}" \
  --eval.t2i_weight=0.5 --eval.t2t_weight=0.5 \
  --data.dataset="${DATASET:-xuemduan/reevaluate-image-text-pairs}" "$@"
