#!/usr/bin/env bash
# Build the corpus embedding store, then serve knowledge-enhanced queries
# (the PyTorch port, on the card).
set -euo pipefail
STORE="${STORE:-data/embeddings/store.npz}"
python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.cli.precompute \
  --model.name=ViT-L/14 --model.checkpoint="${CLIP_CHECKPOINT:-}" \
  --data.dataset="${DATASET:-xuemduan/reevaluate-image-text-pairs}" --out "$STORE"
exec python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.cli.serve --store "$STORE" "$@"
